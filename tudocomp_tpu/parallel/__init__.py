"""Multi-chip scaling layer (no reference counterpart — SURVEY.md §2.7).

The reference is single-core; this package is the data-parallel scaling
design mandated by BASELINE.json: data-parallel blocks over a device
mesh, psum-merged histograms, broadcast code tables, and ordered gather
of per-block compressed frames.
"""

from tudocomp_tpu.parallel.mesh import make_mesh  # noqa: F401
from tudocomp_tpu.parallel.pipeline import (  # noqa: F401
    compress_sharded,
    sharded_huff_stage,
    sharded_rle_stage,
)
