"""Worker for tests/test_distributed.py — one JAX process of a
2-process CPU "pod" (4 virtual devices each, 8 global).

Runs the multi-host encode protocol from ``parallel/distributed.py``:
host-local input shard -> ``global_block_batch`` -> shard_map with a
cross-process ``psum`` histogram (the design's one DCN collective) ->
identical Huffman table derived on every host from the global histogram
-> per-block frames -> ``gather_frames_host_local`` -> each host writes
its own piece, tagged with its global block offset.

Usage: dist_worker.py PID NPROC PORT OUTDIR
"""

import os
import sys

pid, nproc, port, outdir = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
)

# the workers run on the CPU whatever accelerator the machine has
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from tudocomp_tpu.parallel import distributed  # noqa: E402

distributed.initialize(f"localhost:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()

N_BLOCKS, BLOCK = 8, 512
rng = np.random.default_rng(7)
all_blocks = rng.integers(97, 105, (N_BLOCKS, BLOCK), dtype=np.uint8)
per = N_BLOCKS // nproc
local = all_blocks[pid * per : (pid + 1) * per]
local_lens = np.full(per, BLOCK, np.int32)

mesh = Mesh(np.array(jax.devices()), ("dp",))
blocks, lens = distributed.global_block_batch(mesh, local, local_lens)


def step(b, l):
    import jax.numpy as jnp

    hist = jnp.zeros(256, jnp.int32).at[b.reshape(-1)].add(1)
    return b, jax.lax.psum(hist, "dp")  # the one cross-host collective


frames, hist = jax.shard_map(
    step, mesh=mesh, in_specs=(P("dp"), P("dp")), out_specs=(P("dp"), P()),
)(blocks, lens)

hist_np = np.asarray(
    hist.addressable_shards[0].data
    if hasattr(hist, "addressable_shards") else hist
)

# identical table on every host: pure function of the psum'd histogram
from tudocomp_tpu.coders.huffman import HuffmanTable  # noqa: E402

table = HuffmanTable.from_counts(hist_np.astype(np.int64))

# per-block encode of the host-local rows, each tagged with its global
# block index — "each host writes its own byte range"
pieces = []
for start, rows in distributed.gather_frames_host_local(frames):
    for j, row in enumerate(rows):
        code = table.sym_code[row].astype(np.uint64)
        ln = table.sym_len[row].astype(np.int64)
        pieces.append((start + j, code.sum() & 0xFFFF, int(ln.sum())))

np.save(
    os.path.join(outdir, f"proc{pid}.npy"),
    np.array(pieces, dtype=np.int64),
)
np.save(os.path.join(outdir, f"hist{pid}.npy"), hist_np)

# ---- phase 2: the REAL sharded encode kernels across processes --------
# 1 MiB through rle_stage/huff_stage under shard_map on the global
# 2-process mesh; each host frames its own segments. The test glues
# header + pieces and compares byte-for-byte with a single-process
# codec.compress of the same data.
from tudocomp_tpu.models.blockcodec import BlockCodec  # noqa: E402
from tudocomp_tpu.parallel.distributed import (  # noqa: E402
    compress_distributed,
)

rng2 = np.random.default_rng(11)
data2 = (
    b"rosebud was his sled all along; " * 22000
    + bytes(rng2.integers(0, 48, 400000, dtype=np.uint8))
)[: 1 << 20]
codec = BlockCodec()
seg_rows, seg_lens = codec.split_segments(data2)
mesh2 = Mesh(np.array(jax.devices()).reshape(nproc * 4, 1), ("dp", "sp"))
per2 = seg_rows.shape[0] // nproc
header, pieces2 = compress_distributed(
    codec, mesh2,
    np.ascontiguousarray(seg_rows[pid * per2 : (pid + 1) * per2]),
    np.ascontiguousarray(seg_lens[pid * per2 : (pid + 1) * per2]),
    len(data2),
)
if pid == 0:
    with open(os.path.join(outdir, "header.bin"), "wb") as f:
        f.write(header)
for start, frames in pieces2:
    with open(os.path.join(outdir, f"piece_{start:08d}.bin"), "wb") as f:
        f.write(frames)

print("WORKER_OK", pid, flush=True)
