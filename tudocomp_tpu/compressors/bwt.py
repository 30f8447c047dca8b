"""BWT compressor.

Reference: ``compressors/BWTCompressor.hpp`` — compress = raw BWT bytes of
the 0-sentineled input (forward transform is a pure SA gather); decompress
= LF-mapping walk, emitting the text plus the sentinel (the restriction
layer strips it).
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu.compressors.base import Compressor
from tudocomp_tpu.ds.bwt import bwt_decode, bwt_forward
from tudocomp_tpu.ds.suffix import suffix_array
from tudocomp_tpu.meta import Meta


class BWTCompressor(Compressor):
    @classmethod
    def meta(cls):
        m = Meta("compressor", "bwt", "BWT Compressor")
        m.option_dynamic("device", "false")
        m.needs_sentinel_terminator()
        return m

    #: inputs at least this long use the device SA/BWT path
    #: (``ops/suffix_jax.py``) when it is asked for. Opt-in via
    #: bwt(device=true) (env TDC_DEVICE_BWT=1 overrides): each input
    #: size compiles its own device program, so the device path only
    #: pays off for repeated same-shape workloads.
    DEVICE_MIN = 1 << 15

    def _use_device(self, n: int) -> bool:
        import os

        from tudocomp_tpu import backend

        env = os.environ.get("TDC_DEVICE_BWT")
        want = (
            env == "1" if env is not None
            else self.env.option("device").as_bool()
        )
        if not want or n < self.DEVICE_MIN:
            return False
        backend.platform()  # refuses an unsupported platform
        return True

    def compress(self, data: bytes) -> bytes:
        if not data.endswith(b"\x00"):
            raise ValueError("bwt requires a sentineled input")
        t = np.frombuffer(data, np.uint8)
        if self._use_device(len(data)):
            import jax.numpy as jnp

            from tudocomp_tpu.ops.suffix_jax import (
                bwt_device, isa_device, suffix_array_device,
            )

            td = jnp.asarray(t)
            sa = suffix_array_device(td)
            bw = bwt_device(td, isa_device(sa))
            return np.asarray(bw).tobytes()
        sa = suffix_array(t)
        return bwt_forward(t, sa).tobytes()

    def decompress(self, data: bytes) -> bytes:
        if self._use_device(len(data)):
            import jax.numpy as jnp

            from tudocomp_tpu import debug
            from tudocomp_tpu.ops.suffix_jax import unbwt_device

            arr = np.frombuffer(data, np.uint8)
            if debug.PARANOID:  # mirror the host path's LF invariant
                from tudocomp_tpu.ds.bwt import compute_lf

                debug.check_lf(compute_lf(arr), arr)
            out = unbwt_device(jnp.asarray(arr))
            return np.asarray(out).tobytes() + b"\x00"
        from tudocomp_tpu import native

        return native.bwt_decode(data) + b"\x00"
