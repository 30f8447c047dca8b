"""Stage breakdown for lcpcomp(comp=device) (round-5, VERDICT item 5).

Splits the 1 MiB factorize_device wall into:
  lcp_by_pos   SA+ISA+ranks + per-position SA-predecessor LCP
  rounds       the _all_rounds while_loop (plus its round count)
  total        the full factorize_device call (incl. host finish)

Usage: python -u etc/probe_lcpcomp_breakdown.py [corpus]
"""

from __future__ import annotations

import os
import sys
import time


import numpy as np


def main() -> None:
    import jax

    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from etc import datasets

    from tudocomp_tpu.ops import lcpcomp_jax as L

    name = sys.argv[1] if len(sys.argv) > 1 else "english"
    raw = np.frombuffer(getattr(datasets, f"gen_{name}")(1 << 20),
                        np.uint8)
    text = np.tile(raw, -(-(1 << 20) // raw.size))[: 1 << 20].copy()
    text[-1] = 0
    tj = jnp.asarray(text)

    def timeit(fn, reps=3):
        fn()
        best = 1e9
        for _ in range(reps):
            t0 = time.perf_counter()
            r = fn()
            np.asarray(jax.tree_util.tree_leaves(r)[0].ravel()[:1])
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    t = timeit(lambda: L._lcp_by_position(tj, max_len=4096))
    print(f"lcp_by_pos: {t:8.1f} ms/MiB", flush=True)

    lcp0_p, src_p = L._lcp_by_position(tj, max_len=4096)
    lcp0_p = jax.block_until_ready(lcp0_p)
    n = text.size
    cov0 = jnp.zeros(n, bool)
    ch0 = jnp.zeros(n, jnp.int32)
    thr = jnp.asarray(5, jnp.int32)

    t = timeit(lambda: L._all_rounds(cov0, ch0, lcp0_p, thr,
                                     max_len=4096))
    _, _, rounds = L._all_rounds(cov0, ch0, lcp0_p, thr, max_len=4096)
    print(f"rounds:     {t:8.1f} ms/MiB  ({int(rounds)} rounds)",
          flush=True)

    t0 = time.perf_counter()
    L.factorize_device(text, 5)
    t1 = time.perf_counter()
    L.factorize_device(text, 5)
    print(f"total:      {(time.perf_counter()-t1)*1e3:8.1f} ms/MiB "
          f"(first warm {(t1-t0)*1e3:.0f})", flush=True)


if __name__ == "__main__":
    main()
