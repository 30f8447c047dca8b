"""Where does esp(rounds=device) time go? (round 5)

The fused-round program (ops/esp_jax.py) runs every big round in ONE
dispatch; this probe splits the wall time into

  compute   the fused chain (dispatch + the packed scalars/tail pull
            that blocks on it)
  rules     the bucketed rules d2h (with copy_to_host_async it
            overlaps the host tail in production; timed cold here)
  tail      the host esp_vec rounds below the cutoff

plus a fresh-buffer d2h bandwidth row at rule scale.

Usage: python -u etc/probe_esp_breakdown.py [corpus]
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

    import tudocomp_tpu.ops.esp_jax as E

    name = sys.argv[1] if len(sys.argv) > 1 else "english"
    raw = np.frombuffer(getattr(datasets, f"gen_{name}")(1 << 20),
                        np.uint8)
    text = np.tile(raw, -(-(1 << 20) // raw.size))[: 1 << 20].copy()
    text[-1] = 0
    data = text.tobytes()
    tail_cutoff = 4096

    s_host = np.frombuffer(data, np.uint8).astype(np.int64)
    N0 = E._pad_pow2(s_host.size, lo=2 * tail_cutoff)
    schedule = []
    Nk, b = N0, 256
    while True:
        schedule.append((Nk, E.iter_log(b)))
        b = 257
        if Nk <= 2 * tail_cutoff:
            break
        Nk //= 2
    pad = np.zeros(N0, np.int32)
    pad[: s_host.size] = s_host
    sj = jnp.asarray(pad)
    nj = jnp.int32(s_host.size)
    sch = tuple(schedule)

    packed, rules = E._esp_fused(sj, nj, sch)
    np.asarray(packed)
    base = int(np.asarray(packed)[1])
    r_total = base - 256
    bucket = min(E._pad_pow2(max(r_total, 1)), 2 * N0)
    np.asarray(rules[:bucket])

    for _ in range(3):
        t0 = time.perf_counter()
        packed, rules = E._esp_fused(sj, nj, sch)
        p = np.asarray(packed)
        t_comp = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = np.asarray(rules[:bucket])
        t_rules = time.perf_counter() - t0
        t0 = time.perf_counter()
        sh = p[2 : 2 + int(p[0])].astype(np.int64)
        bb = base
        while sh.size > 1:
            top, rr = E.esp_vec.esp_round_vec(sh, bb)
            a = rr[:, 0]
            rr[:, 0] = np.where(a < 0, bb + (-a - 1), a)
            sh = bb + top
            bb += rr.shape[0]
        t_tail = time.perf_counter() - t0
        print(f"compute {t_comp*1e3:7.1f}  rules-pull {t_rules*1e3:6.1f}"
              f"  host-tail {t_tail*1e3:6.1f}  ({r_total} rules,"
              f" {bucket*8/1e6:.1f} MB pulled)", flush=True)

    # end-to-end (the production wrapper overlaps rules d2h + tail)
    E.esp_rounds_jax(data)
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        E.esp_rounds_jax(data)
        best = min(best, time.perf_counter() - t0)
    print(f"esp_rounds_jax end-to-end: {best*1e3:7.1f} ms/MiB",
          flush=True)


if __name__ == "__main__":
    main()
