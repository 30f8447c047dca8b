"""Stage breakdown for the exact device LZ77 matcher (VERDICT r3 #2).

Times each ingredient of _match_exact_device batched over 16 x 64 KiB
blocks on the real chip, after the round-4 rewrite (fused SA+ISA+rank
levels, sort/scan ANSV, elementwise level floors, word-window refine):

  sa+isa+ranks  one doubling chain producing all three
  +ansv         + both-side all-nearest-smaller-values
  +floors       + per-level group-start/end scans -> LCP floors
  full          the complete matcher (adds T4 build + 2 refines + the
                final to-text-order co-sort)

Usage: python -u etc/probe_lz77_breakdown.py [corpus]
"""

from __future__ import annotations

import os
import sys
import time


import numpy as np


def timeit(fn, sync, reps=3):
    fn()
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> None:
    import jax

    import jax.numpy as jnp
    from jax import lax

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from etc import datasets

    name = sys.argv[1] if len(sys.argv) > 1 else "english"
    gen = getattr(datasets, f"gen_{name}")
    raw = np.frombuffer(gen(1 << 20), np.uint8)
    reps = -(-(1 << 20) // raw.size)
    text = np.tile(raw, reps)[: 1 << 20].copy()
    text[-1] = 0
    blocks = np.ascontiguousarray(text.reshape(16, 1 << 16))
    bj = jnp.asarray(blocks)

    def sync(x):
        leaves = jax.tree_util.tree_leaves(x)
        np.asarray(leaves[0].ravel()[:1])
        return x

    from tudocomp_tpu.ops.lzss_jax import (
        _match_exact_device, _psv_smaller,
    )
    from tudocomp_tpu.ops.suffix_jax import suffix_array_isa_ranks

    print(f"corpus={name}, 16 x 64 KiB batched", flush=True)
    L = 512
    _I32 = jnp.int32

    def sir(x):
        sa, isa, ranks = suffix_array_isa_ranks(x, L=L)
        return sa, isa, ranks[L]

    f_sir = jax.jit(jax.vmap(sir))
    t = timeit(lambda: f_sir(bj), sync)
    print(f"sa+isa+ranks: {t*1e3:8.1f} ms/MiB", flush=True)

    def ansv(x):
        sa, isa, _ = suffix_array_isa_ranks(x, L=L)
        psv, cu = _psv_smaller(sa)
        rev, rval = _psv_smaller(sa[::-1])
        return psv, rev, cu, rval

    f_ansv = jax.jit(jax.vmap(ansv))
    t = timeit(lambda: f_ansv(bj), sync)
    print(f"+ansv:        {t*1e3:8.1f} ms/MiB", flush=True)

    def floors(x):
        n = x.shape[0]
        slot = jnp.arange(n, dtype=_I32)
        sa, isa, ranks = suffix_array_isa_ranks(x, L=L)
        psv, cu = _psv_smaller(sa)
        rev, rval = _psv_smaller(sa[::-1])
        nsv = jnp.where(rev >= 0, n - 1 - rev, -1)[::-1]
        levels = sorted(ranks.keys())
        sorted_ = lax.sort(
            (isa,) + tuple(ranks[q] for q in levels), num_keys=1
        )
        r_sa = dict(zip(levels, sorted_[1:]))
        l_up = jnp.zeros(n, _I32)
        l_dn = jnp.zeros(n, _I32)
        for q in levels:
            change = jnp.concatenate(
                [jnp.ones(1, jnp.bool_), r_sa[q][1:] != r_sa[q][:-1]]
            )
            gstart = lax.associative_scan(
                jnp.maximum, jnp.where(change, slot, -1)
            )
            change_n = jnp.concatenate(
                [r_sa[q][1:] != r_sa[q][:-1], jnp.ones(1, jnp.bool_)]
            )
            gend = lax.associative_scan(
                jnp.minimum, jnp.where(change_n, slot, n), reverse=True
            )
            l_up = jnp.where((psv >= 0) & (gstart <= psv), q, l_up)
            l_dn = jnp.where((nsv >= 0) & (gend >= nsv), q, l_dn)
        return l_up, l_dn

    f_fl = jax.jit(jax.vmap(floors))
    t = timeit(lambda: f_fl(bj), sync)
    print(f"+floors:      {t*1e3:8.1f} ms/MiB", flush=True)

    # finer stages inside the refine (round-5): back-sort to text
    # order, the shared wa fetch, one settle, then the full matcher
    from tudocomp_tpu.ops.lzss_jax import (
        _fetch_aligned_words, _window_settle, _word_table,
    )

    def upto(stage):
        def f(x):
            n = x.shape[0]
            pos = jnp.arange(n, dtype=_I32)
            slot = pos
            sa, isa, ranks = suffix_array_isa_ranks(x, L=L, full=False)
            psv, cu = _psv_smaller(sa)
            rev, rval = _psv_smaller(sa[::-1])
            rev, rval = rev[::-1], rval[::-1]
            nsv = jnp.where(rev >= 0, n - 1 - rev, -1)
            cd = jnp.where(rev >= 0, rval, -1)
            levels = sorted(ranks.keys())
            sorted_ = lax.sort(
                (isa,) + tuple(ranks[q] for q in levels), num_keys=1
            )
            r_sa = dict(zip(levels, sorted_[1:]))
            l_up = jnp.zeros(n, _I32)
            l_dn = jnp.zeros(n, _I32)
            for q in levels:
                change = jnp.concatenate(
                    [jnp.ones(1, jnp.bool_), r_sa[q][1:] != r_sa[q][:-1]]
                )
                gstart = lax.associative_scan(
                    jnp.maximum, jnp.where(change, slot, -1)
                )
                change_n = jnp.concatenate(
                    [r_sa[q][1:] != r_sa[q][:-1], jnp.ones(1, jnp.bool_)]
                )
                gend = lax.associative_scan(
                    jnp.minimum, jnp.where(change_n, slot, n),
                    reverse=True,
                )
                l_up = jnp.where((psv >= 0) & (gstart <= psv), q, l_up)
                l_dn = jnp.where((nsv >= 0) & (gend >= nsv), q, l_dn)
            _, cu_t, cd_t, lu_t, ld_t = lax.sort(
                (sa, cu, cd, l_up, l_dn), num_keys=1
            )
            if stage == "backsort":
                return cu_t, cd_t, lu_t, ld_t
            T4 = _word_table(x)
            limit = jnp.minimum(n - 1 - pos, 512)
            hi_up = lu_t >= ld_t
            cand_hi = jnp.where(hi_up, cu_t, cd_t)
            l0 = jnp.maximum(lu_t, ld_t)
            base = jnp.minimum(jnp.where(cand_hi >= 0, l0, 0), limit)
            W = 64
            wa = _fetch_aligned_words(T4, pos + base, W)
            if stage == "wa":
                return wa[:, 0]
            wb = _fetch_aligned_words(
                T4, jnp.clip(cand_hi, 0, n - 1) + base, W
            )
            matched = _window_settle(wa, wb, W)
            return matched

        return jax.jit(jax.vmap(f))

    for st in ("backsort", "wa", "settle1"):
        f = upto(st)
        t = timeit(lambda: f(bj), sync)
        print(f"+{st}:    {t*1e3:8.1f} ms/MiB", flush=True)

    f_all = jax.jit(jax.vmap(
        lambda x: jnp.stack(_match_exact_device(x, max_len=512))
    ))
    t = timeit(lambda: f_all(bj), sync)
    print(f"full match:   {t*1e3:8.1f} ms/MiB", flush=True)


if __name__ == "__main__":
    main()
