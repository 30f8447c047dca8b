"""On-chip timings for the device factorizers (VERDICT r2 item 2).

Measures s/MB on the real chip, with honest transfer-backed syncs, for:

  sa_1m       device SA+ISA (suffix_jax) on one 1 MiB text
  sa_blocks   device SA, vmap-batched over 64 KiB blocks (amortized)
  lz77_1m     exact device LZ77 matching (SA+ANSV), one 1 MiB text
  lz77_blocks exact device LZ77 matching, vmap over 64 KiB blocks
  lcp_dev     lcpcomp(comp=device) parallel rounds, 1 MiB
  esp_dev     esp(rounds=device) round passes, 1 MiB
  lzssdec     device factor-stream resolution (pointer doubling)

Host comparison rows time the native kernels on this VM (SA-IS,
factorize_lcp, lcpcomp arrays). Usage: python -u etc/probe_factorizers.py
[corpus-name] (default english)
"""

from __future__ import annotations

import os
import sys
import time


import numpy as np


def timeit(fn, sync, reps=3):
    fn()  # compile
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> None:
    import jax

    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from etc import datasets

    name = sys.argv[1] if len(sys.argv) > 1 else "english"
    gen = getattr(datasets, f"gen_{name}")
    raw = np.frombuffer(gen(1 << 20), np.uint8)
    reps = -(-(1 << 20) // raw.size)
    text = np.tile(raw, reps)[: 1 << 20].copy()
    text[-1] = 0
    tj = jnp.asarray(text)

    def sync(x):
        leaves = jax.tree_util.tree_leaves(x)
        np.asarray(leaves[0].ravel()[:1])
        return x

    print(f"corpus={name} 1MiB", flush=True)

    # --- device SA ------------------------------------------------------
    from tudocomp_tpu.ops.suffix_jax import isa_device, suffix_array_device

    t = timeit(lambda: suffix_array_device(tj), sync)
    print(f"sa_1m:        {t*1e3:8.1f} ms/MiB", flush=True)

    # batched over 64 KiB blocks (16 blocks = 1 MiB per dispatch)
    import jax as _jax

    blocks = np.ascontiguousarray(text[: (1 << 20)].reshape(16, 1 << 16))
    bj = jnp.asarray(blocks)
    batched_sa = _jax.jit(_jax.vmap(suffix_array_device))
    t = timeit(lambda: batched_sa(bj), sync)
    print(f"sa_blocks:    {t*1e3:8.1f} ms/MiB (16 x 64 KiB)", flush=True)

    # --- host SA (native SA-IS) -----------------------------------------
    from tudocomp_tpu import native

    if native.available():
        t0 = time.perf_counter()
        for _ in range(3):
            native.suffix_array(text)
        t = (time.perf_counter() - t0) / 3
        print(f"sa_host:      {t*1e3:8.1f} ms/MiB (native SA-IS)",
              flush=True)

    # --- exact device LZ77 ----------------------------------------------
    from tudocomp_tpu.ops.lzss_jax import (
        _match_device, _match_exact_device, commit_walk,
        resolve_factors_device,
    )

    m1 = _jax.jit(lambda x: jnp.stack(_match_exact_device(x, max_len=4096)))
    t = timeit(lambda: m1(tj), sync)
    print(f"lz77_1m:      {t*1e3:8.1f} ms/MiB (match only)", flush=True)

    mb = _jax.jit(_jax.vmap(
        lambda x: jnp.stack(_match_exact_device(x, max_len=512))
    ))
    t = timeit(lambda: mb(bj), sync)
    print(f"lz77_blocks:  {t*1e3:8.1f} ms/MiB (16 x 64 KiB, cap 512)",
          flush=True)

    # host exact factorization for comparison
    from tudocomp_tpu.compressors.lzss import factorize_lcp

    t0 = time.perf_counter()
    for _ in range(3):
        fh = factorize_lcp(text, 3)
    t = (time.perf_counter() - t0) / 3
    print(f"lz77_host:    {t*1e3:8.1f} ms/MiB (factorize_lcp incl. SA)",
          flush=True)

    # q-gram heuristic matcher (the cheap parse)
    mf = _jax.jit(lambda x: jnp.stack(_match_device(x, max_len=256)))
    t = timeit(lambda: mf(tj), sync)
    print(f"lz77_fast:    {t*1e3:8.1f} ms/MiB (q-gram heuristic)",
          flush=True)

    # --- device BWT batched over blocks vs host ---------------------------
    from tudocomp_tpu.ops.suffix_jax import bwt_device

    def bwt_blocks(x):
        def one(t):
            sa = suffix_array_device(t)
            return bwt_device(t, isa_device(sa))

        return _jax.vmap(one)(x)

    bwtb = _jax.jit(bwt_blocks)
    t = timeit(lambda: bwtb(bj), sync)
    print(f"bwt_blocks:   {t*1e3:8.1f} ms/MiB (16 x 64 KiB, SA+ISA+BWT)",
          flush=True)
    if native.available():
        from tudocomp_tpu.ds.bwt import bwt_forward

        t0 = time.perf_counter()
        for _ in range(3):
            for blk in blocks:
                bwt_forward(blk, native.suffix_array(blk))
        t = (time.perf_counter() - t0) / 3
        print(f"bwt_host:     {t*1e3:8.1f} ms/MiB (16 x 64 KiB, "
              f"native SA + gather)", flush=True)

    # --- device factor-stream decode (pointer doubling) ------------------
    pos, src, ln = (np.asarray(a) for a in fh.arrays())
    covered = np.zeros(text.size, bool)
    tot = int(ln.sum())
    if pos.size:
        ramp = np.arange(tot) - np.repeat(np.cumsum(ln) - ln, ln)
        covered[np.repeat(pos, ln) + ramp] = True
    lits = text[~covered]
    t0 = time.perf_counter()
    for _ in range(3):
        out = resolve_factors_device(lits, pos, src, ln, text.size)
    t = (time.perf_counter() - t0) / 3
    assert out == text.tobytes()
    print(f"lzssdec_dev:  {t*1e3:8.1f} ms/MiB (resolve, incl. h2d/d2h)",
          flush=True)

    # --- batched factor-stream decode: 16 x 64 KiB streams resolve in
    # one vmapped dispatch (scalar sync; payload transfer is container
    # feed prep, untimed like bench.py's decode) ---------------------------
    import functools

    from tudocomp_tpu.ops.lzss_jax import _resolve_factors_jit

    BN = 1 << 16
    per = []
    for blk in blocks:
        fb = factorize_lcp(blk, 3)
        p, s, l = (np.asarray(a, np.int64) for a in fb.arrays())
        cov = np.zeros(BN, bool)
        if p.size:
            tt = int(l.sum())
            ramp = np.arange(tt) - np.repeat(np.cumsum(l) - l, l)
            cov[np.repeat(p, l) + ramp] = True
        li = np.zeros(BN, np.uint8)
        li[: BN - cov.sum()] = blk[~cov]
        nfp = 1 << 14  # one static bucket covers any 64 KiB parse
        assert p.size <= nfp, p.size
        fp = np.full(nfp, BN, np.int32)
        fs = np.zeros(nfp, np.int32)
        fl = np.zeros(nfp, np.int32)
        fp[: p.size] = p
        fs[: p.size] = s
        fl[: p.size] = l
        per.append((li, fp, fs, fl))
    lit_b = jnp.asarray(np.stack([x[0] for x in per]))
    fp_b = jnp.asarray(np.stack([x[1] for x in per]))
    fs_b = jnp.asarray(np.stack([x[2] for x in per]))
    fl_b = jnp.asarray(np.stack([x[3] for x in per]))
    res_b = _jax.jit(
        _jax.vmap(
            functools.partial(_resolve_factors_jit, n_pad=BN)
        )
    )
    t = timeit(lambda: res_b(lit_b, fp_b, fs_b, fl_b), sync)
    got = np.asarray(res_b(lit_b, fp_b, fs_b, fl_b))
    assert got.reshape(-1).tobytes() == text.tobytes()
    print(f"lzssdec_blk:  {t*1e3:8.1f} ms/MiB (16 x 64 KiB, batched)",
          flush=True)

    # --- lcpcomp device rounds -------------------------------------------
    from tudocomp_tpu.ops.lcpcomp_jax import factorize_device as lcp_dev

    lcp_dev(text, 5)  # compile
    t = 1e9
    for _ in range(2):
        t0 = time.perf_counter()
        lcp_dev(text, 5)
        t = min(t, time.perf_counter() - t0)
    print(f"lcp_dev:      {t*1e3:8.1f} ms/MiB (warm, incl. syncs)",
          flush=True)

    from tudocomp_tpu.ds.suffix import TextDS
    from tudocomp_tpu.registry import REGISTRY as REG
    from tudocomp_tpu.compressors import REGISTRY as _  # noqa: F401
    from tudocomp_tpu.compressors.lzss import FactorBuffer

    ds = TextDS(text)
    strat = REG.instantiate("arrays", type="lcpcomp_comp")
    t0 = time.perf_counter()
    for _ in range(2):
        fb = FactorBuffer()
        strat.factorize(ds, 5, fb)
    t = (time.perf_counter() - t0) / 2
    print(f"lcp_host:     {t*1e3:8.1f} ms/MiB (arrays, ex SA)", flush=True)

    # --- esp device rounds -------------------------------------------------
    from tudocomp_tpu.ops.esp_jax import esp_rounds_jax

    data = text.tobytes()
    esp_rounds_jax(data)  # compile
    t = 1e9
    for _ in range(2):
        t0 = time.perf_counter()
        esp_rounds_jax(data)
        t = min(t, time.perf_counter() - t0)
    print(f"esp_dev:      {t*1e3:8.1f} ms/MiB (warm, incl. syncs)",
          flush=True)

    from tudocomp_tpu.compressors.esp import esp_rounds

    t0 = time.perf_counter()
    for _ in range(2):
        esp_rounds(data)
    t = (time.perf_counter() - t0) / 2
    print(f"esp_host:     {t*1e3:8.1f} ms/MiB", flush=True)


if __name__ == "__main__":
    main()
