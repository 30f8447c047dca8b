"""Per-stage device times of one TBC2 encode batch, and a decoder sweep.

On one seeded ``bench.make_corpus`` batch (default 64 MiB = 32,768
segments, inputs already on the device):

- RLE, histogram and Huffman pack stage times (min and median of 5),
  each with the least HBM traffic it needs and that traffic's share of
  the H100's 3.35 TB/s;
- with ``--trace DIR``, a profiler trace of one batch, reduced to the
  device kernels by summed duration;
- the XLA scan decoder and the Triton decoder at several block/warp
  shapes on the whole batch, each Triton shape checked against the scan.

    python etc/probe_tbc2_encode.py [--mb 64] [--trace DIR]

Needs a GPU for the Triton sweep.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np

HBM = 3.35e12  # H100 SXM HBM3 peak bytes/s
SHAPES = ((128, 4), (64, 2), (256, 8), (128, 2), (256, 4))


def best(fn, k=5):
    import jax

    fn()
    ts = []
    for _ in range(k):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts), sorted(ts)[len(ts) // 2]


def top_device_events(trace_dir: str, k: int = 25) -> None:
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    tot = {}
    for plane in ProfileData.from_file(path).planes:
        if "/device:GPU" not in plane.name:
            continue
        for line in plane.lines:
            for ev in line.events:
                key = (line.name, ev.name)
                tot[key] = tot.get(key, 0) + ev.duration_ns
    print("top device events (line, name, ms):")
    for (ln, nm), d in sorted(tot.items(), key=lambda x: -x[1])[:k]:
        print(f"  {d / 1e6:9.3f} {ln[:20]:20s} {nm[:90]}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mb", type=int, default=64, help="batch MiB")
    p.add_argument("--trace", default=None,
                   help="write a profiler trace of one batch here")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import tudocomp_tpu.ops.hufdec_pallas as hp
    from bench import make_corpus
    from tudocomp_tpu.models.blockcodec import (
        BlockCodec, huff_stage, rle_stage,
    )
    from tudocomp_tpu.ops.hufdec_jax import (
        build_feed, decode_segments, decoder_tables, needed_steps,
        snap_steps,
    )

    data = make_corpus(args.mb << 20).tobytes()
    n = len(data)
    codec = BlockCodec()
    rows, lens = codec.split_segments(data)
    r, l = jnp.asarray(rows), jnp.asarray(lens)
    comp = codec.compress(data)
    sym_code, sym_len = codec._device_table(codec._parse(comp)[0])

    t_rle, m_rle = best(
        lambda: rle_stage(r, l, offset=0, sample=True, hist=False))
    t_rleh, m_rleh = best(
        lambda: rle_stage(r, l, offset=0, sample=True, hist=True))
    sel, cnt, _, _ = rle_stage(r, l, offset=0, sample=True, hist=False)
    t_huf, m_huf = best(lambda: huff_stage(sel, cnt, sym_code, sym_len))
    nseg = rows.shape[0]
    # least traffic each stage needs: its inputs and outputs once
    b_rle = n + nseg * 4 + nseg * 512 * 4 + nseg * 5
    b_hist = nseg // 8 * 512 * 4
    b_huf = nseg * 512 * 4 + nseg * 4 + nseg * 512 * 4 + nseg * 5
    print(f"encode batch {args.mb} MiB ({nseg} segments), min/median of 5:")
    for name, t, m, b in (
        ("rle", t_rle, m_rle, b_rle),
        ("hist (delta)", t_rleh - t_rle, m_rleh - m_rle, b_hist),
        ("huffman", t_huf, m_huf, b_huf),
    ):
        rate = b / max(t, 1e-9)
        print(f"  {name:13s} {t * 1e3:9.3f} ms (median {m * 1e3:9.3f}) "
              f"least bytes {b / 1e6:8.1f} MB -> {rate / 1e9:8.1f} GB/s "
              f"= {rate / HBM * 100:5.2f}% of 3.35 TB/s")
    print("  whole-batch device rate", n / (t_rleh + t_huf) / 1e9, "GB/s",
          flush=True)

    if args.trace:
        with jax.profiler.trace(args.trace):
            out = rle_stage(r, l, offset=0, sample=True, hist=True)
            jax.block_until_ready(huff_stage(out[0], out[1], sym_code,
                                             sym_len))
        top_device_events(args.trace)

    # decoder kernels alone on the whole batch of this container
    table, offset, _, counts, flags, poff, pbytes = codec._parse(comp)
    t = decoder_tables(table)
    need = needed_steps(pbytes, counts, t["d"])
    steps = snap_steps(int(need.max()))
    feed = build_feed(np.frombuffer(comp, np.uint8), np.arange(nseg),
                      counts, flags, poff, pbytes, steps, nseg)
    feed = [jnp.asarray(x) for x in feed]
    tabs = [jnp.asarray(t[k]) for k in ("thresh", "offs", "syms")]
    scan = lambda: decode_segments(*feed, *tabs, offset=offset, d=t["d"])
    tt, mm = best(scan, 3)
    print(f"scan decoder alone, {nseg} lanes x {steps} steps: "
          f"{tt * 1e3:.3f} ms (median {mm * 1e3:.3f}) = "
          f"{n / tt / 1e9:.2f} GB/s", flush=True)
    ref = scan()
    for block, warps in SHAPES:
        hp.BLOCK, hp.NUM_WARPS = block, warps
        hp.decode_segments_pallas.clear_cache()
        f = lambda: hp.decode_segments_pallas(*feed, *tabs, offset=offset,
                                              d=t["d"])
        tt, mm = best(f, 5)
        got = f()
        ok = bool(jnp.array_equal(got[0], ref[0])
                  & jnp.array_equal(got[1], ref[1]))
        print(f"pallas decoder BLOCK={block} warps={warps}: "
              f"{tt * 1e3:.3f} ms (median {mm * 1e3:.3f}) = "
              f"{n / tt / 1e9:.2f} GB/s, equal to scan {ok}", flush=True)


if __name__ == "__main__":
    main()
