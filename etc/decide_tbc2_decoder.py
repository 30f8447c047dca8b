"""The TBC2 GPU decoder choice: the Triton kernel against the XLA scan.

Both decoders run on one seeded ``bench.make_corpus`` container, end to
end through ``BlockCodec._decompress_device`` in alternating pairs, then
the decode kernels alone over every batch of the container, feeds
already on the device. Prints the card's name and power limit first.

    python etc/decide_tbc2_decoder.py [--mb 256] [--pairs 10]

Needs a GPU (the Triton kernel has no compiled CPU form).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

DECODERS = ("pallas", "scan")


def alternating(pairs: int):
    """(pair index, decoder order), swapping the order every pair."""
    for i in range(pairs):
        yield i, DECODERS if i % 2 == 0 else DECODERS[::-1]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mb", type=int, default=256, help="corpus MiB")
    p.add_argument("--pairs", type=int, default=10,
                   help="alternating pairs per measurement")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import make_corpus
    from tudocomp_tpu.models.blockcodec import BlockCodec, _bucket
    from tudocomp_tpu.ops.hufdec_jax import (
        build_feed, decode_segments, decoder_tables, needed_steps,
        snap_steps,
    )
    from tudocomp_tpu.ops.hufdec_pallas import BLOCK, decode_segments_pallas

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip(), flush=True)
    data = make_corpus(args.mb << 20).tobytes()
    n = len(data)
    codec = BlockCodec()
    comp = codec.compress(data)
    for k in DECODERS:  # compile both, check both
        assert codec._decompress_device(comp, k) == data

    e2e = {k: [] for k in DECODERS}
    for i, order in alternating(args.pairs):
        for k in order:
            t0 = time.perf_counter()
            out = codec._decompress_device(comp, k)
            e2e[k].append(time.perf_counter() - t0)
            assert out == data
        print(f"pair {i}: pallas {e2e['pallas'][-1]:.3f} s, "
              f"scan {e2e['scan'][-1]:.3f} s", flush=True)
    wins = sum(a < b for a, b in zip(e2e["pallas"], e2e["scan"]))
    for k, v in e2e.items():
        q = np.percentile(v, [25, 50, 75])
        print(f"e2e {k}: median {q[1]:.3f} s = {n / q[1] / 1e9:.4f} GB/s, "
              f"IQR {q[0]:.3f}-{q[2]:.3f} s, "
              f"runs {[round(x, 3) for x in v]}")
    print(f"pallas faster in {wins} of {args.pairs} pairs", flush=True)

    # the kernels alone over every batch, feeds already on the device
    table, offset, _, counts, flags, poff, pbytes = codec._parse(comp)
    t = decoder_tables(table)
    tabs = [jnp.asarray(t[k]) for k in ("thresh", "offs", "syms")]
    need = needed_steps(pbytes, counts, t["d"])
    order = np.argsort(need, kind="stable")
    flat = np.frombuffer(comp, np.uint8)
    feeds = []
    for lo in range(0, counts.shape[0], codec.batch_lanes):
        idx = order[lo : lo + codec.batch_lanes]
        steps = snap_steps(int(need[idx].max()))
        b = max(_bucket(idx.size), BLOCK)
        feeds.append([jnp.asarray(x) for x in build_feed(
            flat, idx, counts, flags, poff, pbytes, steps, b)])
    fns = {
        "pallas": lambda f: decode_segments_pallas(
            *f, *tabs, offset=offset, d=t["d"]),
        "scan": lambda f: decode_segments(*f, *tabs, offset=offset, d=t["d"]),
    }
    dev = {k: [] for k in DECODERS}
    for k in DECODERS:
        jax.block_until_ready([fns[k](f) for f in feeds])
    for _, order in alternating(args.pairs):
        for k in order:
            t0 = time.perf_counter()
            jax.block_until_ready([fns[k](f) for f in feeds])
            dev[k].append(time.perf_counter() - t0)
    for k, v in dev.items():
        m = np.median(v)
        print(f"kernels alone {k} ({len(feeds)} batches): median "
              f"{m * 1e3:.3f} ms = {n / m / 1e9:.3f} GB/s, "
              f"runs ms {[round(x * 1e3, 3) for x in v]}", flush=True)


if __name__ == "__main__":
    main()
