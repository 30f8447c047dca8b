"""Smoke test of the GPU path.

Drives the TBC2 device codec and the device factorizers once through
their normal entry points on an NVIDIA GPU, at sizes users run, checks
every device kernel of that path against its plain reference, and
prints one JSON object as its last line.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the sharded TBC2 path on four
                                       # cards and its comparison, only

Phase 0 refuses to run without a GPU (nonzero exit, no result line).
Phase 1 round-trips a 256 MiB seeded corpus through ``BlockCodec``:
host and device decode, the Triton decoder compared record for record
with the XLA scan it replaces, and a seeded sample of frames compared
with the host specification encoding. Phase 2 goes through the
algorithm-string entry points: ``tbc2`` through ``cli`` and the four
device factorizers on 8 MiB of seeded text. Any failure exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

MiB = 1 << 20
SEED = 20261016
TBC2_MB = 256  # one card: 131,072 segments, two decode batches
FOUR_CARDS_MB = 1024  # four cards: 256 MiB per card


def log(*args) -> None:
    print(*args, flush=True)


def timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def gbps(nbytes: int, seconds: float) -> float:
    return nbytes / seconds / 1e9


def check_platform(count: int):
    """Phase 0: a GPU, its name and power limit, the host runtime."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX finds no GPU (platform {devs[0].platform!r})"
        )
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: {count} GPUs needed, {len(devs)} found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    for line in smi.splitlines():
        log(line)
    log(f"device_kind={devs[0].device_kind} devices={len(devs)} "
        f"jax={jax.__version__}")
    from tudocomp_tpu import native

    if not native.available():
        raise SystemExit("chip_smoke: the native host runtime did not build")
    return devs


def check_frames_against_spec(codec, data: bytes, comp: bytes, n: int):
    """A seeded sample of frames must equal the host specification
    encoding of their segment: compressors/rle.py's rle_encode, then
    the container's own table packed by io/bitio.py, same escapes."""
    from tudocomp_tpu.compressors.rle import rle_encode
    from tudocomp_tpu.io.bitio import pack_tokens
    from tudocomp_tpu.models.blockcodec import SEG

    table, offset, _, counts, flags, poff, pbytes = codec._parse(comp)
    nseg = counts.shape[0]
    rng = np.random.default_rng(SEED)
    sample = rng.choice(nseg, size=min(n, nseg), replace=False)
    raw = np.frombuffer(data, np.uint8)
    flat = np.frombuffer(comp, np.uint8)
    for i in sample.tolist():
        seg = raw[i * SEG : (i + 1) * SEG]
        syms = rle_encode(seg, offset)
        rle_raw = syms.size > seg.size
        if rle_raw:
            syms = seg
        huff_raw = table is None
        if not huff_raw:
            payload, bits = pack_tokens(
                table.sym_code[syms].astype(np.uint64),
                table.sym_len[syms].astype(np.int64),
            )
            huff_raw = bits >= 8 * syms.size
        if huff_raw:
            payload = syms
        got = flat[poff[i] : poff[i] + pbytes[i]]
        if not (
            counts[i] == syms.size
            and flags[i] == (int(rle_raw) << 1 | int(huff_raw))
            and np.array_equal(got, payload)
        ):
            raise AssertionError(f"frame {i} differs from the host spec")
    return sample.size


def phase_tbc2(mb: int) -> None:
    """Phase 1: the TBC2 codec at ``mb`` MiB."""
    import jax
    import jax.numpy as jnp

    from bench import make_corpus
    from tudocomp_tpu.models.blockcodec import (
        HIST_SEGS, BlockCodec, _bucket, huff_stage, rle_stage,
    )
    from tudocomp_tpu.ops.hufdec_jax import expand_records

    data = make_corpus(mb * MiB).tobytes()
    n = len(data)
    codec = BlockCodec()

    comp, t_cold = timed(codec.compress, data)
    again, t_warm = timed(codec.compress, data)
    assert again == comp, "encode is not deterministic"
    log(f"tbc2 encode {mb} MiB end to end: first call {t_cold:.3f} s "
        f"(compile included), steady {t_warm:.3f} s = "
        f"{gbps(n, t_warm):.3f} GB/s, ratio {len(comp) / n:.4f}")

    # the device stages alone, inputs already on the device
    seg_rows, seg_lens = codec.split_segments(data)
    batches = []
    for lo in range(0, seg_rows.shape[0], codec.batch_lanes):
        rows = seg_rows[lo : lo + codec.batch_lanes]
        b = _bucket(rows.shape[0])
        pr = np.zeros((b, rows.shape[1]), np.uint8)
        pr[: rows.shape[0]] = rows
        pl = np.zeros(b, np.int32)
        pl[: rows.shape[0]] = seg_lens[lo : lo + codec.batch_lanes]
        batches.append((jnp.asarray(pr), jnp.asarray(pl)))
    sym_code, sym_len = codec._device_table(codec._parse(comp)[0])

    def stages():
        outs = []
        for i, (r, l) in enumerate(batches):
            sel, cnt, _, h = rle_stage(
                r, l, offset=0, sample=True, hist=i == 0,
                hist_limit=jnp.int32(HIST_SEGS) if i == 0 else None,
            )
            outs.append((h, huff_stage(sel, cnt, sym_code, sym_len)))
        jax.block_until_ready(outs)

    stages()
    t_st = min(timed(stages)[1] for _ in range(3))
    log(f"tbc2 encode device stages (rle+hist+huffman, "
        f"{len(batches)} batches): {t_st:.4f} s = {gbps(n, t_st):.3f} GB/s")

    host, t_host = timed(codec.decompress, comp)
    assert host == data, "host decode differs from the input"
    log(f"tbc2 decode host (native spec): {t_host:.3f} s = "
        f"{gbps(n, t_host):.3f} GB/s")

    from tudocomp_tpu import backend

    kernel = backend.tbc2_decoder()
    assert kernel == "pallas", kernel
    dev, t_cold = timed(codec.decompress_device, comp)
    assert dev == data, "device decode differs from the input"
    dev, t_warm = timed(codec.decompress_device, comp)
    assert dev == data
    log(f"tbc2 decode device ({kernel}) end to end: first call "
        f"{t_cold:.3f} s (compile included), steady {t_warm:.3f} s = "
        f"{gbps(n, t_warm):.3f} GB/s")

    # where the device decode's time goes, batch by batch
    parsed = codec._parse(comp)
    t_dev = t_xfer = t_exp = 0.0
    rec_bytes = 0
    t0 = time.perf_counter()
    for idx, chars, ends in codec._decode_batches(comp, parsed, kernel):
        _, t = timed(jax.block_until_ready, (chars, ends))
        t_dev += t
        (ch, en), t = timed(lambda: (np.asarray(chars), np.asarray(ends)))
        t_xfer += t
        rec_bytes += ch.nbytes + en.nbytes
        _, t = timed(expand_records, ch, en)
        t_exp += t
    t_all = time.perf_counter() - t0
    log(f"tbc2 decode breakdown: device wait {t_dev:.3f} s, record "
        f"transfer {rec_bytes / 1e9:.3f} GB in {t_xfer:.3f} s "
        f"({gbps(rec_bytes, t_xfer):.2f} GB/s), expand_records "
        f"{t_exp:.3f} s, parse+feed+other "
        f"{t_all - t_dev - t_xfer - t_exp:.3f} s")

    # the Triton kernel against the plain XLA scan, record for record
    same = True
    for (i1, c1, e1), (i2, c2, e2) in zip(
        codec._decode_batches(comp, parsed, "pallas"),
        codec._decode_batches(comp, parsed, "scan"),
    ):
        k = i1.size  # the batches pad to different lane counts
        same &= bool(np.array_equal(i1, i2))
        same &= bool(
            jnp.array_equal(c1[:k], c2[:k]) & jnp.array_equal(e1[:k], e2[:k])
        )
    assert same, "the Triton decoder's records differ from the scan's"
    _, t_scan_cold = timed(codec._decompress_device, comp, "scan")
    scan, t_scan = timed(codec._decompress_device, comp, "scan")
    assert scan == data
    log(f"tbc2 decoder choice at {mb} MiB through decompress_device: "
        f"pallas (Triton) {t_warm:.3f} s = {gbps(n, t_warm):.3f} GB/s, "
        f"scan (XLA) {t_scan:.3f} s = {gbps(n, t_scan):.3f} GB/s "
        f"(scan first call {t_scan_cold:.3f} s); records identical")

    k = check_frames_against_spec(codec, data, comp, 1024)
    log(f"tbc2 frames: {k} sampled segments equal the host spec encoding")


def phase_entry_points() -> None:
    """Phase 2: the algorithm-string entry points."""
    from bench import make_corpus
    from etc.datasets import gen_english
    from tudocomp_tpu import cli
    from tudocomp_tpu.stats import StatPhase

    data = make_corpus(16 * MiB).tobytes()
    comp, t_c = timed(cli.compress, "tbc2", data)
    with StatPhase("smoke") as root:
        out, t_d = timed(cli.decompress, comp)
    assert out == data, "cli tbc2 roundtrip failed"
    decoder = root.children[0].stats.get("tbc2 decoder")
    assert decoder == "pallas", f"tbc2(dec=auto) decoded with {decoder!r}"
    log(f"cli tbc2 16 MiB (first calls at this size): compress {t_c:.3f} s, "
        f"decompress {t_d:.3f} s (decoder {decoder})")

    text = gen_english(8 * MiB, seed=SEED)
    for alg, host_alg in (
        ("lzss_lcp(coder=huff,comp=device)", None),
        ("lcpcomp(coder=sle,threshold=5,comp=device)", None),
        ("esp(rounds=device)", "esp"),
        ("bwt(device=true)", "bwt"),
    ):
        comp, t_c = timed(cli.compress, alg, text)
        out, t_d = timed(cli.decompress, comp)
        assert out == text, f"{alg}: roundtrip failed"
        note = ""
        if host_alg is not None:
            ref, t_h = timed(cli.compress, host_alg, text, raw=True)
            assert comp.split(b"%", 1)[1] == ref, f"{alg} != {host_alg}"
            note = f", equal to {host_alg} on the host ({t_h:.3f} s)"
        log(f"{alg} 8 MiB (first calls, compile included): compress "
            f"{t_c:.3f} s, decompress {t_d:.3f} s, "
            f"ratio {len(comp) / len(text):.4f}{note}")


def four_cards(mb: int) -> None:
    """The sharded TBC2 path on four cards against one card. Each step
    runs once, so its time includes its compilation."""
    from bench import make_corpus
    from tudocomp_tpu.models.blockcodec import BlockCodec
    from tudocomp_tpu.parallel.mesh import make_mesh
    from tudocomp_tpu.parallel.pipeline import (
        compress_sharded, decompress_sharded,
    )

    data = make_corpus(mb * MiB).tobytes()
    codec = BlockCodec()
    mesh = make_mesh(4, sp=1)
    sharded, t_four = timed(compress_sharded, codec, mesh, data)
    single, t_one = timed(codec.compress, data)
    assert sharded == single, "sharded container differs from one card's"
    log(f"tbc2 {mb} MiB: compress_sharded on 4 cards {t_four:.3f} s, "
        f"BlockCodec.compress on one card {t_one:.3f} s (first calls, "
        f"compile included); containers byte-identical, "
        f"ratio {len(single) / len(data):.4f}")
    out, t_dec = timed(decompress_sharded, codec, mesh, sharded)
    assert out == data, "decompress_sharded differs from the input"
    log(f"tbc2 {mb} MiB: decompress_sharded on 4 cards {t_dec:.3f} s "
        f"(first call, compile included); output equals the input")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded TBC2 path on four cards")
    args = p.parse_args(argv)
    count = 4 if args.four_cards else 1
    devs = check_platform(count)
    if args.four_cards:
        four_cards(FOUR_CARDS_MB)
    else:
        phase_tbc2(TBC2_MB)
        phase_entry_points()
    import jax

    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
