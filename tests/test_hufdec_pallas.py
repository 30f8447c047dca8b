"""Triton-route TBC2 decoder (ops/hufdec_pallas.py) vs the scan decoder
and the container spec — interpret mode (CPU).

The kernel runs the same lockstep slot schedule as hufdec_jax's scan,
so its records must match the scan's bit for bit on every real lane.
The compiled kernel runs on the GPU through ``chip_smoke.py``, which
compares it with the scan at full width.
"""

import numpy as np
import pytest

from tudocomp_tpu.models.blockcodec import BlockCodec
from tudocomp_tpu.ops import hufdec_jax as hj
from tudocomp_tpu.ops.hufdec_pallas import (
    BLOCK,
    NUM_WARPS,
    decode_segments_pallas,
)


def _decode_both(comp: bytes):
    """Records of every segment from both decoders, one batch."""
    codec = BlockCodec()
    table, offset, orig_len, counts, flags, poff, pbytes = codec._parse(
        comp
    )
    t = hj.decoder_tables(table)
    nseg = counts.shape[0]
    steps = hj.snap_steps(int(hj.needed_steps(pbytes, counts, t["d"]).max()))
    b = -(-nseg // BLOCK) * BLOCK
    feed, bc, hrw, rrw = hj.build_feed(
        np.frombuffer(comp, np.uint8), np.arange(nseg), counts, flags,
        poff, pbytes, steps, b,
    )
    tabs = (t["thresh"], t["offs"], t["syms"])
    got = decode_segments_pallas(
        feed, bc, hrw, rrw, *tabs, offset=offset, d=t["d"], interpret=True
    )
    ref = hj.decode_segments(
        feed, bc, hrw, rrw, *tabs, offset=offset, d=t["d"]
    )
    return nseg, orig_len, got, ref


@pytest.mark.parametrize(
    "data",
    [
        b"compressible " * 120 + b"\x00\xff" * 40,   # huffman path
        bytes(range(256)) * 3,                       # near-raw path
        b"A" * 5000 + b"B" * 3000 + b"AB" * 250,     # long runs (vbyte)
    ],
    ids=["text", "raw", "runs"],
)
def test_pallas_decode_matches_input(data):
    comp = BlockCodec().compress(data)
    nseg, orig_len, (chars, ends), (rc, re) = _decode_both(comp)
    chars, ends = np.asarray(chars)[:nseg], np.asarray(ends)[:nseg]
    np.testing.assert_array_equal(chars, np.asarray(rc)[:nseg])
    np.testing.assert_array_equal(ends, np.asarray(re)[:nseg])
    out = hj.expand_records(chars, ends).reshape(-1)[:orig_len]
    assert out.tobytes() == data


def test_pallas_bucket_constants():
    # one lane per thread, a power-of-two block (Triton block shapes),
    # and every decode lane bucket (a power of two >= BLOCK) tiles it
    assert BLOCK == NUM_WARPS * 32
    assert BLOCK & (BLOCK - 1) == 0
    from tudocomp_tpu.models.blockcodec import _bucket

    for n in (1, BLOCK - 1, BLOCK + 1, 3000, 65536):
        assert max(_bucket(n), BLOCK) % BLOCK == 0


def test_decompress_device_pallas_env():
    # the Triton branch of BlockCodec.decompress_device, interpreted
    data = b"the quick brown fox " * 80 + b"\x01\x02" * 32
    codec = BlockCodec()
    comp = codec.compress(data)
    assert codec.decompress_device(comp, interpret=True) == data
