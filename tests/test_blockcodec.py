"""Device pipeline tests: RLE kernel vs host spec, flagship roundtrip."""

import functools

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from tudocomp_tpu.compressors.rle import rle_decode, rle_encode
from tudocomp_tpu.coders.huffman import HuffmanTable
from tudocomp_tpu.models.blockcodec import BlockCodec
from tudocomp_tpu.ops.rle_jax import bytes_from_words, rle_encode_device

from tests.helpers import roundtrip_corpus

CORPUS = roundtrip_corpus()


_CAP = 8192  # fixed shape -> one compilation for the whole corpus


@functools.partial(jax.jit, static_argnums=(2,))
def _rle_dev_jit(padded, length, offset):
    words, n_bytes = rle_encode_device(padded, length, offset)
    return bytes_from_words(words, _CAP + _CAP // 2 + 8), n_bytes


def _device_rle(data: bytes, offset: int = 0) -> np.ndarray:
    assert len(data) <= _CAP
    padded = np.zeros(_CAP, np.uint8)
    padded[: len(data)] = np.frombuffer(data, np.uint8)
    out_cap, n_bytes = _rle_dev_jit(jnp.asarray(padded), len(data), offset)
    return np.asarray(out_cap)[: int(n_bytes)]


@pytest.mark.parametrize("offset", [0, 1])
def test_device_rle_matches_host(offset):
    cases = [
        b"", b"a", b"aaa", b"abc", b"aabbccdd", b"a" * 300,
        b"ab" * 50 + b"c" * 1000 + bytes(range(256)) * 3,
    ] + [c for c in CORPUS if c]
    for data in cases:
        if not data:
            continue
        host = rle_encode(np.frombuffer(data, np.uint8), offset)
        dev = _device_rle(data, offset)
        assert dev.tobytes() == host.tobytes(), data[:40]


def test_device_rle_padding_isolated():
    # padding beyond `length` must not merge with a trailing run
    raw = np.zeros(64, np.uint8)
    raw[:10] = ord("x")
    words, n_bytes = rle_encode_device(jnp.asarray(raw), 10, 0)
    dev = np.asarray(bytes_from_words(words, int(n_bytes)))
    host = rle_encode(np.full(10, ord("x"), np.uint8), 0)
    assert dev.tobytes() == host.tobytes()
    assert rle_decode(dev) == b"x" * 10


def test_huffman_fast_decode_roundtrip():
    rng = np.random.default_rng(0)
    data = rng.choice(
        np.frombuffer(b"abcde\xff\x00", np.uint8), size=5000,
        p=[0.4, 0.2, 0.15, 0.1, 0.05, 0.05, 0.05],
    )
    counts = np.bincount(data, minlength=256)
    table = HuffmanTable.from_counts(counts, max_len=31)
    from tudocomp_tpu.io.bitio import BitWriter

    w = BitWriter()
    w.write_tokens(table.sym_code[data], table.sym_len[data].astype(np.int64))
    # raw payload bytes without final-byte convention
    from tudocomp_tpu.io.bitio import pack_tokens

    payload, total_bits = pack_tokens(
        table.sym_code[data].astype(np.uint64),
        table.sym_len[data].astype(np.int64),
    )
    got = table.fast_decode(payload, data.size)
    np.testing.assert_array_equal(got, data)


def test_blockcodec_roundtrip():
    codec = BlockCodec()
    rng = np.random.default_rng(1)
    cases = [c for c in CORPUS] + [
        rng.integers(0, 4, 5 * 2048 + 17, dtype=np.uint8).tobytes(),
        b"\x00" * (2 * 4096),
        bytes(rng.integers(0, 256, 4096, dtype=np.uint8)),
        b"ab" * 3000,  # run-of-2-heavy: rle_raw escape path
    ]
    for data in cases:
        comp = codec.compress(data)
        assert codec.decompress(comp) == data, data[:40]


def test_batchsplit_invariant_with_overpadded_bucket(monkeypatch):
    """A batch's bucket can exceed batch_lanes (a power of two above a
    batch_lanes that is none). compress() must trim each batch's
    outputs to its real lane count before concatenating, or the first
    batch's pad rows become (empty) frames for every later segment.
    Force it by over-padding every batch."""
    import tudocomp_tpu.models.blockcodec as bc

    monkeypatch.setattr(bc, "_bucket", lambda n: 128)
    rng = np.random.default_rng(7)
    data = bytes(rng.integers(0, 64, 100 * 2048, dtype=np.uint8))
    split = BlockCodec(batch_lanes=32).compress(data)
    monkeypatch.undo()
    single = BlockCodec().compress(data)
    assert split == single
    assert BlockCodec().decompress(split) == data


def test_blockcodec_device_decode_matches_host():
    """The device lockstep decoder (the XLA scan on the CPU) must be
    bit-identical to the host/native specification decoder."""
    codec = BlockCodec()
    rng = np.random.default_rng(5)
    cases = [c for c in CORPUS if c] + [
        b"a" * 5000,
        bytes(rng.integers(0, 4, 50000, dtype=np.uint8)),
        bytes(
            rng.choice(
                np.frombuffer(b"abc \n", np.uint8), 30000,
                p=[0.4, 0.3, 0.1, 0.15, 0.05],
            )
        ),
        b"\x00" * 10000 + b"ab" * 3000,
        bytes(rng.integers(0, 256, 10000, dtype=np.uint8)),
    ]
    for data in cases:
        comp = codec.compress(data)
        assert codec.decompress(comp) == data, ("host", data[:40])
        assert codec.decompress_device(comp) == data, ("dev", data[:40])


def test_blockcodec_compresses():
    codec = BlockCodec()
    data = (b"the quick brown fox " * 400)[: 1 << 13]
    comp = codec.compress(data)
    assert len(comp) < len(data) // 2
    assert codec.decompress(comp) == data


def test_device_rle_long_run_continuation_pieces():
    # runs > RUN_CAP=8192 use single-char continuation pieces; host,
    # device, and the (reference-semantics) decoder must all agree
    cap = 1 << 15

    @functools.partial(jax.jit, static_argnums=(2,))
    def dev(padded, length, offset):
        words, n_bytes = rle_encode_device(padded, length, offset)
        return bytes_from_words(words, cap + cap // 2 + 8), n_bytes

    for offset in (0, 3):
        for data in [
            b"a" * 8193,
            b"a" * 20000 + b"b" + b"a" * 9000,
            b"q" * 8192 + b"q",  # continuation piece of length 1
            b"r" * 16384,
        ]:
            padded = np.zeros(cap, np.uint8)
            padded[: len(data)] = np.frombuffer(data, np.uint8)
            out, n_bytes = dev(jnp.asarray(padded), len(data), offset)
            got = np.asarray(out)[: int(n_bytes)]
            host = rle_encode(np.frombuffer(data, np.uint8), offset)
            assert got.tobytes() == host.tobytes(), (offset, len(data))
            assert rle_decode(host, offset) == data


def test_native_rle_decode_rejects_malformed():
    # regression for ADVICE r1: run < offset must not underflow
    from tudocomp_tpu import native

    if not native.available():
        pytest.skip("native runtime unavailable")
    # vbyte(1) with offset 5 -> run would be negative
    bad = np.frombuffer(b"aa\x01", np.uint8)
    with pytest.raises(ValueError):
        native.rle_decode(bad, 5)
    # overlong vbyte continuation chain must be rejected, not shift UB
    bad2 = np.frombuffer(b"aa" + b"\xff" * 12 + b"\x01", np.uint8)
    with pytest.raises(ValueError):
        native.rle_decode(bad2, 0)


def _stage_rows():
    """Segment rows of the kinds the packers see: long runs with 2-byte
    vbytes, no runs, run-of-2 heavy, mixed text-like; with per-row
    lengths covering empty, one byte, full and random tails."""
    rng = np.random.default_rng(11)
    seg = 2048
    kinds = {
        "long_runs": np.repeat(rng.integers(0, 256, 8, dtype=np.uint8), 256),
        "no_runs": np.arange(seg, dtype=np.uint8),
        "run_of_2": np.repeat(
            rng.integers(0, 256, seg // 2, dtype=np.uint8), 2
        ),
        "text": rng.choice(
            np.frombuffer(b"aab\ncd  eee", np.uint8), size=seg
        ),
    }
    lens = np.array([seg, 1, 0, 1000, 2047, 1999, 2, 777], np.int32)
    rows = {}
    for name, row in kinds.items():
        r = np.tile(row[:seg], (lens.size, 1))
        r[np.arange(seg)[None, :] >= lens[:, None]] = 0  # zero-padded
        rows[name] = r.astype(np.uint8)
    return rows, lens


_ROWS, _LENS = _stage_rows()


@pytest.mark.parametrize("offset", [0, 1, 125])
@pytest.mark.parametrize("kind", sorted(_ROWS))
def test_rle_stage_matches_host_spec(kind, offset):
    """Per segment, rle_stage's selected stream, count and escape equal
    the host spec: compressors/rle.py's rle_encode of the segment, or
    the verbatim segment when RLE would expand it."""
    from tudocomp_tpu.models.blockcodec import rle_stage

    rows, lens = _ROWS[kind], _LENS
    sel, counts, rle_raw, _ = rle_stage(
        jnp.asarray(rows), jnp.asarray(lens), offset=offset, sample=False
    )
    got = np.asarray(bytes_from_words(sel, 2048))
    counts, rle_raw = np.asarray(counts), np.asarray(rle_raw)
    for i, n in enumerate(lens.tolist()):
        spec = rle_encode(rows[i, :n], offset)
        want_raw = spec.size > n
        want = rows[i, :n] if want_raw else spec
        assert bool(rle_raw[i]) == want_raw, i
        assert counts[i] == want.size, i
        assert got[i, : want.size].tobytes() == want.tobytes(), i
        assert not got[i, want.size :].any(), i  # zero past the count


@pytest.mark.parametrize("kind", sorted(_ROWS))
def test_huff_stage_matches_host_spec(kind):
    """Per segment, huff_stage's payload words, bit count and escape
    equal io/bitio.py's pack_tokens of the table codes, or the verbatim
    symbols when coding would not shrink them."""
    from tudocomp_tpu.io.bitio import pack_tokens
    from tudocomp_tpu.models.blockcodec import be_words_from_bytes, huff_stage

    rows, counts = _ROWS[kind], _LENS
    live = np.arange(2048)[None, :] < counts[:, None]
    hist = np.bincount(rows[live], minlength=256)
    table = HuffmanTable.from_counts(np.maximum(hist, 1), max_len=16)
    words, bits, huff_raw = huff_stage(
        be_words_from_bytes(jnp.asarray(rows)), jnp.asarray(counts),
        jnp.asarray(table.sym_code.astype(np.uint32)),
        jnp.asarray(table.sym_len.astype(np.uint32)),
    )
    got = np.asarray(bytes_from_words(words, 2048))
    bits, huff_raw = np.asarray(bits), np.asarray(huff_raw)
    for i, n in enumerate(counts.tolist()):
        syms = rows[i, :n]
        payload, nbits = pack_tokens(
            table.sym_code[syms].astype(np.uint64),
            table.sym_len[syms].astype(np.int64),
        )
        want_raw = nbits >= 8 * n
        if want_raw:
            payload, nbits = syms, 8 * n
        assert bool(huff_raw[i]) == want_raw, i
        assert bits[i] == nbits, i
        nb = (nbits + 7) // 8
        assert got[i, :nb].tobytes() == payload.tobytes(), i
        assert not got[i, nb:].any(), i


def test_min_code_len_4_schedule(monkeypatch):
    """TDC_MIN_CODE_LEN=4 builds a table whose shortest code is 4 bits;
    decoder_tables then selects the 8-slot schedule and both device
    decoders (the scan, and the Triton kernel interpreted) roundtrip
    with it."""
    from tudocomp_tpu.ops.hufdec_jax import decoder_tables

    monkeypatch.setenv("TDC_MIN_CODE_LEN", "4")
    codec = BlockCodec()
    rng = np.random.default_rng(9)
    data = (
        b"".join(CORPUS)[: 3 * 2048 + 100]
        + np.repeat(rng.integers(0, 200, 40, dtype=np.uint8), 150).tobytes()
        + bytes(rng.integers(0, 256, 2048, dtype=np.uint8))
    )
    comp = codec.compress(data)
    from tudocomp_tpu.ops.hufdec_jax import slots_for

    tbl = codec._parse(comp)[0]
    mn = int(tbl.lengths.min())
    assert mn >= 4
    d = decoder_tables(tbl)["d"]
    assert d == slots_for(mn) and d <= 8
    assert codec.decompress(comp) == data  # host/native path
    assert codec.decompress_device(comp) == data  # scan on the CPU
    assert codec.decompress_device(comp, interpret=True) == data


_GOLDEN = {
    "empty": "f4d403192e4ed72db3c87465d0a1085cc42d0d1e4fe7f43669a02409ee67559b",
    "one_byte": "d75eece25ba9c7901e6bdcb626408ed7bbb21e799e8cbbcaf4f3013e66addafa",
    "one_segment": "c9df8309617b4b0492e849958f53ee9915b2c18d3ea4450bef24cc79abe1359e",
    "partial_tail": "31e1ce1ae73e08b321ee8624c7b3c918ac4abd522d0721a30e52464081f5ee60",
    "run_of_2": "aed4b8fc2371cf027ef183be322c867c126c5bdf65f90002982c9a16c7bd11af",
    "random": "0d99bebf83bca528056e81de6f38ad7638f4952172389c86a8d6133cdd2a7781",
    "long_runs": "c08ce4847d1f48116cebec2bff4e5470fd1abafed6527942306b117349d7f22e",
    "sampled_64": "db361c9c12b04f37a3a9334586537d16ff0802efa7987a10494f854e7ec36eba",
    "offset_125": "0580502ce8654fe57415a2079a1cd3102d6b3ed262bcbfe277ddc3010ca0c6d4",
    "min_code_len_4": "6063020abda69874a02a686f10afed9089dc77253a73a9ceca7f437b0e8f0b34",
    "hist_segs_straddle": "e0f1a829d9693e6af872b5b9771af6b1df05491290b898de6a90785f3c36d251",
}


def _golden_input(name):
    """(data, codec kwargs) of one pinned container."""
    rng = np.random.default_rng(2024)
    text = (b"It was the best of times, it was the worst of times; "
            b"<page><title>Anarchism</title></page>\n")
    mixed = (text * 4000)[: 40 * 2048] + bytes(
        rng.integers(0, 24, 30 * 2048 + 333, dtype=np.uint8))
    cases = {
        "empty": (b"", {}),
        "one_byte": (b"x", {}),
        "one_segment": ((text * 40)[:2048], {}),
        "partial_tail": (bytes(rng.integers(
            0, 4, 5 * 2048 + 17, dtype=np.uint8)), {}),
        "run_of_2": (np.repeat(rng.integers(
            0, 256, 3 * 1024, dtype=np.uint8), 2).tobytes(), {}),
        "random": (bytes(rng.integers(
            0, 256, 3 * 2048 + 5, dtype=np.uint8)), {}),
        "long_runs": (b"A" * 5000 + b"B" * 3000 + b"AB" * 250
                      + b"\x00" * 9000, {}),
        "sampled_64": (mixed, {}),
        "offset_125": ((b"aaabbbbbbbbcd" * 900)[: 6 * 2048],
                       {"offset": 125}),
        "min_code_len_4": (mixed[: 20 * 2048], {"min_code_len": 4}),
        "hist_segs_straddle": (np.random.default_rng(5).choice(
            np.frombuffer(b"abcdeeeeffg \n", np.uint8), 100 * 2048 - 7
        ).tobytes(), {}),
    }
    return cases[name]


@pytest.mark.parametrize("name", sorted(_GOLDEN))
def test_container_golden(name, monkeypatch):
    """The TBC2 container bytes are pinned: SHA-256 of what the encoder
    made before its kernels were rewritten in plain XLA. The straddle
    case lowers the HIST_SEGS cap so a batch straddles it."""
    import hashlib

    import tudocomp_tpu.models.blockcodec as bc

    data, kw = _golden_input(name)
    if name == "hist_segs_straddle":
        monkeypatch.setattr(bc, "HIST_SEGS", 48)
        comp = BlockCodec(batch_lanes=32).compress(data)
        assert BlockCodec().compress(data) == comp
    else:
        comp = BlockCodec(**kw).compress(data)
    assert hashlib.sha256(comp).hexdigest() == _GOLDEN[name]
    assert BlockCodec(**kw).decompress(comp) == data
