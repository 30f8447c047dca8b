"""LZSS/LZ77 compressors and the shared factor-stream format.

Three parts, mirroring the reference's ``lzss/`` module and the two
compressors built on it:

1. the factor-stream wire format (``lzss/LZSSCoding.hpp:19-140``): header
   ``n, flen_min, flen_max, fdist_max`` then, per factor, a gap flag bit
   [+ gap length], the gap literals, and ``(src, len)``; trailing literals
   after the last factor get a final gap record.
2. ``lzss`` — sliding-window greedy factorization
   (``LZSSSlidingWindowCompressor.hpp:39-143``): window w (default 16),
   threshold t (default 3); factors are ``(bit 1, delta in Range(pos),
   len in Range(w))``, literals ``(bit 0, literal)``; bit widths *grow*
   with the absolute position (adaptive ranges).
3. ``lzss_lcp`` — LZ77 via SA+ISA+LCP with naive PSV/NSV selection
   (``LZSSLCPCompressor.hpp:42-124``), encoded with the shared format and
   decoded through a back-reference buffer.

Factorization runs on the host (vectorized numpy + the native C
factorizer/decoder in ``native/tdc_native.cpp``); there is no device
factorization kernel here — the device paths are ``lzss_lcp``'s
``comp=device`` matcher and the flagship segment codec
(``models/blockcodec.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tudocomp_tpu.coders.base import Literals
from tudocomp_tpu.coders import (
    NON_CONSUMING_CODER_NAMES,
    UNIVERSAL_CODER_NAMES,
)
from tudocomp_tpu.compressors.base import Compressor
from tudocomp_tpu.ds.suffix import TextDS
from tudocomp_tpu.io.bitio import BitReader, BitWriter
from tudocomp_tpu.meta import Meta
from tudocomp_tpu.ranges import MinDistributedRange, Range, bit_r, len_r, literal_r


@dataclass
class Factor:
    pos: int
    src: int
    len: int


class FactorBuffer:
    """Sorted factor buffer with min/max length tracking.

    Array-backed: bulk producers (the native factorizers) hand whole
    (pos, src, len) arrays over via :meth:`extend_arrays`; scalar
    ``append`` stages into lists. ``arrays()`` is the canonical view —
    sort/flatten/encoding all operate vectorized on it."""

    def __init__(self):
        self._pos: list[int] = []
        self._src: list[int] = []
        self._len: list[int] = []
        self._arr = None  # (pos, src, len) int64 arrays once merged
        self.shortest = None
        self.longest = 0

    def append(self, pos: int, src: int, length: int) -> None:
        if self._arr is not None:
            a = self._arr
            self._pos = a[0].tolist()
            self._src = a[1].tolist()
            self._len = a[2].tolist()
            self._arr = None
        self._pos.append(pos)
        self._src.append(src)
        self._len.append(length)
        self.shortest = (
            length if self.shortest is None else min(self.shortest, length)
        )
        self.longest = max(self.longest, length)

    def extend_arrays(self, pos, src, length) -> None:
        """Bulk append from parallel arrays (native factorizer output)."""
        pos = np.asarray(pos, np.int64)
        src = np.asarray(src, np.int64)
        length = np.asarray(length, np.int64)
        if pos.size == 0:
            return
        merged = (
            (pos, src, length) if self._arr is None and not self._pos
            else tuple(
                np.concatenate([a, b])
                for a, b in zip(self.arrays(), (pos, src, length))
            )
        )
        self._arr = merged
        self._pos = self._src = self._len = []
        lo = int(length.min())
        self.shortest = lo if self.shortest is None else min(
            self.shortest, lo
        )
        self.longest = max(self.longest, int(length.max()))

    def arrays(self):
        """(pos, src, len) int64 arrays in current order."""
        if self._arr is None:
            self._arr = (
                np.array(self._pos, np.int64),
                np.array(self._src, np.int64),
                np.array(self._len, np.int64),
            )
            self._pos = self._src = self._len = []
        return self._arr

    @property
    def factors(self) -> list[Factor]:
        p, s, l = self.arrays()
        return [
            Factor(*t)
            for t in zip(p.tolist(), s.tolist(), l.tolist())
        ]

    def __len__(self):
        return self._arr[0].size if self._arr is not None else len(self._pos)

    def __iter__(self):
        return iter(self.factors)

    def sort(self) -> None:
        p, s, l = self.arrays()
        order = np.argsort(p, kind="stable")
        self._arr = (p[order], s[order], l[order])

    def flatten(self) -> None:
        """Rewrite factor sources that point into other factors to their
        transitive origin (reference ``LZSSFactors.hpp:79-132``).
        Vectorized: each round jumps every still-contained source one
        level toward its origin (Jacobi form of the sequential rewrite;
        containment guarantees the same fixed point). Requires factors
        sorted by position (both call sites sort first, as the
        reference does before its flatten pass)."""
        pos, src, lng = self.arrays()
        if pos.size == 0:
            return
        end = int(pos[-1] + lng[-1])
        # fmap[p] = 1 + id of the factor covering p, else 0 — built by
        # a forward-fill of start markers masked by a +-1 diff-scan
        # coverage (the former per-covered-position repeat+ramp arrays
        # were 32 transient bytes/char at 100 MB)
        dt = np.int32 if end < (1 << 31) else np.int64
        fmap = np.zeros(end, dt)
        fmap[pos] = np.arange(1, pos.size + 1, dtype=dt)
        np.maximum.accumulate(fmap, out=fmap)
        delta = np.zeros(end + 1, np.int8)
        delta[pos] += 1
        delta[pos + lng] -= 1
        covered = np.cumsum(delta[:end], dtype=np.int8) > 0
        del delta
        fmap[~covered] = 0
        del covered
        src = src.copy()
        # iterate to the sequential fixed point: blocked intermediate
        # factors (containment fails at some chain level) prevent true
        # pointer doubling, so rounds are capped at the factor count —
        # the scalar algorithm's own worst-case chain length. Converges
        # in a handful of rounds on real factorizations.
        for _ in range(pos.size + 2):
            inside = src < end
            fi = np.where(inside, fmap[np.minimum(src, end - 1)], 0)
            hit = fi > 0
            if not hit.any():
                break
            s_idx = fi - 1
            d = src - pos[s_idx]
            ok = hit & (d + lng <= lng[s_idx])
            if not ok.any():
                break
            nxt = np.where(ok, src[s_idx] + d, src)
            if np.array_equal(nxt, src):
                break
            src = nxt
        self._arr = (pos, src, lng)


def uncovered_literals(text: np.ndarray, factors: FactorBuffer) -> Literals:
    """Literal iterator skipping factor-covered positions
    (reference ``lzss/LZSSLiterals.hpp:10-50``). Coverage comes from a
    +-1 diff scan over the (non-overlapping) factor intervals — the
    former per-covered-position repeat+ramp arrays were 16 transient
    bytes/char at 100 MB."""
    pos, _, lng = factors.arrays()
    delta = np.zeros(text.size + 1, np.int8)
    if pos.size:
        delta[pos] += 1
        delta[pos + lng] -= 1  # start==prior end accumulates via +=/-=
    covered = np.cumsum(delta[: text.size], dtype=np.int8) > 0
    keep = ~covered
    return Literals(text[keep], np.flatnonzero(keep))


def _literal_tokens(coder, byts: np.ndarray):
    """(values u64, lens i64) for a literal byte array under ``coder``
    (bit coder / degenerate huffman: plain 8-bit; huffman: table)."""
    from tudocomp_tpu.coders.huffman import HuffmanCoder

    if isinstance(coder, HuffmanCoder.Encoder) and coder.table is not None:
        return (
            coder.table.sym_code[byts].astype(np.uint64),
            coder.table.sym_len[byts].astype(np.int32),
        )
    return byts.astype(np.uint64), np.full(byts.size, 8, np.int32)


def _encode_factors_bulk(coder, text, factors, text_r, flen_r, fdist_r):
    """Vectorized factor-stream body: one write_tokens call for the whole
    interleaved (flag, [gap, literals...], src, len) sequence. Bit-exact
    with the scalar loop (pinned by tests/test_golden.py); applies for
    bit/huffman coders, whose field widths are fixed per stream."""
    pos, src, lng = factors.arrays()
    n = text.size
    prev_end = np.concatenate([[0], (pos + lng)[:-1]])
    gaps = pos - prev_end
    tail = n - int((pos + lng)[-1]) if pos.size else n

    w_src, w_len, w_dist = text_r.bits, flen_r.bits, fdist_r.bits
    has_gap = gaps > 0
    slots = 1 + np.where(has_gap, 1 + gaps, 0) + 2
    offs = np.concatenate([[0], np.cumsum(slots)[:-1]])
    total = int(slots.sum()) + (2 + tail if tail else 0)
    values = np.zeros(total, np.uint64)
    # int32 slot/len arrays: token counts and bit lengths stay far
    # below 2^31 for any whole-input encode this path serves (the
    # blocks container is the >GB-scale answer)
    lens = np.zeros(total, np.int32)
    # flags
    values[offs] = has_gap
    lens[offs] = 1
    # gap distances
    g_off = offs[has_gap] + 1
    values[g_off] = gaps[has_gap].astype(np.uint64)
    lens[g_off] = w_dist
    # gap literals (concatenated per-factor text slices)
    if has_gap.any():
        gsz = gaps[has_gap]
        lit_slots = np.repeat(g_off + 1, gsz) + (
            np.arange(int(gsz.sum())) - np.repeat(
                np.cumsum(gsz) - gsz, gsz
            )
        )
        lit_text = np.repeat(prev_end[has_gap], gsz) + (
            np.arange(int(gsz.sum())) - np.repeat(
                np.cumsum(gsz) - gsz, gsz
            )
        )
        lv, ll = _literal_tokens(coder, text[lit_text])
        values[lit_slots] = lv
        lens[lit_slots] = ll
    # src / len
    s_off = offs + 1 + np.where(has_gap, 1 + gaps, 0)
    values[s_off] = src.astype(np.uint64)
    lens[s_off] = w_src
    values[s_off + 1] = (lng - flen_r.min).astype(np.uint64)
    lens[s_off + 1] = w_len
    # trailing literal run
    if tail:
        base = int(slots.sum())
        values[base] = 1
        lens[base] = 1
        values[base + 1] = tail
        lens[base + 1] = w_dist
        lv, ll = _literal_tokens(coder, text[n - tail :])
        values[base + 2 :] = lv
        lens[base + 2 :] = ll
    coder.out.write_tokens(values, lens)


def encode_factor_text(coder, text: np.ndarray, factors: FactorBuffer):
    """Shared factor-stream encoder (``lzss/LZSSCoding.hpp:19-92``)."""
    n = int(text.size)
    flen_min = factors.shortest if factors.shortest is not None else 0
    flen_max = factors.longest
    fpos, _, flng = factors.arrays()
    if fpos.size:
        prev_end = np.concatenate([[0], (fpos + flng)[:-1]])
        fdist_max = max(
            int((fpos - prev_end).max()),
            n - int(fpos[-1] + flng[-1]),
        )
    else:
        fdist_max = n

    text_r = Range(n)
    flen_r = MinDistributedRange(flen_min, flen_max)
    fdist_r = Range(fdist_max)

    coder.encode(n, len_r)
    coder.encode(flen_min, text_r)
    coder.encode(flen_max, text_r)
    coder.encode(fdist_max, text_r)

    from tudocomp_tpu.coders.huffman import HuffmanCoder
    from tudocomp_tpu.coders.simple import BitCoder

    if len(factors) and isinstance(
        coder, (BitCoder.Encoder, HuffmanCoder.Encoder)
    ):
        _encode_factors_bulk(coder, text, factors, text_r, flen_r, fdist_r)
        coder.finish()
        return

    from tudocomp_tpu.coders.sle import K as SLE_K, SLECoder

    if len(factors) and isinstance(coder, SLECoder.Encoder) \
            and not coder._pending:
        from tudocomp_tpu import native

        got = native.factor_stream_sle_encode(
            text, *factors.arrays(),
            text_r.bits, flen_r.bits, fdist_r.bits, flen_r.min,
            coder._sorted_keys, coder._key_rank, SLE_K,
            coder._lit_rank32,
        )
        if got is not None:
            coder.out.write_tokens(*got)
            return

    p = 0
    for f in factors:
        if f.pos == p:
            coder.encode(0, bit_r)
        else:
            coder.encode(1, bit_r)
            coder.encode(f.pos - p, fdist_r)
            coder.encode_array(text[p : f.pos], literal_r)
            p = f.pos
        coder.encode(f.src, text_r)
        coder.encode(f.len, flen_r)
        p += f.len
    if p < n:
        coder.encode(1, bit_r)
        coder.encode(n - p, fdist_r)
        coder.encode_array(text[p:n], literal_r)
    coder.finish()


def _native_decode_args(decoder, flen_r, text_r, fdist_r):
    """(payload, nbits, start, widths, lut, code_kind) when the native
    stream decoder applies (every non-consuming coder), else None."""
    from tudocomp_tpu.coders.huffman import HuffmanCoder
    from tudocomp_tpu.coders.simple import (
        ASCIICoder, BitCoder, EliasDeltaCoder, EliasGammaCoder,
        TernaryCoder,
    )

    from tudocomp_tpu import native

    if not native.available():
        return None
    lut = None
    kind = 0
    if isinstance(decoder, HuffmanCoder.Decoder):
        if decoder.table is not None:
            lut_sym, lut_len = decoder.table.build_lut()
            lut = (lut_sym, lut_len, decoder.table.longest)
    elif isinstance(decoder, BitCoder.Decoder):
        pass
    elif isinstance(decoder, EliasGammaCoder.Decoder):
        kind = 1
    elif isinstance(decoder, EliasDeltaCoder.Decoder):
        kind = 2
    elif isinstance(decoder, TernaryCoder.Decoder):
        kind = 3
    elif isinstance(decoder, ASCIICoder.Decoder):
        kind = 4
    else:
        return None
    reader = decoder.inp
    payload = np.packbits(reader._bits)
    return (
        payload, reader.total, reader.pos,
        text_r.bits, flen_r.bits, fdist_r.bits, lut, kind,
    )


def decode_stream_native(decoder, n, flen_r, text_r, fdist_r, mode=0):
    """Native factor-stream decode for bit/huffman/sle decoders. Mode 0
    returns the reconstructed text bytes; mode 1 returns
    ``(literals, fpos, fsrc, flen)`` for forward-capable resolution.
    None when no native fast path applies."""
    from tudocomp_tpu import native

    if not native.available():
        return None
    from tudocomp_tpu.coders.sle import K as SLE_K, SLECoder

    if isinstance(decoder, SLECoder.Decoder):
        if decoder.buffer:
            return None
        rd = decoder.inp
        res = native.lzss_decode_stream_sle(
            np.packbits(rd._bits), rd.total, rd.pos, n, flen_r.min,
            text_r.bits, flen_r.bits, fdist_r.bits,
            b"".join(decoder.kmers), SLE_K,
            bytes(decoder.lits), mode=mode,
        )
        if res is not None:
            rd.pos = rd.total
        return res
    args = _native_decode_args(decoder, flen_r, text_r, fdist_r)
    if args is None:
        return None
    payload, nbits, start, w_src, w_len, w_dist, lut, kind = args
    res = native.lzss_decode_stream(
        payload, nbits, start, n, flen_r.min,
        w_src, w_len, w_dist, lut, mode=mode, code_kind=kind,
    )
    if res is not None:
        decoder.inp.pos = decoder.inp.total
    return res


def parse_factor_arrays(decoder):
    """Parse a factor stream into arrays without resolving the copies:
    returns ``(total, literals u8, fpos, fsrc, flen)`` in stream order.
    Native mode-1 fast path when available, else a Python token walk
    (same tokens as ``decode_factor_text``)."""
    n = decoder.decode(len_r)
    text_r = Range(n)
    flen_min = decoder.decode(text_r)
    flen_max = decoder.decode(text_r)
    flen_r = MinDistributedRange(flen_min, flen_max)
    fdist_max = decoder.decode(text_r)
    fdist_r = Range(fdist_max)
    fast = decode_stream_native(decoder, n, flen_r, text_r, fdist_r, mode=1)
    if fast is not None:
        lit_bytes, fpos, fsrc, flens = fast
        return int(lit_bytes.size + flens.sum()), lit_bytes, fpos, fsrc, flens
    lits: list[np.ndarray] = []
    fpos, fsrc, flens = [], [], []
    cursor = 0
    while not decoder.eof():
        if decoder.decode(bit_r):
            num = decoder.decode(fdist_r)
            got = decoder.decode_array(literal_r, num)
            lits.append(np.asarray(got, np.uint8))
            cursor += num
        if decoder.eof():
            break
        src = decoder.decode(text_r)
        length = decoder.decode(flen_r)
        fpos.append(cursor)
        fsrc.append(src)
        flens.append(length)
        cursor += length
    literals = np.concatenate(lits) if lits else np.zeros(0, np.uint8)
    return (
        cursor, literals, np.asarray(fpos, np.int64),
        np.asarray(fsrc, np.int64), np.asarray(flens, np.int64),
    )


def decode_factor_text_device(decoder) -> bytes:
    """Factor-stream decode with the copy resolution on the device:
    token parse on the host (native mode-1 walker), then per-position
    pointer doubling on the device (``ops/lzss_jax.py
    resolve_factors_device``) — bit-identical to the host back-buffer
    (reference semantics ``lzss/LZSSCoding.hpp:95-140``)."""
    from tudocomp_tpu.ops.lzss_jax import resolve_factors_device

    total, literals, fpos, fsrc, flens = parse_factor_arrays(decoder)
    return resolve_factors_device(literals, fpos, fsrc, flens, total)


def decode_factor_text(decoder) -> bytes:
    """Shared factor-stream decoder with a back-reference buffer
    (``lzss/LZSSCoding.hpp:95-140`` + ``LZSSDecodeBackBuffer.hpp``)."""
    n = decoder.decode(len_r)
    text_r = Range(n)
    flen_min = decoder.decode(text_r)
    flen_max = decoder.decode(text_r)
    flen_r = MinDistributedRange(flen_min, flen_max)
    fdist_max = decoder.decode(text_r)
    fdist_r = Range(fdist_max)

    fast = decode_stream_native(decoder, n, flen_r, text_r, fdist_r, mode=0)
    if fast is not None:
        return fast

    buf = np.zeros(n, np.uint8)
    cursor = 0
    while not decoder.eof():
        if decoder.decode(bit_r):
            num = decoder.decode(fdist_r)
            got = decoder.decode_array(literal_r, num)
            buf[cursor : cursor + num] = got
            cursor += num
        if decoder.eof():
            break
        src = decoder.decode(text_r)
        length = decoder.decode(flen_r)
        for k in range(length):  # overlapping copies must go one-by-one
            buf[cursor + k] = buf[src + k]
        cursor += length
    return buf[:cursor].tobytes()


# --- sliding window ------------------------------------------------------------


def factorize_window(
    text: np.ndarray, window: int, threshold: int
):
    """Greedy sliding-window factorization, reference semantics:
    at position i, candidates start in [max(0, i-w), i); the lookahead is
    bounded by the streaming buffer end min(n, max(2w, i+w)); the longest
    match wins, ties to the leftmost candidate; matches may overlap i.

    Documented divergence: match lengths are capped at ``window``. The
    reference lets matches inside its initial 2w buffer exceed the
    window yet encodes the length in ``Range(window)``
    (``LZSSSlidingWindowCompressor.hpp:74-88``), silently wrapping the
    field and corrupting its own stream for small windows; the cap
    keeps every emitted factor representable."""
    n = text.size
    t = text.tolist()
    out = []  # (kind, ...) events in order
    i = 0
    while i < n:
        buf_end = min(n, i + window)  # length cap == window
        best_len = 0
        best_src = 0
        lo = max(0, i - window)
        for k in range(lo, i):
            j = 0
            while i + j < buf_end and t[k + j] == t[i + j]:
                j += 1
            if j >= threshold and j > best_len:
                best_len = j
                best_src = k
        if best_len > 0:
            out.append(("f", i, best_src, best_len))
            i += best_len
        else:
            out.append(("l", t[i]))
            i += 1
    return out


def _write_raw_bits(out: "BitWriter", packed: np.ndarray,
                    nbits: int) -> None:
    """Append pre-packed MSB-first bits (e.g. a native encoder's
    output) to a BitWriter, preserving the final-byte convention."""
    full = nbits // 32
    if full:
        words = np.ascontiguousarray(packed[: full * 4]).view(">u4")
        out.write_int_array(words.astype(np.uint64), 32)
    rem = nbits - full * 32
    if rem:
        tail = packed[full * 4 : full * 4 + 4].tobytes().ljust(4, b"\0")
        out.write_int(int.from_bytes(tail, "big") >> (32 - rem), rem)


class LZSSSlidingWindowCompressor(Compressor):
    @classmethod
    def meta(cls):
        m = Meta(
            "compressor",
            "lzss",
            "Lempel-Ziv-Storer-Szymanski (Sliding Window)",
        )
        m.option_submeta(
            "coder", "coder", default="bit",
            accepts=UNIVERSAL_CODER_NAMES,
        )
        m.option_dynamic("window", 16)
        m.option_dynamic("threshold", 3)
        return m

    #: coder name -> native int-code kind (BitRd/TdcBitWr read_code)
    _CODE_KINDS = {"bit": 0, "gamma": 1, "delta": 2, "ternary": 3,
                   "ascii": 4}

    def _code_kind(self):
        name = self.env.env_for_option("coder").cls.meta().name
        return self._CODE_KINDS.get(name)

    def compress(self, data: bytes) -> bytes:
        window = self.env.option("window").as_int()
        threshold = self.env.option("threshold").as_int()
        text = np.frombuffer(data, np.uint8)
        kind = self._code_kind()
        if kind is not None:
            from tudocomp_tpu import native

            got = native.lzss_window_encode(text, window, threshold,
                                            kind)
            if got is not None:
                packed, nbits = got
                out = BitWriter()
                _write_raw_bits(out, packed, nbits)
                return out.getvalue()
        out = BitWriter()
        coder = self.coder_encoder(out, Literals.none())
        for ev in factorize_window(text, window, threshold):
            if ev[0] == "f":
                _, pos, src, length = ev
                coder.encode(1, bit_r)
                coder.encode(pos - src, Range(pos))
                coder.encode(length, Range(window))
            else:
                coder.encode(0, bit_r)
                coder.encode(ev[1], literal_r)
        coder.finish()
        return out.getvalue()

    def decompress(self, data: bytes) -> bytes:
        window = self.env.option("window").as_int()
        kind = self._code_kind()
        if kind is not None:
            from tudocomp_tpu import native

            rd = BitReader(data)
            got = native.lzss_window_decode(
                np.packbits(rd._bits), rd.total, rd.pos, window, kind
            ) if native.available() else None
            if got is not None:
                return got
        decoder = self.coder_decoder(BitReader(data))
        text = bytearray()
        win_r = Range(window)
        while not decoder.eof():
            if decoder.decode(bit_r):
                delta = decoder.decode(Range(len(text)))
                src = len(text) - delta
                length = decoder.decode(win_r)
                for k in range(length):
                    text.append(text[src + k])
            else:
                text.append(decoder.decode(literal_r))
        return bytes(text)


# --- SA/LCP based ---------------------------------------------------------------


def factorize_lcp(text: np.ndarray, threshold: int,
                  compressed: bool = False) -> FactorBuffer:
    """LZ77 factorization via SA/ISA/LCP with naive PSV/NSV scans
    (reference ``LZSSLCPCompressor.hpp:60-115``; PSV preferred on ties).
    The native runtime runs the identical loop when available.
    ``compressed`` selects the compressed-space TextDS degree: ISA
    point queries through SparseISA and LCP through the compressed
    PLCP encoding (reference TextDS compressed_space), trading time
    for o(n)-bit extra storage on the host path."""
    ds = TextDS(text.tobytes())
    from tudocomp_tpu import native

    if not compressed:
        lcp = ds.require_lcp()
        # Phi/PLCP only exist to build LCP; dropping them caps resident
        # index memory at 3 arrays (ds/TextDS.hpp release lifecycle)
        ds.discard("phi", "plcp")
        got = native.lzss_lcp_factorize(
            ds.require_sa(), ds.require_isa(), lcp, threshold,
        )
        if got is not None:
            factors = FactorBuffer()
            factors.extend_arrays(*got)
            return factors
    if compressed:
        sa = ds.require_sa()
        isa = ds.require_isa_sparse()
        lcp = ds.require_lcp_compressed()
    else:
        sa = ds.require_sa().tolist()
        isa = ds.require_isa().tolist()
        lcp = ds.require_lcp().tolist()
    n = text.size
    factors = FactorBuffer()
    i = 0
    while i + 1 < n:
        cur = isa[i]
        # PSV: scan up, including current lcp, while suffixes start later
        psv_lcp = lcp[cur]
        psv_pos = cur - 1
        if psv_lcp > 0:
            while psv_pos >= 0 and sa[psv_pos] > sa[cur]:
                psv_lcp = min(psv_lcp, lcp[psv_pos])
                psv_pos -= 1
        # NSV: scan down, excluding current
        nsv_lcp = 0
        nsv_pos = cur + 1
        if nsv_pos < n:
            nsv_lcp = float("inf")
            while True:
                nsv_lcp = min(nsv_lcp, lcp[nsv_pos])
                if sa[nsv_pos] < sa[cur]:
                    break
                nsv_pos += 1
                if nsv_pos >= n:
                    nsv_lcp = 0
                    break
        max_lcp = max(psv_lcp, nsv_lcp)
        if max_lcp >= threshold:
            max_pos = psv_pos if max_lcp == psv_lcp else nsv_pos
            factors.append(i, sa[max_pos], int(max_lcp))
            i += int(max_lcp)
        else:
            i += 1
    return factors


class LZSSLCPCompressor(Compressor):
    @classmethod
    def meta(cls):
        m = Meta("compressor", "lzss_lcp", "LZSS Factorization using LCP")
        m.option_submeta(
            "coder", "coder", default="bit",
            accepts=NON_CONSUMING_CODER_NAMES,
        )
        m.option_dynamic("threshold", 3)
        m.option_dynamic("ds", "plain")
        # comp=psv: reference PSV/NSV scan over SA/LCP (exact, host).
        # comp=device: exact longest-previous-factor on the device
        #   (SA + all-nearest-smaller-values + binary-lifted LCP,
        #   ops/lzss_jax.py) — same per-position answers as psv.
        # comp=device_fast: q-gram class heuristic matcher (cheaper,
        #   slightly worse ratio) — an alternative valid parse.
        m.option_dynamic("comp", "psv")
        # dec=host: native back-buffer walk. dec=device: copy resolution
        #   as pointer-doubling rounds on the device (bit-identical).
        m.option_dynamic("dec", "host")
        m.needs_sentinel_terminator()
        return m

    def compress(self, data: bytes) -> bytes:
        if not data.endswith(b"\x00"):
            raise ValueError("lzss_lcp requires a sentineled input")
        threshold = self.env.option("threshold").as_int()
        text = np.frombuffer(data, np.uint8)
        comp = self.env.option("comp").as_string()
        if comp in ("device", "device_fast"):
            from tudocomp_tpu.ops.lzss_jax import factorize_device

            factors = FactorBuffer()
            factors.extend_arrays(*factorize_device(
                text, threshold, exact=(comp == "device")
            ))
        else:
            factors = factorize_lcp(
                text, threshold,
                compressed=(
                    self.env.option("ds").as_string() == "compressed"
                ),
            )
        out = BitWriter()
        coder = self.coder_encoder(out, uncovered_literals(text, factors))
        encode_factor_text(coder, text, factors)
        return out.getvalue()

    def decompress(self, data: bytes) -> bytes:
        decoder = self.coder_decoder(BitReader(data))
        if self.env.option("dec").as_string() == "device":
            return decode_factor_text_device(decoder)
        return decode_factor_text(decoder)


#: streaming chunk size for the sliding-window path (state kept across
#: chunks: the last 2*window bytes + the partial output byte)
STREAM_CHUNK = 1 << 22


def _lzss_compress_stream(self, fin, fout) -> None:
    """One-pass O(window)-memory streaming encode (reference
    ``as_stream()`` parity: the reference factorizer itself only ever
    holds a 2*window buffer, ``LZSSSlidingWindowCompressor.hpp:51-56``).
    Chunks are factorized with full look-ahead (positions past
    ``len - window`` defer to the next chunk), the adaptive delta width
    uses absolute positions, and per-chunk bit runs splice through
    ``StreamBitSink`` — output byte-identical to the buffered path."""
    from tudocomp_tpu.io.bitio import StreamBitSink

    window = self.env.option("window").as_int()
    threshold = self.env.option("threshold").as_int()
    kind = self._code_kind()
    from tudocomp_tpu import native

    if kind is None or not native.available():
        # consuming/entropy coders need the literal pre-pass, and the
        # chunked factorizer lives in the native runtime: buffered
        fout.write(self.compress(fin.read()))
        return

    sink = StreamBitSink(fout)
    context = np.zeros(0, np.uint8)
    abs_base = 0
    start = 0
    while True:
        chunk = fin.read(STREAM_CHUNK)
        final = not chunk
        buf = np.concatenate(
            [context, np.frombuffer(chunk, np.uint8)]
        )
        packed, nbits, next_i = native.lzss_window_encode_stream(
            buf, start, abs_base, final, window, threshold, kind
        )
        sink.append_packed(packed, nbits)
        if final:
            break
        keep_from = max(0, next_i - window)
        context = buf[keep_from:]
        abs_base += keep_from
        start = next_i - keep_from
    sink.close()


def _lzss_decompress_stream(self, fin, fout) -> None:
    """One-pass O(window)-memory streaming decode: back-copies reach
    at most ``window`` bytes, so the native handle keeps just the
    output tail + the undecoded bit tail across chunks (token rollback
    at chunk edges; absolute-position delta widths). Byte-identical to
    the buffered decode at every chunking."""
    from tudocomp_tpu import native

    window = self.env.option("window").as_int()
    kind = self._code_kind()
    if kind is None or not native.available():
        fout.write(self.decompress(fin.read()))
        return
    stream = native.LzssDecStream(window, kind)
    try:
        while True:
            chunk = fin.read(STREAM_CHUNK)
            final = not chunk
            out = stream.feed(chunk, final)
            if out:
                fout.write(out)
            if final:
                break
    finally:
        stream.close()


LZSSSlidingWindowCompressor.supports_streaming = True
LZSSSlidingWindowCompressor.compress_stream = _lzss_compress_stream
LZSSSlidingWindowCompressor.decompress_stream = _lzss_decompress_stream
