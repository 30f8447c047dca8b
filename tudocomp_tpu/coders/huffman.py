"""Canonical Huffman coder.

Wire format mirrors the reference ``coders/HuffmanCoder.hpp``:

- 1 flag bit: 0 = degenerate (empty or single-symbol alphabet; literals are
  stored as plain 8-bit), 1 = table follows.
- table: compressed_int(longest), longest x compressed_int(numl[l]) (count of
  codewords of length l+1), compressed_int(alphabet_size), then the effective
  alphabet symbols sorted by codeword length, 8 bits each.
- literals: canonical codewords; firstcode recurrence
  ``firstcode[longest-1] = 0; firstcode[i-1] = (firstcode[i]+numl[i])/2``
  with codewords assigned in sorted-symbol order.
- every non-literal range falls back to range-optimal binary.

Two deliberate divergences from the reference, both where its behavior is
implementation-defined or broken (SURVEY.md §7 hard-part #1):

1. codeword order for equal lengths is pinned to *stable* (length, symbol)
   order — the reference uses non-stable ``std::sort`` so its order is
   implementation-defined (``HuffmanCoder.hpp:452-455``);
2. ``numl`` counts are stored at full width — the reference stores them in
   a uint8, which wraps for a 256-symbol uniform alphabet.

The tree construction uses a deterministic two-queue/heap with ties broken
by creation order; code *lengths* are optimal, so compressed size matches
any optimal Huffman code.
"""

from __future__ import annotations

import heapq

import numpy as np

from tudocomp_tpu.coders import base
from tudocomp_tpu.meta import Algorithm, Meta
from tudocomp_tpu.ranges import BitRange, LiteralRange, Range


def gen_codelengths_limited(counts: np.ndarray, max_len: int = 31):
    """Optimal-then-flattened code lengths with ``max(len) <= max_len``.

    The device bit packer emits one <= 32-bit token per codeword, so
    codeword lengths are capped (the reference has no cap; its uint64
    codewords can reach depth 255). Flattening halves the counts until the
    optimal code fits — terminating at the uniform distribution (depth 8
    for a byte alphabet). Lengths stay optimal for every realistic input;
    only adversarial Fibonacci-like count vectors are touched at all.
    """
    c = np.asarray(counts, np.int64)
    if c.size > (1 << max_len):
        raise ValueError(
            f"{c.size} symbols cannot fit codes of <= {max_len} bits"
        )
    while True:
        lengths = gen_codelengths(c)
        if lengths.max() <= max_len:
            return lengths
        new_c = (c + 1) // 2
        if (new_c == c).all():
            # counts saturated at 1 but the alphabet fits max_len: use
            # the near-balanced full-Kraft code (2^d - n symbols of
            # d-1 bits, the rest d bits; shorter codes to higher counts)
            d = int(np.ceil(np.log2(c.size)))
            lengths = np.full(c.size, d, np.uint8)
            n_short = (1 << d) - c.size
            by_count = np.argsort(-c, kind="stable")
            lengths[by_count[:n_short]] = d - 1
            return lengths
        c = new_c


def gen_codelengths(counts: np.ndarray) -> np.ndarray:
    """Optimal prefix-code lengths for positive ``counts`` (size >= 2)."""
    sigma = counts.size
    heap = [(int(c), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent = np.full(2 * sigma - 1, -1, np.int32)
    nxt = sigma
    while len(heap) > 1:
        c1, n1 = heapq.heappop(heap)
        c2, n2 = heapq.heappop(heap)
        parent[n1] = parent[n2] = nxt
        heapq.heappush(heap, (c1 + c2, nxt))
        nxt += 1
    depths = np.zeros(2 * sigma - 1, np.uint8)
    for node in range(nxt - 2, -1, -1):  # children have larger parents
        depths[node] = depths[parent[node]] + 1
    return depths[:sigma]


class HuffmanTable:
    """Canonical table: symbols sorted by (codelength, symbol)."""

    def __init__(self, ordered_symbols, ordered_lengths):
        self.symbols = np.asarray(ordered_symbols, np.uint8)
        self.lengths = np.asarray(ordered_lengths, np.uint8)
        self.longest = int(self.lengths.max()) if self.lengths.size else 0
        self.numl = np.bincount(
            self.lengths, minlength=self.longest + 1
        )[1:].astype(np.int64)
        self.firstcode = self._gen_firstcodes()
        # codeword of ordered symbol i = firstcode[len-1] + rank within length
        start_of_len = np.concatenate([[0], np.cumsum(self.numl)[:-1]])
        rank = np.arange(self.symbols.size) - start_of_len[self.lengths - 1]
        self.codewords = (
            self.firstcode[self.lengths.astype(np.int64) - 1] + rank
        ).astype(np.uint64)
        # full-alphabet lookup: symbol -> (codeword, length)
        self.sym_code = np.zeros(256, np.uint64)
        self.sym_len = np.zeros(256, np.uint8)
        self.sym_code[self.symbols] = self.codewords
        self.sym_len[self.symbols] = self.lengths

    def _gen_firstcodes(self) -> np.ndarray:
        # Ceiling division (the reference floors, HuffmanCoder.hpp:195):
        # identical for full-Kraft tables (fc[i]+numl[i] is even at every
        # level), but sound also for Kraft-deficient tables (min-length
        # clamping), where flooring lets the first-hit decode rule stop
        # at an empty shorter length.
        fc = np.zeros(self.longest, np.int64)
        for i in range(self.longest - 1, 0, -1):
            fc[i - 1] = (fc[i] + self.numl[i] + 1) // 2
        return fc

    @classmethod
    def from_counts(
        cls, counts256: np.ndarray, max_len: int | None = None,
        min_len: int | None = None,
    ) -> "HuffmanTable":
        eff = np.flatnonzero(counts256)
        if max_len is None:
            lengths = gen_codelengths(counts256[eff])
        else:
            lengths = gen_codelengths_limited(counts256[eff], max_len)
        if min_len is not None and lengths.size > 1:
            # lengthening codes keeps the Kraft sum <= 1, so a canonical
            # code with the clamped lengths always exists. The device
            # decoder's drain invariant needs min length >= 2.
            lengths = np.maximum(lengths, min_len).astype(lengths.dtype)
        from tudocomp_tpu.debug import check_kraft

        check_kraft(lengths, full=min_len is None)
        order = np.argsort(lengths, kind="stable")
        return cls(eff[order].astype(np.uint8), lengths[order])

    # -- fast vectorized decode ----------------------------------------------

    def build_lut(self):
        """Full-depth decode LUT (requires ``longest <= 22``): for every
        ``longest``-bit window, the decoded symbol and its code length.
        Cached after the first build."""
        if getattr(self, "_lut", None) is not None:
            return self._lut
        k = self.longest
        if k > 22:
            raise ValueError("codeword too long for LUT decode")
        lut_sym = np.zeros(1 << k, np.uint8)
        lut_len = np.zeros(1 << k, np.uint8)
        spans = (1 << (k - self.lengths.astype(np.int64)))
        starts = (self.codewords.astype(np.int64)) * spans
        for s, e, sym, ln in zip(
            starts, starts + spans, self.symbols, self.lengths
        ):
            lut_sym[s:e] = sym
            lut_len[s:e] = ln
        self._lut = (lut_sym, lut_len)
        return self._lut

    def fast_decode(self, payload: np.ndarray, count: int) -> np.ndarray:
        """Decode ``count`` symbols from an MSB-first byte payload.

        Fully vectorized: (1) speculatively LUT-decode *every* bit offset,
        (2) resolve the sequential decode chain ``p -> p + len[p]`` by
        pointer doubling (jump tables compose associatively), (3) gather.
        O(bits * log(count)) numpy work — no per-symbol Python loop.
        """
        if count == 0:
            return np.zeros(0, np.uint8)
        k = self.longest
        lut_sym, lut_len = self.build_lut()
        from tudocomp_tpu import native

        got = native.huffman_decode(
            np.asarray(payload, np.uint8), count, lut_sym, lut_len, k
        )
        if got is not None:
            return got
        payload = np.asarray(payload, np.uint8)
        nbits = payload.size * 8
        bits = np.unpackbits(payload)
        # window[p] = bits[p : p+k] as an integer (zero-padded past the end)
        padded = np.concatenate([bits, np.zeros(k, np.uint8)]).astype(np.int64)
        window = np.zeros(nbits, np.int64)
        for j in range(k):
            window = (window << 1) | padded[j : j + nbits]
        sym_at = lut_sym[window]
        len_at = lut_len[window].astype(np.int64)
        # jump chain: position after one symbol decoded at p
        sentinel = nbits
        jump = np.minimum(np.arange(nbits, dtype=np.int64) + len_at, sentinel)
        jump = np.concatenate([jump, [sentinel]])
        pos = np.zeros(count, np.int64)
        i = np.arange(count, dtype=np.int64)
        b = 0
        while (1 << b) <= count:
            mask = (i >> b) & 1 == 1
            pos[mask] = jump[pos[mask]]
            jump = jump[np.minimum(jump, sentinel)]
            b += 1
        if pos.max(initial=0) >= nbits:
            raise ValueError("huffman decode ran past end of stream")
        return sym_at[pos]

    # -- serialization (reference huffmantable_encode/decode) ---------------

    def write(self, out) -> None:
        out.write_compressed_int(self.longest)
        for n in self.numl.tolist():
            out.write_compressed_int(int(n))
        out.write_compressed_int(int(self.symbols.size))
        out.write_int_array(self.symbols.astype(np.uint64), 8)

    @classmethod
    def read(cls, inp) -> "HuffmanTable":
        longest = inp.read_compressed_int()
        numl = [inp.read_compressed_int() for _ in range(longest)]
        sigma = inp.read_compressed_int()
        symbols = inp.read_int_array(8, sigma).astype(np.uint8)
        lengths = np.repeat(
            np.arange(1, longest + 1, dtype=np.uint8), numl
        )
        return cls(symbols, lengths)


class HuffmanCoder(Algorithm):
    @classmethod
    def meta(cls):
        return Meta("coder", "huff", "Canonical Huffman coder")

    class Encoder(base.Encoder):
        def __init__(self, env, out, literals):
            super().__init__(env, out, literals)
            chars = literals.chars
            counts = np.bincount(chars, minlength=256)
            sigma = int((counts > 0).sum())
            if sigma <= 1:
                self.table = None
                out.write_bit(0)
            else:
                self.table = HuffmanTable.from_counts(counts)
                out.write_bit(1)
                self.table.write(out)

        def encode(self, v, r: Range) -> None:
            if isinstance(r, LiteralRange):
                if self.table is None:
                    self.out.write_int(int(v) & 0xFF, 8)
                else:
                    s = int(v) & 0xFF
                    self.out.write_int(
                        int(self.table.sym_code[s]),
                        int(self.table.sym_len[s]),
                    )
            else:
                super().encode(v, r)

        def encode_array(self, values, r: Range) -> None:
            if isinstance(r, LiteralRange):
                values = np.asarray(values, np.uint8)
                if self.table is None:
                    self.out.write_int_array(values.astype(np.uint64), 8)
                else:
                    self.out.write_tokens(
                        self.table.sym_code[values],
                        self.table.sym_len[values].astype(np.int32),
                    )
            else:
                super().encode_array(values, r)

    class Decoder(base.Decoder):
        def __init__(self, env, inp):
            super().__init__(env, inp)
            if inp.read_bit():
                self.table = HuffmanTable.read(inp)
                # start index of each length among sorted symbols
                self.start_of_len = np.concatenate(
                    [[0], np.cumsum(self.table.numl)[:-1]]
                )
            else:
                self.table = None

        def decode(self, r: Range) -> int:
            if not isinstance(r, LiteralRange):
                return super().decode(r)
            if self.table is None:
                return self.inp.read_int(8)
            value = 0
            length = 0
            fc = self.table.firstcode
            while True:
                value = (value << 1) | self.inp.read_bit()
                length += 1
                if value >= fc[length - 1]:
                    break
            idx = self.start_of_len[length - 1] + (value - fc[length - 1])
            return int(self.table.symbols[idx])

        def decode_array(self, r: Range, count: int) -> np.ndarray:
            if not isinstance(r, LiteralRange):
                return super().decode_array(r, count)
            if self.table is None:
                return self.inp.read_int_array(8, count)
            return np.array(
                [self.decode(r) for _ in range(count)], np.uint64
            )
