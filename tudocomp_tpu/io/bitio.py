"""Host (numpy) implementation of the bit-stream wire format.

This is the executable specification: semantics follow ``io/spec.md`` (which
mirrors the reference's ``io/BitOStream.hpp`` / ``io/BitIStream.hpp``). The
device packing kernel in ``tudocomp_tpu.ops.bitpack`` must produce bit-identical
output; tests pin that.

Design: the writer is *token-buffered* — every write appends ``(value, len)``
tokens (len <= 32) and the byte stream is produced in one vectorized pass at
``getvalue()``. This keeps host encoding fast and shares the packing math
with the device kernel.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu.utils.bits import bits_for, bits_for_arr

_U64_1 = np.uint64(1)


def split_tokens(values: np.ndarray, lens: np.ndarray):
    """Split tokens wider than 32 bits into (MSB-part, LSB-part) pairs.

    ``values`` uint64, ``lens`` integer array with lens <= 64. Returns
    (values uint32, lens uint8) with all lens <= 32, preserving bit order.
    """
    values = np.asarray(values)
    lens = np.asarray(lens)
    if lens.size == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint8)
    if int(lens.max(initial=0)) <= 32:
        # fast path keeps the caller's dtypes (truncating to uint32
        # directly equals the uint64 round trip on the low 32 bits;
        # the former upfront uint64 copy was 8 transient bytes/token)
        return values.astype(np.uint32), lens.astype(np.uint8)
    values = values.astype(np.uint64)
    lens = lens.astype(np.int64)
    wide = lens > 32
    n_out = lens.size + int(wide.sum())
    out_v = np.empty(n_out, np.uint64)
    out_l = np.empty(n_out, np.int64)
    # destination index of each token's *first* part
    dst = np.arange(lens.size) + np.cumsum(wide) - wide
    out_v[dst] = np.where(wide, values >> np.uint64(32), values)
    out_l[dst] = np.where(wide, lens - 32, lens)
    out_v[dst[wide] + 1] = values[wide] & np.uint64(0xFFFFFFFF)
    out_l[dst[wide] + 1] = 32
    return out_v.astype(np.uint32), out_l.astype(np.uint8)


def pack_tokens(values: np.ndarray, lens: np.ndarray):
    """Pack tokens (len <= 32 each) into a payload byte array.

    Returns ``(payload: uint8[ceil(T/8)], total_bits: int)`` without the
    finalization byte — apply :func:`finalize_stream` for a finished stream.
    """
    if np.asarray(values).size == 0:
        return np.zeros(0, np.uint8), 0
    if np.asarray(values).size > 512:
        from tudocomp_tpu import native

        # hand the raw arrays over: the token buffer's native-width
        # u32/u8 chunks pass through with zero copies (the former
        # uint64/int64 pre-conversion cost 16 transient bytes/token —
        # the peak-RSS hotspot of whole-input encodes at 100 MB)
        got = native.pack_tokens32(values, lens)
        if got is not None:
            return got
    values = np.asarray(values, dtype=np.uint64)
    lens64 = np.asarray(lens, dtype=np.int64)
    ends = np.cumsum(lens64)
    total = int(ends[-1])
    offs = ends - lens64
    # mask to len bits
    v = values & ((_U64_1 << lens64.astype(np.uint64)) - _U64_1)
    n_words = (total + 31) // 32 + 1
    words = np.zeros(n_words, np.uint32)
    bitpos = offs & 31
    sh = 32 - bitpos - lens64  # in [-31, 31]
    w0 = (offs >> 5).astype(np.int64)
    pos_sh = sh >= 0
    part1 = np.where(
        pos_sh,
        v << np.where(pos_sh, sh, 0).astype(np.uint64),
        v >> np.where(pos_sh, 0, -sh).astype(np.uint64),
    ).astype(np.uint32)
    np.bitwise_or.at(words, w0, part1)
    strad = ~pos_sh
    if strad.any():
        neg = (-sh[strad]).astype(np.uint64)  # 1..31 low bits spill over
        spill = (v[strad] & ((_U64_1 << neg) - _U64_1)) << (np.uint64(32) - neg)
        np.bitwise_or.at(words, w0[strad] + 1, spill.astype(np.uint32))
    payload = words.astype(">u4").view(np.uint8)[: (total + 7) // 8]
    return payload, total


def finalize_stream(payload: np.ndarray, total_bits: int) -> bytes:
    """Apply the final-byte convention (spec.md "Finalization")."""
    payload = np.asarray(payload, dtype=np.uint8)
    k = total_bits % 8
    if k == 0:
        return payload.tobytes() + b"\x00"
    if k <= 5:
        out = payload.copy()
        out[-1] |= np.uint8(k)
        return out.tobytes()
    return payload.tobytes() + bytes([k])


def parse_stream(data: bytes):
    """Inverse of finalization: returns ``(payload: uint8[], total_bits)``."""
    buf = np.frombuffer(data, dtype=np.uint8)
    n = buf.size
    if n == 0:
        return buf, 0
    f = int(buf[-1]) & 7
    if f >= 6:
        total = 8 * (n - 2) + f
        payload = buf[:-1]
    else:
        total = 8 * (n - 1) + f
        payload = buf if f else buf[:-1]
    return payload, max(total, 0)


class BitWriter:
    """Token-buffered bit writer producing the finished wire format."""

    def __init__(self):
        self._chunks = []  # list of (values uint32 array, lens uint8 array)
        self._sv = []  # scalar staging: values
        self._sl = []  # scalar staging: lens

    # -- scalar writes (reference BitOStream API) --------------------------

    def write_bit(self, bit) -> None:
        self._sv.append(1 if bit else 0)
        self._sl.append(1)

    def write_int(self, v: int, bits: int = 64) -> None:
        v = int(v)
        while bits > 32:
            # emit the MSB part first; keep the final chunk exactly 32 bits
            take = bits - 32 if bits <= 64 else 32
            self._sv.append((v >> (bits - take)) & ((1 << take) - 1))
            self._sl.append(take)
            bits -= take
        self._sv.append(v & ((1 << bits) - 1))
        self._sl.append(bits)

    def write_unary(self, v: int) -> None:
        v = int(v)
        while v >= 32:
            self._sv.append(0)
            self._sl.append(32)
            v -= 32
        self._sv.append(1)
        self._sl.append(v + 1)

    def write_ternary(self, v: int) -> None:
        v = int(v)
        if v:
            v -= 1
            while True:
                self._sv.append(v % 3)
                self._sl.append(2)
                v //= 3
                if not v:
                    break
        self._sv.append(3)
        self._sl.append(2)

    def write_elias_gamma(self, v: int) -> None:
        nbits = bits_for(v)
        self.write_unary(nbits)
        self.write_int(v, nbits)

    def write_elias_delta(self, v: int) -> None:
        nbits = bits_for(v)
        self.write_elias_gamma(nbits)
        self.write_int(v, nbits)

    def write_compressed_int(self, v: int, b: int = 7) -> None:
        v = int(v)
        while True:
            block = v & ((1 << b) - 1)
            v >>= b
            self.write_bit(v > 0)
            self.write_int(block, b)
            if not v:
                break

    # -- vectorized writes --------------------------------------------------

    def write_tokens(self, values, lens) -> None:
        """Append token arrays; tokens wider than 32 bits are split."""
        v, l = split_tokens(values, lens)
        if v.size:
            self._flush_scalars()
            self._chunks.append((v, l))

    def write_int_array(self, values, bits: int) -> None:
        """Fixed-width batch write: each value in ``bits`` bits."""
        values = np.asarray(values, dtype=np.uint64)
        self.write_tokens(values, np.full(values.shape, bits, np.int32))

    def write_unary_array(self, values) -> None:
        values = np.asarray(values, dtype=np.int64)
        if (values < 32).all():
            self.write_tokens(
                np.ones(values.shape, np.uint64), (values + 1)
            )
            return
        # wide path, still vectorized: emit ceil(v/31) tokens per value —
        # (v % 31) zeros + the terminating one, then 31-zero filler
        # tokens scattered before their value's terminator
        n_fill = values // 31
        total = int(n_fill.sum()) + values.size
        tv = np.zeros(total, np.uint64)
        tl = np.full(total, 31, np.int64)
        ends = np.cumsum(n_fill + 1) - 1
        tv[ends] = 1
        tl[ends] = values % 31 + 1
        self.write_tokens(tv, tl)

    def write_gamma_array(self, values) -> None:
        values = np.asarray(values, dtype=np.uint64)
        nb = bits_for_arr(values).astype(np.int64)
        if (nb < 32).all():
            # interleave unary(nb) and int(v, nb) tokens
            tv = np.empty(values.size * 2, np.uint64)
            tl = np.empty(values.size * 2, np.int64)
            tv[0::2] = 1
            tl[0::2] = nb + 1
            tv[1::2] = values
            tl[1::2] = nb
            self.write_tokens(tv, tl)
            return
        for v in values.tolist():
            self.write_elias_gamma(int(v))

    def write_ternary_array(self, values) -> None:
        """Vectorized ternary codes: per value the base-3 digits of
        ``v-1`` as 2-bit tokens plus the ``0b11`` terminator (``v == 0``
        is the bare terminator), matching :meth:`write_ternary`."""
        values = np.asarray(values, dtype=np.uint64)
        if values.size == 0:
            return
        if (values >= 3 ** 20).any():  # keep int64 power math exact
            for v in values.tolist():
                self.write_ternary(int(v))
            return
        v = values.astype(np.int64)
        v1 = np.maximum(v - 1, 0)
        d = np.ones(values.size, np.int64)
        p = 3
        while (v1 >= p).any():
            d += v1 >= p
            p *= 3
        d = np.where(v == 0, 0, d)
        tok_counts = d + 1
        total = int(tok_counts.sum())
        off = np.cumsum(tok_counts) - tok_counts
        owner = np.repeat(np.arange(values.size), tok_counts)
        j = np.arange(total) - off[owner]
        vo = v1[owner]
        tok = np.where(
            j < d[owner], (vo // np.power(3, j, dtype=np.int64)) % 3, 3
        )
        self.write_tokens(
            tok.astype(np.uint64), np.full(total, 2, np.int64)
        )

    def write_delta_array(self, values) -> None:
        values = np.asarray(values, dtype=np.uint64)
        nb = bits_for_arr(values).astype(np.int64)
        nnb = bits_for_arr(nb).astype(np.int64)  # bits_for(nb) <= 7 always
        tv = np.empty(values.size * 3, np.uint64)
        tl = np.empty(values.size * 3, np.int64)
        tv[0::3] = 1
        tl[0::3] = nnb + 1
        tv[1::3] = nb.astype(np.uint64)
        tl[1::3] = nnb
        tv[2::3] = values
        tl[2::3] = nb
        self.write_tokens(tv, tl)

    # -- produce output ------------------------------------------------------

    def _flush_scalars(self):
        if self._sv:
            v, l = split_tokens(
                np.array(self._sv, np.uint64), np.array(self._sl, np.int64)
            )
            self._chunks.append((v, l))
            self._sv, self._sl = [], []

    def tokens(self):
        """All buffered tokens as (values uint32, lens uint8)."""
        self._flush_scalars()
        if not self._chunks:
            return np.zeros(0, np.uint32), np.zeros(0, np.uint8)
        return (
            np.concatenate([c[0] for c in self._chunks]),
            np.concatenate([c[1] for c in self._chunks]),
        )

    @property
    def bit_len(self) -> int:
        self._flush_scalars()
        return int(sum(int(c[1].sum()) for c in self._chunks))

    def getvalue(self) -> bytes:
        """The finished (finalized) byte stream."""
        payload, total = pack_tokens(*self.tokens())
        return finalize_stream(payload, total)


class BitReader:
    """Bit reader over a finished stream (specification decoder)."""

    def __init__(self, data: bytes):
        payload, total = parse_stream(data)
        self.total = total
        nbits = payload.size * 8
        if nbits < total:  # defensive; malformed stream
            payload = np.concatenate(
                [payload, np.zeros((total - nbits + 7) // 8, np.uint8)]
            )
        self._bits = np.unpackbits(payload)[:total] if total else np.zeros(
            0, np.uint8
        )
        self._ones = np.flatnonzero(self._bits)
        self._wl = None  # packed words as Python ints (lazy, scalar reads)
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= self.total

    def read_bit(self) -> int:
        if self.pos >= self.total:
            return 0
        b = int(self._bits[self.pos])
        self.pos += 1
        return b

    def read_int(self, amount: int) -> int:
        # bits past EOF read as 0 (reference behavior): the packed-word
        # cache is built from the truncated bit array, so the out-of-
        # range tail is zero automatically
        if amount > 57:
            hi = self.read_int(amount - 32)
            return (hi << 32) | self.read_int(32)
        wl = self._wl
        if wl is None:
            wl = self._packed_words().tolist()
            self._wl = wl
        o = self.pos
        sh = o & 63
        w = (wl[o >> 6] << sh) & 0xFFFFFFFFFFFFFFFF
        if sh:
            w |= wl[(o >> 6) + 1] >> (64 - sh)
        o += amount
        self.pos = o if o < self.total else self.total
        return w >> (64 - amount) if amount else 0

    def read_unary(self) -> int:
        i = np.searchsorted(self._ones, self.pos)
        if i >= self._ones.size:
            v = self.total - self.pos
            self.pos = self.total
            return int(v)
        one_at = int(self._ones[i])
        v = one_at - self.pos
        self.pos = one_at + 1
        return v

    def read_ternary(self) -> int:
        mod = self.read_int(2)
        v = 0
        if mod < 3:
            b = 1
            while True:
                v += mod * b
                b *= 3
                mod = self.read_int(2)
                if mod == 3:
                    break
            v += 1
        return v

    def read_elias_gamma(self) -> int:
        return self.read_int(self.read_unary())

    def read_elias_delta(self) -> int:
        return self.read_int(self.read_elias_gamma())

    def read_compressed_int(self, b: int = 7) -> int:
        value = 0
        i = 0
        while True:
            has_next = self.read_bit()
            value |= self.read_int(b) << (b * i)
            i += 1
            if not has_next:
                break
        return value

    # -- vectorized bulk reads ------------------------------------------------

    def _packed_words(self) -> np.ndarray:
        """Big-endian 64-bit words over the bit stream (cached), padded
        with two zero words so any (word, word+1) window is in range."""
        w = getattr(self, "_words", None)
        if w is None:
            by = np.packbits(self._bits)
            pad = (-by.size) % 8 + 16
            by = np.concatenate([by, np.zeros(pad, np.uint8)])
            w = by.view(">u8").astype(np.uint64)
            self._words = w
        return w

    def read_var_int_array(self, widths) -> np.ndarray:
        """Read consecutive integers with per-item bit widths (<= 57).

        Vectorized via packed 64-bit words: each item's value sits in
        the window ``words[o>>6] << (o&63) | words[o>>6+1] >> (64-o&63)``
        shifted down to its width — O(count) temporaries.
        """
        widths = np.asarray(widths, np.int64)
        if widths.size == 0:
            return np.zeros(0, np.uint64)
        offs = self.pos + np.concatenate(
            [[0], np.cumsum(widths)[:-1]]
        )
        total = int(widths.sum())
        if self.pos + total > self.total:
            raise EOFError("bulk read past end of stream")
        words = self._packed_words()
        wi = offs >> 6
        sh = (offs & 63).astype(np.uint64)
        hi = words[wi] << sh
        lo_shift = (np.uint64(64) - sh) & np.uint64(63)  # sh=0 -> 0 via mask
        lo = np.where(sh == 0, np.uint64(0), words[wi + 1] >> lo_shift)
        window = hi | lo
        vals = window >> (np.uint64(64) - widths.astype(np.uint64))
        vals = np.where(widths == 0, np.uint64(0), vals)
        self.pos += total
        return vals

    def read_int_array(self, bits: int, count: int) -> np.ndarray:
        """Read ``count`` consecutive fixed-width integers (bits <= 64)."""
        if count == 0:
            return np.zeros(0, np.uint64)
        end = self.pos + bits * count
        if end > self.total:
            raise EOFError("bulk read past end of stream")
        chunk = self._bits[self.pos : end].reshape(count, bits)
        weights = (_U64_1 << np.arange(bits - 1, -1, -1, dtype=np.uint64))
        out = (chunk.astype(np.uint64) * weights).sum(
            axis=1, dtype=np.uint64
        )
        self.pos = end
        return out

    def read_unary_array(self, count: int) -> np.ndarray:
        """Read ``count`` consecutive unary values (vectorized via the
        precomputed one-bit index)."""
        if count == 0:
            return np.zeros(0, np.int64)
        i = np.searchsorted(self._ones, self.pos)
        if i + count > self._ones.size:
            raise EOFError("unary bulk read past end of stream")
        ones = self._ones[i : i + count].astype(np.int64)
        out = np.empty(count, np.int64)
        out[0] = ones[0] - self.pos
        out[1:] = np.diff(ones) - 1
        self.pos = int(ones[-1]) + 1
        return out

    def read_bit_array(self, count: int) -> np.ndarray:
        """Read ``count`` consecutive bits as a u8 array."""
        end = self.pos + count
        if end > self.total:
            raise EOFError("bit bulk read past end of stream")
        out = self._bits[self.pos : end].copy()
        self.pos = end
        return out


class StreamBitSink:
    """Incremental bit-stream writer: flushes whole bytes to a binary
    file object as they fill, keeping only the (< 8 bit) partial tail in
    memory — the O(1)-state complement of BitWriter for streaming
    compressors. ``close()`` applies the final-byte convention
    (io/spec.md; reference BitOStream destructor,
    ``io/BitOStream.hpp:53-64``)."""

    def __init__(self, fout):
        self.fout = fout
        self._tail = 0  # pending bits, MSB-aligned within _tail_n bits
        self._tail_n = 0
        self.total_bits = 0

    def append_packed(self, packed: np.ndarray, nbits: int) -> None:
        """Append ``nbits`` MSB-first bits from a packed byte array."""
        if nbits <= 0:
            return
        self.total_bits += nbits
        bits = np.unpackbits(
            np.ascontiguousarray(packed[: (nbits + 7) // 8])
        )[:nbits]
        if self._tail_n:
            head = np.zeros(self._tail_n, np.uint8)
            for k in range(self._tail_n):
                head[k] = (self._tail >> (self._tail_n - 1 - k)) & 1
            bits = np.concatenate([head, bits])
        n_full = bits.size // 8
        if n_full:
            self.fout.write(np.packbits(bits[: n_full * 8]).tobytes())
        rest = bits[n_full * 8 :]
        self._tail_n = rest.size
        self._tail = 0
        for b in rest.tolist():
            self._tail = (self._tail << 1) | int(b)

    def close(self) -> None:
        k = self.total_bits % 8
        if k == 0:
            self.fout.write(b"\x00")
        elif k <= 5:
            self.fout.write(bytes([(self._tail << (8 - k)) | k]))
        else:
            self.fout.write(bytes([self._tail << (8 - k), k]))
