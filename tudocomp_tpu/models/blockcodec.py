"""Flagship device pipeline: segment-parallel RLE + shared canonical Huffman.

This is BASELINE.json config 1/2 re-designed for a data-parallel device
(reference counterparts: ``compressors/RunLengthEncoder.hpp`` +
``coders/HuffmanCoder.hpp``, composed like ``rle:encode(huff)``):

- the input splits into fixed **segments** of ``SEG = 2048`` output
  bytes — the lockstep SIMD unit for both encode and decode, and the
  data-parallel unit across devices (``parallel/pipeline.py``);
- each segment RLEs independently on device (``ops/rle_jax.py``, one
  token per position; runs never span segments);
- ONE canonical Huffman table (min code length 3, max 16) is built on
  the host from the device-computed histogram of RLE bytes — across
  devices the histogram merges with psum and the table broadcasts;
- each segment's RLE bytes Huffman-code independently (256-entry table
  gather, then per-segment bit packing, ``ops/bitpack.py``), with two
  per-segment worst-case escapes: ``rle_raw`` (RLE would expand:
  symbols are the verbatim input bytes) and ``huff_raw`` (coding would
  expand: payload is the verbatim symbol bytes). The escapes bound
  every segment to <= SEG symbols and <= 8*count payload bits — the
  static guarantees the device decoder's lockstep schedule is built on
  (``ops/hufdec_jax.py``).

Container layout (TBC2; integers are byte-aligned vbyte):

    magic "TBC2" | vbyte(header_len) |
    header (finished bit stream): seg_size, offset, orig_len,
        table flag + huffman table (as coders/huffman.py) |
    per segment: vbyte(count << 2 | rle_raw << 1 | huff_raw),
        vbyte(payload_bytes), payload (byte-aligned)

Per-segment framing costs ~4 bytes per 2 KiB (~0.2%) and buys fully
parallel decode on both the device (one lane per segment) and the host
(native batch kernel, all cores).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from tudocomp_tpu import backend
from tudocomp_tpu.coders.huffman import HuffmanTable
from tudocomp_tpu.io.bitio import BitReader, BitWriter
from tudocomp_tpu.ops.bitpack import pack_token_rows
from tudocomp_tpu.ops.hufdec_jax import (
    SEG,
    SEG_CAP,
    build_feed,
    decode_segments,
    decoder_tables,
    expand_records,
    needed_steps,
    snap_steps,
)
from tudocomp_tpu.ops.hufdec_pallas import BLOCK, decode_segments_pallas
from tudocomp_tpu.ops.huffman_jax import huffman_encode_tokens, masked_histogram
from tudocomp_tpu.ops.rle_jax import bytes_from_words, rle_tokens
from tudocomp_tpu.utils.vbyte import read_vbyte, write_vbyte

MAGIC = b"TBC2"

#: payload words kept per segment: bits <= 8 * count <= 16384 -> 512
PAYLOAD_WORDS = 512

#: segments per device dispatch, encode and decode (128 MiB of input
#: or output). Decode runs one lane per thread, so 65536 lanes are 512
#: programs of 128 threads: several resident on each of an H100's 132
#: SMs, where 8192 lanes filled a few percent of it. Inputs above one
#: batch still split, so the host finish of one batch overlaps the
#: device work of the next, and the per-batch temporaries (a few GB of
#: encode tokens, ~1 GB of decode records) stay small beside the
#: card's memory.
BATCH_LANES = 65536

#: table-histogram cap (segments): when sampling is on, only the first
#: HIST_SEGS segments (16 MiB) feed the 1-in-8 histogram — zstd-style
#: bounded sampling. This makes the canonical table a function of the
#: first 16 MiB alone, so the host can pull that histogram and build
#: the table while later RLE batches still run on the device.
HIST_SEGS = 8192


def _bucket(n: int) -> int:
    """Lane-count bucket of a batch: the next power of two (>= 8), so
    inputs of any size reuse a handful of compiled shapes."""
    return max(8, 1 << max(0, (n - 1)).bit_length())


def be_words_from_bytes(rows_u8):
    """Big-endian u32 stream words from byte rows ``u8[..., 4k]``
    (byte 0 lands in the top byte of word 0)."""
    le = lax.bitcast_convert_type(
        rows_u8.reshape(*rows_u8.shape[:-1], rows_u8.shape[-1] // 4, 4),
        jnp.uint32,
    )
    return (
        ((le & 0xFF) << 24) | ((le & 0xFF00) << 8)
        | ((le >> 8) & 0xFF00) | (le >> 24)
    )


@functools.partial(
    jax.jit, static_argnames=("offset", "sample", "hist")
)
def rle_stage(seg_rows, seg_lens, *, offset: int, sample: bool,
              hist: bool = True, hist_limit=None):
    """Stage 1: per-segment device RLE + escape + table histogram.

    seg_rows: u8[NC, SEG], seg_lens: i32[NC]. Returns
    ``(sel_words u32[NC, SEG_CAP//4] big-endian stream words of the
    escape-selected byte stream, counts i32[NC], rle_raw bool[NC],
    hist u32[256])``. Words are zero past ``counts`` so the container
    bytes are deterministic — on the ``rle_raw`` branch this holds
    because callers MUST zero-pad ``seg_rows`` past ``seg_lens`` (all
    do: split_segments / the sharded pipeline build zero-initialised
    row buffers); the RLE branch masks internally.

    ``hist=False`` skips the histogram entirely (batches past the
    HIST_SEGS cap); ``hist_limit`` (traced i32) masks segments at
    LOCAL index >= limit out of the histogram so a batch straddling
    the global cap contributes exactly its first ``hist_limit``
    segments. Both leave sel/counts/rle_raw untouched.
    """
    values, lens = jax.vmap(
        lambda row, n: rle_tokens(row, n, offset)
    )(seg_rows, seg_lens)
    # only the first SEG_CAP bytes (SEG_CAP/4 words) of the RLE stream
    # can survive: longer streams lose to the rle_raw escape
    words, rle_bits = pack_token_rows(values, lens, SEG_CAP // 4)
    rle_lens = rle_bits >> 3
    rle_raw = rle_lens > seg_lens  # RLE would expand: keep input bytes
    sel = jnp.where(
        rle_raw[:, None], be_words_from_bytes(seg_rows), words
    )
    counts = jnp.where(rle_raw, seg_lens, rle_lens).astype(jnp.int32)
    if not hist:
        return sel, counts, rle_raw, jnp.zeros(256, jnp.uint32)
    if sample:  # 1-in-8 segments feed the table histogram (zstd-style)
        sub, subc, stride = sel[::8], counts[::8], 8
    else:
        sub, subc, stride = sel, counts, 1
    if hist_limit is not None:
        idx = jnp.arange(subc.shape[0], dtype=jnp.int32) * stride
        subc = jnp.where(idx < hist_limit, subc, 0)
    h = masked_histogram(bytes_from_words(sub, SEG_CAP), subc)
    return sel, counts, rle_raw, h


@jax.jit
def huff_stage(sel_words, counts, sym_code, sym_len):
    """Stage 2: per-segment Huffman table gather + bit packing, with the
    ``huff_raw`` escape resolved on device (payload = verbatim bytes
    whenever coding would not strictly shrink the segment).

    ``sel_words``: the rle_stage stream words u32[NC, SEG_CAP//4].
    Returns ``(words u32[NC, PAYLOAD_WORDS], bits i32[NC],
    huff_raw bool[NC])``.
    """
    rows = bytes_from_words(sel_words, SEG_CAP)
    values, lens = huffman_encode_tokens(rows, counts, sym_code, sym_len)
    words, bits = pack_token_rows(values, lens, PAYLOAD_WORDS)
    huff_raw = bits >= counts * 8
    out = jnp.where(
        huff_raw[:, None], sel_words[:, :PAYLOAD_WORDS], words
    )
    bits = jnp.where(huff_raw, counts * 8, bits)
    return out, bits, huff_raw


class BlockCodec:
    """Host orchestration: split -> device encode -> container assembly.

    ``batch_lanes`` segments are processed per device dispatch (padded
    to power-of-two buckets so compilations are reused).
    """

    def __init__(self, offset: int = 0, batch_lanes: int = BATCH_LANES,
                 min_code_len: int | None = None, **_compat):
        # _compat swallows the retired TBC1 knobs (block_size,
        # sub_chunks) so older call sites keep working.
        self.offset = offset
        self.batch_lanes = batch_lanes
        self.min_code_len = min_code_len

    # -- encode --------------------------------------------------------------

    def split_segments(self, data: bytes):
        n = len(data)
        nseg = -(-n // SEG)
        arr = np.zeros((nseg, SEG), np.uint8)
        flat = np.frombuffer(data, np.uint8)
        arr.reshape(-1)[:n] = flat
        lens = np.minimum(
            np.full(nseg, SEG, np.int64),
            n - SEG * np.arange(nseg, dtype=np.int64),
        ).astype(np.int32)
        return arr, lens

    def compress(self, data: bytes) -> bytes:
        n = len(data)
        if n == 0:
            return self._assemble_empty()
        seg_rows, seg_lens = self.split_segments(data)
        nseg = seg_rows.shape[0]
        rows_l, counts_l, rleraw_l, lanes_l = [], [], [], []
        hist_dev = None
        # one global sampling decision per input (not per batch bucket)
        # so the container bytes are identical across batch splits,
        # backends, and mesh shapes (parallel/pipeline.py uses the
        # same rule); batches start at multiples of 8, so per-batch
        # rows[::8] equals the global 1-in-8 segment sample. When
        # sampled, the histogram additionally caps at the FIRST
        # HIST_SEGS segments (same global rule in the sharded paths),
        # so only batches intersecting [0, HIST_SEGS) compute one.
        sampled = self.sample_rule(nseg)
        for lo in range(0, nseg, self.batch_lanes):
            hi = min(lo + self.batch_lanes, nseg)
            b = _bucket(hi - lo)
            br = np.zeros((b, SEG), np.uint8)
            br[: hi - lo] = seg_rows[lo:hi]
            bl = np.zeros(b, np.int32)
            bl[: hi - lo] = seg_lens[lo:hi]
            hist_on = (not sampled) or lo < HIST_SEGS
            limit = None
            if sampled and hist_on and lo + b > HIST_SEGS:
                limit = jnp.int32(HIST_SEGS - lo)
            rows, counts, rleraw, h = rle_stage(
                jnp.asarray(br), jnp.asarray(bl),
                offset=self.offset, sample=sampled,
                hist=hist_on, hist_limit=limit,
            )
            rows_l.append(rows)
            counts_l.append(counts)
            rleraw_l.append(rleraw)
            lanes_l.append(hi - lo)
            if hist_on:
                hist_dev = h if hist_dev is None else hist_dev + h
        # host table build: the histogram pull only waits for the
        # batches that intersect the HIST_SEGS cap, while the remaining
        # queued RLE batches keep the device busy
        table = self._table_from_hist(
            np.asarray(hist_dev, np.int64), sampled
        )
        sym_code, sym_len = self._device_table(table)
        outs = [
            huff_stage(rows, counts, sym_code, sym_len)
            for rows, counts in zip(rows_l, counts_l)
        ]

        def gather(arrays):
            # trim each batch to its REAL lane count before
            # concatenating: the bucket pads past it
            return np.concatenate(
                [np.asarray(x)[:nl] for x, nl in zip(arrays, lanes_l)]
            )

        return self._assemble(
            n, table, gather(counts_l), gather(rleraw_l),
            gather([o[2] for o in outs]), gather([o[0] for o in outs]),
            gather([o[1] for o in outs]),
        )

    @staticmethod
    def sample_rule(nseg: int) -> bool:
        """Histogram sampling (1-in-8 segments, zstd-style) kicks in at
        64 segments (128 KiB); below that the exact histogram is free."""
        return nseg >= 64

    def _min_code_len(self) -> int:
        # min 3: the device decoder drains D=11 slots * 3 bits >= 32 bits
        # per feed word (hufdec_jax.py); forcing 3 over 2 costs <0.2%
        # ratio post-RLE and cuts slots 31%. min_code_len=4 trades
        # ~1.5% payload for an 8-slot decode schedule (decoder_tables
        # derives slots from the table itself). Settable via the
        # ``tbc2(min_code_len=...)`` option; TDC_MIN_CODE_LEN env
        # overrides for experiments.
        import os

        env = os.environ.get("TDC_MIN_CODE_LEN")
        if env is not None:
            mn = int(env)
        elif self.min_code_len is not None:
            mn = int(self.min_code_len)
        else:
            mn = 3
        return min(max(mn, 3), 8)

    def _table_from_hist(self, hist, sampled: bool):
        hist = np.asarray(hist, np.int64)
        if sampled:
            hist = hist + 1  # sampled histogram: keep all bytes encodable
        if (hist > 0).sum() <= 1:
            return None
        # 16-bit cap: packer tokens (see _min_code_len for the floor)
        return HuffmanTable.from_counts(
            hist, max_len=16, min_len=self._min_code_len()
        )

    @staticmethod
    def _device_table(table):
        if table is None:
            # identity: bits == 8*count everywhere -> all huff_raw
            return (
                jnp.arange(256, dtype=jnp.uint32),
                jnp.full(256, 8, jnp.uint32),
            )
        return (
            jnp.asarray(table.sym_code.astype(np.uint32)),
            jnp.asarray(table.sym_len.astype(np.uint32)),
        )

    def _header(self, orig_len: int, table) -> bytes:
        head = BitWriter()
        head.write_compressed_int(SEG)
        head.write_compressed_int(self.offset)
        head.write_compressed_int(orig_len)
        if table is None:
            head.write_bit(0)
        else:
            head.write_bit(1)
            table.write(head)
        return head.getvalue()

    def _assemble_empty(self) -> bytes:
        out = bytearray(MAGIC)
        header = self._header(0, None)
        write_vbyte(out, len(header))
        out += header
        return bytes(out)

    def _assemble(self, orig_len, table, counts, rleraw, hraw, words,
                  bits) -> bytes:
        """Vectorized container assembly (no per-segment Python loop)."""
        out = bytearray(MAGIC)
        header = self._header(orig_len, table)
        write_vbyte(out, len(header))
        out += header
        out += self._frames(counts, rleraw, hraw, words, bits)
        return bytes(out)

    def _frames(self, counts, rleraw, hraw, words, bits) -> bytes:
        """Per-segment frame bytes for a (slice of a) segment batch —
        the container body after the header. Hosts of a multi-process
        job frame their own contiguous segment ranges with this and
        write them at offsets from a size all-gather
        (``parallel/distributed.compress_distributed``)."""
        from tudocomp_tpu.utils.vbyte import encode_vbyte_array

        nseg = counts.shape[0]
        meta1 = (
            (counts.astype(np.uint64) << np.uint64(2))
            | (rleraw.astype(np.uint64) << np.uint64(1))
            | hraw.astype(np.uint64)
        )
        pbytes = ((bits.astype(np.int64) + 7) // 8)
        meta2 = pbytes.astype(np.uint64)

        def vb_lens(v):
            nb = np.ones(v.shape, np.int64)
            vv = v.copy()
            for _ in range(9):
                vv >>= np.uint64(7)
                nb += (vv > 0).astype(np.int64)
            return nb

        m1_payload = encode_vbyte_array(meta1)
        m2_payload = encode_vbyte_array(meta2)
        l1 = vb_lens(meta1)
        l2 = vb_lens(meta2)
        seg_sizes = l1 + l2 + pbytes
        seg_starts = np.concatenate([[0], np.cumsum(seg_sizes)[:-1]])
        total = int(seg_sizes.sum())
        buf = np.zeros(total, np.uint8)

        def ragged_place(dst_starts, lens, src, src_starts):
            """buf[dst_starts[i] + j] = src[src_starts[i] + j]."""
            tot = int(lens.sum())
            if tot == 0:
                return
            piece = np.repeat(np.arange(lens.size), lens)
            within = np.arange(tot) - np.repeat(
                np.cumsum(lens) - lens, lens
            )
            buf[dst_starts[piece] + within] = src[src_starts[piece] + within]

        l1_starts = np.cumsum(l1) - l1
        l2_starts = np.cumsum(l2) - l2
        ragged_place(seg_starts, l1, m1_payload, l1_starts)
        ragged_place(seg_starts + l1, l2, m2_payload, l2_starts)
        payload_bytes = np.ascontiguousarray(
            words, dtype=">u4"
        ).view(np.uint8).reshape(nseg, -1)
        ragged_place(
            seg_starts + l1 + l2, pbytes,
            payload_bytes.reshape(-1),
            np.arange(nseg, dtype=np.int64) * payload_bytes.shape[1],
        )
        return buf.tobytes()

    # -- container parse (shared by host + device decode) --------------------

    def _parse(self, data: bytes):
        if data[:4] != MAGIC:
            raise ValueError("bad magic")
        header_len, pos = read_vbyte(data, 4)
        head = BitReader(data[pos : pos + header_len])
        pos += header_len
        seg_size = head.read_compressed_int()
        if seg_size != SEG:
            raise ValueError("unsupported segment size")
        offset = head.read_compressed_int()
        orig_len = head.read_compressed_int()
        table = HuffmanTable.read(head) if head.read_bit() else None
        nseg = -(-orig_len // SEG)
        from tudocomp_tpu import native

        parsed = native.tbc2_parse(data, pos, nseg)
        if parsed is None:
            counts = np.zeros(nseg, np.int64)
            flags = np.zeros(nseg, np.uint8)
            poff = np.zeros(nseg, np.int64)
            pbytes = np.zeros(nseg, np.int64)
            for i in range(nseg):
                m1, pos = read_vbyte(data, pos)
                m2, pos = read_vbyte(data, pos)
                counts[i] = m1 >> 2
                flags[i] = m1 & 3
                poff[i] = pos
                pbytes[i] = m2
                pos += m2
        else:
            counts, flags, poff, pbytes = parsed
        return table, offset, orig_len, counts, flags, poff, pbytes

    # -- host decode (specification path; native batch kernel) ---------------

    def decompress(self, data: bytes) -> bytes:
        (table, offset, orig_len, counts, flags, poff,
         pbytes) = self._parse(data)
        if orig_len == 0:
            return b""
        nseg = counts.shape[0]
        if table is not None:
            table.build_lut()
        from tudocomp_tpu import native

        out = native.tbc2_decode(
            data, counts, flags, poff, pbytes, orig_len, SEG,
            table, offset,
        )
        if out is not None:
            return out
        # pure-Python fallback (no native runtime)
        res = bytearray()
        for i in range(nseg):
            n_out = min(SEG, orig_len - i * SEG)
            payload = np.frombuffer(
                data, np.uint8, int(pbytes[i]), int(poff[i])
            )
            cnt = int(counts[i])
            if flags[i] & 1:  # huff_raw
                syms = payload[:cnt]
            else:
                syms = table.fast_decode(payload, cnt)
            if flags[i] & 2:  # rle_raw
                res += syms[:n_out].tobytes()
            else:
                from tudocomp_tpu.compressors.rle import rle_decode

                res += rle_decode(syms, offset)[:n_out]
        return bytes(res)

    # -- device decode (one lane per segment; ops/hufdec_*.py) ---------------

    def decompress_device(self, data: bytes, *,
                          interpret: bool = False) -> bytes:
        """Decode on the device with the kernel ``backend.tbc2_decoder``
        picks; ``interpret=True`` (tests) runs the GPU kernel through
        the Pallas interpreter instead."""
        return self._decompress_device(
            data, backend.tbc2_decoder(interpret=interpret),
            interpret=interpret,
        )

    def _decompress_device(self, data: bytes, kernel: str, *,
                           interpret: bool = False) -> bytes:
        parsed = self._parse(data)
        orig_len, counts = parsed[2], parsed[3]
        if orig_len == 0:
            return b""
        out = np.empty((counts.shape[0], SEG), np.uint8)
        for idx, chars, ends in self._decode_batches(
            data, parsed, kernel, interpret=interpret
        ):
            out[idx] = expand_records(
                np.asarray(chars), np.asarray(ends)
            )[: idx.size]
        return out.reshape(-1)[:orig_len].tobytes()

    def _decode_batches(self, data: bytes, parsed, kernel: str, *,
                        interpret: bool = False):
        """Dispatch the device decode batch by batch; yields
        ``(segment indices, chars, ends)`` with the records still on
        the device. Segments are sorted by needed steps so each batch
        runs the shortest static step bucket that fits it
        (``hufdec_jax.S_BUCKETS``). Batch k is yielded only after
        batch k+1 is dispatched, so the caller's host finish of one
        overlaps the device work of the next."""
        table, offset, _, counts, flags, poff, pbytes = parsed
        t = decoder_tables(table)
        d = t["d"]
        tables = tuple(jnp.asarray(t[k]) for k in ("thresh", "offs", "syms"))
        flat = np.frombuffer(data, np.uint8)
        need = needed_steps(pbytes, counts, d)
        order = np.argsort(need, kind="stable")
        pending = None
        for lo in range(0, counts.shape[0], self.batch_lanes):
            idx = order[lo : lo + self.batch_lanes]
            steps = snap_steps(int(need[idx].max()))
            b = _bucket(idx.size)
            if kernel == "pallas":
                b = max(b, BLOCK)  # powers of two >= BLOCK tile it
            feed, bc, hrw, rrw = build_feed(
                flat, idx, counts, flags, poff, pbytes, steps, b
            )
            args = tuple(jnp.asarray(x) for x in (feed, bc, hrw, rrw))
            if kernel == "pallas":
                chars, ends = decode_segments_pallas(
                    *args, *tables, offset=offset, d=d,
                    interpret=interpret,
                )
            else:
                chars, ends = decode_segments(
                    *args, *tables, offset=offset, d=d
                )
            if pending is not None:
                yield pending
            pending = (idx, chars, ends)
        if pending is not None:
            yield pending
