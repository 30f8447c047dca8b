"""Device decoder for the TBC2 flagship container: the plain XLA form.

A ``lax.scan`` over the lockstep decode schedule. It is the CPU decoder
and the reference the GPU kernel (``ops/hufdec_pallas.py``) is tested
against. Reference decode semantics being reproduced: bit-by-bit
canonical walk ``coders/HuffmanCoder.hpp:377-397`` and RLE expansion
``compressors/RunLengthEncoder.hpp:36-49``.

Design (one segment = one SIMD lane, thousands of segments in lockstep):

1. **Word-fed scan.** xs feeds each lane one big-endian u32 of its
   payload per step. Each lane carries a 64-bit left-justified bit
   buffer (two i32 halves) plus the RLE parser state. Per step it
   decodes up to ``D = 11`` symbols (unrolled slots). With the table's
   minimum code length forced >= 3 (and raw segments at 8 bits/symbol),
   ``D * Lmin >= 32`` bits drain per full step, so the buffer never
   exceeds 63 bits — the feed schedule is static.
2. **Canonical length detection = 16 threshold compares.** The
   Managing-Gigabytes firstcode recurrence makes the 16-bit-scaled
   thresholds ``fc[l] << (16-l)`` monotone non-increasing in ``l``, so
   ``len = 1 + sum_l [window < thresh_l]`` — no argmin, no lookup.
3. **Symbol map.** ``sym_index -> byte`` is a 256-entry table gather.
4. **Fused RLE record parse.** The reference RLE state machine (armed
   previous char, vbyte accumulator) runs inside the same scan on each
   decoded byte, emitting per-slot ``(char, cumulative output end)``.
5. **No device compaction.** Slots that emit no record repeat the
   previous cumulative end, so the host finish — one global
   ``np.repeat`` over diff-of-ends deltas — consumes the positional
   arrays directly.

Container framing required: per segment ``count <= SEG`` symbols and
payload <= ``8 * count`` bits (the encoder's raw-escape flags guarantee
both), so the scan length is static: ``SEG*8/32`` feed steps + 3 drain
steps.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

SEG = 2048          # output bytes per segment
SEG_CAP = 2048      # max RLE bytes per segment (the rle_raw
                    # escape clamps counts to <= SEG)
D = 11              # decode slots per scan step (11 * min len 3 >= 32)
FEED_STEPS = SEG * 8 // 32   # 512: max payload words per segment
DEC_STEPS = FEED_STEPS + 3   # + drain steps (buffer <= 63 bits)

_I32 = jnp.int32
_BIG = jnp.int32(0x7FFFFFFF)

#: static scan-length buckets for payload-proportional decode: a batch
#: of segments runs the shortest bucket that fits its largest payload
#: (3 shapes -> 3 cached compiles; decode cost is linear in steps)
S_BUCKETS = (195, 323, DEC_STEPS)


def slots_for(min_len: int) -> int:
    """Decode slots per feed word for a table whose shortest code is
    ``min_len`` bits: d * min_len >= 32 keeps the buffer <= 63 bits
    (the drain invariant). min 3 -> 11, min 4 -> 8, min 5 -> 7."""
    return -(-32 // max(3, int(min_len)))


def needed_steps(pbytes, counts, d: int = D):
    """Minimal scan steps per segment: feed words + 3 drain steps, and
    enough slots for every symbol (steps * d >= count)."""
    pb = np.asarray(pbytes, np.int64)
    cn = np.asarray(counts, np.int64)
    return np.maximum(-(-pb // 4) + 3, -(-cn // d))


def snap_steps(need: int) -> int:
    """Smallest static bucket >= need."""
    for s in S_BUCKETS:
        if need <= s:
            return s
    return DEC_STEPS


def build_feed(flat, idx, counts, flags, poff, pbytes, steps: int,
               lanes: int):
    """Ragged payload gather into the decoders' fixed-shape inputs.

    flat u8[]: whole container; idx: segment indices for this batch;
    counts/flags/poff/pbytes: parsed per-segment metadata. Returns
    ``(feed u32[lanes, steps] big-endian, counts i32[lanes],
    huff_raw bool[lanes], rle_raw bool[lanes])`` zero-padded past
    ``idx.size``. Shared by the scan decoder, the Pallas decoder, the
    sharded mesh decode, and bench.py.
    """
    idx = np.asarray(idx)
    feed8 = np.zeros((lanes, steps * 4), np.uint8)
    ls = np.minimum(pbytes[idx], steps * 4)
    piece = np.repeat(np.arange(idx.size), ls)
    within = np.arange(int(ls.sum())) - np.repeat(
        np.cumsum(ls) - ls, ls
    )
    feed8[piece, within] = flat[poff[idx][piece] + within]
    feed = feed8.view(">u4").astype(np.uint32)
    bc = np.zeros(lanes, np.int32)
    bc[: idx.size] = counts[idx]
    hrw = np.zeros(lanes, bool)
    hrw[: idx.size] = (flags[idx] & 1).astype(bool)
    rrw = np.zeros(lanes, bool)
    rrw[: idx.size] = (flags[idx] & 2).astype(bool)
    return feed, bc, hrw, rrw


def decoder_tables(table):
    """Precompute scan-side arrays from a ``HuffmanTable``.

    Returns dict of numpy arrays: ``thresh`` i32[16] (16-bit-scaled
    firstcode thresholds, monotone non-increasing), ``offs`` i32[16]
    (sym_index = (window >> (16-l)) + offs[l-1]), ``syms`` i32[256]
    (sorted-symbol table) and ``d`` (slots per feed word). Requires max
    code length <= 16 and min >= 3 (the TBC2 encoder enforces both;
    11 slots * 3 bits >= one 32-bit feed word is the drain invariant).
    ``table=None`` (every segment huff_raw) gives tables that are never
    read.
    """
    if table is None:
        return {
            "thresh": np.zeros(16, np.int32),
            "offs": np.zeros(16, np.int32),
            "syms": np.zeros(256, np.int32),
            "d": D,
        }
    longest = table.longest
    assert 1 <= longest <= 16
    min_len = int(table.lengths.min())
    assert min_len >= 3, "device decode needs min len 3"
    fc = table.firstcode  # fc[l-1] = first code of length l
    numl = table.numl
    thresh = np.zeros(16, np.int64)
    for l in range(1, 17):
        if l <= longest:
            thresh[l - 1] = int(fc[l - 1]) << (16 - l)
        else:
            thresh[l - 1] = 0
    # monotonicity check (decode correctness depends on it)
    assert np.all(np.diff(thresh) <= 0), thresh
    start_of_len = np.concatenate([[0], np.cumsum(numl)]).astype(np.int64)
    offs = np.zeros(16, np.int64)
    for l in range(1, longest + 1):
        offs[l - 1] = start_of_len[l - 1] - int(fc[l - 1])
    syms = np.zeros(256, np.int32)
    syms[: table.symbols.size] = table.symbols
    return {
        "thresh": thresh.astype(np.int32),
        "offs": offs.astype(np.int32),
        "syms": syms,
        # slots per feed word for THIS table: a table whose shortest
        # code is >= 4 bits decodes with 8 slots instead of 11 (27%
        # less slot work) at the same schedule invariants
        "d": slots_for(min_len),
    }


@functools.partial(jax.jit, static_argnames=("offset", "d"))
def decode_segments(feed, counts, raw_flags, rle_raw_flags, thresh, offs,
                    syms, *, offset: int = 0, d: int = D):
    """Lockstep-decode a batch of segments.

    feed: u32[nseg, DEC_STEPS] big-endian payload words (zero padded)
    counts: i32[nseg] symbols (RLE bytes) per segment
    raw_flags: bool[nseg] huff_raw segments (8-bit verbatim symbols)
    rle_raw_flags: bool[nseg] segments whose symbols are verbatim output
        bytes (RLE layer bypassed — every symbol is a 1-byte record)
    thresh/offs: i32[16], syms: i32[256] from decoder_tables

    Returns ``(chars u8[nseg, S], ends u16[nseg, S])`` with one column
    per decode slot (S = steps * d): ``ends`` is the cumulative
    output position after each slot (monotone non-decreasing; a slot
    that emits no record repeats the previous value, so its delta is
    zero), ``chars`` the record character. The caller derives run
    lengths by differencing ends and expands with one np.repeat.
    """
    nseg = feed.shape[0]
    feed_t = lax.bitcast_convert_type(
        feed.astype(jnp.uint32), _I32
    ).T  # [steps, nseg]
    thresh = thresh.astype(_I32)
    offs = offs.astype(_I32)
    syms = syms.astype(_I32)
    raw = raw_flags.astype(jnp.bool_)
    rleraw = rle_raw_flags.astype(jnp.bool_)
    counts = counts.astype(_I32)

    def step(carry, w):
        (hi, lo, bits, done, armed, vb_pend, vb_char, vb_acc, out_end) = carry
        # refill: place w's 32 bits after the `bits` valid bits. Skip
        # when bits > 31 (finished lanes) — the buffer must stay <= 63.
        refill = bits <= 31
        sh = jnp.minimum(bits, 31)
        sh1 = jnp.maximum(sh, 1)  # keep shift args in [0, 31]
        hi = jnp.where(
            refill,
            hi | jnp.where(sh == 0, w, lax.shift_right_logical(w, sh)),
            hi,
        )
        lo = jnp.where(
            refill,
            lo | jnp.where(sh == 0, _I32(0), w << (32 - sh1)),
            lo,
        )
        bits = bits + jnp.where(refill, 32, 0)

        def slot(sc, _):
            (hi, lo, bits, done, armed, vb_pend, vb_char, vb_acc,
             out_end) = sc
            win = lax.shift_right_logical(hi, 16)  # top 16 bits
            ln = 1 + jnp.sum(
                (win[:, None] < thresh[None, :]).astype(_I32), axis=1
            )
            ln = jnp.minimum(ln, 16)
            # raw segments: fixed 8-bit symbols, byte = top 8 bits
            ln = jnp.where(raw, _I32(8), ln)
            prefix = lax.shift_right_logical(win, 16 - ln)
            lhot = ln[:, None] == (1 + jnp.arange(16, dtype=_I32))[None, :]
            off_sel = jnp.sum(jnp.where(lhot, offs[None, :], 0), axis=1)
            idx = jnp.clip(prefix + off_sel, 0, 255)
            byte = jnp.where(raw, lax.shift_right_logical(win, 8), syms[idx])
            valid = (bits >= 16) & (done < counts)
            take = jnp.where(valid, ln, 0)
            take1 = jnp.maximum(take, 1)  # keep shift args in [1, 16]
            # consume
            hi = jnp.where(
                take == 0, hi,
                (hi << take1) | lax.shift_right_logical(lo, 32 - take1),
            )
            lo = jnp.where(take == 0, lo, lo << take1)
            bits = bits - take
            done = done + valid.astype(_I32)

            # RLE record state machine (reference RunLengthEncoder.hpp)
            is_vb = vb_pend > 0
            shift7 = 7 * jnp.maximum(vb_pend - 1, 0)
            new_acc = vb_acc | ((byte & 0x7F) << shift7)
            cont = (byte & 0x80) != 0
            trig = (~is_vb) & (byte == armed) & ~rleraw
            delta = jnp.where(
                ~valid, 0,
                jnp.where(
                    is_vb & ~cont, new_acc - offset + 1,
                    jnp.where(is_vb | trig, 0, 1),
                ),
            )
            delta = jnp.clip(delta, 0, SEG)
            char = jnp.where(is_vb, vb_char, byte)
            vb_pend = jnp.where(
                ~valid, vb_pend,
                jnp.where(
                    is_vb,
                    jnp.where(cont, jnp.minimum(vb_pend + 1, 3), 0),
                    jnp.where(trig, 1, 0),
                ),
            )
            vb_char = jnp.where(valid & trig, byte, vb_char)
            vb_acc = jnp.where(
                ~valid, vb_acc, jnp.where(is_vb & cont, new_acc, 0)
            )
            armed = jnp.where(valid & ~is_vb, byte, armed)
            out_end = jnp.minimum(out_end + delta, SEG)
            sc = (hi, lo, bits, done, armed, vb_pend, vb_char, vb_acc,
                  out_end)
            return sc, (char.astype(jnp.uint8), out_end.astype(jnp.uint16))

        carry, (ch, en) = lax.scan(
            slot,
            (hi, lo, bits, done, armed, vb_pend, vb_char, vb_acc, out_end),
            None, length=d,
        )
        return carry, (ch, en)

    z = jnp.zeros(nseg, _I32)
    init = (z, z, z, z, jnp.full(nseg, -1, _I32), z, z, z, z)
    _, (ys_char, ys_end) = lax.scan(step, init, feed_t)
    # [steps, D, nseg] -> slot-major per lane [nseg, steps*D]
    chars = ys_char.transpose(2, 0, 1).reshape(nseg, -1)
    ends = ys_end.transpose(2, 0, 1).reshape(nseg, -1)
    return chars, ends


def expand_records(chars: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Host finish: one global np.repeat over all lanes' record slots.

    chars u8 / ends u16: [nseg, S] from a decoder (ends monotone per
    lane, <= SEG; zero-delta slots carry no record). Returns
    ``u8[nseg, SEG]``: each lane's output, zero-padded to SEG bytes (a
    final record per lane fills the pad), so callers place whole rows
    and cut the last segment to the original length.
    """
    n = ends.shape[0]
    e = np.concatenate(
        [
            np.zeros((n, 1), np.int32),
            np.asarray(ends, np.int32),
            np.full((n, 1), SEG, np.int32),
        ],
        axis=1,
    )
    ch = np.concatenate(
        [np.asarray(chars, np.uint8), np.zeros((n, 1), np.uint8)], axis=1
    )
    return np.repeat(ch.ravel(), np.diff(e, axis=1).ravel()).reshape(n, SEG)
