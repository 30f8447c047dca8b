"""TBC2 segment decoder as one Pallas kernel on the Triton route (GPU).

Same lockstep decode schedule as the XLA scan in ``hufdec_jax.py``
(reference semantics: canonical walk ``coders/HuffmanCoder.hpp:377-397``
+ RLE expansion ``compressors/RunLengthEncoder.hpp:36-49``), but the
whole step loop runs inside one kernel with each lane's decoder state
in registers. The scan pays one while-loop iteration per slot and keeps
its state in device memory between them.

Layout (one segment = one lane = one thread):

- a program owns ``BLOCK`` consecutive lanes (blocks run in any order;
  nothing carries between programs);
- feed ``i32[steps, nseg]`` is step-major, so each step's load of the
  block's words is one coalesced row;
- records ``i32[steps * d, nseg]`` (``char << 16 | end``) are
  slot-major, so each slot's store is one coalesced row;
- the 16 thresholds and 16 offsets are loaded once per program; the
  symbol map is a gather from the 1 KiB 256-entry table.

Bit-identical to ``hufdec_jax.decode_segments`` by construction: same
refill rule, same 16-threshold length detection, same symbol map, same
fused RLE record state machine, same slot validity rule. Every shift
amount stays inside [0, 31] (Triton leaves wider shifts undefined where
XLA gives 0); the clamps ``sh1``/``take1`` and the ``16 - ln`` bound
keep them there.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from tudocomp_tpu.ops.hufdec_jax import D, SEG

#: lanes per program: one lane per thread of NUM_WARPS warps
BLOCK = 128
NUM_WARPS = 4

_I32 = jnp.int32


def _srl(x, n):
    return lax.shift_right_logical(x, jnp.broadcast_to(_I32(n), x.shape)
                                   if isinstance(n, int) else n)


def _decode_kernel(thresh_ref, offs_ref, syms_ref, feed_ref, counts_ref,
                   raw_ref, rleraw_ref, out_ref, *, offset: int, steps: int,
                   d: int):
    thresh = [thresh_ref[l] for l in range(16)]
    offs = [offs_ref[l] for l in range(16)]
    counts = counts_ref[...]
    raw = raw_ref[...] != 0
    rleraw = rleraw_ref[...] != 0

    def step(t, carry):
        (hi, lo, bits, done, armed, vb_pend, vb_char, vb_acc,
         out_end) = carry
        w = feed_ref[t, :]
        # refill: place w's 32 bits after the `bits` valid bits
        refill = bits <= 31
        sh = jnp.minimum(bits, 31)
        sh1 = jnp.maximum(sh, 1)
        hi = jnp.where(
            refill, hi | jnp.where(sh == 0, w, _srl(w, sh)), hi
        )
        lo = jnp.where(
            refill, lo | jnp.where(sh == 0, _I32(0), w << (32 - sh1)), lo
        )
        bits = bits + jnp.where(refill, 32, 0)

        for slot_i in range(d):
            win = _srl(hi, 16)
            ln = jnp.ones_like(win)
            for l in range(16):
                ln = ln + (win < thresh[l]).astype(_I32)
            ln = jnp.minimum(ln, 16)
            ln = jnp.where(raw, _I32(8), ln)
            prefix = _srl(win, 16 - ln)
            off_sel = jnp.zeros_like(win)
            for l in range(16):
                off_sel = jnp.where(ln == l + 1, offs[l], off_sel)
            idx = jnp.clip(prefix + off_sel, 0, 255)
            byte = jnp.where(raw, _srl(win, 8), syms_ref[idx])
            valid = (bits >= 16) & (done < counts)
            take = jnp.where(valid, ln, 0)
            take1 = jnp.maximum(take, 1)
            hi = jnp.where(
                take == 0, hi, (hi << take1) | _srl(lo, 32 - take1)
            )
            lo = jnp.where(take == 0, lo, lo << take1)
            bits = bits - take
            done = done + valid.astype(_I32)

            # RLE record state machine (RunLengthEncoder.hpp semantics)
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
            out_ref[t * d + slot_i, :] = (char << 16) | out_end
        return (hi, lo, bits, done, armed, vb_pend, vb_char, vb_acc,
                out_end)

    z = jnp.zeros((BLOCK,), _I32)
    init = (z, z, z, z, jnp.full((BLOCK,), -1, _I32), z, z, z, z)
    lax.fori_loop(0, steps, step, init)


@functools.partial(
    jax.jit, static_argnames=("offset", "interpret", "d")
)
def decode_segments_pallas(feed, counts, raw_flags, rle_raw_flags, thresh,
                           offs, syms, *, offset: int = 0, d: int = D,
                           interpret: bool = False):
    """Drop-in for ``hufdec_jax.decode_segments``: same arguments (feed
    u32[nseg, steps], nseg % BLOCK == 0) and the same result
    ``(chars u8[nseg, steps*d], ends u16[nseg, steps*d])``."""
    nseg, steps = feed.shape
    assert nseg % BLOCK == 0, nseg
    feed_t = lax.bitcast_convert_type(feed.astype(jnp.uint32), _I32).T
    kernel = functools.partial(
        _decode_kernel, offset=offset, steps=steps, d=d
    )
    lanes = pl.BlockSpec((BLOCK,), lambda i: (i,))
    packed = pl.pallas_call(
        kernel,
        grid=(nseg // BLOCK,),
        in_specs=[
            pl.BlockSpec((16,), lambda i: (0,)),
            pl.BlockSpec((16,), lambda i: (0,)),
            pl.BlockSpec((256,), lambda i: (0,)),
            pl.BlockSpec((steps, BLOCK), lambda i: (0, i)),
            lanes, lanes, lanes,
        ],
        out_specs=pl.BlockSpec((steps * d, BLOCK), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((steps * d, nseg), _I32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="tbc2_decode",
    )(
        jnp.asarray(thresh, _I32), jnp.asarray(offs, _I32),
        jnp.asarray(syms, _I32), feed_t, counts.astype(_I32),
        raw_flags.astype(_I32), rle_raw_flags.astype(_I32),
    )
    packed = packed.T
    return (
        _srl(packed, 16).astype(jnp.uint8),
        (packed & 0xFFFF).astype(jnp.uint16),
    )
