"""Device run-length encoding as a token-emission kernel.

Format: the reference scheme (``compressors/RunLengthEncoder.hpp``: run of
n >= 2 equal bytes -> byte, byte, vbyte(n - 2 + offset); single byte
verbatim) with one device-friendly amendment — **runs are split into pieces of
at most RUN_CAP = 8192 bytes**. The first piece of a run uses the doubled
char; continuation pieces of length L emit the char ONCE followed by
vbyte(L - 1 + offset), because the reference decoder keeps ``prev``
armed after a run, so a single repeat char triggers the vbyte read and
expands to ``run + 1`` copies. Split output is therefore decodable by
the reference tool; the size cost is 3 bytes per 8 KiB of run, and the
gain is that every piece emits ONE <= 32-bit token (char or
char[,char],vbyte<=2B merged), so the stream is exactly one token slot
per input byte:

1. run boundaries   = elementwise neq with left neighbor
2. start-of-run     = forward cummax of boundary indices — the ONLY scan
3. piece ends       = elementwise: next char differs, end of input, or
                      (i - sor) hits the cap; piece length is local math
4. token emission   = at piece *ends* (stream order preserved), zero-len
                      tokens elsewhere
5. packing          = the Pallas bitpack kernel

Bit-exact vs the host specification ``compressors/rle.py:rle_encode``.
Positions >= ``length`` (fixed-shape padding) emit nothing and never
merge with real runs.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from tudocomp_tpu.ops.bitpack import pack_tokens_device

_U32 = jnp.uint32
_I32 = jnp.int32

RUN_CAP = 8192  # max piece length; keeps vbyte(n-2+offset) <= 2 bytes


def vbyte2_token(v: jnp.ndarray):
    """vbyte of ``v < 2**14`` as one MSB-first token ``(value, bits)``."""
    v = v.astype(_U32)
    two = v >= _U32(1 << 7)
    b0 = (v & _U32(0x7F)) | jnp.where(two, _U32(0x80), _U32(0))
    b1 = (v >> _U32(7)) & _U32(0x7F)
    value = jnp.where(two, (b0 << _U32(8)) | b1, b0)
    bits = jnp.where(two, 16, 8)
    return value, bits


def rle_tokens(block: jnp.ndarray, length, offset: int = 0):
    """RLE token arrays for ``block[:length]`` — ONE token per position.

    Returns ``(values: u32[N], lens: u32[N])`` in stream order (tokens
    are emitted at piece ends).
    """
    assert 0 <= offset < RUN_CAP // 2
    a = block.astype(_U32)
    n = a.shape[0]
    idx = jnp.arange(n, dtype=_I32)
    length = jnp.asarray(length, _I32)
    boundary = jnp.concatenate(
        [jnp.ones(1, bool), a[1:] != a[:-1]]
    ) | (idx >= length)
    # start of own run: forward cummax of boundary positions
    sor = lax.cummax(jnp.where(boundary, idx, _I32(0)))
    # piece end: next position starts a new run / is padding / cap hit
    next_boundary = jnp.concatenate(
        [boundary[1:], jnp.ones(1, bool)]
    ) | (idx + 1 >= length)
    since = idx - sor
    piece_len = (since % RUN_CAP) + 1
    is_end = (next_boundary | (piece_len == RUN_CAP)) & (idx < length)
    is_cont = since >= RUN_CAP  # continuation piece (not first of run)
    is_run = is_cont | (piece_len >= 2)
    vb_val, vb_bits = vbyte2_token(
        jnp.maximum(
            jnp.where(is_cont, piece_len - 1, piece_len - 2) + offset, 0
        ).astype(_U32)
    )
    cc = jnp.where(is_cont, a, (a << _U32(8)) | a)
    head_bits = jnp.where(is_cont, 8, 16)
    run_val = (cc << vb_bits.astype(_U32)) | vb_val
    run_bits = head_bits + vb_bits
    values = jnp.where(is_run, run_val, a)
    lens = jnp.where(is_end, jnp.where(is_run, run_bits, 8), 0)
    return values, lens.astype(_U32)


def rle_encode_device(block: jnp.ndarray, length, offset: int = 0):
    """Single-chunk RLE byte stream (reference packer; kernels use
    ``models/blockcodec.py``'s batched path). Returns (words, n_bytes)."""
    values, lens = rle_tokens(block, length, offset)
    words, total_bits = pack_tokens_device(values, lens)
    return words, total_bits >> 3


def bytes_from_words(words: jnp.ndarray, count: int) -> jnp.ndarray:
    """First ``count`` (static) bytes of a big-endian uint32 word buffer."""
    b = jnp.stack(
        [(words >> _U32(sh)) & _U32(0xFF) for sh in (24, 16, 8, 0)],
        axis=-1,
    ).reshape(*words.shape[:-1], -1)
    return b[..., :count].astype(jnp.uint8)
