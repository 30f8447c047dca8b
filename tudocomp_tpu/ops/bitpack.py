"""Device-side bit packing: the universal variable-length output kernel.

Everything in the framework funnels through this op (SURVEY.md §7 "hard
parts" #4): encoders produce token arrays ``(values, lens)`` — ``lens[i]``
MSB-first bits of ``values[i]`` — and this module packs them into big-endian
``uint32`` words entirely on device:

1. bit offsets   = exclusive prefix sum of lens (``jnp.cumsum``)
2. word index    = offset >> 5 — *sorted*, because offsets are monotone
3. contributions = value shifted into word position; a token straddles at
                   most 2 words (lens <= 32)
4. reduction     = ``segment_sum`` with sorted segment ids (bit ranges are
                   disjoint, so add == or) — no generic scatter needed.

Zero-length tokens contribute nothing, so fixed-shape padding under ``jit``
is simply "pad with lens == 0".

The host specification packer lives in ``io/bitio.py``; tests pin
bit-identical output.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tudocomp_tpu.io.bitio import finalize_stream

_U32 = jnp.uint32


def bits_for_u32(v: jnp.ndarray) -> jnp.ndarray:
    """Vectorized bits_for over uint32 (bits_for(0) == 1), exact."""
    v = v.astype(_U32)
    out = jnp.zeros(v.shape, _U32)
    for shift in (16, 8, 4, 2, 1):
        m = v >= (_U32(1) << _U32(shift))
        out = out + jnp.where(m, _U32(shift), _U32(0))
        v = jnp.where(m, v >> _U32(shift), v)
    return jnp.maximum(out + _U32(1), _U32(1))


def _token_parts(values: jnp.ndarray, lens: jnp.ndarray,
                 offs: jnp.ndarray):
    """Each token's two word contributions: ``part1`` into word
    ``offs >> 5`` and ``spill`` into the next word (lens <= 32)."""
    mask = jnp.where(
        lens >= _U32(32),
        _U32(0xFFFFFFFF),
        (_U32(1) << jnp.minimum(lens, _U32(31))) - _U32(1),
    )
    v = values & mask
    bitpos = offs & _U32(31)
    # signed shift: 32 - bitpos - len in [-31, 32]
    sh = 32 - bitpos.astype(jnp.int32) - lens.astype(jnp.int32)
    lsh = jnp.clip(sh, 0, 31).astype(_U32)
    rsh = jnp.clip(-sh, 0, 31).astype(_U32)
    part1 = jnp.where(sh >= 0, v << lsh, v >> rsh)
    spill = jnp.where(
        sh < 0,
        (v & ((_U32(1) << rsh) - _U32(1))) << (_U32(32) - rsh),
        _U32(0),
    )
    return part1, spill


def pack_tokens_device(values: jnp.ndarray, lens: jnp.ndarray):
    """Pack tokens (lens <= 32) into big-endian uint32 words on device.

    Returns ``(words: uint32[N+1], total_bits: int32)``. ``N+1`` words always
    suffice: total bits <= 32*N. Padding tokens must have ``lens == 0``.
    """
    n = values.shape[0]
    values = values.astype(_U32)
    lens = lens.astype(_U32)
    ends = jnp.cumsum(lens, dtype=jnp.uint32)
    total = ends[-1] if n else jnp.uint32(0)
    offs = ends - lens
    part1, spill = _token_parts(values, lens, offs)
    w0 = (offs >> _U32(5)).astype(jnp.int32)
    n_words = n + 1
    words = jax.ops.segment_sum(
        part1, w0, num_segments=n_words, indices_are_sorted=True
    ) + jax.ops.segment_sum(
        spill, w0 + 1, num_segments=n_words, indices_are_sorted=True
    )
    return words.astype(_U32), total.astype(jnp.int32)


def pack_token_rows(values: jnp.ndarray, lens: jnp.ndarray, n_words: int):
    """Pack each row of ``[R, N]`` tokens (lens <= 32) into its own
    big-endian word stream starting at bit 0.

    Returns ``(words: uint32[R, n_words], total_bits: int32[R])``: a
    row's bits past ``32 * n_words`` are dropped, its total counts them
    all. One flat sorted ``segment_sum`` over every row: each row owns
    ``n_words + 1`` output slots, the last one collecting the dropped
    bits.
    """
    r, n = values.shape
    values = values.astype(_U32)
    lens = lens.astype(_U32)
    ends = jnp.cumsum(lens, axis=1, dtype=jnp.uint32)
    total = ends[:, -1] if n else jnp.zeros(r, _U32)
    offs = ends - lens
    part1, spill = _token_parts(values, lens, offs)
    w0 = (offs >> _U32(5)).astype(jnp.int32)
    base = (jnp.arange(r, dtype=jnp.int32) * (n_words + 1))[:, None]
    slots = r * (n_words + 1)
    words = jax.ops.segment_sum(
        part1.reshape(-1),
        (base + jnp.minimum(w0, n_words)).reshape(-1),
        num_segments=slots, indices_are_sorted=True,
    ) + jax.ops.segment_sum(
        spill.reshape(-1),
        (base + jnp.minimum(w0 + 1, n_words)).reshape(-1),
        num_segments=slots, indices_are_sorted=True,
    )
    words = words.reshape(r, n_words + 1)[:, :n_words]
    return words.astype(_U32), total.astype(jnp.int32)


def unpack_fixed(
    words: jnp.ndarray, start_bit, width: int, count: int
) -> jnp.ndarray:
    """Read ``count`` consecutive ``width``-bit ints (1 <= width <= 32).

    ``words`` are big-endian uint32; ``start_bit`` may be traced. The words
    array must have at least one word of slack past the last read.
    """
    offs = jnp.asarray(start_bit, jnp.int32) + jnp.arange(
        count, dtype=jnp.int32
    ) * jnp.int32(width)
    w0 = offs >> 5
    bitpos = (offs & 31).astype(_U32)
    hi = words[w0].astype(_U32)
    lo = words[jnp.minimum(w0 + 1, words.shape[0] - 1)].astype(_U32)
    merged = (hi << bitpos) | jnp.where(
        bitpos > 0, lo >> (_U32(32) - bitpos), _U32(0)
    )
    return merged >> _U32(32 - width) if width < 32 else merged


def words_to_stream(words: np.ndarray, total_bits: int) -> bytes:
    """Host: trim big-endian words to the payload and finalize."""
    total_bits = int(total_bits)
    payload = (
        np.asarray(words, dtype=np.uint32)
        .astype(">u4")
        .view(np.uint8)[: (total_bits + 7) // 8]
    )
    return finalize_stream(payload, total_bits)


def stream_to_words(payload: np.ndarray) -> np.ndarray:
    """Host: payload bytes -> big-endian uint32 words (padded with slack)."""
    payload = np.asarray(payload, dtype=np.uint8)
    pad = (-payload.size) % 4 + 4  # alignment + one word of slack
    padded = np.concatenate([payload, np.zeros(pad, np.uint8)])
    return padded.view(">u4").astype(np.uint32)
