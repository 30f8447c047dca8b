"""Device-side Huffman: masked histogram + table-driven gather-encode.

The device formulation of the reference coder (``coders/HuffmanCoder.hpp``):
the *table* (an inherently sequential ~256-element problem) is built on
host from a device-computed histogram; encode is then a pure gather
``(sym_code[b], sym_len[b])`` followed by the universal bitpack kernel.
Across devices, per-shard histograms merge with ``psum`` and the shared
table broadcasts to all shards (SURVEY.md §2.7).

Codeword lengths are limited to <= 31 bits so a codeword always fits one
packer token (see ``limit_codelengths`` in ``coders/huffman.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tudocomp_tpu.ops.bitpack import pack_tokens_device

_U32 = jnp.uint32


def masked_histogram(data: jnp.ndarray, length) -> jnp.ndarray:
    """256-bin histogram of the first ``length`` bytes of each row of
    ``data`` (uint8 ``[..., N]``; ``length`` is a scalar or one value
    per row)."""
    n = data.shape[-1]
    w = (
        jnp.arange(n) < jnp.asarray(length)[..., None]
    ).astype(_U32)
    w = jnp.broadcast_to(w, data.shape)
    return jnp.zeros(256, _U32).at[data.astype(jnp.int32)].add(w)


def lookup_codes(flat_u8: jnp.ndarray, sym_code: jnp.ndarray,
                 sym_len: jnp.ndarray):
    """(codeword, length) per byte: two 256-entry table gathers."""
    idx = flat_u8.astype(jnp.int32)
    return sym_code.astype(_U32)[idx], sym_len.astype(_U32)[idx]


def huffman_encode_tokens(
    data: jnp.ndarray, length, sym_code: jnp.ndarray, sym_len: jnp.ndarray
):
    """Token arrays coding the first ``length`` bytes of each row of
    ``data`` (``[..., N]``; ``length`` scalar or per row) with a
    canonical table."""
    values, lens = lookup_codes(data, sym_code, sym_len)
    mask = jnp.arange(data.shape[-1]) < jnp.asarray(length)[..., None]
    return values, jnp.where(mask, lens, _U32(0))


def huffman_pack_device(
    data: jnp.ndarray, length, sym_code: jnp.ndarray, sym_len: jnp.ndarray
):
    """Gather-encode + pack. Returns ``(words, total_bits)``."""
    values, lens = huffman_encode_tokens(
        data.reshape(-1), length, sym_code, sym_len
    )
    return pack_tokens_device(values, lens)


# ---------------------------------------------------------------------------
# Device-side canonical table construction
# ---------------------------------------------------------------------------
#
# The table build is the one encode stage on the host; it costs a
# device->host sync plus host work in the middle of the pipeline.
# This builds the EXACT same table on device (bit-identical to
# coders/huffman.py ``HuffmanTable.from_counts(hist, max_len, min_len)`` — pinned by
# tests/test_huffman_device_table.py), so encode needs no mid-stream
# host round trip.
#
# The 255-step two-queue merge reproduces the host heapq order exactly:
# the heap pops ascending (count, index) with leaf indices < merged
# indices, which is "prefer the leaf queue on count ties"; merged
# counts are non-decreasing in creation order, so a FIFO queue is a
# faithful heap for them.


def _codelengths_device(counts: jnp.ndarray) -> jnp.ndarray:
    """Optimal code lengths for 256 positive i32 counts — exact mirror
    of ``coders/huffman.py gen_codelengths`` (heapq on (count, index));
    total count must stay < 2^31."""
    from jax import lax

    i32 = jnp.int32
    INF = jnp.int32(2**31 - 1)
    idx256 = jnp.arange(256, dtype=i32)
    idx255 = jnp.arange(255, dtype=i32)
    sc, ssym = lax.sort((counts.astype(i32), idx256), num_keys=1)

    def pick(i1, i2, created, q2):
        c1 = jnp.where(i1 < 256, sc[jnp.clip(i1, 0, 255)], INF)
        c2 = jnp.where(i2 < created, q2[jnp.clip(i2, 0, 254)], INF)
        take1 = c1 <= c2  # count tie -> leaf (smaller heap index) wins
        return (
            jnp.where(take1, c1, c2),
            take1,
            jnp.where(take1, i1, i2),
            i1 + take1.astype(i32),
            i2 + (1 - take1.astype(i32)),
        )

    def step(state, k):
        # carry holds only the queue cursors and the merged-count queue
        # (updated via one single-element dynamic set); WHICH item each
        # pick took is emitted as a scan output and scattered into
        # pl/pi vectorized after the loop — every leaf/node is popped
        # exactly once, so the post-scatters never collide.
        i1, i2, q2 = state
        ca, leafa, ia, i1, i2 = pick(i1, i2, k, q2)
        cb, leafb, ib, i1, i2 = pick(i1, i2, k, q2)
        q2 = q2.at[k].set(ca + cb)
        return (i1, i2, q2), (ia, leafa, ib, leafb)

    init = (i32(0), i32(0), jnp.zeros(255, i32))
    (i1, i2, q2), (ia, leafa, ib, leafb) = lax.scan(
        step, init, jnp.arange(255, dtype=i32), unroll=8
    )
    ks = jnp.arange(255, dtype=i32)
    pl = jnp.zeros(256, i32)
    pl = pl.at[jnp.where(leafa, ia, 256)].set(ks, mode="drop")
    pl = pl.at[jnp.where(leafb, ib, 256)].set(ks, mode="drop")
    pi = jnp.zeros(255, i32)
    pi = pi.at[jnp.where(leafa, 255, ia)].set(ks, mode="drop")
    pi = pi.at[jnp.where(leafb, 255, ib)].set(ks, mode="drop")

    # internal-node depths by pointer doubling (root = 254, depth 0)
    jump = jnp.where(idx255 == 254, 254, pi)
    d = jnp.where(idx255 == 254, 0, 1).astype(i32)
    for _ in range(8):  # 2^8 >= 255 covers any tree depth
        d = d + d[jump]
        jump = jump[jump]
    leaf_depth_sorted = 1 + d[pl]
    # back to symbol order
    _, lengths = lax.sort((ssym, leaf_depth_sorted), num_keys=1)
    return lengths


import functools


@functools.partial(jax.jit, static_argnames=("max_len", "min_len"))
def device_table_build(hist: jnp.ndarray, *, max_len: int = 16,
                       min_len: int = 3):
    """(sym_code u32[256], sym_len u32[256]) from a 256-bin histogram
    with ALL bins positive, bit-identical to the host
    ``HuffmanTable.from_counts(hist, max_len, min_len)`` +
    ``BlockCodec._device_table`` pair. Runs entirely on device — no
    host sync on the encode critical path."""
    from jax import lax

    i32 = jnp.int32
    counts0 = jnp.maximum(hist.astype(i32), 1)

    def cond(state):
        _, lengths = state
        return jnp.max(lengths) > max_len

    def body(state):
        counts, _ = state
        counts = (counts + 1) // 2
        return counts, _codelengths_device(counts)

    _, lengths = lax.while_loop(
        cond, body, (counts0, _codelengths_device(counts0))
    )
    lengths = jnp.maximum(lengths, min_len)

    # canonical assignment, mirroring HuffmanTable.__init__ +
    # _gen_firstcodes (ceiling division; zero-padded numl above the
    # dynamic longest leaves firstcode = 0 all the way down, so a
    # fixed-size recurrence is exact)
    order_len, order_sym = lax.sort(
        (lengths, jnp.arange(256, dtype=i32)), num_keys=1
    )
    numl = jnp.sum(
        lengths[None, :] == jnp.arange(1, max_len + 1, dtype=i32)[:, None],
        axis=1,
    )  # numl[l-1] = #codes of length l
    fc = jnp.zeros(max_len, i32)
    for i in range(max_len - 1, 0, -1):
        fc = fc.at[i - 1].set((fc[i] + numl[i] + 1) // 2)
    start_of_len = jnp.concatenate(
        [jnp.zeros(1, i32), jnp.cumsum(numl)[:-1]]
    )
    rank = jnp.arange(256, dtype=i32) - start_of_len[order_len - 1]
    codewords = fc[order_len - 1] + rank
    sym_code = jnp.zeros(256, _U32).at[order_sym].set(
        codewords.astype(_U32)
    )
    sym_len = jnp.zeros(256, _U32).at[order_sym].set(
        order_len.astype(_U32)
    )
    return sym_code, sym_len
