"""Device suffix array / ISA / BWT via prefix doubling (SURVEY.md §7#5).

Replaces divsufsort's induced copying (``util/divsufsort/``) with the
sort-based formulation that maps onto a data-parallel device:

- one doubling round = ONE multi-key ``lax.sort`` carrying the suffix
  index as payload (lexicographic on (rank, rank[i+k])), plus one sort
  to land the new ranks back in position order;
- **no scatters or gathers anywhere**: every permutation application
  is a co-sort ("permute via sort" pattern), a choice made on hardware
  where scatters and gathers were slow and sorts fast, and re-decided
  by measurement on the GPU;
- ISA and BWT are likewise co-sorts: ``isa = sort(iota by sa)``,
  ``bwt[i] = text[sa[i]-1]`` = ``sort(text by isa[(j+1) mod n])``.

Outputs match the host specification ``ds/suffix.py`` exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

_I32 = jnp.int32


@jax.jit
def suffix_array_device(text: jnp.ndarray) -> jnp.ndarray:
    """SA of ``text`` (u8[N], N >= 1 static) as i32[N].

    A ``while_loop`` over doubling rounds (single compiled body; rounds
    end as soon as all ranks are distinct); the k-shift uses ``roll`` +
    mask so ``k`` can stay a traced value.
    """
    n = text.shape[0]
    idx = jnp.arange(n, dtype=_I32)

    def densify(keys1, keys2):
        """Sort by (keys1, keys2) and return dense ranks in text order."""
        s1, s2, s_idx = lax.sort(
            (keys1, keys2, idx), dimension=0, num_keys=2, is_stable=True
        )
        changed = jnp.concatenate(
            [
                jnp.zeros(1, _I32),
                ((s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])).astype(_I32),
            ]
        )
        new_rank_sorted = jnp.cumsum(changed)
        _, rank = lax.sort(
            (s_idx, new_rank_sorted), dimension=0, num_keys=1,
            is_stable=True,
        )
        return rank

    # round 0: dense byte ranks
    rank = densify(text.astype(_I32), jnp.zeros(n, _I32))

    def round_body(state):
        rank, k = state
        # rank[i + k], -1 past the end: dynamic_slice of a padded copy
        # (a roll with a traced shift lowers to a gather)
        padded = jnp.concatenate([rank, jnp.full(n, -1, _I32)])
        key2 = lax.dynamic_slice(padded, (k,), (n,))
        return densify(rank, key2), k * 2

    def not_done(state):
        rank, k = state
        return (jnp.max(rank) < n - 1) & (k < 2 * n)

    rank, _ = lax.while_loop(
        not_done, round_body, (rank, jnp.asarray(1, _I32))
    )
    _, sa = lax.sort(
        (rank, idx), dimension=0, num_keys=1, is_stable=True
    )
    return sa


@functools.partial(jax.jit, static_argnames=("L", "full"))
def suffix_array_isa_ranks(text: jnp.ndarray, *, L: int,
                           full: bool = True):
    """(sa, isa, {q: rank_q for q = 4..L}) in one doubling chain.

    ``full=False`` stops doubling at L and orders equal-L-gram groups
    by text position ("truncated suffix array"). For consumers that
    cap match lengths at L this is EXACT: suffixes with lcp < L sit in
    distinct L-groups (true lexicographic order), and within a group
    every pair's capped lcp is L, so any group-adjacent neighbor is an
    optimal capped candidate. The LZ77 matcher qualifies (its factors
    are strict back-references, src < pos, so decode order never needs
    the true rank); the lcpcomp candidate builder does NOT — its
    forward-factor acyclicity proof hops along strictly decreasing
    TRUE suffix ranks — and keeps ``full=True``. Skipping the residual
    doubling rounds saves ~log(n/L) co-sort pairs per block.

    The LZ77/lcpcomp matchers need the SA, the ISA, and exact q-gram
    equivalence classes at q = 4, 8, ..., L (``lzss_jax.rank_tables``).
    The doubling SA construction computes all of these as by-products:
    its round-k ranks ARE dense 2k-gram classes for every position with
    2k in-range characters (induction over rounds: two in-range grams
    compare equal iff their half-gram rank pairs do; truncated tails
    may alias each other under the -1 pad, unlike rank_tables' unique
    negative ids, but every consumer guards probes with
    ``pos <= n - q``), and its final distinct rank IS the ISA. The
    fused form saves rank_tables' seven co-sorts plus isa_device's one
    (~45 ms/MiB of the exact matcher's round-4 cost).

    The first log2(L) rounds are statically unrolled to capture the
    level snapshots; the remaining rounds run in the usual while_loop.
    """
    n = text.shape[0]
    idx = jnp.arange(n, dtype=_I32)

    def densify(keys1, keys2):
        s1, s2, s_idx = lax.sort(
            (keys1, keys2, idx), dimension=0, num_keys=2, is_stable=True
        )
        changed = jnp.concatenate(
            [
                jnp.zeros(1, _I32),
                ((s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])).astype(_I32),
            ]
        )
        new_rank_sorted = jnp.cumsum(changed)
        _, rank = lax.sort(
            (s_idx, new_rank_sorted), dimension=0, num_keys=1,
            is_stable=True,
        )
        return rank

    def shifted(rank, k: int):
        if k >= n:
            return jnp.full(n, -1, _I32)
        return jnp.concatenate([rank[k:], jnp.full(k, -1, _I32)])

    rank = densify(text.astype(_I32), jnp.zeros(n, _I32))
    ranks = {}
    k = 1
    while 2 * k <= L:
        rank = densify(rank, shifted(rank, min(k, n)))
        k *= 2
        if k >= 4:
            ranks[k] = rank

    if not full:
        # truncated order: (rank_L, position) — position ties inside
        # equal-L-gram groups; isa by inverting sa with one co-sort
        _, sa = lax.sort(
            (rank, idx), dimension=0, num_keys=2, is_stable=True
        )
        _, isa = lax.sort(
            (sa, idx), dimension=0, num_keys=1, is_stable=True
        )
        return sa, isa, ranks

    def round_body(state):
        rank, k = state
        padded = jnp.concatenate([rank, jnp.full(n, -1, _I32)])
        key2 = lax.dynamic_slice(padded, (k,), (n,))
        return densify(rank, key2), k * 2

    def not_done(state):
        rank, k = state
        return (jnp.max(rank) < n - 1) & (k < 2 * n)

    rank, _ = lax.while_loop(
        not_done, round_body, (rank, jnp.asarray(k, _I32))
    )
    _, sa = lax.sort(
        (rank, idx), dimension=0, num_keys=1, is_stable=True
    )
    return sa, rank, ranks


@jax.jit
def isa_device(sa: jnp.ndarray) -> jnp.ndarray:
    """Inverse permutation without scatter: co-sort iota by sa."""
    n = sa.shape[0]
    idx = jnp.arange(n, dtype=_I32)
    _, isa = lax.sort((sa.astype(_I32), idx), dimension=0, num_keys=1,
                      is_stable=True)
    return isa


@jax.jit
def bwt_device(text: jnp.ndarray, isa: jnp.ndarray) -> jnp.ndarray:
    """bwt[i] = text[(sa[i] - 1) mod n] without gather.

    ``text[j]`` must land at output position ``isa[(j+1) mod n]``; one
    co-sort by that destination key does it.
    """
    n = text.shape[0]
    dest = jnp.concatenate([isa[1:], isa[:1]])  # isa[(j+1) mod n]
    _, bwt = lax.sort(
        (dest, text.astype(_I32)), dimension=0, num_keys=1,
        is_stable=True,
    )
    return bwt.astype(jnp.uint8)


@jax.jit
def unbwt_device(bwt: jnp.ndarray) -> jnp.ndarray:
    """Inverse BWT of a 0-sentineled text's transform (u8[n] ->
    u8[n-1], sentinel stripped) — the reference's sequential LF walk
    (``ds/bwt.hpp:77-98``, host spec ``ds/bwt.py``) replaced by **orbit
    doubling**: LF is the inverse of the stable argsort of the BWT (two
    co-sorts, no scatter); the walk's full orbit ``t_k = LF^k(0)``
    materializes in ceil(log2 n) rounds via ``t[k+m] = LF^m(t[k])``
    while squaring ``LF^m`` — O(n log n) gathers, no sequential chase.
    Bit-identical to the host decode."""
    n = bwt.shape[0]
    idx = jnp.arange(n, dtype=_I32)
    _, order = lax.sort(
        (bwt.astype(_I32), idx), dimension=0, num_keys=1, is_stable=True
    )
    _, lf = lax.sort(
        (order, idx), dimension=0, num_keys=1, is_stable=True
    )
    orbit = jnp.zeros(n, _I32)  # t_0 = 0
    power = lf  # lf^m
    m = 1
    while m < n - 1:
        take = min(m, n - 1 - m)
        nxt = power[lax.dynamic_slice(orbit, (0,), (take,))]
        orbit = lax.dynamic_update_slice(orbit, nxt, (m,))
        m *= 2
        if m < n - 1:
            power = power[power]
    # host walk: out[n-1-j] = bwt[t_{j-1}] for j = 1..n-1
    return bwt[orbit[: n - 1]][::-1]
