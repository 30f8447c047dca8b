"""Device lcpcomp factorization: parallel greedy rounds, no scatters.

Puts the reference flagship's factorization (greedy longest-first over
the LCP array, ``compressors/lcpcomp/compress/ArraysComp.hpp:22-117``)
on the device as an array program.  Two reformulations make the
sequential algorithm data-parallel:

1. **Truncation as a pure function of the covered set.**  The
   reference erases LCP entries starting inside a replaced interval and
   caps entries before it at their distance (``ArraysComp.hpp:92-112``,
   here ``lcpcomp.py::_emit_factor``).  Both rules collapse to::

       el[p] = min(LCP[isa[p]], next_covered(p) - p)

   where ``next_covered(p)`` is the first covered position ``>= p`` —
   one reversed cumulative min per round instead of per-factor scatter
   updates.

2. **Max-class rounds are a legal sequential schedule.**  Each round
   selects, among candidates of the *current maximum* effective length
   ``L``, a pairwise-disjoint set (window-dominant: a candidate wins if
   it is the leftmost of its class within any overlapping window).
   Equal-length disjoint targets never truncate each other (a target
   wholly before another caps it at a distance >= L, a target after is
   untouched), so emitting a round's set simultaneously equals *some*
   order of the reference's per-bucket pops — the device output is a
   factorization the reference's arrays strategy could emit, inheriting
   its invariants (disjoint targets, resolvable chains).

Selection and covering are each ONE cumulative max: "leftmost of the
class within any overlapping window" is equivalent to "previous class
member at least ``cur_max`` away", and "covered by some selected
interval" to "last selected start within ``cur_max``" — zero scatters,
zero gathers, zero per-element loops (the round-3 doubling-table
windows cost ~580 ms/round on chip; scans are ~2 ms).  Factor lengths
are capped at ``max_len`` (4096): one prefix-doubling rank level per
doubling, same trade as the exact device LZ77.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_I32 = jnp.int32


@functools.partial(jax.jit, static_argnames=("max_len",))
def _all_rounds(covered, chosen, lcp0_p, threshold, *, max_len: int):
    """Run max-class selection rounds to convergence in ONE dispatch.

    covered  bool[n]   — union of emitted target intervals
    chosen   i32[n]    — emitted factor length at its start (0 = none)
    lcp0_p   i32[n]    — LCP with the SA-predecessor, by text position
    Returns (covered, chosen, rounds). The convergence test
    (``cur_max < threshold``) runs on device inside a
    ``lax.while_loop``, so the loop needs no host round trip per
    round.
    """
    n = covered.shape[0]
    pos = jnp.arange(n, dtype=_I32)

    # dyadic window levels: candidate lengths are capped at max_len,
    # so attacks come from distances <= max_len and the right check
    # needs one window of size >= max_len
    n_levels = 1
    while (1 << n_levels) < max_len:
        n_levels += 1

    def one_round(state):
        covered, chosen = state
        ncov = lax.cummin(
            jnp.where(covered, pos, n), reverse=True
        )
        el = jnp.minimum(lcp0_p, ncov - pos)
        active = el >= threshold
        cur_max = jnp.max(jnp.where(active, el, 0))
        # cur_max doubles as the loop condition for the NEXT iteration
        # (one lagged no-op round instead of recomputing the residual
        # scan chain a second time per round)

        # **Local-dominance selection** (Luby-MIS shape). Order pops by
        # decreasing (el, -pos) — a valid order of the reference's
        # per-bucket pops. Candidate p emits this round iff it beats
        # every candidate whose target interval overlaps p's:
        #
        #   right: no q in (p, p+el[p])        with el[q] >  el[p]
        #   left:  no q with q + el[q] > p     with el[q] >= el[p]
        #
        # (ties break leftmost, so a left tie blocks and a right tie
        # does not). Such a p is popped before every overlapping
        # competitor, and no earlier pop can truncate it (an earlier
        # overlapping pop would be a dominating competitor), so the
        # round's emissions form a prefix of that pop order: legality
        # and the reference's invariants are inherited, while every
        # neighborhood makes progress simultaneously instead of the
        # whole text waiting on the single global max class (the
        # round-3 band rule ran thousands of rounds = 34 s/MiB).
        #
        # Both checks evaluate gather-free via dyadic windowed maxima:
        # T_k[i] = max el over [i, i+2^k), built by log-shift maxima;
        # queries are STATIC shifts of T_k. Windows over-approximate
        # the exact ranges, which can only block extra candidates —
        # legal (they stay pending) — never admit an illegal one:
        # attacks are tested with thresholds <= the exact condition.
        # Progress: the leftmost global max has no left >=-attacker
        # (leftmost) and no right >-attacker (max), so it always emits.
        elm = jnp.where(active, el, 0)

        def shift_r(x, k):  # x[i - k], zero-pad (no attacker)
            if k >= n:
                return jnp.zeros_like(x)
            return jnp.concatenate([jnp.zeros(k, _I32), x[:-k]])

        def shift_l(x, k):  # x[i + k], zero-pad
            if k >= n:
                return jnp.zeros_like(x)
            return jnp.concatenate([x[k:], jnp.zeros(k, _I32)])

        tk = elm
        left_atk = shift_r(elm, 1) >= jnp.maximum(el, 2)  # d = 1 exact
        right_atk = jnp.zeros(n, bool)
        for k in range(n_levels + 1):
            w = 1 << k
            if k > 0:
                tk = jnp.maximum(tk, shift_l(tk, w // 2))
            # tk[i] = max elm over [i, i + 2^k)
            # left attackers at distance d in (2^k, 2^(k+1)] need
            # el[q] >= max(el[p], d + 1) >= max(el[p], 2^k + 1)
            left_atk = left_atk | (
                shift_r(tk, 2 * w) >= jnp.maximum(el, w + 1)
            )
            # right attackers strictly inside (p, p + el[p]): one
            # window [p+1, p+1+2^k) with 2^k >= el[p] covers it
            is_level = (el <= 1) if k == 0 else (
                (el > w // 2) & (el <= w)
            )
            right_atk = right_atk | (
                is_level & (shift_l(tk, 1) > el)
            )
        selected = active & ~left_atk & ~right_atk

        # covered |= union of selected targets [p, p+el[p]): position x
        # is newly covered iff the max selected interval end at or
        # before x exceeds x — one more inclusive cummax
        send = jnp.where(selected, pos + el, -(1 << 30))
        last_end = lax.cummax(send)
        cov_add = last_end > pos
        any_sel = cur_max >= threshold
        covered = jnp.where(any_sel, covered | cov_add, covered)
        chosen = jnp.where(selected & any_sel, el, chosen)
        return covered, chosen, cur_max

    def cond(state):
        covered, chosen, cur_max, i = state
        # i < n is an unreachable safety bound (each round emits >= 1
        # factor, factors are disjoint non-empty intervals)
        return (cur_max >= threshold) & (i < n)

    def body(state):
        covered, chosen, _, i = state
        covered, chosen, cur_max = one_round((covered, chosen))
        return covered, chosen, cur_max, i + 1

    covered, chosen, _, rounds = lax.while_loop(
        cond,
        body,
        (covered, chosen, jnp.int32(1 << 30), jnp.zeros((), _I32)),
    )
    return covered, chosen, rounds


@functools.partial(jax.jit, static_argnames=("max_len",))
def _lcp_by_position(text, *, max_len: int):
    """(lcp0_p, src_p): for every text position p, the LCP with its
    suffix-array predecessor (capped at max_len) and that predecessor's
    position — the reference's candidate set (pos=sa[i], src=sa[i-1],
    len=lcp[i]) indexed by text position.

    Round-5 reformulation: the candidate pairs are SA-ADJACENT, so the
    level floor is an elementwise shift compare in SA order (largest q
    with equal q-gram rank between slots i-1 and i) — the former
    ``lifted_lcp`` descent paid ~22 elementwise 1M-gathers per call.
    What remains data-dependent: 2 gathers per probe level >= 256
    (floors f in {512..L/2} leave a residual < f), and one 64-word
    window settle for the final < 256 bytes (word-granular fetches are
    ~free after the round-5 ``_word_table`` layout)."""
    from tudocomp_tpu.ops.lzss_jax import (
        _fetch_aligned_words, _window_settle, _word_table,
    )
    from tudocomp_tpu.ops.suffix_jax import suffix_array_isa_ranks

    n = text.shape[0]
    pos = jnp.arange(n, dtype=_I32)
    L = 4
    while L < max_len:
        L *= 2
    sa, isa, ranks = suffix_array_isa_ranks(text, L=L)
    levels = sorted(ranks.keys())

    # ranks to SA order in one multi-operand co-sort; the floor with
    # the SA predecessor is then a shift compare per level
    sorted_ = lax.sort(
        (isa,) + tuple(ranks[q] for q in levels), num_keys=1
    )
    floor = jnp.zeros(n, _I32)
    for q, rq in zip(levels, sorted_[1:]):
        same = jnp.concatenate(
            [jnp.zeros(1, bool), rq[1:] == rq[:-1]]
        )
        floor = jnp.where(same, q, floor)
    prev_pos = jnp.concatenate([jnp.full(1, -1, _I32), sa[:-1]])
    # back to text order carrying (floor, predecessor position)
    _, floor_t, src = lax.sort((sa, floor, prev_pos), num_keys=1)

    has = src >= 0
    # the pair's match cannot outrun either suffix: n-1-pos on the
    # target side (as before), n - src on the source side (the settle
    # would otherwise count zero padding past the end as sentinel
    # matches when src sits near n)
    limit = jnp.minimum(
        jnp.minimum(n - 1 - pos, max_len),
        jnp.where(has, n - src, 0),
    )
    length = jnp.minimum(jnp.where(has, floor_t, 0), limit)
    # descending rank probes settle the residual below 256 (floor f
    # means lcp in [f, 2f), so only levels 256..L/4 can still extend)
    for q in reversed([q for q in levels if 256 <= q <= L // 4]):
        rq = ranks[q]
        a = pos + length
        b = src + length
        in_rng = (a <= n - q) & (b >= 0) & (b <= n - q)
        ok = (
            has & in_rng
            & (rq[jnp.clip(a, 0, n - 1)] == rq[jnp.clip(b, 0, n - 1)])
            & (length + q <= limit)
        )
        length = jnp.where(ok, length + q, length)
    T4 = _word_table(text)
    wa = _fetch_aligned_words(T4, pos + length, 64)
    wb = _fetch_aligned_words(
        T4, jnp.clip(src, 0, n - 1) + length, 64
    )
    matched = _window_settle(wa, wb, 64)
    add = jnp.clip(jnp.minimum(matched, limit - length), 0, None)
    return jnp.where(has, length + add, 0), src


def factorize_device(text: np.ndarray, threshold: int,
                     max_len: int = 4096):
    """Device lcpcomp factorization (see module docstring).  Returns
    (pos, src, len) int64 arrays; factors may point forward, exactly
    like the host strategies."""
    n = int(text.size)
    if n < 2 or threshold < 1:
        return (np.zeros(0, np.int64),) * 3
    max_len = min(max_len, max(4, n - 1))
    tj = jnp.asarray(text)
    lcp0_p, src_p = _lcp_by_position(tj, max_len=max_len)
    covered = jnp.zeros(n, bool)
    chosen = jnp.zeros(n, _I32)
    thr = jnp.asarray(threshold, _I32)
    covered, chosen, rounds = _all_rounds(
        covered, chosen, lcp0_p, thr, max_len=max_len
    )
    from tudocomp_tpu.stats import StatPhase

    StatPhase.log("device_rounds", int(rounds))
    chosen = np.asarray(chosen, np.int64)
    src = np.asarray(src_p, np.int64)
    starts = np.flatnonzero(chosen > 0)
    return starts, src[starts], chosen[starts]
