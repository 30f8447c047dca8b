"""Device LZ77 factorization: prefix-doubling ranks, no tries.

Replaces the reference's sequential PSV/NSV scan over the LCP array
(``compressors/LZSSLCPCompressor.hpp:60-115``) with array programs
built from the ops this chip is good at (`lax.sort`, elementwise
compares, a handful of gathers) and none it is bad at (no hash
tables, no scatters, no per-position loops).

Two matchers share the factor pipeline:

- ``exact`` (default, ``_match_exact_device``): the classical SA+ANSV
  longest-previous-factor formulation — device suffix array,
  all-nearest-smaller-values by chunked dominance + merge co-sort,
  LCP floors by segmented scans over the prefix-doubling rank levels,
  residual by word-window compares. Per-position answers equal
  the reference's PSV/NSV scan (up to the 4096 length cap); measured
  ratios: english.1MB 28.3% (host-exact 28.0%), repetitive.1MB 2.8%
  (host-exact 3.3% — the one-step-lazy commit walk below beats the
  reference's plain greedy on repetitive phase alignments).
- ``fast`` (``_match_device``): q-gram class heuristic, below:

1. **Exact q-gram ranks by prefix doubling.** ``r_q[i]`` = dense id of
   ``text[i:i+q]`` for q = 4, 8, 16, 32, 64, built the suffix-array
   way: sort ``(r_q[i], r_q[i+q])`` pairs and number the groups. Tail
   positions get unique negative ids so truncated grams never alias.
2. **Candidates per level — one co-sort each.** Sorting ``(r_q, pos)``
   puts equal q-grams adjacent with positions ascending, so each
   position's nearest *previous* occurrence of its q-gram is its sort
   predecessor. A second co-sort (by pos) carries candidates back to
   text order — sort twice instead of scatter once (scatters measure
   ~100M elem/s here; sorts are far cheaper, see ARCHITECTURE.md).
   The largest q with a candidate wins: if the best possible match has
   length l, some q in [l/2, l] has an occurrence, so the chosen
   match is at least half-optimal before extension.
3. **Binary-lifting extension.** From the base length q, repeat the
   top level (+64 while the 64-grams at ``pos+L`` / ``cand+L`` agree)
   then descend 32/16/8/4 and settle 3 final bytes — O(log) gathers,
   exact lengths up to ``max_len``.
4. **Commit walk — host.** The greedy left-to-right parse is a trivial
   O(#factors) walk over the device-computed arrays; like the
   flagship's np.repeat finish, it rides along with the d2h transfer.

The emitted factors are back-references (src < pos, non-overlapping
positions), so they flow through the shared factor-stream wire format
(`compressors/lzss.py`) and its decoders unchanged. The parse is a
valid LZSS parse but NOT bit-identical to the PSV/NSV one — it is an
alternative `comp=` strategy, selected as ``lzss_lcp(comp=device)``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_I32 = jnp.int32

LEVELS = (4, 8, 16, 32, 64)


def rank_tables(text, L: int):
    """Exact q-gram dense ranks for q = 4, 8, ..., L by prefix
    doubling: rank_q[i] identifies ``text[i:i+q]`` exactly; positions
    whose gram is truncated by the end get unique negative ids so they
    never compare equal.  Shared by the LZ77 matchers and the lcpcomp
    device strategy."""
    n = text.shape[0]
    pos = jnp.arange(n, dtype=_I32)

    def shifted(r, k):
        tail = -2 - pos[: min(k, n)]
        return jnp.concatenate([r[k:], tail]) if k < n else -2 - pos

    def dense_rank(hi, lo):
        shi, slo, spos = lax.sort((hi, lo, pos), num_keys=2)
        first = jnp.concatenate([
            jnp.ones(1, jnp.bool_),
            (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1]),
        ])
        ranks_sorted = jnp.cumsum(first.astype(_I32)) - 1
        _, r = lax.sort((spos, ranks_sorted), num_keys=1)
        return r

    r = text.astype(_I32)
    r = dense_rank(r, shifted(r, 1))
    r = dense_rank(r, shifted(r, 2))
    ranks = {4: r}
    q = 4
    while q < L:
        r = dense_rank(r, shifted(r, q))
        ranks[2 * q] = r
        q *= 2
    return ranks


@functools.partial(jax.jit, static_argnames=("max_len",))
def _match_device(text, *, max_len: int):
    """text u8[n] -> (cand i32[n], length i32[n]).

    cand[i] = nearest previous position whose q-byte prefix equals
    text[i:i+q] for the largest q in LEVELS with any previous
    occurrence (-1 if none); length[i] = exact common prefix length of
    text[i:] and text[cand[i]:], capped at max_len and at n-1-i.
    """
    n = text.shape[0]
    pos = jnp.arange(n, dtype=_I32)
    ranks = rank_tables(text, LEVELS[-1])

    # unique negative ids for tails mean tail positions simply find no
    # equal-rank predecessor; no extra masking needed. Two candidates
    # per position: the nearest and second-nearest previous occurrence
    # of the largest matching q-gram class (the nearest one is not
    # always the longest-extending one).
    cand = jnp.full(n, -1, _I32)
    cand2 = jnp.full(n, -1, _I32)
    base = jnp.zeros(n, _I32)
    for q in LEVELS:
        srq, spos = lax.sort((ranks[q], pos), num_keys=2)
        p1 = jnp.concatenate([jnp.full(1, -1, _I32), spos[:-1]])
        r1_ = jnp.concatenate([jnp.full(1, -1, _I32), srq[:-1]])
        p2 = jnp.concatenate([jnp.full(2, -1, _I32), spos[:-2]])
        r2_ = jnp.concatenate([jnp.full(2, -1, _I32), srq[:-2]])
        cq = jnp.where(r1_ == srq, p1, -1)
        cq2 = jnp.where(r2_ == srq, p2, -1)
        _, cq, cq2 = lax.sort((spos, cq, cq2), num_keys=1)
        cand = jnp.where(cq >= 0, cq, cand)
        cand2 = jnp.where(cq >= 0, cq2, cand2)
        base = jnp.where(cq >= 0, q, base)

    limit = jnp.minimum(n - 1 - pos, max_len)
    assert max_len <= 256, "device_fast caps matches at 256"
    # Extension by ONE shared word-window round (round 4): both
    # candidates share the same verified base (the largest matching
    # class level), so the pos-side fetch is shared — 3 row fetches
    # and two compare trees replace a binary-lifting descent of ~44
    # elementwise gathers.
    T4 = _word_table(text)
    W = 64  # residual <= 256 - base < 4W bytes
    base_l = jnp.minimum(jnp.where(cand >= 0, base, 0), limit)
    wa = _fetch_aligned_words(T4, pos + base_l, W)

    def match_len(c):
        has = c >= 0
        wb = _fetch_aligned_words(
            T4, jnp.clip(c, 0, n - 1) + base_l, W
        )
        matched = _window_settle(wa, wb, W)
        add = jnp.clip(jnp.minimum(matched, limit - base_l), 0, None)
        return jnp.where(has, base_l + add, 0)

    l1 = match_len(cand)
    l2 = match_len(cand2)
    # base-q equality for cand2 is only guaranteed at its own level;
    # after the level loop cand2 belongs to the same (largest) class
    # as cand, so both start from `base` verified bytes
    take2 = l2 > l1
    return (
        jnp.where(take2, cand2, cand),
        jnp.where(take2, l2, l1),
    )


def _psv_indices(A):
    """All-nearest-smaller-values slots: see ``_psv_smaller``."""
    return _psv_smaller(A)[0]


def _psv_smaller(A):
    """All-nearest-smaller-values: for each index ``j`` of ``A`` (a
    permutation of values < 2**24), the nearest ``j' < j`` with
    ``A[j'] < A[j]`` — returns ``(slot, value)`` = (j', A[j']), both -1
    if none.  The value rides along for free (packed into the in-chunk
    dominance max, carried as a scan payload in the merge), saving the
    caller a 10 ms/M ``A[slot]`` gather.

    Sort/scan formulation, with zero gather rounds (a pointer-doubling
    version needs ~40):

    1. **In-chunk** (chunks of 128): full (C, C) dominance compare per
       chunk — ``psv_in`` = max lane ``l' < l`` with a smaller value.
    2. **Chunk routing**: the cross-chunk answer lives in the nearest
       chunk ``c' < c`` whose minimum is below ``A[j]`` (chunks between
       have no smaller element); one masked broadcast-max over chunk
       minima finds it.
    3. **Merge**: elements keyed by their own chunk and queries keyed by
       their target chunk co-sort on (chunk, value, tag); a segmented
       running max of element positions then hands every query the last
       position in its chunk with a strictly smaller value (queries
       sort before equal-valued elements, and values are distinct
       anyway). One sort back restores query order.

    The final answer is the max of the in-chunk and cross-chunk
    candidates (in-chunk positions always dominate when present).
    """
    m = A.shape[0]
    C = 128
    if m % C:  # pad with +inf values: never smaller, never chosen
        pad = ((m + C - 1) // C) * C - m
        Ap = jnp.concatenate([A, jnp.full(pad, 1 << 30, A.dtype)])
        s, v = _psv_smaller(Ap)
        return s[:m], v[:m]
    R = m // C
    j = jnp.arange(m, dtype=_I32)
    Ar = A.reshape(R, C)
    VS = 24  # packing shift: lane (7 bits) above value (< 2**24)

    # 1) in-chunk dominance, value packed under the lane key
    lane = lax.broadcasted_iota(_I32, (C, C), 1)
    tri = lane < lax.broadcasted_iota(_I32, (C, C), 0)
    lt = Ar[:, None, :] < Ar[:, :, None]  # [r, l, l'] = A[l'] < A[l]
    packed = (lane[None] << VS) + jnp.broadcast_to(
        Ar[:, None, :], (R, C, C)
    )
    best = jnp.max(
        jnp.where(lt & tri[None], packed, -1), axis=2
    )  # (R, C)
    row_base = lax.broadcasted_iota(_I32, (R, C), 0) * C
    has_in = best >= 0
    psv_in = jnp.where(
        has_in, row_base + _srl_i32(jnp.maximum(best, 0), VS), -1
    ).reshape(m)
    val_in = jnp.where(
        has_in, jnp.maximum(best, 0) & ((1 << VS) - 1), -1
    ).reshape(m)

    # 2) nearest previous chunk with min < A[j]
    mins = jnp.min(Ar, axis=1)  # (R,)
    ridx = jnp.arange(R, dtype=_I32)
    okc = (mins[None, :] < A[:, None]) & (
        ridx[None, :] < (j // C)[:, None]
    )
    cprime = jnp.max(jnp.where(okc, ridx[None, :], -1), axis=1)

    # 3) merge elements and queries per target chunk
    keys = jnp.concatenate([j // C + 1, cprime + 1])
    vals = jnp.concatenate([A, A])
    tags = jnp.concatenate(
        [jnp.ones(m, _I32), jnp.zeros(m, _I32)]
    )  # queries (tag 0) sort before equal-keyed elements
    pays = jnp.concatenate([j + 1, jnp.zeros(m, _I32)])
    qid = jnp.concatenate([jnp.full(m, m, _I32), j])
    sk, sv, st, sp, sq = lax.sort(
        (keys, vals, tags, pays, qid), num_keys=3
    )
    seg_start = jnp.concatenate(
        [jnp.ones(1, jnp.bool_), sk[1:] != sk[:-1]]
    )
    pay_elem = jnp.where(st == 1, sp, 0)
    val_elem = jnp.where(st == 1, sv, 0)

    def segmax(a, b):
        fa, pa, va = a
        fb, pb, vb = b
        pick_b = pb >= pa
        return (
            fa | fb,
            jnp.where(fb, pb, jnp.maximum(pa, pb)),
            jnp.where(fb, vb, jnp.where(pick_b, vb, va)),
        )

    _, runmax, runval = lax.associative_scan(
        segmax, (seg_start, pay_elem, val_elem)
    )
    _, _, rm, rv = lax.sort((st, sq, runmax, runval), num_keys=2)
    psv_cross = rm[:m] - 1
    val_cross = jnp.where(psv_cross >= 0, rv[:m], -1)
    take_in = psv_in >= psv_cross
    return (
        jnp.maximum(psv_in, psv_cross),
        jnp.where(take_in, val_in, val_cross),
    )


_TBL_W = 64  # max fetch width any call site uses


def _word_table(text):
    """WORD-granular overlapping big-endian rows: row r holds words
    r..r+_TBL_W+1 (bytes [4r, 4r + 4*_TBL_W + 8)), so a window fetch is
    ONE row gather plus the byte-in-word shift. The round-4 table used
    128-byte rows and needed 5 conditional lane-shift stages per fetch
    to align the word offset; this layout removes the lane stages at
    the price of a (n/4, 66) table (66 bytes/char of device memory,
    built once per matcher call)."""
    n = text.shape[0]
    R = (n + 3) // 4
    cols = _TBL_W + 2
    textp = jnp.concatenate(
        [text, jnp.zeros(4 * (R + cols) - n, jnp.uint8)]
    )
    le = lax.bitcast_convert_type(textp.reshape(-1, 4), jnp.uint32)
    w = lax.bitcast_convert_type(
        ((le & 0xFF) << 24) | ((le & 0xFF00) << 8)
        | ((le >> 8) & 0xFF00) | (le >> 24),
        jnp.int32,
    )
    # Hankel build by column doubling (7 concats instead of a 66-slice
    # stack, which cost ~25 ms/MiB in per-op overhead): at width k,
    # tbl[r, j] = w[r + j]; widening by s appends tbl[r + k, :s]
    m = w.shape[0]
    tbl = w[:, None]
    k = 1
    while k < cols:
        s = min(k, cols - k)
        rows = m - (k + s) + 1
        # columns k..k+s hold w[r+k .. r+k+s-1] = tbl[r+s, k-s : k]
        # (row shift s keeps the slice in range on the partial last
        # step, where s < k)
        tbl = jnp.concatenate(
            [tbl[:rows, :], tbl[s : s + rows, k - s : k]], axis=1
        )
        k += s
    return tbl[:R]


def _window_settle(wa, wb, W: int):
    """Matched byte count of two aligned W-word windows (0..4W)."""
    n = wa.shape[0]
    lane = lax.broadcasted_iota(_I32, (n, W), 1)
    neq = wa != wb
    first_w = jnp.min(jnp.where(neq, lane, W), axis=1)
    onehot = lane == first_w[:, None]
    x = jnp.sum(jnp.where(onehot, wa, 0), axis=1) ^ jnp.sum(
        jnp.where(onehot, wb, 0), axis=1
    )
    lead = jnp.where(
        _srl_i32(x, 24) != 0, 0,
        jnp.where(
            (_srl_i32(x, 16) & 0xFF) != 0, 1,
            jnp.where((_srl_i32(x, 8) & 0xFF) != 0, 2, 3),
        ),
    )
    return jnp.where(first_w == W, 4 * W, first_w * 4 + lead)


def _fetch_aligned_words(T4, i, w: int = 64):
    """``w`` big-endian text words (4w bytes) starting at BYTE index
    ``i``, per row: one row fetch from the word-granular table (row r
    covers bytes [4r, ...)) — no lane alignment needed — then the
    per-row variable BIT shift for the byte-in-word offset (variable
    lane rolls would be gathers; variable bit shifts are plain VPU
    ops). Requires ``w <= _TBL_W``."""
    assert w <= _TBL_W
    wv = T4[_srl_i32(i, 2)][:, : w + 1]  # +1: byte align peeks ahead
    boff = (i & 3) << 3  # bit offset: 0/8/16/24
    w_next = jnp.concatenate(
        [wv[:, 1:], jnp.zeros((wv.shape[0], 1), wv.dtype)], axis=1
    )
    b = boff[:, None]
    lo = jnp.where(
        b == 0, 0,
        _srl(w_next, jnp.broadcast_to(32 - b, w_next.shape))
    )
    return jnp.where(b == 0, wv, (wv << b) | lo)[:, :w]


def _srl(x, s):
    return lax.shift_right_logical(x, s)


def _refine_exact(text, T4, pos, cand, l0, limit, ranks, L: int):
    """Exact lcp(text[pos:], text[cand:]) given the level floor ``l0``
    (true lcp in [l0, 2*l0), both a verified common prefix and a
    bracket): rank-probe descent brings the residual under 256, then
    ONE 256-byte word-window round compares text directly — two
    128-lane row fetches total instead of 2 elementwise gathers per
    descent level (word packing does 4 bytes per lane op)."""
    n = text.shape[0]
    has = cand >= 0
    length = jnp.minimum(jnp.where(has, l0, 0), limit)
    cb = jnp.clip(cand, 0, n - 1)
    # residual < l0 <= L/2: probe q = L/4 .. 256 to get it under 256
    q = L // 4
    while q >= 256:
        rq = ranks[q]
        a = pos + length
        b = cb + length
        in_rng = (a <= n - q) & (b <= n - q)
        ok = (
            has & in_rng
            & (rq[jnp.clip(a, 0, n - 1)] == rq[jnp.clip(b, 0, n - 1)])
            & (length + q <= limit)
        )
        length = jnp.where(ok, length + q, length)
        q //= 2
    # one word-window round settles the whole residual: after the
    # probes the residual is < min(l0, 256) <= 4W bytes, so W words
    # suffice (W = 64 at cap 512; halves to 32 at cap 256)
    W = max(16, min(64, L // 8))
    wa = _fetch_aligned_words(T4, pos + length, W)
    wb = _fetch_aligned_words(T4, cb + length, W)
    matched = _window_settle(wa, wb, W)
    add = jnp.clip(jnp.minimum(matched, limit - length), 0, None)
    return jnp.where(has, length + add, 0)


def _srl_i32(x, k: int):
    return lax.shift_right_logical(x, jnp.full(x.shape, k, x.dtype))


@functools.partial(jax.jit, static_argnames=("max_len",))
def _match_exact_device(text, *, max_len: int):
    """Exact longest-previous-factor matching (the classical SA+ANSV
    LZ77 formulation): for every position, the longest match among ALL
    previous positions — the reference PSV/NSV answer
    (``LZSSLCPCompressor.hpp:60-115``) — as a sort/scan array program:

    - device suffix array + ISA (co-sorts);
    - all-nearest-smaller-values over SA order via the chunked
      merge-sort formulation (``_psv_indices``, zero gather rounds);
    - per-pair LCP **level floors computed elementwise**: in SA order
      the level-q rank groups are contiguous, so "same q-group as my
      PSV/NSV neighbor" is just ``group_start_q <= psv`` /
      ``group_end_q >= nsv`` — group starts/ends come from two
      segmented scans per level, no gathers at all;
    - exact refinement from the floor by direct 128-byte window
      compares (``_refine_exact``).

    Lengths are capped at ``max_len``. Round 3 measured the old
    pointer-doubling + binary-lifting version at 2.6 s/MiB batched
    (gather-bound); this formulation replaces ~70 elementwise gather
    rounds with sorts, scans, and 8 row fetches.
    """
    from tudocomp_tpu.ops.suffix_jax import suffix_array_isa_ranks

    n = text.shape[0]
    pos = jnp.arange(n, dtype=_I32)
    slot = pos

    L = 4
    while L < max_len:
        L *= 2
    # SA + ISA + all q-gram rank levels from ONE doubling chain — the
    # separate rank_tables build re-paid seven co-sorts the SA already
    # ran (~45 ms/MiB at round-4 scale). full=False: matches are
    # capped at max_len <= L, so the TRUNCATED order (position ties
    # inside equal-L-gram groups) gives the exact capped answer and
    # skips the residual log(n/L) doubling rounds (sources stay strict
    # back-references: ANSV candidates are smaller text positions).
    sa, isa, ranks = suffix_array_isa_ranks(text, L=L, full=False)

    # nearest SA-neighbor with a smaller text position, on each side:
    # among all previous text positions these two share the longest
    # common prefix with suffix i (SA adjacency). The neighbor's VALUE
    # (= the candidate text position) rides out of the ANSV for free.
    psv, cu = _psv_smaller(sa)
    rev, rval = _psv_smaller(sa[::-1])
    rev, rval = rev[::-1], rval[::-1]
    nsv = jnp.where(rev >= 0, n - 1 - rev, -1)
    cd = jnp.where(rev >= 0, rval, -1)

    levels = sorted(ranks.keys())

    # all rank levels to SA order in ONE multi-operand co-sort
    sorted_ = lax.sort(
        (isa,) + tuple(ranks[q] for q in levels), num_keys=1
    )
    r_sa = dict(zip(levels, sorted_[1:]))

    # level floor per side, fully elementwise: same q-group as the
    # PSV/NSV neighbor iff the group reaches that slot
    l_up = jnp.zeros(n, _I32)
    l_dn = jnp.zeros(n, _I32)
    for q in levels:
        change = jnp.concatenate(
            [jnp.ones(1, jnp.bool_), r_sa[q][1:] != r_sa[q][:-1]]
        )
        gstart = lax.associative_scan(
            jnp.maximum, jnp.where(change, slot, -1)
        )
        change_n = jnp.concatenate(
            [r_sa[q][1:] != r_sa[q][:-1], jnp.ones(1, jnp.bool_)]
        )
        gend = lax.associative_scan(
            jnp.minimum, jnp.where(change_n, slot, n), reverse=True
        )
        l_up = jnp.where((psv >= 0) & (gstart <= psv), q, l_up)
        l_dn = jnp.where((nsv >= 0) & (gend >= nsv), q, l_dn)

    # everything back to text order in one co-sort by sa
    _, cu_t, cd_t, lu_t, ld_t = lax.sort(
        (sa, cu, cd, l_up, l_dn), num_keys=1
    )

    T4 = _word_table(text)

    limit = jnp.minimum(n - 1 - pos, max_len)
    if L > 512:
        # rank-probe descent differs per side: two full refines
        l1 = _refine_exact(text, T4, pos, cu_t, lu_t, limit, ranks, L)
        l2 = _refine_exact(text, T4, pos, cd_t, ld_t, limit, ranks, L)
        take2 = l2 > l1
        return (
            jnp.where(take2, cd_t, cu_t),
            jnp.where(take2, l2, l1),
        )
    # Floor dominance: floors are power-of-two levels, so the side
    # with the strictly larger floor wins outright (lcp_hi >= l0_hi
    # >= 2*l0_lo > lcp_lo); only FLOOR TIES need the other side, and
    # on a tie both refines start from the same base — the pos-side
    # window fetch is shared: 3 row fetches instead of 4.
    hi_up = lu_t >= ld_t
    cand_hi = jnp.where(hi_up, cu_t, cd_t)
    cand_lo = jnp.where(hi_up, cd_t, cu_t)
    l0 = jnp.maximum(lu_t, ld_t)
    has_hi = cand_hi >= 0
    has_lo = cand_lo >= 0
    base = jnp.minimum(jnp.where(has_hi, l0, 0), limit)
    W = max(16, min(64, L // 8))
    wa = _fetch_aligned_words(T4, pos + base, W)

    def settle(cand, has):
        wb = _fetch_aligned_words(
            T4, jnp.clip(cand, 0, n - 1) + base, W
        )
        matched = _window_settle(wa, wb, W)
        add = jnp.clip(jnp.minimum(matched, limit - base), 0, None)
        return jnp.where(has, base + add, 0)

    l_hi = settle(cand_hi, has_hi)
    # lo result is consulted ONLY on floor ties (base then equals the
    # lo side's own start, so the shared wa is exact there); elsewhere
    # hi wins strictly and the lo garbage is discarded
    l_lo = settle(cand_lo, has_lo)
    tie_lo = (lu_t == ld_t) & (l_lo > l_hi)
    return (
        jnp.where(tie_lo, cand_lo, cand_hi),
        jnp.where(tie_lo, l_lo, l_hi),
    )


def factorize_device(text: np.ndarray, threshold: int,
                     max_len: int | None = None, exact: bool = True):
    """Greedy LZSS parse of ``text`` (numpy u8, sentinel-terminated)
    using device matching. Returns (pos, src, len) int64 arrays.

    ``exact=True`` (default) computes the true longest previous factor
    per position (SA + ANSV, capped at 4096 — longer caps cost one rank
    level per doubling); ``exact=False`` uses the cheaper q-gram class
    matcher (nearest/second-nearest occurrence heuristic, cap 256)."""
    n = int(text.size)
    if n > 1 << 24:
        # _psv_smaller packs lane<<24 + value into int32: text positions
        # (sa entries) must stay < 2**24 or PSV/NSV candidates silently
        # corrupt (ADVICE r4). Block-sharded callers stay far below this.
        raise ValueError(
            "exact device matcher requires len(text) <= 2**24; "
            "use factorize_blocks_sharded or the host matcher"
        )
    if n < 4 or threshold < 1:
        return (np.zeros(0, np.int64),) * 3
    if max_len is None:
        max_len = 4096 if exact else 256
    max_len = min(max_len, max(4, n - 1))
    match = _match_exact_device if exact else _match_device
    cand, length = match(jnp.asarray(text), max_len=max_len)
    return commit_walk(
        np.asarray(cand, np.int64), np.asarray(length, np.int64),
        threshold,
    )


def commit_walk(cand: np.ndarray, length: np.ndarray, threshold: int):
    """Host commit walk over factor starts only: jump to the next
    position with a usable match after each commit; one-step lazy
    matching (defer when the next position matches strictly longer,
    zstd-style) recovers most of the greedy/optimal gap for free."""
    n = int(length.size)
    length = np.where(length >= threshold, length, 0)
    starts = np.flatnonzero(length > 0)
    out_pos, out_src, out_len = [], [], []
    i = 0
    k = 0
    ns = starts.size
    while k < ns:
        s = starts[k]
        if s < i:
            k += 1
            continue
        if s + 1 < n and length[s + 1] > length[s] + 1:
            s += 1  # the deferred byte joins the preceding gap
        out_pos.append(s)
        out_src.append(cand[s])
        out_len.append(length[s])
        i = s + length[s]
        k = int(np.searchsorted(starts, i))
    return (
        np.asarray(out_pos, np.int64),
        np.asarray(out_src, np.int64),
        np.asarray(out_len, np.int64),
    )


# --- device factor-stream resolution (the decode side) -----------------------


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _resolve_factors_jit(lit, fpos, fsrc, flen, *, n_pad: int):
    """Resolve back-referencing factors into bytes by pointer doubling.

    Inputs are padded to static shapes: ``lit`` u8[n_pad] literal bytes
    in stream order (zero-padded), ``fpos/fsrc/flen`` i32[nf_pad] sorted
    by ``fpos`` with pad entries at ``fpos = n_pad, flen = 0``.

    The reference decodes the factor stream with a back-buffer whose
    copies run byte-by-byte because sources may overlap their targets
    (``lzss/LZSSCoding.hpp:95-140``, ``LZSSDecodeBackBuffer.hpp:10-40``).
    Per OUTPUT POSITION the dependency is a chain: position ``i`` inside
    factor ``(pos, src, len)`` takes its byte from ``src + (i - pos)``,
    strictly below ``i`` — so ``ptr = ptr[ptr]`` squares every chain per
    round (the orbit-doubling shape of ``suffix_jax.unbwt_device``) and
    all chains bottom out at literal positions in O(log depth) gathers,
    independent of factor overlap. Literals land by rank: position
    ``i``'s byte is ``lit[cumsum(uncovered)[i] - 1]``.
    """
    nf_pad = fpos.shape[0]
    i = jnp.arange(n_pad, dtype=_I32)
    fidx = jnp.searchsorted(fpos, i, side="right").astype(_I32) - 1
    safe = jnp.clip(fidx, 0, nf_pad - 1)
    covered = (fidx >= 0) & (i < fpos[safe] + flen[safe])
    ptr = jnp.where(covered, i - fpos[safe] + fsrc[safe], i)
    rank = jnp.cumsum(jnp.where(covered, 0, 1).astype(_I32)) - 1

    def cond(state):
        ptr, done = state
        return ~done

    def body(state):
        ptr, _ = state
        nxt = ptr[ptr]
        return nxt, jnp.all(nxt == ptr)

    ptr, _ = lax.while_loop(cond, body, (ptr, jnp.asarray(False)))
    return lit[jnp.clip(rank[ptr], 0, n_pad - 1)]


def resolve_factors_device(literals: np.ndarray, fpos: np.ndarray,
                           fsrc: np.ndarray, flen: np.ndarray,
                           n: int) -> bytes:
    """Device decode of a parsed factor stream (back-references only:
    every source interval must start below its factor position, the
    invariant of the lzss/lzss_lcp wire format). ``n`` = output length.
    Shapes bucket to powers of two so compilations are reused.

    **Spec path only**: the resolve is gather/scan-bound, and no
    default dispatches here; the production decode paths (CLI,
    BlockCodec) are host-native. Kept as the executable specification
    for a future device-resident multi-device pipeline; its speed on the
    GPU is not measured."""
    if n == 0:
        return b""
    n_pad = max(256, 1 << (n - 1).bit_length())
    nf = int(fpos.size)
    nf_pad = max(8, 1 << max(0, nf - 1).bit_length())
    lit_p = np.zeros(n_pad, np.uint8)
    lit_p[: literals.size] = literals
    fp = np.full(nf_pad, n_pad, np.int32)
    fs = np.zeros(nf_pad, np.int32)
    fl = np.zeros(nf_pad, np.int32)
    fp[:nf] = fpos
    fs[:nf] = fsrc
    fl[:nf] = flen
    out = _resolve_factors_jit(
        jnp.asarray(lit_p), jnp.asarray(fp), jnp.asarray(fs),
        jnp.asarray(fl), n_pad=n_pad,
    )
    return np.asarray(out)[:n].tobytes()
