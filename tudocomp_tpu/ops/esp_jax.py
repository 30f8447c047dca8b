"""Device ESP rounds (JAX): ALL rounds fused into one XLA program.

Grammar-identical re-derivation of the host ESP round loop
(``ops/esp_vec.py`` spec; reference ``esp/EspContextImpl.hpp:14-165``):

- **One dispatch for the whole round chain.** Rounds halve the layer
  (every block has length >= 2), so a static pow2 halving schedule
  ``N0, N0/2, ...`` always fits the live layer; the fused program runs
  every round back-to-back on device, and the host syncs twice in
  total (scalars+tail, rules) instead of once per round.
- **No scatters, no symbol gathers**, a design choice made on hardware
  where both were slow; it is re-decided by measurement on the GPU:
  block symbols (a, b, c) are *shifts* read at block-head positions
  (the whole round works on the text domain, not a compacted block
  domain); the 1-block merge emits flags via +-3-position shifts
  instead of compaction; rules land in id order via ONE compaction
  sort (targets are distinct ids) written into a global rules buffer
  with ``dynamic_update_slice`` (contiguous copy, not scatter); the
  next layer compacts by one 2-operand sort; dedup group heads
  propagate by a last-valid ``associative_scan`` instead of a gather.
- Remaining per-round gathers: the two first-encounter id lookups
  (``idA_head[firstA]``, ``idB_head[firstB]``) — genuinely random
  access.

``esp_rounds_jax(data)`` pulls ``(nb, base, tail-layer)`` in one
transfer and the concatenated rules (pow2-bucketed slice) in a second,
then finishes layers below ``tail_cutoff`` with the host
``esp_vec.esp_round_vec`` — bit-identical to the host ``esp_rounds``.
Symbols are int32 (requires ``len(data) < 2**30``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from tudocomp_tpu.compressors.esp import iter_log
from tudocomp_tpu.ops import esp_vec

I32 = jnp.int32
INF = jnp.int32(2**31 - 1)


def _shr(x, d, fill):
    """Shift right by static d >= 1 (flag lands d positions later)."""
    if d >= x.shape[0]:
        return jnp.full(x.shape, fill, x.dtype)
    return jnp.concatenate([jnp.full((d,), fill, x.dtype), x[:-d]])


def _shl(x, d, fill):
    """Shift left by static d >= 1 (reads d positions ahead)."""
    if d >= x.shape[0]:
        return jnp.full(x.shape, fill, x.dtype)
    return jnp.concatenate([x[d:], jnp.full((d,), fill, x.dtype)])


def _eager13_starts(k, L):
    """Block-start predicate of ``_split_eager13`` (esp_vec closed form)."""
    m3 = L % 3
    base = k % 3 == 0
    special = (m3 == 1) & (L > 1)
    return jnp.where(
        special, (base & (k <= L - 4)) | (k == L - 2), base
    ) | ((L == 1) & (k == 0))


def _label_pass(buf):
    """One alphabet-reduction pass on the full layer (left-aligned):
    out[i] = 2*ctz(buf[i]^buf[i+1]) + bit (esp_vec._label_pass)."""
    left = buf
    right = jnp.concatenate([buf[1:], buf[-1:]])
    diff = left ^ right
    ctz = jnp.zeros(diff.shape, I32)
    d = diff
    for shift in (16, 8, 4, 2, 1):
        mask = (d & ((1 << shift) - 1)) == 0
        ctz = ctz + jnp.where(mask, shift, 0)
        d = jnp.where(mask, d >> shift, d)
    # diff == 0 only at positions never read (segment ends / padding);
    # clamp the shift so XLA semantics stay defined there.
    bit = (right >> jnp.minimum(ctz, 30)) & 1
    return 2 * ctz + bit


def _suffix_min(x):
    return lax.cummin(x, axis=0, reverse=True)


def _seg_suffix_min(v, reset):
    """out[i] = reset[i] ? v[i] : min(v[i], out[i+1]) — segmented
    suffix min (reset = last-of-region)."""

    def comb(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, jnp.minimum(av, bv)), af | bf

    outv, _ = lax.associative_scan(comb, (v[::-1], reset[::-1]))
    return outv[::-1]


def _prop_last(v, valid):
    """out[i] = v at the nearest j <= i with valid[j] (last-valid
    forward propagation; replaces a head-position gather)."""

    def comb(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, av), af | bf

    out, _ = lax.associative_scan(comb, (v, valid))
    return out


def _round_block_starts(s, n, ilog):
    """Boolean block-start flags (padded length N; False past n).

    Pure shifts/scans/elementwise — the round-4 span-cut scatter is
    gone: a cut after local position e starts the next span at
    e_local + 1, which is always 1 or 2 positions ahead of the
    landmark, so the flags are two static shifts."""
    N = s.shape[0]
    pos = jnp.arange(N, dtype=I32)
    valid = pos < n
    # padded tail: unique values so every padded position is its own
    # run; run_is1 is masked by validity so they never join segments
    s_eff = jnp.where(valid, s, -1 - pos)
    prev = jnp.concatenate([s_eff[:1] - 1, s_eff[:-1]])
    boundary = (pos == 0) | (s_eff != prev)
    run_start = lax.cummax(jnp.where(boundary, pos, -1), axis=0)
    nxt_b = _suffix_min(
        jnp.concatenate([jnp.where(boundary, pos, INF)[1:], INF[None]])
    )
    run_len = jnp.minimum(nxt_b, n) - run_start
    run_is1 = (run_len == 1) & valid
    k_run = pos - run_start

    starts = valid & (run_len > 1) & _eager13_starts(k_run, run_len)

    # segments = maximal groups of consecutive 1-runs (positions are
    # contiguous since each such run has length 1)
    prev_is1 = jnp.concatenate([jnp.zeros(1, bool), run_is1[:-1]])
    new_seg = run_is1 & ~prev_is1
    seg_start = lax.cummax(jnp.where(new_seg, pos, -1), axis=0)
    nonseg = jnp.where(run_is1, INF, pos)
    # first non-1-run position - 1; clamp for a segment running to the
    # end of an exactly-filled buffer (suffix min = INF there)
    seg_end = jnp.minimum(_suffix_min(nonseg) - 1, n - 1)
    seg_len = seg_end - seg_start + 1
    k_seg = pos - seg_start
    p_seg = jnp.minimum(ilog, seg_len)
    in_seg = run_is1

    # type-3 prefix
    starts = starts | (in_seg & (k_seg < p_seg)
                       & _eager13_starts(k_seg, p_seg))

    # type-2 remainder: reduced labels live left-aligned; for every
    # segment with a remainder p_seg == ilog, so red0[p] = buf[p-ilog]
    buf = s_eff
    for _ in range(ilog):
        buf = _label_pass(buf)
    rem = in_seg & (k_seg >= p_seg)
    k2 = k_seg - p_seg
    rem_len = seg_len - p_seg
    # reduced labels are read at pos - ilog; rem rows always satisfy
    # pos >= ilog (rem implies k_seg >= p_seg == ilog), so a static
    # shift replaces the round-4 clipped gather
    red = jnp.where(rem, _shr(buf, ilog, 0) if ilog else buf, INF)
    first = rem & (k2 == 0)
    last = rem & (pos == seg_end)
    # 6 -> 3 remap (neighbors within the region; sentinels at borders)
    for v in (3, 4, 5):
        left = jnp.where(first, -1, _shr(red, 1, I32(-1)))
        right = jnp.where(last, -1, _shl(red, 1, I32(-1)))
        e = jnp.zeros(N, I32)
        for _ in range(2):
            e = jnp.where(left == e, e + 1, e)
            e = jnp.where(right == e, e + 1, e)
        red = jnp.where(rem & (red == v), e, red)

    # landmarks
    m = rem_len
    left = jnp.where(first, -1, _shr(red, 1, I32(-1)))
    right = jnp.where(last, -1, _shl(red, 1, I32(-1)))
    high = rem & (red > left) & (red > right)
    lowl = jnp.where(first, 4, _shr(red, 1, I32(4)))
    lowr = jnp.where(last, 4, _shl(red, 1, I32(4)))
    low = rem & (red < lowl) & (red < lowr)
    lm = high
    lm_l = jnp.where(first, False, _shr(lm, 1, False))
    lm_r = jnp.where(last, False, _shl(lm, 1, False))
    lm = lm | (low & ~lm_l & ~lm_r)
    lm = lm & (m > 1)

    # next landmark strictly after k within the region (segmented)
    w = jnp.where(lm, k2, INF)
    shifted = jnp.where(last | ~rem, INF, _shl(w, 1, INF))
    nxt2 = _seg_suffix_min(shifted, last | ~rem)
    is_last_lm = lm & (nxt2 == INF)
    e_local = k2 + 1 - (nxt2 == k2 + 2).astype(I32)
    cut_after = lm & ~is_last_lm
    # span starts: region firsts + one position after each cut; the cut
    # lands at local e_local in {k2, k2+1}, so the next span start is
    # exactly 1 or 2 positions ahead of the landmark — static shifts
    d1 = cut_after & (e_local == k2)
    d2 = cut_after & (e_local == k2 + 1)
    span_flag = first | _shr(d1, 1, False) | _shr(d2, 2, False)
    span_first = lax.cummax(jnp.where(span_flag & rem, pos, -1), axis=0)
    nxt_span = _suffix_min(
        jnp.concatenate(
            [jnp.where(span_flag & rem, pos, INF)[1:], INF[None]]
        )
    )
    span_end = jnp.minimum(nxt_span - 1, seg_end)
    sk = pos - span_first
    sL = span_end - span_first + 1
    starts = starts | (rem & _eager13_starts(sk, sL))
    return starts


def _merged_start_flags(starts0, n, N):
    """Text-domain 1-block merge (esp_vec.merge_one_blocks_vec
    semantics): block-start flags AFTER the merge, via shifts only.

    Every kept (non-1) block absorbs a following 1-block (post1) and —
    only for block index 1 — a preceding 1-block at position 0 (pre1),
    then rewrites to one or two blocks of lengths 2/3 per the local
    table. Flag positions relative to the kept block's start p:
    the (possibly extended) first block starts at p - pre1, the second
    at p - pre1 + first_len — offsets in {-1, 0, 1, 2, 3}."""
    pos = jnp.arange(N, dtype=I32)
    valid = pos < n
    st = starts0 & valid
    nxt = _suffix_min(
        jnp.concatenate([jnp.where(st, pos, INF)[1:], INF[None]])
    )
    blen0 = jnp.minimum(nxt, n) - pos  # valid at start rows
    is1 = st & (blen0 == 1)
    kept = st & (blen0 > 1)

    pre1 = kept & (pos == 1) & is1[0]
    # next block is a 1-block: look blen0 in {2,3} positions ahead
    post1 = kept & (
        ((blen0 == 2) & _shl(is1, 2, False))
        | ((blen0 == 3) & _shl(is1, 3, False))
    )
    v = blen0 + pre1.astype(I32)  # in {2, 3, 4} at kept rows
    fst = jnp.where(v == 4, 2, v)
    snd = jnp.where(v == 4, 2, 0)
    t = jnp.where(snd > 0, snd, fst) + 1
    fst2 = jnp.where(snd > 0, fst, jnp.where(t == 4, 2, t))
    snd2 = jnp.where(snd > 0, t, jnp.where(t == 4, 2, 0))
    out_fst = jnp.where(post1, fst2, fst)
    out_snd = jnp.where(post1, snd2, snd)

    has2 = kept & (out_snd > 0)
    d2 = out_fst - pre1.astype(I32)  # second-block offset in {1, 2, 3}
    start1 = (kept & ~pre1) | _shl(kept & pre1, 1, False)
    for d in (1, 2, 3):
        start1 = start1 | _shr(has2 & (d2 == d), d, False)
    return start1 & valid


def _esp_round_body(s, n, base, ilog, rules_buf, rule_off,
                    first_round=False):
    """One ESP round: text-domain split, block-domain dedup.

    Input width N; returns (s_next[N//2] — the next layer dense in its
    first nb slots (always fits: every merged block has length >= 2),
    nb, rules_buf with this round's R rules appended at rule_off,
    rule_off + R). A layer of size n <= 1 passes through unchanged
    (the host loop stops there; fixed fused schedules may overshoot).

    The phase-A dedup sort doubles as the block COMPACTION: its
    back-sort keys on the block sequence position, so valid rows land
    dense at [0, nb) and phase B, the id cumsums, and the two
    first-encounter gathers all run at half width; the next layer
    needs no compaction sort at all.
    """
    N = s.shape[0]
    NB = N // 2
    pos = jnp.arange(N, dtype=I32)
    starts0 = _round_block_starts(s, n, ilog)
    starts0 = (starts0 & (pos < n)) | (pos == 0)

    head = _merged_start_flags(starts0, n, N)
    valid = pos < n
    bid = jnp.cumsum(head.astype(I32)) - 1
    nb = jnp.where(n > 0, jnp.max(jnp.where(head, bid, -1)) + 1, 0)
    nxt = _suffix_min(
        jnp.concatenate([jnp.where(head, pos, INF)[1:], INF[None]])
    )
    blen = jnp.minimum(nxt, n) - pos  # merged block length at heads

    # block symbols as shifts at head rows (b/c reads stay inside the
    # block for the rows that are used: len >= 2 covers b, is3 covers c)
    a = s
    b = _shl(s, 1, 0)
    c = _shl(s, 2, 0)
    is3 = head & valid & (blen == 3)
    hvalid = head & valid

    # phase A: keys (a, b) at sequence positions 2*bid; c and the
    # 3-block flag ride as one packed payload (symbols < 2^30).
    # Round 1 packs (a, b) into ONE 16-bit key (byte alphabet) —
    # one fewer operand in the two largest sorts of the biggest round.
    seqk = jnp.where(hvalid, 2 * bid, INF)
    c2p = jnp.where(is3, c * 2 + 1, c * 2)
    if first_round:
        km = jnp.where(hvalid, a * 256 + b, INF)
        s_km, s_seq, s_c2 = lax.sort((km, seqk, c2p), num_keys=2)
        headA = jnp.concatenate(
            [jnp.ones(1, bool), s_km[1:] != s_km[:-1]]
        )
        firstA_seq = _prop_last(s_seq, headA)
        _, hA_i, fA, kk_, cc2 = lax.sort(
            (s_seq, headA.astype(I32), firstA_seq, s_km, s_c2),
            num_keys=1,
        )
        aa = kk_ >> 8  # positive int32: arithmetic == logical
        bb = kk_ & 255
    else:
        am = jnp.where(hvalid, a, INF)
        bm = jnp.where(hvalid, b, INF)
        s_am, s_bm, s_seq, s_c2 = lax.sort(
            (am, bm, seqk, c2p), num_keys=3
        )
        headA = jnp.concatenate(
            [
                jnp.ones(1, bool),
                (s_am[1:] != s_am[:-1]) | (s_bm[1:] != s_bm[:-1]),
            ]
        )
        # A-group identity: its first encounter's sequence key
        # (bijective), propagated by scan, then ONE back-sort on the
        # sequence key lands every valid row dense at its block index
        firstA_seq = _prop_last(s_seq, headA)
        _, hA_i, fA, aa, bb, cc2 = lax.sort(
            (s_seq, headA.astype(I32), firstA_seq, s_am, s_bm, s_c2),
            num_keys=1,
        )
    j = jnp.arange(NB, dtype=I32)
    bvalid = j < nb
    hA_i, fA, aa, bb, cc2 = (
        x[:NB] for x in (hA_i, fA, aa, bb, cc2)
    )
    newA = (hA_i == 1) & bvalid
    cc = cc2 >> 1
    is3b = ((cc2 & 1) == 1) & bvalid
    fA_bid = _srl_pos(fA)  # block index of the A-group's first row

    # phase B at half width: keys (A-group identity, c) at 2*j + 1
    fm = jnp.where(is3b, fA, INF)
    cm = jnp.where(is3b, cc, INF)
    s_fm, s_cm, s_j = lax.sort((fm, cm, j), num_keys=3)
    headB = jnp.concatenate(
        [
            jnp.ones(1, bool),
            (s_fm[1:] != s_fm[:-1]) | (s_cm[1:] != s_cm[:-1]),
        ]
    )
    firstB_j = _prop_last(s_j, headB)
    _, hB_i, fB = lax.sort(
        (s_j, headB.astype(I32), firstB_j), num_keys=1
    )
    newB = (hB_i == 1) & is3b

    # global first-encounter ranking: exclusive cumsum over the
    # interleaved event sequence (A event at 2*j, B event at 2*j + 1)
    new_cnt = newA.astype(I32) + newB.astype(I32)
    pre = jnp.cumsum(new_cnt) - new_cnt
    idA_head = pre
    idB_head = pre + newA.astype(I32)
    R = pre[-1] + new_cnt[-1]
    clamp = lambda x: jnp.clip(x, 0, NB - 1)  # noqa: E731
    idA = idA_head[clamp(fA_bid)]
    idB = idB_head[clamp(fB)]

    # rules in id order by ONE compaction sort: targets are the
    # (distinct) new-rule ids, payload the rule symbols; rows [0, R)
    # of the sorted result are exactly this round's rules
    tgt = jnp.stack(
        [jnp.where(newA, idA_head, INF), jnp.where(newB, idB_head, INF)],
        axis=1,
    ).reshape(-1)
    c1 = jnp.stack([aa, base + idA], axis=1).reshape(-1)
    c2 = jnp.stack([bb, cc], axis=1).reshape(-1)
    _, c1s, c2s = lax.sort((tgt, c1, c2), num_keys=1)
    round_rules = jnp.stack([c1s, c2s], axis=1)  # (2*NB, 2)
    rules_buf = lax.dynamic_update_slice(
        rules_buf, round_rules, (rule_off, jnp.int32(0))
    )

    # next layer: already dense in block order — no sort
    top = jnp.where(is3b, idB, idA)
    s_next = jnp.where(bvalid, base + top, 0)

    # n <= 1 passes through untouched (no rules, same layer)
    passthru = n <= 1
    s_next = jnp.where(passthru, s[:NB], s_next)
    nb = jnp.where(passthru, n, nb)
    R = jnp.where(passthru, 0, R)
    rule_off = rule_off + R
    return s_next, nb, rules_buf, rule_off


def _srl_pos(x):
    """x // 2 for the nonneg sequence keys (INF rows are masked off)."""
    return lax.shift_right_logical(x, jnp.ones_like(x))


@functools.partial(jax.jit, static_argnames=("schedule",))
def _esp_fused(s, n, schedule):
    """All device rounds in one program. ``schedule`` is a static
    tuple of (N_k, ilog_k) with N_{k+1} = N_k // 2 (valid because the
    merged layer always satisfies nb <= n/2: every block has length
    >= 2). Returns (packed scalars+tail int32[2 + N_last//2],
    rules int32[2*N_0, 2]) — the caller slices rules[:base-256]."""
    N0 = schedule[0][0]
    rules_buf = jnp.zeros((2 * N0, 2), I32)
    base = jnp.int32(256)
    off = jnp.int32(0)
    for k, (Nk, ilog) in enumerate(schedule):
        s = s[:Nk]
        s, nb, rules_buf, off2 = _esp_round_body(
            s, n, base, ilog, rules_buf, off, first_round=(k == 0)
        )
        base = base + (off2 - off)
        off = off2
        n = nb
    tail = s[: schedule[-1][0] // 2]
    packed = jnp.concatenate([jnp.stack([n, base]), tail])
    return packed, rules_buf


def _pad_pow2(n, lo=256):
    p = lo
    while p < n:
        p *= 2
    return p


def esp_rounds_jax(data: bytes, tail_cutoff: int = 4096):
    """Full ESP on the device: grammar bit-identical to ``esp_rounds``.

    One fused dispatch covers every big round (see ``_esp_fused``); the
    host then pulls (nb, base, tail layer) in one transfer and the
    concatenated rules in a second (pow2-bucketed slice so repeat calls
    reuse the executable), and finishes layers below ``tail_cutoff``
    with the host array program (``esp_vec.esp_round_vec``) — the tail
    is microseconds of work and not worth a device dispatch. Returns
    (rules int64[R,2], root, empty).
    """
    s_host = np.frombuffer(data, np.uint8).astype(np.int64)
    if s_host.size == 0:
        return np.zeros((0, 2), np.int64), 0, True
    if len(data) >= (1 << 30) - 512:
        # int32 headroom: symbols reach 256 + total rules <= 256 + n,
        # and the packed (c, is3) payload needs 2*c + 1 < 2^31
        raise ValueError("device ESP requires len(data) < 2**30 - 512")
    chunks = []
    base = 256
    if s_host.size > tail_cutoff:
        N0 = _pad_pow2(s_host.size, lo=max(256, 2 * tail_cutoff))
        schedule = []
        Nk, b = N0, 256
        while True:
            schedule.append((Nk, iter_log(b)))
            b = 257  # any alphabet > 256 -> ilog 4 (iter_log saturates)
            if Nk <= 2 * tail_cutoff:
                break
            Nk //= 2
        pad = np.zeros(N0, np.int32)
        pad[: s_host.size] = s_host
        packed, rules_buf = _esp_fused(
            jnp.asarray(pad), jnp.int32(s_host.size), tuple(schedule)
        )
        packed = np.asarray(packed)  # pull 1: scalars + tail layer
        nb_i, base = int(packed[0]), int(packed[1])
        r_total = base - 256
        bucket = min(_pad_pow2(max(r_total, 1)), 2 * N0)
        rules_slice = rules_buf[:bucket]
        # start the rules d2h while the host tail rounds run below
        try:
            rules_slice.copy_to_host_async()
        except AttributeError:
            pass
        chunks.append((rules_slice, r_total))
        s_host = packed[2 : 2 + nb_i].astype(np.int64)
    while s_host.size > 1:
        top, rules_rel = esp_vec.esp_round_vec(s_host, base)
        a = rules_rel[:, 0]
        rules_rel[:, 0] = np.where(a < 0, base + (-a - 1), a)
        chunks.append(rules_rel)
        s_host = base + top
        base += rules_rel.shape[0]
    parts = [
        (np.asarray(c[0])[: c[1]].astype(np.int64)
         if isinstance(c, tuple) else c)
        for c in chunks
    ]
    all_rules = (
        np.concatenate(parts) if parts else np.zeros((0, 2), np.int64)
    )
    return all_rules, int(s_host[0]), False
