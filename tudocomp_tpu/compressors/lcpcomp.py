"""lcpcomp: greedy longest-first LCP factorization (reference flagship).

Reference: ``compressors/LCPCompressor.hpp`` + ``lcpcomp/``. The input's
LCP array is consumed greedily: repeatedly take a suffix-array entry with
maximal remaining LCP ``l >= threshold``, emit the factor
``(pos=sa[i], src=sa[i-1], len=l)``, then invalidate the covered
positions and truncate overlapping candidates. Factors may point
*forward*, so decompression resolves reference chains.

Compression strategies (``comp=``):
- ``arrays`` (default): one candidate bucket per LCP value with lazy
  decrease-key (reference ``compress/ArraysComp.hpp:22-117``)
- ``heap``: max-heap with lazy invalidation (reference
  ``compress/MaxHeapStrategy.hpp``-equivalent behavior)
- ``naive``: rescan for the max each round (reference
  ``compress/NaiveStrategy.hpp``)
- ``device``: the same greedy as a device array program — parallel rounds
  of disjoint max-class selections, truncation recomputed from the
  covered set (``ops/lcpcomp_jax.py``); ratio <= arrays on the 1 MB
  suite corpora (english 28.9% vs 29.1%)

Decompression strategies (``dec=``): ``scan`` (default), ``compact``,
``MultimapListBuffer(lazy)`` (lazy sweep rounds + eager chase) and
``QueueListBuffer`` (breadth-parallel eager fixpoint) — the reference's
full registered set (``etc/registry_config.py:160-163``).  scan/compact
use a data-parallel re-derivation of the reference's chain-chasing
(``decompress/ScanDec.hpp:61-120``): every factor-covered position maps
to its source position, and the mapping is resolved to literal roots by
**pointer doubling** — O(log chain) vectorized rounds instead of the
reference's sequential rounds + eager chase.

Wire format: the shared lzss factor stream (``lzss/LZSSCoding.hpp``),
identical to the reference's lcpcomp output structure.
"""

from __future__ import annotations

import heapq

import numpy as np

from tudocomp_tpu.compressors.base import Compressor
from tudocomp_tpu.compressors.lzss import (
    FactorBuffer,
    encode_factor_text,
    uncovered_literals,
)
from tudocomp_tpu.ds.suffix import TextDS
from tudocomp_tpu.meta import Algorithm, Meta
from tudocomp_tpu.ranges import (
    BitRange,
    LiteralRange,
    MinDistributedRange,
    Range,
    len_r,
)
from tudocomp_tpu.registry import REGISTRY
from tudocomp_tpu.stats import StatPhase

bit_r = BitRange()
literal_r = LiteralRange()


def _emit_factor(factors, sa, isa, lcp, index, threshold):
    """Emit one factor and invalidate/truncate affected LCP entries
    (reference ``ArraysComp.hpp:92-112``)."""
    pos = int(sa[index])
    src = int(sa[index - 1])
    length = int(lcp[index])
    factors.append(pos, src, length)
    # erase suffixes starting inside the replaced area
    lcp[isa[pos : pos + length]] = 0
    # truncate suffixes whose LCP would reach into the replaced area
    max_affect = min(length, pos)
    if max_affect:
        ks = np.arange(1, max_affect + 1)
        inds = isa[pos - ks]
        np.minimum.at(lcp, inds, ks)
    return length


class ArraysComp(Algorithm):
    """Bucket array per LCP value, lazy decrease-key."""

    @classmethod
    def meta(cls):
        return Meta(
            "lcpcomp_comp", "arrays",
            "Bucket arrays per LCP value, lazy decrease-key",
        )

    def factorize(self, text: TextDS, threshold: int,
                  factors: FactorBuffer) -> None:
        sa = text.require_sa()
        isa = text.require_isa()
        lcp = text.require_lcp()
        text.discard("phi", "plcp")  # LCP construction helpers
        from tudocomp_tpu import native

        got = native.lcpcomp_arrays_factorize(sa, isa, lcp, threshold)
        if got is not None:
            factors.extend_arrays(*got)
            return
        lcp = text.require_lcp().copy()
        if lcp.size == 0:
            return
        maxlcp = int(lcp.max())
        if maxlcp < threshold:
            return
        cand: list[list[int]] = [[] for _ in range(maxlcp + 1 - threshold)]
        for i in np.flatnonzero(lcp >= threshold):
            cand[lcp[i] - threshold].append(int(i))
        for cur in range(maxlcp, threshold - 1, -1):
            col = cand[cur - threshold]
            for index in col:
                lv = int(lcp[index])
                if lv < cur:
                    if lv >= threshold:  # push down (lazy decrease-key)
                        cand[lv - threshold].append(index)
                    continue
                _emit_factor(factors, sa, isa, lcp, index, threshold)
            col.clear()


class DeviceComp(Algorithm):
    """Greedy longest-first factorization as a device array program
    (``ops/lcpcomp_jax.py``): the reference's truncation rules
    reformulated as a pure function of the covered set, and per-round
    simultaneous selection of disjoint max-length-class candidates —
    a legal parallel schedule of the arrays strategy (equal-length
    disjoint targets never truncate each other).  Factor lengths cap at
    4096; outputs roundtrip through every ``dec=`` strategy."""

    @classmethod
    def meta(cls):
        return Meta(
            "lcpcomp_comp", "device",
            "Parallel-rounds device factorization",
        )

    def factorize(self, text, threshold, factors):
        from tudocomp_tpu.ops.lcpcomp_jax import factorize_device

        factors.extend_arrays(*factorize_device(text.text, threshold))


class MaxHeapStrategy(Algorithm):
    """Max-heap ordered factorization with lazy invalidation."""

    @classmethod
    def meta(cls):
        return Meta("lcpcomp_comp", "heap", "Max-heap LCP factorization")

    def factorize(self, text, threshold, factors):
        sa = text.require_sa()
        isa = text.require_isa()
        from tudocomp_tpu import native

        got = native.lcpcomp_factorize(
            sa, isa, text.require_lcp(), threshold, "heap"
        )
        if got is not None:
            factors.extend_arrays(*got)
            return
        lcp = text.require_lcp().copy()
        heap = [
            (-int(lcp[i]), int(i))
            for i in np.flatnonzero(lcp >= threshold)
        ]
        heapq.heapify(heap)
        while heap:
            neg, index = heapq.heappop(heap)
            lv = int(lcp[index])
            if lv != -neg:
                if lv >= threshold:
                    heapq.heappush(heap, (-lv, index))
                continue
            _emit_factor(factors, sa, isa, lcp, index, threshold)


class NaiveStrategy(Algorithm):
    """Rescan for the maximum each round (reference NaiveStrategy)."""

    @classmethod
    def meta(cls):
        return Meta("lcpcomp_comp", "naive", "Naive max-LCP rescan")

    def factorize(self, text, threshold, factors):
        sa = text.require_sa()
        isa = text.require_isa()
        lcp = text.require_lcp().copy()
        while lcp.size:
            index = int(lcp.argmax())
            if lcp[index] < threshold:
                break
            _emit_factor(factors, sa, isa, lcp, index, threshold)


class MaxLCPStrategy(Algorithm):
    """The original BA-thesis strategy (reference
    ``compress/MaxLCPStrategy.hpp`` via ``MaxLCPSuffixList``): an
    LCP-bucketed list popped max-first with *eager* removal. The factor
    sequence matches the heap strategy's (both take maxima in the same
    order with the same invalidation rules)."""

    @classmethod
    def meta(cls):
        return Meta("lcpcomp_comp", "max_lcp", "Max-LCP suffix list")

    factorize = MaxHeapStrategy.factorize


class PLCPStrategy(Algorithm):
    """PLCP peak strategy (re-derivation of reference
    ``compress/PLCPStrategy.hpp:20-171``): scan PLCP left to right,
    climb to each local peak >= threshold, factorize there, and resume
    past the replaced span. The reference implements the wave of peaks
    with a Boost pairing heap; the greedy peak climb selects the same
    dominant peaks without the heap bookkeeping."""

    @classmethod
    def meta(cls):
        return Meta("lcpcomp_comp", "plcp", "PLCP peak factorization")

    climb_strict = True

    def factorize(self, text, threshold, factors):
        sa = text.require_sa()
        isa = text.require_isa()
        plcp = text.require_plcp()
        n = sa.size
        i = 0
        while i + 1 < n:
            if plcp[i] < threshold:
                i += 1
                continue
            j = i
            if self.climb_strict:
                while j + 1 < n and plcp[j + 1] > plcp[j]:
                    j += 1
            else:
                while j + 1 < n and plcp[j + 1] >= plcp[j]:
                    j += 1
            length = int(plcp[j])
            factors.append(j, int(sa[isa[j] - 1]), length)
            i = j + length


class PLCPPeaksStrategy(PLCPStrategy):
    """Peak variant with non-strict climbs (reference
    ``compress/PLCPPeaksStrategy.hpp``)."""

    @classmethod
    def meta(cls):
        return Meta("lcpcomp_comp", "plcppeaks", "PLCP peaks")

    climb_strict = False


class BulldozerStrategy(Algorithm):
    """Interval sweep (reference ``compress/BulldozerStrategy.hpp``):
    for every LCP entry >= threshold both (sa[i], sa[i-1], lcp) and the
    swap become candidate intervals, sorted by (target, -len); the sweep
    takes an interval when its source run is unmarked, marks the target,
    and jumps past overlapping targets. (The reference's inner
    ``intervals`` vector shadows the outer one — a bug that makes it
    emit nothing; this implements the intended behavior.)"""

    @classmethod
    def meta(cls):
        return Meta("lcpcomp_comp", "bulldozer", "Interval sweep")

    def factorize(self, text, threshold, factors):
        sa = text.require_sa()
        lcp = text.require_lcp()
        from tudocomp_tpu import native

        got = native.lcpcomp_bulldozer(sa, lcp, threshold)
        if got is not None:
            factors.extend_arrays(*got)
            return
        n = sa.size
        intervals = []
        for i in range(1, n):
            if lcp[i] >= threshold:
                intervals.append((int(sa[i]), int(sa[i - 1]), int(lcp[i])))
                intervals.append((int(sa[i - 1]), int(sa[i]), int(lcp[i])))
        intervals.sort(key=lambda x: (x[0], -x[2]))
        marked = np.zeros(n, bool)
        x = 0
        while x < len(intervals):
            p, q, max_l = intervals[x]
            if not marked[q]:
                length = 1
                while (
                    length < max_l and q + length < n
                    and not marked[q + length]
                ):
                    length += 1
                if length >= threshold and not marked[p : p + length].any():
                    factors.append(p, q, length)
                    marked[p : p + length] = True
                    x += 1
                    while x < len(intervals) and intervals[x][0] < p + length:
                        x += 1
                    continue
            x += 1


def _factor_arrays(factors):
    """Normalize a factor collection (list of tuples or an array
    triple) to (pos, src, len) int64 arrays."""
    if isinstance(factors, tuple):
        return tuple(np.asarray(a, np.int64) for a in factors)
    if not factors:
        z = np.zeros(0, np.int64)
        return z, z, z
    a = np.asarray(factors, np.int64)
    return a[:, 0], a[:, 1], a[:, 2]


def _factor_mapping(n: int, factors) -> np.ndarray:
    mapping = np.full(n, -1, np.int64)
    pos, src, lng = _factor_arrays(factors)
    if pos.size:
        tot = int(lng.sum())
        ramp = np.arange(tot) - np.repeat(np.cumsum(lng) - lng, lng)
        mapping[np.repeat(pos, lng) + ramp] = np.repeat(src, lng) + ramp
    return mapping


class ScanDec(Algorithm):
    """Round-limited parallel chain resolution (re-derivation of the
    reference's multi-round lazy scan, ``decompress/ScanDec.hpp:61-120``:
    instead of re-scanning the factor list per round, each pointer-
    doubling round squares the resolved chain length — ``rounds`` bounds
    the vectorized rounds exactly like the reference's ``scan(N)``
    bounds lazy scans, and leftover deep chains fall back to the eager
    sequential chase)."""

    @classmethod
    def meta(cls):
        m = Meta("lcpcomp_dec", "scan", "Scan decoding (parallelized)")
        m.option_dynamic("rounds", 25)
        return m

    def resolve(self, n, literals, lit_positions, factors) -> bytes:
        rounds = max(1, self.env.option("rounds").as_int())
        buf = np.zeros(n, np.uint8)
        buf[lit_positions] = literals
        mapping = _factor_mapping(n, factors)
        root = np.where(mapping >= 0, mapping, np.arange(n))
        for _ in range(min(rounds, max(1, int(np.ceil(np.log2(n + 1))) + 1))):
            nxt = root[root]
            if np.array_equal(nxt, root):
                break
            root = nxt
        unresolved = np.flatnonzero(mapping[root] >= 0)
        if unresolved.size:  # eager chase for chains deeper than 2^rounds
            mlist = mapping.tolist()
            rl = root.tolist()
            for i in unresolved.tolist():
                r = rl[i]
                seen = 0
                while mlist[r] >= 0:
                    r = mlist[r]
                    seen += 1
                    if seen > n:
                        raise ValueError("cyclic factor chain")
                root[i] = r
        return buf[root].tobytes()


class CompactDec(Algorithm):
    """Forward-bucket eager resolution (reference
    ``decompress/CompactDec.hpp:18-40``): every copied position waits on
    its source; known bytes propagate through the waiter buckets (native
    kernel ``tdc_lcpcomp_compact``)."""

    @classmethod
    def meta(cls):
        return Meta("lcpcomp_dec", "compact", "Compact decoding")

    def resolve(self, n, literals, lit_positions, factors) -> bytes:
        from tudocomp_tpu import native

        fpos, fsrc, flen = _factor_arrays(factors)
        got = native.lcpcomp_compact_decode(
            n, literals, lit_positions, fpos, fsrc, flen
        )
        if got is not None:
            return got
        # pure-Python fallback: same waiter-propagation algorithm
        buf = np.zeros(n, np.uint8)
        waiters: dict[int, list[int]] = {}
        for pos, src, length in zip(
            fpos.tolist(), fsrc.tolist(), flen.tolist()
        ):
            for k in range(length):
                waiters.setdefault(src + k, []).append(pos + k)
        known = np.zeros(n, bool)
        stack = []
        for p, c in zip(np.asarray(lit_positions).tolist(),
                        np.asarray(literals).tolist()):
            buf[p] = c
            known[p] = True
            stack.append(p)
            while stack:
                q = stack.pop()
                for t in waiters.pop(q, ()):  # noqa: B020
                    if not known[t]:
                        buf[t] = buf[q]
                        known[t] = True
                        stack.append(t)
        if not known.all():
            raise ValueError("unresolvable factor chain")
        return buf.tobytes()


def _waiter_chase(buf, known, mapping, pending) -> None:
    """Eager waiter-bucket chase: every unresolved position waits on its
    source; arriving bytes propagate depth-first (the recursion in the
    reference's ``decode_literal_at``).  Mutates ``buf``/``known``."""
    waiters: dict[int, list[int]] = {}
    for t in pending.tolist():
        waiters.setdefault(int(mapping[t]), []).append(int(t))
    stack = [s for s in waiters if known[s]]
    while stack:
        q = stack.pop()
        for t in waiters.pop(q, ()):
            if not known[t]:
                buf[t] = buf[q]
                known[t] = True
                if t in waiters:
                    stack.append(t)
    if not known.all():
        raise ValueError("unresolvable factor chain")


class MultimapListBuffer(Algorithm):
    """Lazy-round forward-waiter resolution (reference
    ``decompress/MultiMapBuffer.hpp:65-150``): ``lazy`` propagation
    passes copy every byte whose source is already decoded (the
    reference's ``decode_lazy_`` factor sweep, vectorized here), then
    the remaining deep chains resolve through the eager chase the
    reference implements with a src->target ``unordered_multimap``."""

    @classmethod
    def meta(cls):
        m = Meta("lcpcomp_dec", "MultimapListBuffer",
                 "Lazy multimap-buffered decoding")
        m.option_dynamic("lazy", 0)
        return m

    def resolve(self, n, literals, lit_positions, factors) -> bytes:
        lazy = max(0, self.env.option("lazy").as_int())
        buf = np.zeros(n, np.uint8)
        known = np.zeros(n, bool)
        buf[lit_positions] = literals
        known[lit_positions] = True
        mapping = _factor_mapping(n, factors)
        pending = np.flatnonzero(mapping >= 0)
        for _ in range(lazy):
            if not pending.size:
                break
            ready = known[mapping[pending]]
            hit = pending[ready]
            buf[hit] = buf[mapping[hit]]
            known[hit] = True
            pending = pending[~ready]
        if pending.size:
            _waiter_chase(buf, known, mapping, pending)
        return buf.tobytes()


class QueueListBuffer(Algorithm):
    """Fully-eager forward-list resolution (reference
    ``decompress/DecodeQueueListBuffer.hpp:35-76``): breadth-parallel
    value propagation — each round copies every byte whose source
    became known, iterated to the fixpoint; the reference walks the
    same dependency DAG depth-first through per-position forward
    lists."""

    @classmethod
    def meta(cls):
        return Meta("lcpcomp_dec", "QueueListBuffer",
                    "Forward-pointing factors stored in lists")

    def resolve(self, n, literals, lit_positions, factors) -> bytes:
        buf = np.zeros(n, np.uint8)
        known = np.zeros(n, bool)
        buf[lit_positions] = literals
        known[lit_positions] = True
        mapping = _factor_mapping(n, factors)
        pending = np.flatnonzero(mapping >= 0)
        while pending.size:
            ready = known[mapping[pending]]
            if not ready.any():
                raise ValueError("unresolvable factor chain")
            hit = pending[ready]
            buf[hit] = buf[mapping[hit]]
            known[hit] = True
            pending = pending[~ready]
        return buf.tobytes()


def resolve_factors(n: int, literals, lit_positions, factors,
                    strategy=None) -> bytes:
    """Resolve possibly-forward factor references via the configured
    decompression strategy (default: pointer-doubling scan)."""
    if strategy is None:
        from tudocomp_tpu.registry import create_algo

        strategy = create_algo(ScanDec)
    return strategy.resolve(n, literals, lit_positions, factors)


class LCPCompressor(Compressor):
    @classmethod
    def meta(cls):
        m = Meta(
            "compressor", "lcpcomp",
            "Factorizes the input by redundant phrases in the LCP table",
        )
        from tudocomp_tpu.coders import LCPCOMP_CODER_NAMES
        m.option_submeta(
            "coder", "coder", accepts=LCPCOMP_CODER_NAMES
        )
        m.option_submeta("comp", "lcpcomp_comp", default="arrays")
        m.option_submeta("dec", "lcpcomp_dec", default="scan")
        m.option_dynamic("threshold", 5)
        m.option_dynamic("flatten", 1)
        m.needs_sentinel_terminator()
        return m

    def compress(self, data: bytes) -> bytes:
        text = np.frombuffer(data, np.uint8)
        threshold = self.env.option("threshold").as_int()
        ds = TextDS(data)
        factors = FactorBuffer()
        with StatPhase("factorize"):
            strategy = self.env.instantiate("comp")
            strategy.factorize(ds, threshold, factors)
            StatPhase.log("factors", len(factors))
        factors.sort()
        if self.env.option("flatten").as_int():
            factors.flatten()
        from tudocomp_tpu.io.bitio import BitWriter

        out = BitWriter()
        coder = self.coder_encoder(out, uncovered_literals(text, factors))
        encode_factor_text(coder, text, factors)
        return out.getvalue()

    def decompress(self, data: bytes) -> bytes:
        from tudocomp_tpu.io.bitio import BitReader

        decoder = self.coder_decoder(BitReader(data))
        n = decoder.decode(len_r)
        text_r = Range(n)
        flen_min = decoder.decode(text_r)
        flen_max = decoder.decode(text_r)
        flen_r = MinDistributedRange(flen_min, flen_max)
        fdist_max = decoder.decode(text_r)
        fdist_r = Range(fdist_max)
        from tudocomp_tpu.compressors.lzss import decode_stream_native

        fast = decode_stream_native(
            decoder, n, flen_r, text_r, fdist_r, mode=1
        )
        if fast is not None:
            lit_bytes, fpos, fsrc, flens = fast
            total = int(lit_bytes.size + flens.sum())
            delta = np.zeros(total + 1, np.int8)
            if fpos.size:
                delta[fpos] += 1
                delta[fpos + flens] -= 1
            covered = np.cumsum(delta[:total], dtype=np.int8) > 0
            positions = np.flatnonzero(~covered)
            return resolve_factors(
                total, lit_bytes, positions, (fpos, fsrc, flens),
                strategy=self.env.instantiate("dec"),
            )

        lits: list[np.ndarray] = []
        lit_pos: list[np.ndarray] = []
        factors = []
        cursor = 0
        while not decoder.eof():
            if decoder.decode(bit_r):
                num = decoder.decode(fdist_r)
                got = decoder.decode_array(literal_r, num)
                lits.append(np.asarray(got, np.uint8))
                lit_pos.append(np.arange(cursor, cursor + num))
                cursor += num
            if decoder.eof():
                break
            src = decoder.decode(text_r)
            length = decoder.decode(flen_r)
            factors.append((cursor, src, length))
            cursor += length
        literals = (
            np.concatenate(lits) if lits else np.zeros(0, np.uint8)
        )
        positions = (
            np.concatenate(lit_pos) if lit_pos else np.zeros(0, np.int64)
        )
        return resolve_factors(
            cursor, literals, positions, factors,
            strategy=self.env.instantiate("dec"),
        )


for _cls in (ArraysComp, DeviceComp, MaxHeapStrategy, NaiveStrategy,
             MaxLCPStrategy,
             PLCPStrategy, PLCPPeaksStrategy, BulldozerStrategy, ScanDec,
             CompactDec, MultimapListBuffer, QueueListBuffer,
             LCPCompressor):
    REGISTRY.register(_cls)
