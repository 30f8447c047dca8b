"""Sharded flagship pipeline: shard_map over the (dp, sp) mesh.

Multi-chip formulation of ``models/blockcodec.py`` (SURVEY.md §2.7). The
TBC2 unit of work is a fixed 2 KiB *segment*, so sharding is simply the
segment axis split over the whole mesh (dp x sp — the two axes exist so
callers can later map dp to hosts and sp to chips within a host):

- each shard RLE-encodes and Huffman-packs its local segments with the
  same stage functions as the single-device path, so the assembled
  container is **byte-identical** regardless of mesh shape;
- the **histogram** is psum-merged over the mesh (the only cross-chip
  communication on the encode path), and the canonical table broadcasts
  back in as a replicated argument;
- per-segment words/bits/flags come back sharded; the host's ordered
  gather assembles the container — bit streams never need cross-chip
  stitching because every segment is framed independently.

Everything here works identically on a virtual 8-device CPU mesh (tests)
and on the GPUs of one host, which NVLink joins all to all, so the mesh
shape follows the algorithm alone.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map


def _mesh_axes(mesh: Mesh):
    return ("dp", "sp")


def shard_segments(mesh: Mesh, seg_rows, seg_lens):
    """Place a host segment batch sharded over the whole mesh."""
    s = NamedSharding(mesh, P(("dp", "sp")))
    return jax.device_put(seg_rows, s), jax.device_put(seg_lens, s)


def sharded_rle_stage(mesh: Mesh, seg_rows, seg_lens, *, offset: int,
                      sample: bool = False, hist: bool = True,
                      global_base: int = 0):
    """Stage 1 sharded: local RLE + escapes, mesh-psum'd histogram.

    Returns ``(rows, counts, rle_raw)`` sharded over the mesh and a
    replicated u32[256] histogram. With ``sample``, each shard
    histograms its local rows[::8]; shard chunks are multiples of 8
    segments, so the union equals the single-device global 1-in-8
    sample and the table (hence the container) is identical — including
    the ``HIST_SEGS`` cap: each shard masks segments whose GLOBAL index
    (``global_base`` + shard offset + local index) falls at or past the
    cap, reproducing the single-device "first 16 MiB only" histogram at
    any mesh shape. ``hist=False`` skips histogram work for batches
    entirely past the cap.
    """
    nloc = seg_rows.shape[0] // mesh.size
    sp_size = mesh.shape["sp"]

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(("dp", "sp")), P(("dp", "sp")), P()),
        out_specs=(
            P(("dp", "sp")), P(("dp", "sp")), P(("dp", "sp")), P(),
        ),
    )
    def fn(rows, lens, gbase):
        from tudocomp_tpu.models.blockcodec import HIST_SEGS, rle_stage

        limit = None
        if hist and sample:
            i = (
                jax.lax.axis_index("dp") * sp_size
                + jax.lax.axis_index("sp")
            )
            base = gbase[0] + i * nloc
            limit = jnp.clip(HIST_SEGS - base, 0, nloc).astype(
                jnp.int32
            )
        r, c, rr, h = rle_stage(
            rows, lens, offset=offset, sample=sample, hist=hist,
            hist_limit=limit,
        )
        return r, c, rr, jax.lax.psum(h, ("dp", "sp"))

    gbase = jnp.asarray([global_base], jnp.int32)
    return jax.jit(fn)(seg_rows, seg_lens, gbase)


def sharded_huff_stage(mesh: Mesh, rows, counts, sym_code, sym_len):
    """Stage 2 sharded: local fused Huffman pack + raw escape."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(("dp", "sp")), P(("dp", "sp")), P(), P()),
        out_specs=(P(("dp", "sp")), P(("dp", "sp")), P(("dp", "sp"))),
    )
    def fn(rows, counts, code, ln):
        from tudocomp_tpu.models.blockcodec import huff_stage

        return huff_stage(rows, counts, code, ln)

    return jax.jit(fn)(rows, counts, sym_code, sym_len)


def sharded_decode_stage(mesh: Mesh, feed, counts, hraw, rleraw, thresh,
                         offs, syms, *, offset: int, d: int, kernel: str):
    """Lockstep segment decode sharded over the mesh (every segment is
    independently framed, so decode needs **zero** cross-device
    communication — the tables are replicated arguments). ``kernel``
    is ``backend.tbc2_decoder()``'s choice."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(("dp", "sp")), P(("dp", "sp")), P(("dp", "sp")),
            P(("dp", "sp")), P(), P(), P(),
        ),
        out_specs=(P(("dp", "sp")), P(("dp", "sp"))),
        # both decoders fail the check: the scan's carry starts as
        # replicated constants, and the pallas_call's out_shape names
        # no varying axes
        check_vma=False,
    )
    def fn(feed, counts, hraw, rleraw, thresh, offs, syms):
        if kernel == "pallas":
            from tudocomp_tpu.ops.hufdec_pallas import (
                decode_segments_pallas as dec,
            )
        else:
            from tudocomp_tpu.ops.hufdec_jax import decode_segments as dec

        return dec(
            feed, counts, hraw, rleraw, thresh, offs, syms,
            offset=offset, d=d,
        )

    return jax.jit(fn)(feed, counts, hraw, rleraw, thresh, offs, syms)


def decompress_sharded(codec, mesh: Mesh, data: bytes) -> bytes:
    """Sharded decompression of a TBC2 container (inverse of
    :func:`compress_sharded`): per-segment payload feeds scatter over
    the mesh, each device decodes its segments in lockstep, and the
    host finish (``np.repeat`` expansion) reassembles in order.

    One static step count (the largest segment's) serves the whole
    container here.
    """
    from tudocomp_tpu import backend
    from tudocomp_tpu.ops.hufdec_jax import (
        build_feed, decoder_tables, expand_records, needed_steps,
        snap_steps,
    )
    from tudocomp_tpu.ops.hufdec_pallas import BLOCK

    (table, offset, orig_len, counts, flags, poff,
     pbytes) = codec._parse(data)
    if orig_len == 0:
        return b""
    kernel = backend.tbc2_decoder()
    t = decoder_tables(table)
    nseg = counts.shape[0]
    unit = mesh.size * (BLOCK if kernel == "pallas" else 1)
    pad_to = -(-nseg // unit) * unit
    steps = snap_steps(int(needed_steps(pbytes, counts, t["d"]).max()))
    flat = np.frombuffer(data, np.uint8)
    feed, bc, hrw, rrw = build_feed(
        flat, np.arange(nseg), counts, flags, poff, pbytes, steps,
        pad_to,
    )
    s = NamedSharding(mesh, P(("dp", "sp")))
    chars, ends = sharded_decode_stage(
        mesh,
        *(jax.device_put(jnp.asarray(x), s) for x in (feed, bc, hrw, rrw)),
        jnp.asarray(t["thresh"]), jnp.asarray(t["offs"]),
        jnp.asarray(t["syms"]), offset=offset, d=t["d"], kernel=kernel,
    )
    out = expand_records(np.asarray(chars), np.asarray(ends))
    return out.reshape(-1)[:orig_len].tobytes()


def compress_sharded(codec, mesh: Mesh, data: bytes) -> bytes:
    """Sharded compression producing the exact single-device container
    at every input size: the histogram-sampling decision uses the same
    global rule (``BlockCodec.sample_rule``) and the per-shard 1-in-8
    sample unions to the single-device one (see sharded_rle_stage).
    """
    if len(data) == 0:
        return codec._assemble_empty()
    seg_rows, seg_lens = codec.split_segments(data)
    nseg = seg_rows.shape[0]
    # each shard's batch is a multiple of 8 segments, so the per-shard
    # 1-in-8 histogram samples union to the global one
    n_dev = mesh.size * 8
    pad_to = -(-nseg // n_dev) * n_dev
    if pad_to != nseg:
        seg_rows = np.pad(seg_rows, ((0, pad_to - nseg), (0, 0)))
        seg_lens = np.pad(seg_lens, (0, pad_to - nseg))
    seg_rows, seg_lens = shard_segments(mesh, seg_rows, seg_lens)
    sampled = codec.sample_rule(nseg)
    rows, counts, rleraw, hist = sharded_rle_stage(
        mesh, seg_rows, seg_lens, offset=codec.offset, sample=sampled
    )
    table = codec._table_from_hist(np.asarray(hist, np.int64), sampled)
    sym_code, sym_len = codec._device_table(table)
    words, bits, hraw = sharded_huff_stage(
        mesh, rows, counts, sym_code, sym_len
    )
    return codec._assemble(
        len(data), table,
        np.asarray(counts)[:nseg],
        np.asarray(rleraw)[:nseg],
        np.asarray(hraw)[:nseg],
        np.asarray(words)[:nseg],
        np.asarray(bits)[:nseg],
    )


def factorize_blocks_sharded(mesh: Mesh, blocks: np.ndarray,
                             threshold: int, max_len: int = 512):
    """Exact device LZ77 matching for a batch of equal-length blocks,
    data-parallel over the mesh (blocks are independent texts; zero
    cross-chip communication — the dp axis shards the block dimension
    and every collective-free matcher instance runs on its own chip).

    ``blocks`` is u8[B, n] with B a multiple of the mesh size; returns
    the per-block factor triples finished by the host commit walk."""
    from tudocomp_tpu.ops.lzss_jax import _match_exact_device, commit_walk

    b, n = blocks.shape
    if n > 1 << 24:
        # _psv_smaller packs lane<<24 + value into int32 (ADVICE r4):
        # per-block positions must stay < 2**24
        raise ValueError(
            "exact device matcher requires block length <= 2**24"
        )
    axes = _mesh_axes(mesh)
    spec = P(axes, None)
    arr = jax.device_put(
        jnp.asarray(blocks), NamedSharding(mesh, spec)
    )
    ml = min(max_len, max(4, n - 1))

    @functools.partial(jax.jit, out_shardings=NamedSharding(mesh, spec))
    def matched(x):
        return jax.vmap(
            lambda t: jnp.stack(_match_exact_device(t, max_len=ml))
        )(x)

    got = np.asarray(matched(arr), np.int64)
    return [
        commit_walk(got[i, 0], got[i, 1], threshold) for i in range(b)
    ]


# --- journaled, restartable sharded compression (SURVEY §5 failure
# --- detection / restartable jobs, extended to the mesh path) ---------------

JOURNAL_MAGIC = "TBCJ1"


def _journal_path(dst_path: str) -> str:
    return dst_path + ".journal"


def compress_sharded_resumable(codec, mesh: Mesh, src_path: str,
                               dst_path: str, *,
                               batch_segments: int | None = None,
                               resume: bool = False) -> int:
    """Sharded TBC2 compression with per-batch journaled restart.

    The container is written batch-by-batch; after each batch's frames
    are durably appended, the journal (``dst_path + ".journal"``)
    records the batch index and the container end offset. A killed job
    rerun with ``resume=True`` truncates the container to the last
    journaled batch boundary (dropping any torn frames) and continues —
    the result is byte-identical to an uninterrupted run (the sampled
    histogram from pass 1 is journaled too, so the table — and hence
    every frame — is reproduced exactly).

    Output bytes equal ``compress_sharded(codec, mesh, data)`` for the
    same input. Returns the container size. Single-writer semantics
    (process 0 in a multi-host job); the *compute* per batch is the
    sharded mesh pipeline.

    Test hook: ``TDC_CRASH_AFTER_BATCH=k`` hard-exits after appending
    batch k's frames but before journaling it (the worst tear point).
    """
    import os

    from tudocomp_tpu.models.blockcodec import SEG
    from tudocomp_tpu.utils.vbyte import write_vbyte

    orig_len = os.path.getsize(src_path)
    nseg = -(-orig_len // SEG)
    unit = mesh.size * 8  # 1-in-8 sample alignment per shard
    if batch_segments is None:
        batch_segments = max(unit, (4096 // unit) * unit)
    batch_segments = -(-batch_segments // unit) * unit
    n_batches = max(1, -(-nseg // batch_segments))
    sampled = codec.sample_rule(nseg)
    jpath = _journal_path(dst_path)

    hist = None
    done_upto = -1  # last completed batch index
    data_end = None
    if resume and os.path.exists(jpath):
        with open(jpath) as jf:
            lines = [ln.strip() for ln in jf if ln.strip()]
        if lines and lines[0].split() == [
            JOURNAL_MAGIC, str(nseg), str(orig_len), str(batch_segments)
        ]:
            for ln in lines[1:]:
                parts = ln.split()
                if parts[0] == "HIST":
                    hist = np.frombuffer(
                        bytes.fromhex(parts[1]), np.int64
                    ).copy()
                elif parts[0] == "BATCH":
                    done_upto = int(parts[1])
                    data_end = int(parts[2])
                elif parts[0] == "HEADER":
                    data_end = int(parts[1])

    def read_batch(bi: int):
        lo = bi * batch_segments
        hi = min(lo + batch_segments, nseg)
        with open(src_path, "rb") as f:
            f.seek(lo * SEG)
            raw = f.read((hi - lo) * SEG)
        rows = np.zeros((batch_segments, SEG), np.uint8)
        rows.reshape(-1)[: len(raw)] = np.frombuffer(raw, np.uint8)
        lens = np.zeros(batch_segments, np.int32)
        lens[: hi - lo] = np.minimum(
            np.full(hi - lo, SEG, np.int64),
            orig_len - SEG * np.arange(lo, hi, dtype=np.int64),
        )
        return rows, lens, hi - lo

    if hist is None:
        # pass 1: sampled histogram (device work only). With sampling
        # on, only batches intersecting [0, HIST_SEGS) contribute
        # (blockcodec.HIST_SEGS cap — identical to the single-device
        # and one-shot sharded rules), so the pass ends early.
        from tudocomp_tpu.models.blockcodec import HIST_SEGS

        acc = None
        for bi in range(n_batches):
            lo_seg = bi * batch_segments
            if sampled and lo_seg >= HIST_SEGS:
                break
            rows, lens, _ = read_batch(bi)
            r, l = shard_segments(mesh, rows, lens)
            _, _, _, h = sharded_rle_stage(
                mesh, r, l, offset=codec.offset, sample=sampled,
                global_base=lo_seg,
            )
            h = np.asarray(h, np.int64)
            acc = h if acc is None else acc + h
        hist = acc
        with open(jpath, "w") as jf:
            jf.write(
                f"{JOURNAL_MAGIC} {nseg} {orig_len} {batch_segments}\n"
            )
            jf.write(f"HIST {hist.astype(np.int64).tobytes().hex()}\n")
            jf.flush()
            os.fsync(jf.fileno())
        done_upto = -1
        data_end = None

    table = codec._table_from_hist(hist, sampled)
    sym_code, sym_len = codec._device_table(table)

    if data_end is None:
        # (re)write the container prefix
        header = codec._header(orig_len, table)
        with open(dst_path, "wb") as f:
            buf = bytearray(b"TBC2")
            write_vbyte(buf, len(header))
            buf += header
            f.write(buf)
            f.flush()
            os.fsync(f.fileno())
            data_end = f.tell()
        with open(jpath, "a") as jf:
            jf.write(f"HEADER {data_end}\n")
            jf.flush()
            os.fsync(jf.fileno())

    crash_after = os.environ.get("TDC_CRASH_AFTER_BATCH")
    with open(dst_path, "r+b") as f:
        f.truncate(data_end)  # drop torn frames past the journal point
        f.seek(data_end)
        for bi in range(done_upto + 1, n_batches):
            rows, lens, take = read_batch(bi)
            r, l = shard_segments(mesh, rows, lens)
            rr, cc, rl, _ = sharded_rle_stage(
                mesh, r, l, offset=codec.offset, sample=sampled,
                hist=False,  # table is fixed; skip histogram work
            )
            ww, bb, hh = sharded_huff_stage(
                mesh, rr, cc, sym_code, sym_len
            )
            frames = codec._frames(
                np.asarray(cc)[:take], np.asarray(rl)[:take],
                np.asarray(hh)[:take], np.asarray(ww)[:take],
                np.asarray(bb)[:take],
            )
            f.write(frames)
            f.flush()
            os.fsync(f.fileno())
            if crash_after is not None and bi == int(crash_after):
                os._exit(17)  # test hook: die before journaling
            data_end = f.tell()
            with open(jpath, "a") as jf:
                jf.write(f"BATCH {bi} {data_end}\n")
                jf.flush()
                os.fsync(jf.fileno())
        f.truncate(data_end)
    os.remove(jpath)
    return data_end
