"""Multi-host orchestration (no reference counterpart — SURVEY.md §2.7).

The scaling model across the devices of several hosts:

- ``jax.distributed.initialize()`` on every host (coordinator address
  from the env / args), then one global ``Mesh`` over all devices with
  the same ``(dp, sp)`` axes as single-host (``parallel/mesh.py``);
- each host feeds its local shard of the block batch
  (``jax.make_array_from_process_local_data``) — input IO is
  host-local, so reading N shards of a file across N hosts needs no
  cross-host traffic;
- the encode step is the same ``shard_map`` as single-host: the only
  cross-host collective is the 256-bin histogram ``psum`` (rides DCN
  once per batch, 1 KiB);
- per-block compressed frames are fetched host-locally
  (``addressable_shards``) and the ordered container gather happens on
  process 0 (or each host writes its own byte range at offsets from a
  size all-gather).

This module provides the init + host-sharding helpers; correctness of
the sharded compute path is validated on the virtual multi-device mesh
(tests / ``__graft_entry__.dryrun_multichip``), since this environment
exposes a single physical chip.
"""

from __future__ import annotations

import numpy as np


def initialize(coordinator_address=None, num_processes=None,
               process_id=None) -> None:
    """``jax.distributed.initialize`` passthrough (no-op if single)."""
    import jax

    if num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_block_batch(mesh, local_blocks: np.ndarray,
                       local_lengths: np.ndarray):
    """Assemble a process-local block shard into a global dp-sharded
    array pair."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    s = NamedSharding(mesh, P("dp"))
    blocks = jax.make_array_from_process_local_data(s, local_blocks)
    lengths = jax.make_array_from_process_local_data(s, local_lengths)
    return blocks, lengths


def gather_frames_host_local(arr):
    """Per-host view of the block rows this process owns, as ordered
    ``(first_block_index, rows)`` pieces. Each host then writes its own
    byte range of the container (offsets from a size all-gather), or
    ships its pieces to process 0 — either way no device-level
    cross-host gather is needed."""
    out = []
    for shard in arr.addressable_shards:
        out.append((shard.index[0].start or 0, np.asarray(shard.data)))
    out.sort(key=lambda t: t[0])
    return out


def compress_distributed(codec, mesh, local_rows: np.ndarray,
                         local_lens: np.ndarray, orig_len: int):
    """Run the REAL fused encode kernels (``rle_stage``/``huff_stage``
    under ``shard_map``) across processes on a global mesh.

    Every process contributes its contiguous slice of the global padded
    segment batch (equal sizes, each a multiple of 8 segments per local
    device so the 1-in-8 histogram sample unions to the single-process
    one). The histogram ``psum`` is the only cross-host collective; the
    canonical table is then a pure function of it, so every host builds
    the identical table without further traffic.

    Returns ``(header_bytes, pieces)``: ``pieces`` is an ordered list of
    ``(global_segment_start, frame_bytes)`` for the segments whose
    devices live on THIS process. Writing ``MAGIC + vbyte(len(header)) +
    header`` followed by all hosts' pieces in global segment order
    reproduces ``codec.compress(data)`` byte for byte
    (tests/test_distributed.py).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tudocomp_tpu.models.blockcodec import MAGIC, SEG
    from tudocomp_tpu.parallel.pipeline import (
        sharded_huff_stage, sharded_rle_stage,
    )
    from tudocomp_tpu.utils.vbyte import write_vbyte

    nseg = -(-orig_len // SEG)
    s = NamedSharding(mesh, P(("dp", "sp")))
    rows = jax.make_array_from_process_local_data(s, local_rows)
    lens = jax.make_array_from_process_local_data(s, local_lens)
    sampled = codec.sample_rule(nseg)
    rows, counts, rleraw, hist = sharded_rle_stage(
        mesh, rows, lens, offset=codec.offset, sample=sampled
    )
    hist_np = np.asarray(
        hist.addressable_shards[0].data
        if hasattr(hist, "addressable_shards") else hist,
        np.int64,
    )
    table = codec._table_from_hist(hist_np, sampled)
    sym_code, sym_len = codec._device_table(table)
    words, bits, hraw = sharded_huff_stage(
        mesh, rows, counts, sym_code, sym_len
    )

    def local(arr):
        return gather_frames_host_local(arr)

    pieces = []
    for (start, c), (_, rr), (_, hr), (_, w), (_, b) in zip(
        local(counts), local(rleraw), local(hraw), local(words),
        local(bits),
    ):
        take = max(0, min(c.shape[0], nseg - start))
        if take == 0:
            continue
        frames = codec._frames(
            np.asarray(c[:take]), np.asarray(rr[:take]),
            np.asarray(hr[:take]), np.asarray(w[:take]),
            np.asarray(b[:take]),
        )
        pieces.append((start, frames))

    header = codec._header(orig_len, table)
    prefix = bytearray(MAGIC)
    write_vbyte(prefix, len(header))
    prefix += header
    return bytes(prefix), pieces
