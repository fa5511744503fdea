"""Frozen index snapshots on a torch device (counterpart of
models/snapshot.py): the device tensors (IndexSnapshot), the compact host
tables (HostTables), and the freeze path from a live InvertedIndex.

The host halves (build_host_tables, snapshot_tables) are copies of the
numpy code in the JAX package's models/snapshot.py; the layout they produce
is the same, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..codec import hashing
from ..codec import keys as keys_mod
from ..codec import native as native_mod
from ..codec import packing
from ..segment.registry import Segments
from ..shard import merge_views
from ..utils.ragged import ragged_gather
from ..utils.u32 import to_device, to_numpy_u32

# Arena row pitch, in words. Rows start 16-byte aligned at a cost of at most
# 3 padding words per row; the decode kernels (csrc/) take any pitch.
STRIDE_ALIGN = 4
# Trailing zero rows after the last block: none. The decode (K1) and fused
# AND (K2) kernels read only rows a term owns (below term_block_start + its
# block count), unlike the TPU kernels' fixed-size DMA windows.
SLACK_ROWS = 0


@dataclass
class IndexSnapshot:
    """Immutable device image of one index: u32 data as int32 bits (see
    utils/u32.py) on one torch device. `host_counts` is the one host-side
    array, used to pick ladder levels."""

    keys: torch.Tensor              # (N, W+1) u32 bits, sorted rows
    blocks: torch.Tensor            # (B, stride) u32 bits, one block per row
    term_block_start: torch.Tensor  # (N+1,) int32 first arena row per term
    counts: torch.Tensor            # (N,) int32
    removed: torch.Tensor           # (R,) u32 bits, sorted in u32 order
    width: int                      # W (words per packed term, excl. len)
    hash_slots: Optional[torch.Tensor] = None  # (S,) int32, -1 empty
    max_probes: int = 1
    max_count: int = 0
    host_counts: np.ndarray = field(repr=False, default=None)

    @property
    def n_terms(self) -> int:
        return int(self.keys.shape[0])

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def device_bytes(self) -> int:
        arrs = (self.keys, self.blocks, self.term_block_start, self.counts,
                self.removed, self.hash_slots)
        return int(sum(a.numel() * a.element_size() for a in arrs
                       if a is not None))


@dataclass
class HostTables:
    """Compact host image of one snapshot build (see the JAX HostTables):
    the compressed postings stream plus per-block word offsets; the
    expanded arena is rebuilt on the device at upload."""

    keys: np.ndarray      # (N, W+1) uint32 packed term keys
    words: np.ndarray     # (T,) uint32 compressed postings stream
    flat: np.ndarray      # (B,) int32 per-block word offsets
    tbs: np.ndarray       # (N+1,) int32 term -> first block row
    counts: np.ndarray    # (N,) int32 posting-list lengths
    removed: np.ndarray   # (R,) uint32 sorted tombstones
    slots: np.ndarray     # (S,) int32 linear-probe hash table (-1 empty)
    max_probes: int
    max_count: int
    width: int            # W
    max_bw: int           # widest block in words

    @property
    def n_terms(self) -> int:
        return int(self.keys.shape[0])


def _sorted_removed(removed) -> np.ndarray:
    if removed is None:
        return np.zeros(0, np.uint32)
    return np.sort(np.asarray(removed, dtype=np.uint32))


def _empty_tables(width: int, removed=None) -> HostTables:
    return HostTables(
        keys=np.zeros((0, width + 1), dtype=np.uint32),
        words=np.zeros(0, dtype=np.uint32),
        flat=np.zeros(0, dtype=np.int32),
        tbs=np.zeros(1, dtype=np.int32),
        counts=np.zeros(0, dtype=np.int32),
        removed=_sorted_removed(removed),
        slots=np.full(8, -1, dtype=np.int32),
        max_probes=1,
        max_count=0,
        width=width,
        max_bw=3,
    )


def build_host_tables(blob, offsets, values, voffs, removed=None,
                      width=None, build_hash: bool = True) -> HostTables:
    """Merged (blob, offsets, values, voffs) arrays -> compact host tables:
    packed keys, the arena codec stream (power-of-two byte widths
    {0, 8, 16, 32}), per-block offsets and the term hash table.
    build_hash=False leaves the table empty (the mesh builds one per
    partition at a common size, parallel/mesh.py)."""
    offsets = np.asarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    if n == 0:
        return _empty_tables(width or 1, removed)
    blob_arr = (np.frombuffer(blob, dtype=np.uint8)
                if isinstance(blob, bytes) else blob)
    keys = keys_mod.pack_blob(blob_arr, offsets, width)
    W = keys.shape[1] - 1
    words, outs = packing.encode_bulk(
        np.asarray(values, dtype=np.uint32), voffs, byte_align=2)
    if len(words) >= 2**31:
        raise ValueError(
            "snapshot partition exceeds int32 word addressing; shard it")
    counts = words[np.asarray(outs, dtype=np.int64)].astype(np.int64)
    nb1 = np.maximum(-(-counts // 128), 1)
    tbs = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(nb1, out=tbs[1:])
    if native_mod.available():
        flat = native_mod.scan_blocks(words, outs, tbs.astype(np.int64))
    else:
        _, _, block_off, _ = packing.scan_term_blocks(words, outs)
        flat = np.zeros(tbs[-1], dtype=np.int32)
        colm = np.arange(block_off.shape[1], dtype=np.int64)
        maskm = colm[None, :] < nb1[:, None]
        flat[(tbs[:-1].astype(np.int64)[:, None] + colm[None, :])[maskm]] = (
            block_off[maskm])
    headers = words[flat.astype(np.int64)]
    h_b = (headers & 0xFF).astype(np.int64)
    h_nblk = ((headers >> 8) & 0xFF).astype(np.int64)
    blk_words = 2 + packing._packed_words(h_nblk, h_b)
    if build_hash:
        slots, max_probes = hashing.build_table_with_probes(keys)
    else:
        slots, max_probes = np.full(8, -1, dtype=np.int32), 1
    return HostTables(
        keys=keys,
        words=words,
        flat=flat,
        tbs=tbs,
        counts=counts.astype(np.int32),
        removed=_sorted_removed(removed),
        slots=np.asarray(slots, dtype=np.int32),
        max_probes=max_probes,
        max_count=int(counts.max()),
        width=W,
        max_bw=int(blk_words.max()),
    )


def arena_stride(t: HostTables) -> int:
    """Arena row pitch: the widest block plus one word, aligned."""
    stride = max(4, t.max_bw + 1)
    return -(-stride // STRIDE_ALIGN) * STRIDE_ALIGN


def _empty_snapshot(width: int, device) -> IndexSnapshot:
    """A snapshot of no terms on `device`. Also the placeholder of a warm
    checkpoint start: the engine's device check passes, and nothing serves
    from it, because every entry point takes the host route until the
    uploaded snapshot is published (ServingState.device_ready)."""
    device = torch.device(device)
    return IndexSnapshot(
        keys=torch.zeros((0, width + 1), dtype=torch.int32, device=device),
        blocks=torch.zeros((1, 4), dtype=torch.int32, device=device),
        term_block_start=torch.zeros(1, dtype=torch.int32, device=device),
        counts=torch.zeros(0, dtype=torch.int32, device=device),
        removed=torch.zeros(0, dtype=torch.int32, device=device),
        width=width,
        hash_slots=torch.full((8,), -1, dtype=torch.int32, device=device),
        host_counts=np.zeros(0, dtype=np.int32),
    )


def upload_tables(t: HostTables, *, device="cuda",
                  staging: Optional[list] = None) -> IndexSnapshot:
    """Materialize host tables on `device`: ship the compressed words and
    block offsets, then expand the (B, stride) block arena with one row
    gather on the device (row i = words[flat[i] : flat[i] + stride]).

    With `staging` (a list, CUDA only) every host array is first copied
    into pinned memory, appended to the list, and shipped with a
    non_blocking copy on the current stream: the caller keeps the list
    until that stream has passed the copies (upload_on_side_stream)."""
    device = torch.device(device)

    def put(a: np.ndarray) -> torch.Tensor:
        if staging is None:
            return to_device(a, device)
        host = to_device(a, "cpu").pin_memory()
        staging.append(host)
        return host.to(device, non_blocking=True)

    if t.n_terms == 0:
        snap = _empty_snapshot(t.width or 1, device)
        snap.removed = put(t.removed)
        return snap
    stride = arena_stride(t)
    wpad = put(np.concatenate([t.words, np.zeros(stride, dtype=np.uint32)]))
    flat = put(t.flat.astype(np.int64))
    arena = wpad.unfold(0, stride, 1)[flat]
    return IndexSnapshot(
        keys=put(t.keys),
        blocks=arena,
        term_block_start=put(t.tbs),
        counts=put(t.counts),
        removed=put(t.removed),
        width=t.width,
        hash_slots=put(t.slots),
        max_probes=t.max_probes,
        max_count=t.max_count,
        host_counts=t.counts,
    )


def upload_on_side_stream(t: HostTables, device,
                          serve_stream) -> IndexSnapshot:
    """upload_tables on a CUDA stream of its own, from pinned host memory
    with non_blocking copies, so serving on `serve_stream` goes on while
    the arena lands. Before it returns, `serve_stream` waits on the side
    stream's event (work queued there later sees the whole snapshot), every
    tensor is recorded on `serve_stream` (the allocator keeps its memory
    until that stream's uses end), and the host waits for the event, so the
    pinned staging buffers outlive their copies."""
    side = torch.cuda.Stream(device)
    staging: list = []
    with torch.cuda.stream(side):
        snap = upload_tables(t, device=device, staging=staging)
        done = torch.cuda.Event()
        done.record(side)
    serve_stream.wait_event(done)
    for a in (snap.keys, snap.blocks, snap.term_block_start, snap.counts,
              snap.removed, snap.hash_slots):
        a.record_stream(serve_stream)
    done.synchronize()
    staging.clear()
    return snap


def build_snapshot_arrays(blob, offsets, values, voffs, removed=None,
                          width=None, *, device="cuda") -> IndexSnapshot:
    """Merged (blob, offsets, values, voffs) arrays -> a snapshot on
    `device` (build_host_tables, then upload_tables)."""
    return upload_tables(
        build_host_tables(blob, offsets, values, voffs, removed, width),
        device=device)


def _purge_merged(merged, removed: np.ndarray):
    """Drop tombstoned values from merged arrays and the terms they empty;
    None when nothing survives (the apply_removed build)."""
    blob, offsets, values, voffs = merged
    keep = ~np.isin(values, removed)
    term_of = np.repeat(np.arange(len(voffs) - 1), np.diff(voffs))
    values = values[keep]
    new_counts = np.bincount(term_of[keep], minlength=len(voffs) - 1)
    nz = new_counts > 0
    if not nz.any():
        return None
    lens = np.diff(offsets)[nz]
    starts = offsets[:-1][nz]
    blob_arr = (np.frombuffer(blob, dtype=np.uint8)
                if isinstance(blob, bytes) else blob)
    nb, _ = ragged_gather(blob_arr, starts, lens)
    offsets = np.zeros(int(nz.sum()) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    voffs = np.zeros(int(nz.sum()) + 1, dtype=np.int64)
    np.cumsum(new_counts[nz], out=voffs[1:])
    return nb.tobytes(), offsets, values, voffs


def _collect_removed(index) -> np.ndarray:
    parts = [sh.removed_list.values() for sh in index._snapshot()]
    return np.sort(np.concatenate(parts)) if parts else np.zeros(0, np.uint32)


def snapshot_new_segments(index, base_segments: Dict[str, frozenset],
                          removed: Optional[np.ndarray] = None,
                          with_tables: bool = False, *, device="cuda"):
    """Freeze only the segments not in `base_segments` (shard key ->
    segment keys): the O(delta) piece of an incremental refresh. None when
    nothing is new. `removed` (sorted tombstones) purges the delta at build,
    which apply_removed requires: the main tier was purged, and an unpurged
    delta would bring removed values back. with_tables=True returns
    (snapshot, HostTables)."""
    views, pinned_all = [], []
    for sh in index._snapshot():
        pinned = sh.segments.pin_all()
        pinned_all.append(pinned)
        base = base_segments.get(sh.get_key(), frozenset())
        views.extend(s.view for s in pinned
                     if s.view is not None and s.key not in base)
    try:
        merged = merge_views(views, None)
    finally:
        for pinned in pinned_all:
            Segments.release(pinned)
    if merged is None:
        return None
    if removed is not None and len(removed):
        merged = _purge_merged(merged, removed)
        if merged is None:
            return None
    blob, offsets, values, voffs = merged
    t = build_host_tables(blob, offsets, values, voffs, None)
    snap = upload_tables(t, device=device)
    return (snap, t) if with_tables else snap


class _SnapshotTier:
    """merge_views adapter over a device snapshot: term bytes rebuilt from
    the key matrix, postings decoded on the device in ladder-grouped
    batches (engine._decode_indices, K1). Lets the main and delta tiers
    merge into one without re-reading a segment file: the promotion
    path."""

    def __init__(self, snap: IndexSnapshot, engine):
        kb, ko = keys_mod.unpack_keys(to_numpy_u32(snap.keys))
        self.blob = kb
        self.offsets = np.asarray(ko, dtype=np.int64)
        self.n_terms = snap.n_terms
        self.max_term_len = (int(np.diff(self.offsets).max())
                             if snap.n_terms else 0)
        self._vals, self._voffs = engine._decode_indices(
            np.arange(snap.n_terms), snap)

    def keys(self, W: int) -> np.ndarray:
        return keys_mod.pack_blob(self.blob, self.offsets, W)

    def decode_all(self):
        return self._vals, np.diff(self._voffs), self._voffs


def _index_fingerprint(index, apply_removed: bool):
    """Cheap identity of the index's visible state (segment keys and
    tombstone batch counts per shard) for refresh no-op detection. The
    tombstone counts always count: without apply_removed they feed the
    engine's filter_removed array, so a tombstone-only change refreshes."""
    parts = []
    for sh in index._snapshot():
        segs = tuple(s.key for s in sh.segments.snapshot())
        parts.append((sh.get_key(), segs, len(sh.removed_list)))
    return (apply_removed, tuple(parts))


def snapshot_tables(index, apply_removed: bool = False,
                    width: Optional[int] = None) -> HostTables:
    """Freeze an InvertedIndex into compact host tables: pin every segment
    of every shard, merge them logically (Read(nil, nil) semantics), and
    encode the postings with the arena codec."""
    views, pinned_all, removed_parts = [], [], []
    for sh in index._snapshot():
        pinned = sh.segments.pin_all()
        pinned_all.append(pinned)
        views.extend(s.view for s in pinned if s.view is not None)
        removed_parts.append(sh.removed_list.values())
    try:
        merged = merge_views(views, None)
    finally:
        for pinned in pinned_all:
            Segments.release(pinned)
    removed = (np.sort(np.concatenate(removed_parts)) if removed_parts
               else np.zeros(0, np.uint32))
    if merged is None:
        return _empty_tables(width or 1, removed)
    if apply_removed and len(removed):
        merged = _purge_merged(merged, removed)
        if merged is None:
            return _empty_tables(width or 1)
        removed = np.zeros(0, np.uint32)
    blob, offsets, values, voffs = merged
    return build_host_tables(blob, offsets, values, voffs, removed, width)


def snapshot_index(index, apply_removed: bool = False,
                   width: Optional[int] = None, *,
                   device="cuda") -> IndexSnapshot:
    """Freeze an InvertedIndex into a snapshot on `device`
    (snapshot_tables, then upload_tables)."""
    return upload_tables(
        snapshot_tables(index, apply_removed=apply_removed, width=width),
        device=device)
