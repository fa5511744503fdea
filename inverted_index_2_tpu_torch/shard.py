"""Per-directory LSM shard engine.

Replaces shard.go. One subdirectory = one shard; a shard is
not aware of its siblings (shard.go:19-20). It:

 * ingests one document's terms as one new immutable direct-mode segment,
 * serves range-scoped merged reads over all live segments,
 * accumulates timestamped tombstones and persists them to `removed.list`,
 * compacts its smallest segments into one normal-mode segment, purging
   removed values and empty terms.

Where the reference streams through Go iterators term-by-term (shard.go:168),
compaction here is a vectorized array program: pack → multiword lexsort →
group → ragged union → searchsorted tombstone mask → bulk re-encode.

A copy of inverted_index_2_tpu/shard.py. A merge of DEVICE_MERGE_MIN_VALUES
postings or more runs the device merge (ops/merge.py) on MERGE_DEVICE, the
card unless a caller sets it to "cpu", and raises when that device is
missing; a smaller one runs merge_views on the host (native C++ or numpy).
Both give the same segment.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Iterator, List, Optional

import numpy as np

from .codec import keys as keys_mod
from .iterators import ClosingIterator, MergingIterator, TermValues
from .removed_list import RemovedLists, unserialize_removed_list
from .segment import formats
from .segment import writer as seg_writer
from .segment.reader import SegmentView
from .segment.registry import Segment, Segments
from .utils.ragged import ragged_gather

REMOVED_LIST_FILE = "removed.list"


class _MergeScratch:
    """Reusable compaction staging buffers (values + group tags).

    The gather stage of every merge needs ~12 bytes per input posting of
    TRANSIENT staging (consumed by the dedupe/purge pass, then dead).
    Pooled process-wide with TTL eviction — the analogue of the reference
    sharing one FST-writer pool across all shards' Put/Merge calls
    (inverted_index.go:344-352, evictable_pool.go)."""

    def __init__(self):
        self.vals = np.empty(0, dtype=np.uint32)
        self.groups = np.empty(0, dtype=np.int64)

    def ensure(self, total: int):
        if len(self.vals) < total:
            cap = max(total, 2 * len(self.vals))
            self.vals = np.empty(cap, dtype=np.uint32)
            self.groups = np.empty(cap, dtype=np.int64)
        return self.vals, self.groups


def _scratch_pool():
    """Lazy singleton: created on first merge, TTL 10s (the reference's pool
    TTL, inverted_index.go:346)."""
    global _SCRATCH_POOL
    with _SCRATCH_POOL_LOCK:
        if _SCRATCH_POOL is None:
            from .evictable_pool import Pool

            _SCRATCH_POOL = Pool(10.0, _MergeScratch)
        return _SCRATCH_POOL


_SCRATCH_POOL = None
_SCRATCH_POOL_LOCK = threading.Lock()


def shard_key(term: bytes) -> str:
    """First 10 bits of the first two term bytes, rendered %04d
    ("0000".."1023"). Terms shorter than 2 bytes map to shard "0000"
    regardless of content (parity: shard.go:362-378)."""
    if len(term) < 2:
        return "0000"
    key = ((term[0] << 8) | term[1]) >> 6
    return f"{key:04d}"


def shard_key_u16(first_two: int) -> str:
    return f"{first_two >> 6:04d}"


# merges whose total decoded postings reach this run the device merge
# (ops/merge.py); smaller ones stay on the host. Tune via TPI_DEVICE_MERGE_MIN.
DEVICE_MERGE_MIN_VALUES = int(os.environ.get("TPI_DEVICE_MERGE_MIN", 2_000_000))
# the torch device of that merge (tests set "cpu")
MERGE_DEVICE = "cuda"


class Shard:
    def __init__(self, basedir: str):
        self.basedir = basedir
        self.segments = Segments()
        self.removed_list = RemovedLists()
        self._rm_file_lock = threading.Lock()
        self._load()

    # ---- lifecycle -----------------------------------------------------

    def _load(self) -> None:
        """Scan the shard dir for `*_dict` segments (ignoring `*_tmp` crash
        litter) and the removed.list (parity: shard.go:300-359)."""
        try:
            entries = os.listdir(self.basedir)
        except FileNotFoundError:
            os.makedirs(self.basedir, exist_ok=True)
            entries = []
        for name in entries:
            if name.endswith(formats.TMP_SUFFIX):
                continue
            if formats.is_dict_file(name):
                key = formats.key_of_dict_file(name)
                view = SegmentView(self.basedir, key)
                self.segments.add(
                    Segment(key, view.n_terms, view.min_term, view.max_term, view)
                )
        rl_path = os.path.join(self.basedir, REMOVED_LIST_FILE)
        if os.path.exists(rl_path):
            with open(rl_path, "rb") as f:
                self.removed_list = unserialize_removed_list(f.read())

    def get_key(self) -> str:
        """Shard key = directory basename (parity: shard.go:28-30)."""
        return os.path.basename(self.basedir)

    def close(self) -> None:
        """No-op (parity: shard.go:247-249)."""

    # ---- ingestion -----------------------------------------------------

    def put(self, terms: List[bytes], value: int) -> None:
        """Ingest one document: all terms share one uint32 value; writes ONE
        new direct-mode segment (parity: shard.go:33-67). Terms may arrive
        unsorted / with duplicates; they are sorted+deduped vectorized."""
        if not terms:
            return
        blob = b"".join(terms)
        arr = np.frombuffer(blob, dtype=np.uint8)
        offsets = np.zeros(len(terms) + 1, dtype=np.int64)
        np.cumsum([len(t) for t in terms], out=offsets[1:])
        self.put_packed(arr, offsets, value)

    def put_packed(self, blob: np.ndarray, offsets: np.ndarray, value: int) -> None:
        """Batch ingestion entry point: terms as (byte array, offsets[n+1])."""
        n = len(offsets) - 1
        if n == 0:
            return
        keys = keys_mod.pack_blob(blob, offsets)
        order = keys_mod.lexsort_rows(keys)
        ks = keys[order]
        if n > 1:
            keep = np.concatenate([[True], np.any(ks[1:] != ks[:-1], axis=1)])
            order = order[keep]
        # rebuild sorted unique blob via ragged gather
        lens = np.diff(offsets)[order]
        sblob, _ = ragged_gather(blob, offsets[:-1][order], lens)
        soffs = np.zeros(len(order) + 1, dtype=np.int64)
        np.cumsum(lens, out=soffs[1:])
        self.put_sorted(sblob, soffs, value)

    def put_sorted(self, blob, offsets: np.ndarray, value: int) -> None:
        """Fast path: terms already SORTED and UNIQUE (the vectorized router
        in InvertedIndex.put_packed sorts globally once). Writes one
        direct-mode segment and publishes it. `blob` may be bytes or a uint8
        ndarray view (zero-copy end to end)."""
        if len(offsets) <= 1:
            return
        key = seg_writer.write_direct_segment(self.basedir, blob, offsets, np.uint32(value))
        n = len(offsets) - 1
        outs = np.broadcast_to(np.uint64(value), n)
        view = SegmentView.from_arrays(
            self.basedir, key, formats.MODE_DIRECT, offsets, outs, blob
        )
        self.segments.add(Segment(key, view.n_terms, view.min_term, view.max_term, view))

    def put_sorted_many(self, blob, offsets: np.ndarray, values: np.ndarray,
                        voffs: np.ndarray) -> None:
        """Batched multi-document ingest: terms SORTED UNIQUE with per-term
        sorted unique value lists (values[voffs[i]:voffs[i+1]] = term i's).
        Writes ONE normal-mode segment for the whole batch — read-equivalent
        to one direct segment per document (union semantics,
        file/types.go:14-22), amortizing the per-segment
        file + publish cost (see InvertedIndex.put_many)."""
        if len(offsets) <= 1:
            return
        values = np.asarray(values, dtype=np.uint32)
        voffs = np.asarray(voffs, dtype=np.int64)
        if bool(np.all(np.diff(voffs) == 1)):
            # every term carries exactly one value (the common batch shape):
            # a SINGLE-FILE direct segment with per-term outs — file-system
            # syscalls are what bound the per-doc grain on this host
            key = seg_writer.write_direct_segment_outs(
                self.basedir, blob, offsets, values
            )
            view = SegmentView.from_arrays(
                self.basedir, key, formats.MODE_DIRECT, offsets,
                values.astype(np.uint64), blob,
            )
        else:
            from .codec import packing as _packing

            words, w_outs = _packing.encode_bulk(values, voffs)
            key = seg_writer.write_normal_segment_words(
                self.basedir, blob, offsets, words, w_outs
            )
            view = SegmentView.from_arrays(
                self.basedir, key, formats.MODE_NORMAL, offsets,
                w_outs.astype(np.uint64), blob, words,
            )
        self.segments.add(Segment(key, view.n_terms, view.min_term, view.max_term, view))

    # ---- read ------------------------------------------------------------

    def read(
        self, min_term: Optional[bytes] = None, max_term: Optional[bytes] = None
    ) -> ClosingIterator:
        """Merged sorted stream of TermValues over all live segments in
        [min,max] inclusive; pins segments until the iterator is closed
        (parity: shard.go:72-75, :253-278). Tombstones are NOT applied
        (reads don't filter; only merge purges — see reference Read path)."""
        pinned = self.segments.pin_all()
        iters = []
        for seg in pinned:
            if seg.view is not None and seg.view.overlaps(min_term, max_term):
                iters.append(
                    (TermValues(t, v) for t, v in seg.view.iterate(min_term, max_term))
                )
        if len(iters) == 1:
            # compacted steady state: skip the k-way heap entirely
            merged = iters[0]
        else:
            merged = MergingIterator(iters)
        return ClosingIterator(merged, lambda: Segments.release(pinned))

    def min_max(self) -> Optional[List[bytes]]:
        """[min term, max term] over all segments, or None when empty
        (parity: shard.go:280-298)."""
        lo = hi = None
        for seg in self.segments.snapshot():
            if seg.min_term is None:
                continue
            if lo is None or seg.min_term < lo:
                lo = seg.min_term
            if hi is None or seg.max_term > hi:
                hi = seg.max_term
        if lo is None:
            return None
        return [lo, hi]

    # ---- delete -----------------------------------------------------------

    def remove(self, values) -> None:
        """Logical delete: GC expired tombstone batches against live segment
        timestamps, append a now-timestamped batch, persist
        (parity: shard.go:78-120)."""
        now = time.time_ns()
        # The reference seeds Sync with live segment timestamps PLUS time.Now()
        # (shard.go:84-98) — with zero live segments that drops every stale
        # batch instead of no-op'ing, so a value re-inserted later is not
        # spuriously purged at the next merge.
        live_ts = [int(s.key) for s in self.segments.snapshot()]
        self.removed_list.sync(live_ts + [now])
        self.removed_list.put(now, np.asarray(values, dtype=np.uint32))
        self.write_removed_list()

    def write_removed_list(self) -> None:
        """Persist tombstones. Atomic tmp+rename — deliberately stronger than
        the reference's bare os.WriteFile (shard.go:113-115, noted quirk)."""
        data = self.removed_list.serialize()
        path = os.path.join(self.basedir, REMOVED_LIST_FILE)
        with self._rm_file_lock:
            tmp = path + "_tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.rename(tmp, path)

    # ---- compaction ---------------------------------------------------------

    def merge(self, req_count: int, m_count: int) -> int:
        """Merge up to m_count smallest segments into one normal-mode segment,
        dropping removed values and empty terms; returns the number of INPUT
        segments consumed (parity: shard.go:127-245). Skips entirely when
        fewer than req_count segments exist."""
        if len(self.segments) < req_count:
            return 0
        claimed = self.segments.claim_for_merge(m_count)
        if len(claimed) < 2:
            self.segments.unclaim(claimed)
            return 0

        for seg in claimed:
            seg.pin()
        try:
            try:
                views = [s.view for s in claimed]
                est = sum(_estimate_values(v) for v in views)
                if est >= DEVICE_MERGE_MIN_VALUES:
                    from .ops.merge import merge_views_device

                    out = merge_views_device(views, self.removed_list.values(),
                                             device=MERGE_DEVICE)
                else:
                    out = merge_views(views, self.removed_list.values())

                if out is not None:
                    blob, offsets, values, voffs = out
                    if len(offsets) > 1:
                        from .codec import packing as _packing

                        words, w_outs = _packing.encode_bulk(
                            values, np.asarray(voffs, dtype=np.int64)
                        )
                        key = seg_writer.write_normal_segment_words(
                            self.basedir, blob, offsets, words, w_outs
                        )
                        view = SegmentView.from_arrays(
                            self.basedir, key, formats.MODE_NORMAL, offsets,
                            w_outs.astype(np.uint64), blob, words,
                        )
                        self.segments.add(
                            Segment(key, view.n_terms, view.min_term, view.max_term, view)
                        )
            except BaseException:
                # a failed merge (decode, encode, write) must not strand its
                # inputs: release the CAS claims so a later merge can retry
                self.segments.unclaim(claimed)
                raise
        finally:
            Segments.release(claimed)

        # make inputs invisible to new readers, then delete once readers drain
        # (non-blocking: deletion runs at the last unpin — see
        # Segment.drop_when_drained)
        self.segments.detach(claimed)
        basedir = self.basedir
        for seg in claimed:
            seg.drop_when_drained(
                lambda key=seg.key: formats.remove_segment(basedir, key)
            )
        return len(claimed)


def _estimate_values(view: SegmentView) -> int:
    """Cheap posting-count estimate for the device-vs-host merge choice."""
    if view.mode == 1:  # direct: one value per term
        return view.n_terms
    # normal mode: read each term's count word (gather touches only the
    # needed memmap pages; do NOT np.asarray the memmap — that reads the file)
    if view.n_terms == 0:
        return 0
    return int(view.words[view.outs.astype(np.int64)].sum())


def merge_views(views: List[SegmentView], removed: Optional[np.ndarray] = None):
    """Vectorized k-way merge + tombstone purge over segment views.

    Replaces the reference's streaming loop (shard.go:168-212): instead of
    a loser-tree pulling one term at a time, ALL terms of the input segments
    are packed into a key matrix, lexsorted, grouped, and their values
    unioned/purged with array ops. Used by Shard.merge (compaction) and by
    the device snapshot build (models/snapshot.py).

    removed: sorted uint32 tombstones (may be None/empty).
    Returns (blob, offsets, values, value_offsets) or None when everything
    was purged (then no output segment is written, shard.go:196-205)."""
    views = [v for v in views if v.n_terms > 0]
    if not views:
        return None
    W = max(keys_mod.width_words(v.max_term_len) for v in views)
    keys_all = np.concatenate([v.keys(W) for v in views], axis=0)
    n_per = np.array([v.n_terms for v in views], dtype=np.int64)
    view_base = np.zeros(len(views) + 1, dtype=np.int64)
    np.cumsum(n_per, out=view_base[1:])

    order = keys_mod.lexsort_rows(keys_all)
    ks = keys_all[order]
    N = len(order)
    if N == 0:
        return None
    new_group = np.concatenate([[True], np.any(ks[1:] != ks[:-1], axis=1)])
    group_id = np.cumsum(new_group) - 1

    # decode all postings per view, concatenated with global value bases
    vals_parts, counts_parts, vstart_parts = [], [], []
    vbase = 0
    for v in views:
        vals, counts, voffs = v.decode_all()
        vals_parts.append(vals)
        counts_parts.append(counts)
        vstart_parts.append(voffs[:-1] + vbase)
        vbase += len(vals)
    all_vals = np.concatenate(vals_parts)
    g_counts = np.concatenate(counts_parts)
    g_vstart = np.concatenate(vstart_parts)

    # values in sorted-term order, tagged with group ids
    starts_sorted = g_vstart[order]
    counts_sorted = g_counts[order]
    from .codec import native

    rem = (
        np.asarray(removed, dtype=np.uint32)
        if removed is not None
        else np.zeros(0, np.uint32)
    )
    if native.available():
        pool = _scratch_pool()
        scratch = pool.get()
        try:
            sv, sg = scratch.ensure(int(counts_sorted.sum()))
            flat_vals, flat_groups = native.merge_gather(
                all_vals, starts_sorted, counts_sorted, group_id, sv, sg
            )
            # union + dedupe + tombstone purge in one native pass; its
            # outputs are fresh arrays, so the scratch is free afterwards
            out_vals, out_groups = native.merge_pairs(flat_vals, flat_groups, rem)
        finally:
            pool.put(scratch)
        if len(out_vals) == 0:
            return None
    else:
        flat_vals, rep = ragged_gather(all_vals, starts_sorted, counts_sorted)
        flat_groups = group_id[rep]

        # union + dedupe per group: unique on (group << 32 | value)
        pairs = (flat_groups.astype(np.uint64) << np.uint64(32)) | flat_vals.astype(np.uint64)
        pairs = np.unique(pairs)

        # tombstone purge (vectorized binary search, replaces shard.go:181-190)
        if len(rem):
            vals_only = (pairs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            pos = np.searchsorted(rem, vals_only)
            pos_c = np.minimum(pos, len(rem) - 1)
            hit = rem[pos_c] == vals_only
            hit &= pos < len(rem)
            pairs = pairs[~hit]

        if len(pairs) == 0:
            return None

        out_groups = (pairs >> np.uint64(32)).astype(np.int64)
        out_vals = (pairs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    # out_groups is already sorted (merge core emits (group, value) order):
    # run-boundary diff beats np.unique's internal sort (~13% of merge time)
    heads = np.empty(len(out_groups), dtype=bool)
    heads[0] = True
    np.not_equal(out_groups[1:], out_groups[:-1], out=heads[1:])
    head_idx = np.nonzero(heads)[0]
    kept = out_groups[head_idx]
    group_counts = np.diff(np.append(head_idx, len(out_groups)))
    voffs = np.zeros(len(kept) + 1, dtype=np.int64)
    np.cumsum(group_counts, out=voffs[1:])

    # representative original term per kept group -> rebuild blob
    first_pos_of_group = np.nonzero(new_group)[0]  # sorted position of group heads
    rep_orig = order[first_pos_of_group[kept]]  # index into concatenated views
    view_idx = np.searchsorted(view_base, rep_orig, side="right") - 1

    blob_parts = [v.blob for v in views]
    blob_base = np.zeros(len(views) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blob_parts], out=blob_base[1:])
    all_blob = np.concatenate(blob_parts) if blob_parts else np.zeros(0, np.uint8)
    term_starts = np.concatenate([v.offsets[:-1] for v in views])
    term_lens = np.concatenate([np.diff(v.offsets) for v in views])
    g_tstart = term_starts[rep_orig] + blob_base[view_idx]
    g_tlen = term_lens[rep_orig]
    if native.available():
        out_blob = native.gather_bytes(all_blob, g_tstart, g_tlen)
    else:
        out_blob, _ = ragged_gather(all_blob, g_tstart, g_tlen)
    out_offsets = np.zeros(len(kept) + 1, dtype=np.int64)
    np.cumsum(g_tlen, out=out_offsets[1:])

    return out_blob.tobytes(), out_offsets, out_vals, voffs
