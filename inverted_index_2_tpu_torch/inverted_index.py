"""Top-level index API: shard router over up to 1024 prefix shards.

Replaces inverted_index.go. Public operations (the complete
capability contract, SURVEY §2.4):

 * InvertedIndex(basedir, enable_logging)   — open/create (recovery path)
 * put(terms, value)                        — ingest one document
 * read(min, max) -> iterator               — globally sorted range scan
 * prefix_search(prefixes) -> dict          — union of values per prefix
 * put_removed(values)                      — logical delete across all shards
 * merge(req_count, m_count, concurrency)   — compaction over all shards

Concurrency mirrors the reference: bounded thread fan-out for put_removed and
prefix_search (errgroup w/ NumCPU, inverted_index.go:46,239), a worker pool
over a queue for merge (:71-103), copy-on-read shard snapshots under an
RWMutex-equivalent lock, and double-checked locking for shard creation
(:160-188). Heavy array work inside each shard releases the GIL (numpy/JAX),
so threads parallelize like goroutines here.
"""
from __future__ import annotations

import functools
import logging
import os
import queue
import threading
import time
from contextlib import contextmanager
from bisect import bisect_left
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

from .iterators import SequentialDynamicIterator, TermValues
from .shard import Shard

logger = logging.getLogger("inverted_index_2_tpu_torch")

_NCPU = os.cpu_count() or 4


def _tracks_busy(fn):
    """Wrap a mutating InvertedIndex method so is_busy() is True for its
    whole duration (the serving router's engine-internal busy signal)."""

    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        with self._busy():
            return fn(self, *a, **kw)

    return wrapper


class InvertedIndex:
    def __init__(self, basedir: str, enable_logging: bool = False):
        """Open or create an index at basedir; loads every subdirectory as a
        shard concurrently (parity: inverted_index.go:342-403)."""
        self.basedir = basedir
        self.enable_logging = enable_logging
        self._shards: List[Shard] = []
        self._shard_keys: List[str] = []  # kept aligned with _shards
        self._shards_m = threading.Lock()
        # live mutator count (put*/put_removed/merge in flight): the serving
        # router's PRIMARY busy signal — reacts within one call, unlike the
        # 1-minute loadavg it replaces (which missed a merge burst for its
        # first seconds and poisoned the signal for ~a minute after; see
        # QueryEngine._host_busy). Guarded by its own lock so readers never
        # contend with the shard-registry lock.
        self._busy_n = 0
        self._busy_m = threading.Lock()
        os.makedirs(basedir, exist_ok=True)

        dirs = sorted(
            e.name for e in os.scandir(basedir) if e.is_dir()
        )
        if dirs:
            with ThreadPoolExecutor(max_workers=_NCPU) as pool:
                shards = list(
                    pool.map(lambda d: Shard(os.path.join(basedir, d)), dirs)
                )
            shards.sort(key=lambda s: s.get_key())
            self._shards = shards
            self._shard_keys = [s.get_key() for s in shards]

    # ---- helpers ---------------------------------------------------------

    @contextmanager
    def _busy(self):
        """Mark a mutating operation in flight for is_busy()."""
        with self._busy_m:
            self._busy_n += 1
        try:
            yield
        finally:
            with self._busy_m:
                self._busy_n -= 1

    def is_busy(self) -> bool:
        """True while any put/put_removed/merge call is executing (any
        thread). QueryEngine.from_index wires this into the serving
        router's load-aware fallback, so the route flips within one batch
        of a merge starting or finishing."""
        return self._busy_n > 0

    def _snapshot(self) -> List[Shard]:
        with self._shards_m:
            return list(self._shards)

    def _find_shard(self, key: str) -> Optional[Shard]:
        with self._shards_m:
            keys = self._shard_keys
            i = bisect_left(keys, key)
            if i < len(keys) and keys[i] == key:
                return self._shards[i]
        return None

    def _new_shard(self, key: str) -> Shard:
        """Create (or find, double-checked) the shard directory
        (parity: inverted_index.go:160-188)."""
        with self._shards_m:
            keys = self._shard_keys
            i = bisect_left(keys, key)
            if i < len(keys) and keys[i] == key:
                return self._shards[i]
            shard = Shard(os.path.join(self.basedir, key))
            self._shards.insert(i, shard)
            self._shard_keys.insert(i, key)
            return shard

    # ---- ingest -----------------------------------------------------------

    # below this many terms, plain-Python sort/group beats the vectorized
    # router's fixed numpy/ctypes costs (~0.3ms/call) — the per-DOCUMENT
    # ingest grain of the reference's Put (inverted_index.go:113-145)
    _SMALL_PUT = 64

    @_tracks_busy
    def put(self, terms: List[bytes], value: int) -> None:
        """One document: all terms share one uint32 value. Terms are grouped
        by shard key; each touched shard gets ONE new direct segment
        (parity: inverted_index.go:113-145)."""
        if not terms:
            return
        if len(terms) <= self._SMALL_PUT:
            from .shard import shard_key

            groups: Dict[str, list] = {}
            for t in set(terms):
                groups.setdefault(shard_key(t), []).append(t)
            for key in sorted(groups):
                ts = sorted(groups[key])
                blob = b"".join(ts)
                offsets = np.empty(len(ts) + 1, dtype=np.int64)
                offsets[0] = 0
                np.cumsum([len(t) for t in ts], out=offsets[1:])
                shard = self._find_shard(key) or self._new_shard(key)
                shard.put_sorted(blob, offsets, value)
            return
        blob = b"".join(terms)
        offsets = np.zeros(len(terms) + 1, dtype=np.int64)
        np.cumsum([len(t) for t in terms], out=offsets[1:])
        self.put_packed(np.frombuffer(blob, dtype=np.uint8), offsets, value)

    @_tracks_busy
    def put_packed(self, blob: np.ndarray, offsets: np.ndarray, value: int) -> None:
        """Vectorized ingestion: terms as (uint8 array, offsets[n+1]).

        One global lexsort orders terms by (shard key, term bytes); shard
        groups fall out as contiguous slices, each written as one direct
        segment via the shard's pre-sorted fast path. Replaces the
        reference's per-term sort + grouping-iterator walk
        (inverted_index.go:116-136) with array ops.
        """
        from .codec import keys as keys_mod
        from .codec import native
        from .utils.ragged import ragged_gather

        n = len(offsets) - 1
        if n == 0:
            return
        if native.available():
            # C++ fast path: fused (shard, bytes) sort + dedupe + blob gather
            sh, sblob, soffs = native.ingest_sort_concat(blob, offsets)
            bounds = np.concatenate(
                [[0], np.nonzero(sh[1:] != sh[:-1])[0] + 1, [len(sh)]]
            )
            for g in range(len(bounds) - 1):
                lo, hi = int(bounds[g]), int(bounds[g + 1])
                key = f"{int(sh[lo]):04d}"
                shard = self._find_shard(key) or self._new_shard(key)
                sub_off = soffs[lo : hi + 1] - soffs[lo]
                # zero-copy views: put_sorted accepts uint8 arrays
                shard.put_sorted(sblob[int(soffs[lo]) : int(soffs[hi])], sub_off, value)
            return
        keys = keys_mod.pack_blob(blob, offsets)
        # shard id from the first two bytes (shard.go:362-378 semantics):
        # terms shorter than 2 bytes -> shard 0
        first_word = keys[:, 0]
        two = ((first_word >> 16) & 0xFFFF).astype(np.uint32)
        lens = np.diff(offsets)
        shard_ids = np.where(lens >= 2, two >> 6, 0).astype(np.uint32)

        cols = [keys[:, c] for c in range(keys.shape[1] - 1, -1, -1)]
        order = np.lexsort(tuple(cols) + (shard_ids,))
        ks = keys[order]
        sh = shard_ids[order]
        if n > 1:
            keep = np.concatenate(
                [[True], np.any(ks[1:] != ks[:-1], axis=1) | (sh[1:] != sh[:-1])]
            )
            order = order[keep]
            sh = sh[keep]
        slens = lens[order]
        sblob, _ = ragged_gather(blob, offsets[:-1][order], slens)
        soffs = np.zeros(len(order) + 1, dtype=np.int64)
        np.cumsum(slens, out=soffs[1:])

        # contiguous shard group boundaries
        bounds = np.concatenate(
            [[0], np.nonzero(sh[1:] != sh[:-1])[0] + 1, [len(sh)]]
        )
        for g in range(len(bounds) - 1):
            lo, hi = int(bounds[g]), int(bounds[g + 1])
            key = f"{int(sh[lo]):04d}"
            shard = self._find_shard(key) or self._new_shard(key)
            sub_off = soffs[lo : hi + 1] - soffs[lo]
            shard.put_sorted(sblob[int(soffs[lo]) : int(soffs[hi])], sub_off, value)

    @_tracks_busy
    def put_many(self, docs) -> None:
        """Batched ingest of many documents in one call: docs = iterable of
        (terms, value) pairs. Writes ONE new segment per TOUCHED SHARD for
        the whole batch — read results are identical to calling put() per
        document (the union semantics of file/types.go:14-22
        make (term, value) pairs grouping-insensitive), while the
        per-segment file-creation + publish cost amortizes across the batch
        (the reference's Put grain is one segment per doc per shard,
        shard.go:33-67 — its dominant cost at the per-document grain).

        Terms repeated across documents carry multiple values, so the batch
        segment is NORMAL mode (per-term posting lists)."""
        from .codec import keys as keys_mod
        from .utils.ragged import ragged_gather

        terms_flat: List[bytes] = []
        vals_list: List[int] = []
        for terms, value in docs:
            for t in terms:
                terms_flat.append(t)
                vals_list.append(value)
        if not terms_flat:
            return
        blob = np.frombuffer(b"".join(terms_flat), dtype=np.uint8)
        lens = np.array([len(t) for t in terms_flat], dtype=np.int64)
        offsets = np.zeros(len(terms_flat) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        vals = np.array(vals_list, dtype=np.uint32)

        keys = keys_mod.pack_blob(blob, offsets)
        two = ((keys[:, 0] >> 16) & 0xFFFF).astype(np.uint32)
        shard_ids = np.where(lens >= 2, two >> 6, 0).astype(np.uint32)
        # one lexsort orders occurrences by (shard, term bytes, value);
        # shard groups and per-term sorted-unique value runs fall out
        cols = tuple(keys[:, c] for c in range(keys.shape[1] - 1, -1, -1))
        order = np.lexsort((vals,) + cols + (shard_ids,))
        ks = keys[order]
        sh = shard_ids[order]
        sv = vals[order]
        if len(order) > 1:
            keep = np.concatenate(
                [[True],
                 np.any(ks[1:] != ks[:-1], axis=1)
                 | (sh[1:] != sh[:-1]) | (sv[1:] != sv[:-1])]
            )
            order, ks, sh, sv = order[keep], ks[keep], sh[keep], sv[keep]
        m = len(order)
        new_term = np.concatenate(
            [[True], np.any(ks[1:] != ks[:-1], axis=1) | (sh[1:] != sh[:-1])]
        )
        bounds = np.concatenate(
            [[0], np.nonzero(sh[1:] != sh[:-1])[0] + 1, [m]]
        )
        for g in range(len(bounds) - 1):
            lo, hi = int(bounds[g]), int(bounds[g + 1])
            heads = np.nonzero(new_term[lo:hi])[0] + lo   # pair-rows starting a term
            tl = lens[order[heads]]
            tblob, _ = ragged_gather(blob, offsets[:-1][order[heads]], tl)
            toffs = np.zeros(len(heads) + 1, dtype=np.int64)
            np.cumsum(tl, out=toffs[1:])
            voffs = np.concatenate([heads, [hi]]).astype(np.int64) - lo
            key = f"{int(sh[lo]):04d}"
            shard = self._find_shard(key) or self._new_shard(key)
            shard.put_sorted_many(tblob, toffs, sv[lo:hi], voffs)

    # ---- delete ------------------------------------------------------------

    @_tracks_busy
    def put_removed(self, values) -> None:
        """Append tombstones in every shard, parallel with bounded fan-out
        (parity: inverted_index.go:41-55)."""
        shards = self._snapshot()
        values = np.asarray(values, dtype=np.uint32)
        if not shards:
            return
        with ThreadPoolExecutor(max_workers=_NCPU) as pool:
            list(pool.map(lambda s: s.remove(values), shards))

    # ---- compaction ----------------------------------------------------------

    @_tracks_busy
    def merge(self, req_count: int, m_count: int, concurrency: int) -> int:
        """Per-shard compaction spread over `concurrency` workers; returns the
        total number of input segments consumed across shards (parity:
        inverted_index.go:62-109). Callers loop until it returns 0."""
        shards = self._snapshot()
        work: "queue.Queue[Shard]" = queue.Queue()
        for s in shards:
            work.put(s)
        total = 0
        total_lock = threading.Lock()
        errs: List[BaseException] = []

        def worker():
            nonlocal total
            while True:
                try:
                    s = work.get_nowait()
                except queue.Empty:
                    return
                t0 = time.monotonic()
                try:
                    merged = s.merge(req_count, m_count)
                except BaseException as e:  # propagate after drain
                    errs.append(e)
                    return
                if merged > 0 and self.enable_logging:
                    logger.info(
                        "Shard %s merged %d segments in %.3fs",
                        s.get_key(), merged, time.monotonic() - t0,
                    )
                with total_lock:
                    total += merged

        threads = [threading.Thread(target=worker) for _ in range(max(1, concurrency))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return total

    # ---- read -----------------------------------------------------------------

    def read(
        self, min_term: Optional[bytes] = None, max_term: Optional[bytes] = None
    ) -> SequentialDynamicIterator:
        """Globally sorted TermValues stream over all shards, [min,max]
        inclusive, nil = unbounded. Lazy: opens one shard at a time; shards
        wholly outside the range are pruned by their min/max terms (parity:
        inverted_index.go:300-340). Tombstones are NOT applied (they act only
        at merge). Close() releases segment pins."""
        shards = []
        for s in self._snapshot():
            mm = s.min_max()
            if mm is None:
                continue
            if min_term is not None and min_term > mm[1]:
                continue
            if max_term is not None and max_term < mm[0]:
                continue
            shards.append(s)

        shards_iter = iter(shards)

        def pick_next():
            s = next(shards_iter, None)
            if s is None:
                return None
            return s.read(min_term, max_term)

        return SequentialDynamicIterator(pick_next)

    def read_bulk(
        self, min_term: Optional[bytes] = None, max_term: Optional[bytes] = None
    ):
        """Columnar bulk read: the whole [min,max] inclusive range as four
        arrays (blob uint8, offsets[n+1], values uint32, voffs[n+1]) — the
        zero-Python-loop counterpart of read() for bulk consumers (exports,
        reindexing, snapshot feeds). Same union/tombstone semantics as
        read(); returns None when the range is empty."""
        from .segment.registry import Segments
        from .shard import merge_views

        views, pinned_all = [], []
        for s in self._snapshot():
            pinned = s.segments.pin_all()
            pinned_all.append(pinned)
            views.extend(
                sg.view
                for sg in pinned
                if sg.view is not None and sg.view.overlaps(min_term, max_term)
            )
        try:
            merged = merge_views(views, None)
        finally:
            for pinned in pinned_all:
                Segments.release(pinned)
        if merged is None:
            return None
        blob, offsets, values, voffs = merged
        n = len(offsets) - 1
        blob_arr = np.frombuffer(blob, dtype=np.uint8)

        def term_at(i):
            return blob_arr[offsets[i] : offsets[i + 1]].tobytes()

        lo, hi = 0, n
        if min_term is not None:
            a, b = 0, n
            while a < b:
                m = (a + b) // 2
                if term_at(m) < min_term:
                    a = m + 1
                else:
                    b = m
            lo = a
        if max_term is not None:
            a, b = lo, n
            while a < b:
                m = (a + b) // 2
                if term_at(m) <= max_term:
                    a = m + 1
                else:
                    b = m
            hi = a
        if hi <= lo:
            return None
        sub_blob = blob_arr[offsets[lo] : offsets[hi]]
        sub_off = offsets[lo : hi + 1] - offsets[lo]
        sub_vals = values[voffs[lo] : voffs[hi]]
        sub_voffs = voffs[lo : hi + 1] - voffs[lo]
        return sub_blob, sub_off, sub_vals, sub_voffs

    # ---- observability --------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        """Lightweight counters (the reference's only metrics are merge
        counts + optional merge-duration logs, inverted_index.go:97-99;
        this is the structured equivalent)."""
        shards = self._snapshot()
        seg_counts = [len(s.segments) for s in shards]
        return {
            "shards": len(shards),
            "segments": int(sum(seg_counts)),
            "max_segments_per_shard": int(max(seg_counts, default=0)),
            "terms": int(
                sum(seg.terms for s in shards for seg in s.segments.snapshot())
            ),
            "removed_batches": int(sum(len(s.removed_list) for s in shards)),
        }

    # ---- prefix search -----------------------------------------------------------

    def prefix_search(self, prefixes: List[bytes]) -> Dict[bytes, np.ndarray]:
        """For each prefix: sorted unique union of the values of all terms
        starting with it; unmatched prefixes are absent from the result
        (parity: inverted_index.go:192-295). Shards are pruned by comparing
        each prefix against the shard's min/max terms truncated to the prefix
        length, then scanned concurrently."""
        found: Dict[bytes, list] = {}
        found_m = threading.Lock()
        prefixes = sorted(prefixes)

        shard_prefixes: Dict[int, List[bytes]] = {}
        shards = []
        for s in self._snapshot():
            mm = s.min_max()
            if mm is None:
                continue
            mine = []
            for p in prefixes:
                l0 = min(len(p), len(mm[0]))
                if p[:l0] < mm[0][:l0]:
                    continue
                l1 = min(len(p), len(mm[1]))
                if p[:l1] > mm[1][:l1]:
                    continue
                mine.append(p)
            if mine:
                shard_prefixes[id(s)] = mine
                shards.append(s)

        def scan(s: Shard):
            mine = shard_prefixes[id(s)]
            it = s.read(mine[0], None)
            try:
                for tv in it:
                    # Early stop once the term is past EVERY prefix's range.
                    # (The reference stops when past the lexicographically
                    # greatest prefix, inverted_index.go:266-271 — which
                    # wrongly drops matches of a shorter prefix that contains
                    # the greatest one, e.g. prefixes [ban, band] lose
                    # "banjo" for "ban". Monotone-correct version here.)
                    if all(tv.term[: len(p)] > p for p in mine):
                        break
                    for p in mine:
                        if tv.term.startswith(p):
                            with found_m:
                                found.setdefault(p, []).append(tv.values)
            finally:
                it.close()

        if shards:
            with ThreadPoolExecutor(max_workers=_NCPU) as pool:
                list(pool.map(scan, shards))

        out: Dict[bytes, np.ndarray] = {}
        for p, chunks in found.items():
            vals = np.unique(np.concatenate(chunks)).astype(np.uint32)
            out[p] = vals
        return out
