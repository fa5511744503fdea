"""In-memory segment registry: sorted-by-size list + reader pinning protocol.

Replaces segments.go. The reference coordinates readers and
the merger with a per-segment RWMutex (readers RLock, deletion spin-waits on
TryLock, shard.go:233-242) plus an atomic `merging` CAS flag. We use an
explicit refcount + condition variable: readers pin segments; the merger
CAS-claims segments (merging flag under the registry lock), detaches them, and
waits for pins to drain before deleting files. Same guarantees:

 * readers never block writers or merges,
 * a segment's files are deleted only after the last reader releases it,
 * the registry list stays sorted by terms count ascending so merge always
   claims the smallest segments first (segments.go:56-64).
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional

from .reader import SegmentView


class Segment:
    """Registry entry for one immutable on-disk segment."""

    __slots__ = (
        "key", "terms", "min_term", "max_term", "view", "pins", "merging",
        "_cv", "_drop_cb",
    )

    def __init__(self, key: str, terms: int, min_term, max_term, view: Optional[SegmentView]):
        self.key = key
        self.terms = terms
        self.min_term = min_term
        self.max_term = max_term
        self.view = view
        self.pins = 0
        self.merging = False
        self._cv = threading.Condition()
        self._drop_cb: Optional[Callable[[], None]] = None

    def pin(self) -> None:
        with self._cv:
            self.pins += 1

    def unpin(self) -> None:
        cb = None
        with self._cv:
            self.pins -= 1
            if self.pins == 0:
                self._cv.notify_all()
                cb, self._drop_cb = self._drop_cb, None
        if cb is not None:
            cb()

    def drop_when_drained(self, cb: Callable[[], None]) -> None:
        """Run cb (file deletion) once no reader pins remain.

        The reference BLOCKS compaction spinning on TryLock+Gosched until
        readers drain (shard.go:235-237) — which deadlocks a
        thread that merges while holding its own open reader. We instead
        defer deletion to the last unpin; merge returns immediately. With no
        readers open the deletion is synchronous, so on-disk segment counts
        observed after merge match the reference exactly."""
        run = False
        with self._cv:
            if self.pins == 0:
                run = True
            else:
                self._drop_cb = cb
        if run:
            cb()

    def wait_unpinned(self) -> None:
        """Block until no reader pins remain."""
        with self._cv:
            while self.pins > 0:
                self._cv.wait()


class Segments:
    """Thread-safe registry of live segments, sorted by terms count ascending."""

    def __init__(self) -> None:
        self.list: List[Segment] = []
        self._m = threading.RLock()

    def add(self, segment: Segment) -> None:
        with self._m:
            # binary insert by terms count (stable wrt existing order)
            lo, hi = 0, len(self.list)
            while lo < hi:
                mid = (lo + hi) // 2
                if self.list[mid].terms <= segment.terms:
                    lo = mid + 1
                else:
                    hi = mid
            self.list.insert(lo, segment)

    def __len__(self) -> int:
        with self._m:
            return len(self.list)

    def snapshot(self) -> List[Segment]:
        with self._m:
            return list(self.list)

    def pin_all(self) -> List[Segment]:
        """Pin every live segment and return the pinned snapshot
        (readLockAll, segments.go:32-40)."""
        with self._m:
            snap = list(self.list)
            for s in snap:
                s.pin()
            return snap

    @staticmethod
    def release(segments: List[Segment]) -> None:
        for s in segments:
            s.unpin()

    def claim_for_merge(self, max_count: int) -> List[Segment]:
        """CAS-claim up to max_count smallest unclaimed segments
        (shard.go:136-146). Claimed segments stay visible to readers until
        detach()."""
        with self._m:
            claimed = []
            for s in self.list:
                if len(claimed) == max_count:
                    break
                if not s.merging:
                    s.merging = True
                    claimed.append(s)
            return claimed

    @staticmethod
    def unclaim(segments: List[Segment]) -> None:
        for s in segments:
            s.merging = False

    def detach(self, segments: List[Segment]) -> None:
        """Remove merged segments from the registry (invisible to new readers,
        segments.go:72-93)."""
        gone = set(id(s) for s in segments)
        with self._m:
            self.list = [s for s in self.list if id(s) not in gone]
