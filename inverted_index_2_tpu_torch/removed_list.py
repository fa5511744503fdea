"""Timestamped tombstone lists (logical deletes).

Replaces removed_list.go. Each removal batch is keyed by a
unix-nano timestamp; batches are garbage-collected once older than every live
segment (Sync, removed_list.go:57-71) because by then every segment that could
contain those values has been merged (and the values physically purged).

Serialization is a simple little-endian binary format instead of Go's gob:

    u32 magic 0x54504952 ("TPIR"), u32 version=1, u32 count, u32 pad
    count entries of: i64 timestamp, u64 n, u32 values[n]
"""
from __future__ import annotations

import struct
import threading
from typing import Dict, Iterable, List

import numpy as np

MAGIC = 0x54504952
_HDR = struct.Struct("<IIII")
_ENT = struct.Struct("<qQ")


class RemovedLists:
    def __init__(self, lists: Dict[int, np.ndarray] | None = None):
        self.lists: Dict[int, np.ndarray] = {
            int(k): np.asarray(v, dtype=np.uint32) for k, v in (lists or {}).items()
        }
        self._m = threading.RLock()

    def put(self, timestamp: int, values: Iterable[int] | np.ndarray) -> None:
        with self._m:
            self.lists[int(timestamp)] = np.asarray(values, dtype=np.uint32)

    def values(self) -> np.ndarray:
        """All removed values combined, sorted (for binary-search filtering
        during merge — removed_list.go:44-54). Not deduplicated, matching the
        reference (sorted-with-duplicates is equally valid for searchsorted)."""
        with self._m:
            if not self.lists:
                return np.zeros(0, dtype=np.uint32)
            out = np.concatenate(list(self.lists.values()))
        out.sort()
        return out

    def sync(self, segment_timestamps: List[int]) -> None:
        """Drop batches older than the oldest live segment
        (removed_list.go:57-71). No-op when no segments are live."""
        if not segment_timestamps:
            return
        oldest = min(segment_timestamps)
        with self._m:
            for t in [t for t in self.lists if t < oldest]:
                del self.lists[t]

    def serialize(self) -> bytes:
        with self._m:
            items = sorted(self.lists.items())
        parts = [_HDR.pack(MAGIC, 1, len(items), 0)]
        for ts, vals in items:
            parts.append(_ENT.pack(ts, len(vals)))
            parts.append(np.asarray(vals, dtype="<u4").tobytes())
        return b"".join(parts)

    def __len__(self) -> int:
        with self._m:
            return len(self.lists)


def unserialize_removed_list(raw: bytes) -> RemovedLists:
    magic, version, count, _ = _HDR.unpack_from(raw, 0)
    if magic != MAGIC or version != 1:
        raise ValueError("bad removed.list file")
    off = _HDR.size
    lists: Dict[int, np.ndarray] = {}
    for _ in range(count):
        ts, n = _ENT.unpack_from(raw, off)
        off += _ENT.size
        lists[ts] = np.frombuffer(raw, dtype="<u4", count=n, offset=off).copy()
        off += n * 4
    return RemovedLists(lists)
