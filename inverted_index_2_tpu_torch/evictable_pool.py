"""Generic TTL-evicting object pool.

Replaces evictable_pool.go (there: reuses vellum FST writers
across Put/Merge calls; here: reuses the compaction staging buffers — see
shard._MergeScratch / merge_views — shared process-wide across shards).
A background daemon thread ticks every `max_age` and evicts items idle longer
than `max_age`; Close() stops the monitor.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Generic, List, Optional, Tuple, TypeVar

T = TypeVar("T")


class Pool(Generic[T]):
    def __init__(self, max_age: float, factory: Callable[[], T]):
        self._list: Optional[List[Tuple[T, float]]] = []
        self._m = threading.Lock()
        self._factory = factory
        self._max_age = max_age
        self._stop = threading.Event()
        self._monitor = threading.Thread(target=self._run_monitor, daemon=True)
        self._monitor.start()

    def get(self) -> T:
        """Pop the oldest pooled object, or build a fresh one
        (evictable_pool.go:25-36)."""
        with self._m:
            if self._list:
                item, _ = self._list.pop(0)
                return item
        return self._factory()

    def put(self, item: T) -> None:
        with self._m:
            if self._list is not None:
                self._list.append((item, time.monotonic()))

    def size(self) -> int:
        with self._m:
            return len(self._list) if self._list is not None else 0

    def _run_monitor(self) -> None:
        while not self._stop.wait(self._max_age):
            with self._m:
                if self._list is None:
                    return
                now = time.monotonic()
                self._list = [(i, t) for (i, t) in self._list if now - t < self._max_age]

    def close(self) -> None:
        """Stop the monitor and drop pooled objects (evictable_pool.go:73-75,
        but race-free unlike the reference's unsynchronized nil-out)."""
        self._stop.set()
        with self._m:
            self._list = None
