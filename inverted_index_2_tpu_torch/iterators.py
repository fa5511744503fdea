"""Iterator algebra over TermValues streams.

Replaces the reference's `lezhnev74/go-iterators` dependency (k-way merging,
grouping, lazy sequential concat, closing hooks — see go.mod:8 and usages at
shard.go:267, inverted_index.go:118,338). The Go library's
`EmptyIterator` error sentinel maps onto Python's StopIteration protocol.

These iterators are HOST-side plumbing at the file/stream boundary only — the
bulk read/merge/query paths use vectorized array ops (ops/, shard.merge); this
module serves the streaming Read(min,max) API and tests.
"""
from __future__ import annotations

import heapq
from typing import Callable, Iterable, Iterator, List, NamedTuple, Optional

import numpy as np


class TermValues(NamedTuple):
    """The record type flowing through every stream
    (parity: file/types.go:9-12)."""

    term: bytes
    values: np.ndarray  # sorted unique uint32


def merge_term_values(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Union of two sorted unique value sets, sorted unique
    (parity: file/types.go:14-22)."""
    return np.union1d(a, b).astype(np.uint32)


def compare_term_values(a: TermValues, b: TermValues) -> int:
    """bytes.Compare on term (parity: file/types.go:24-26)."""
    return (a.term > b.term) - (a.term < b.term)


class MergingIterator:
    """K-way merge of sorted TermValues streams, merging equal terms.

    Equivalent of go_iterators.NewMergingIterator with CompareTermValues /
    MergeTermValues (shard.go:267)."""

    def __init__(self, iterators: List[Iterator[TermValues]]):
        self._heap: List[tuple] = []
        self._iters = iterators
        for idx, it in enumerate(iterators):
            self._push(idx, it)

    def _push(self, idx: int, it: Iterator[TermValues]) -> None:
        try:
            tv = next(it)
        except StopIteration:
            return
        heapq.heappush(self._heap, (tv.term, idx, tv.values, it))

    def __iter__(self):
        return self

    def __next__(self) -> TermValues:
        if not self._heap:
            raise StopIteration
        term, idx, values, it = heapq.heappop(self._heap)
        self._push(idx, it)
        while self._heap and self._heap[0][0] == term:
            _, idx2, values2, it2 = heapq.heappop(self._heap)
            values = merge_term_values(values, values2)
            self._push(idx2, it2)
        return TermValues(term, np.asarray(values, dtype=np.uint32))


class ClosingIterator:
    """Wraps an iterator with a close hook that runs exactly once — used to
    release segment pins (parity: shard.go:268-275). Also runs the hook when
    the stream is exhausted or the object is GC'd."""

    def __init__(self, inner: Iterator[TermValues], on_close: Callable[[], None]):
        self._inner = inner
        self._on_close = on_close
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self) -> TermValues:
        try:
            return next(self._inner)
        except StopIteration:
            self.close()
            raise

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._on_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class SequentialDynamicIterator:
    """Lazily concatenates iterators produced on demand — opens one shard at a
    time (parity: inverted_index.go:330-339)."""

    def __init__(self, pick_next: Callable[[], Optional[Iterator[TermValues]]]):
        self._pick_next = pick_next
        self._cur: Optional[Iterator[TermValues]] = None
        self._done = False

    def __iter__(self):
        return self

    def __next__(self) -> TermValues:
        while True:
            if self._done:
                raise StopIteration
            if self._cur is None:
                self._cur = self._pick_next()
                if self._cur is None:
                    self._done = True
                    raise StopIteration
            try:
                return next(self._cur)
            except StopIteration:
                self._close_cur()

    def _close_cur(self) -> None:
        cur, self._cur = self._cur, None
        if cur is not None and hasattr(cur, "close"):
            cur.close()

    def close(self) -> None:
        self._close_cur()
        self._done = True


def group_by(items: Iterable, key: Callable) -> Iterator[list]:
    """Group consecutive items with equal keys
    (parity: go_iterators.NewGroupingIterator, inverted_index.go:118-119)."""
    group: list = []
    cur_key = None
    for item in items:
        k = key(item)
        if group and k != cur_key:
            yield group
            group = []
        cur_key = k
        group.append(item)
    if group:
        yield group


def to_slice(it: Iterator[TermValues]) -> List[TermValues]:
    """Drain an iterator (parity: go_iterators.ToSlice, used in tests)."""
    out = list(it)
    if hasattr(it, "close"):
        it.close()
    return out
