"""Dictionary-encoded bitmap codec (counterpart of codec/bitmask.py; parity
with the reference's orphan file/bitmask.go).

The reference keeps an experimental roaring-bitmap codec in-tree
(file/bitmask.go:11-16, not referenced by any non-test code):
a growing dictionary of distinct uint32 values per file, with each term's
value set encoded as a bitmap over dictionary INDEXES — amortizing the value
storage across terms that share values. We provide the same capability with a
vectorized dense-bitmap encoding (an array-friendly stand-in for roaring's
container machinery): bitmaps over dictionary indexes are small because
indexes are dense by construction, which is exactly the regime where roaring
degrades to its dense (bitset) container anyway.

Wire format per encoded batch (little-endian):
    u32 n_words | n_words * u32 bitset words (bit i = dictionary index i)

Like the reference (bitmask_test.go:34-53), encodings are self-delimiting and
stream-decodable. Like the reference (`indexOf` appends unseen values,
bitmask.go:64-71), the dictionary grows on Put — but membership here is a
hash-map lookup, not an O(n) scan.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


class Bitmask:
    """Per-file value dictionary + bitmap encoder/decoder."""

    def __init__(self, values: np.ndarray | None = None):
        self._values: List[int] = []
        self._index: Dict[int, int] = {}
        if values is not None:
            for v in np.asarray(values, dtype=np.uint32).tolist():
                self._intern(v)

    def _intern(self, v: int) -> int:
        i = self._index.get(v)
        if i is None:
            i = len(self._values)
            self._values.append(v)
            self._index[v] = i
        return i

    def all_values(self) -> np.ndarray:
        """The dictionary, in insertion order (parity: bitmask.go:24-27)."""
        return np.asarray(self._values, dtype=np.uint32)

    def put(self, values: np.ndarray) -> bytes:
        """Encode a batch of values as a bitmap over dictionary indexes,
        growing the dictionary for unseen values (parity: bitmask.go:53-62)."""
        idxs = np.array([self._intern(int(v)) for v in np.asarray(values, dtype=np.uint32)],
                        dtype=np.int64)
        if len(idxs) == 0:
            return np.uint32(0).astype("<u4").tobytes()
        n_words = int(idxs.max()) // 32 + 1
        words = np.zeros(n_words, dtype=np.uint32)
        np.bitwise_or.at(words, idxs // 32, np.uint32(1) << (idxs % 32).astype(np.uint32))
        return np.uint32(n_words).astype("<u4").tobytes() + words.astype("<u4").tobytes()

    def get(self, encoded: bytes, offset: int = 0) -> tuple[np.ndarray, int]:
        """Decode one batch at `offset`; returns (values, bytes consumed)
        (parity: bitmask.go:30-49, incl. stream decoding of bitmask_test.go)."""
        n_words = int(np.frombuffer(encoded, dtype="<u4", count=1, offset=offset)[0])
        words = np.frombuffer(encoded, dtype="<u4", count=n_words, offset=offset + 4)
        if n_words == 0:
            return np.zeros(0, dtype=np.uint32), 4
        bits = (
            (words[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & np.uint32(1)
        ).astype(bool).reshape(-1)
        idxs = np.nonzero(bits)[0]
        vals = self.all_values()[idxs]
        return vals.astype(np.uint32), 4 + 4 * n_words
