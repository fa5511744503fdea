"""Segment reader: mmap-backed columnar view of one immutable segment.

Replaces the reference's file.Reader (file/reader.go): instead
of walking an FST iterator term-by-term and peeking the next offset to size
each compressed run (reader.go:44-69), a SegmentView exposes the whole segment
as arrays — offsets, outs, blob, posting words — and serves:

 * O(log n) exact / lower-bound term search (bytes.Compare semantics),
 * range iteration [min, max] inclusive (nil = unbounded) yielding TermValues,
 * bulk columnar access for the device loaders (models/query_engine.py) and
   the vectorized merge (ops used by shard.merge).

The _vals file is np.memmap'd (parity: reference mmaps via x/exp/mmap,
reader.go:176-180). The retry/buffer-doubling of reader.go:79-98 has no
equivalent: runs are self-delimiting in our codec.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from ..codec import keys as keys_mod
from ..codec import packing
from . import formats
from .formats import MODE_DIRECT, MODE_NORMAL


class SegmentView:
    """Immutable view of one on-disk segment.

    The _dict file is np.memmap'd and its arrays materialize LAZILY: opening
    a segment touches only the header plus the first/last term slices (the
    reference also opens segments lazily — the FST walks on demand,
    reader.go:176-180; shard recovery reads only Len/GetMinKey/GetMaxKey,
    shard.go:318-334). Bulk scans/merges materialize offsets/outs on first
    use via the `offsets`/`outs` properties.
    """

    def __init__(self, basedir: str, key: str):
        self.basedir = basedir
        self.key = key
        path = formats.dict_path(basedir, key)
        mm = np.memmap(path, dtype=np.uint8, mode="r")
        hdr = formats.read_header(bytes(mm[: formats.HEADER_SIZE]))
        self.mode = hdr.mode
        self.n_terms = n = hdr.n_terms
        off = formats.HEADER_SIZE
        off_dt, off_w = (
            ("<u4", 4) if hdr.flags & formats.FLAG_OFFSETS_U32 else ("<u8", 8)
        )
        out_dt, out_w = (
            ("<u4", 4) if hdr.flags & formats.FLAG_OUTS_U32 else ("<u8", 8)
        )
        if hdr.flags & formats.FLAG_FIXED_WIDTH:
            self._fixed_width = int(mm[off : off + off_w].view(off_dt)[0])
            if self._fixed_width * n != hdr.blob_len:
                raise ValueError("segment dict corrupt (fixed width != blob)")
            self._off_mm = None
            off += off_w
        else:
            self._fixed_width = None
            end = off + (n + 1) * off_w
            if end > len(mm):
                raise ValueError("segment dict truncated (offsets)")
            self._off_mm = mm[off:end].view(off_dt)
            off = end
        if hdr.flags & formats.FLAG_OUTS_CONST:
            self._const_out = int(mm[off : off + out_w].view(out_dt)[0])
            self._out_mm = None
            off += out_w
        else:
            self._const_out = None
            end = off + n * out_w
            if end > len(mm):
                raise ValueError("segment dict truncated (outs)")
            self._out_mm = mm[off:end].view(out_dt)
            off = end
        if off + hdr.blob_len > len(mm):
            raise ValueError("segment dict truncated (blob)")
        self.blob = mm[off : off + hdr.blob_len]
        self._mm = mm  # keep mapping alive
        self._offsets: Optional[np.ndarray] = None
        self._outs: Optional[np.ndarray] = None
        if self.mode == MODE_NORMAL:
            vpath = formats.vals_path(basedir, key)
            sz = os.path.getsize(vpath)
            self.words = (
                np.memmap(vpath, dtype="<u4", mode="r")
                if sz
                else np.zeros(0, dtype=np.uint32)
            )
        else:
            self.words = None
        self._keys_cache: Optional[np.ndarray] = None

    @classmethod
    def from_arrays(
        cls,
        basedir: str,
        key: str,
        mode: int,
        offsets: np.ndarray,
        outs: np.ndarray,
        blob,
        words: Optional[np.ndarray] = None,
    ) -> "SegmentView":
        """Construct a view directly from the writer's in-memory arrays,
        skipping the read-back of the file just written (the write path's
        equivalent of the reference registering segment metadata it already
        has, shard.go:64)."""
        self = cls.__new__(cls)
        self.basedir = basedir
        self.key = key
        self.mode = mode
        self.n_terms = len(offsets) - 1
        self._offsets = np.asarray(offsets, dtype=np.int64)
        self._outs = np.asarray(outs, dtype=np.uint64)
        self._off_mm = None
        self._out_mm = None
        self._fixed_width = None
        self._const_out = None
        self.blob = (
            np.frombuffer(blob, dtype=np.uint8) if isinstance(blob, bytes) else np.asarray(blob)
        )
        self._mm = None
        self.words = words if mode == MODE_NORMAL else None
        if self.words is None and mode == MODE_NORMAL:
            self.words = np.zeros(0, dtype=np.uint32)
        self._keys_cache = None
        return self

    # ---- lazy array materialization ----------------------------------------

    @property
    def offsets(self) -> np.ndarray:
        if self._offsets is None:
            if self._fixed_width is not None:
                self._offsets = (
                    np.arange(self.n_terms + 1, dtype=np.int64) * self._fixed_width
                )
            else:
                self._offsets = self._off_mm.astype(np.int64)
        return self._offsets

    @property
    def outs(self) -> np.ndarray:
        if self._outs is None:
            if self._const_out is not None:
                self._outs = np.broadcast_to(
                    np.uint64(self._const_out), self.n_terms
                )
            else:
                self._outs = self._out_mm.astype(np.uint64)
        return self._outs

    def _off(self, i: int) -> int:
        """One offset without materializing the whole array."""
        if self._offsets is not None:
            return int(self._offsets[i])
        if self._fixed_width is not None:
            return i * self._fixed_width
        return int(self._off_mm[i])

    # ---- term access -----------------------------------------------------

    def term(self, i: int) -> bytes:
        return self.blob[self._off(i) : self._off(i + 1)].tobytes()

    @property
    def min_term(self) -> Optional[bytes]:
        return self.term(0) if self.n_terms else None

    @property
    def max_term(self) -> Optional[bytes]:
        return self.term(self.n_terms - 1) if self.n_terms else None

    def keys(self, width: Optional[int] = None) -> np.ndarray:
        """Packed (n, W+1) uint32 key matrix for device search / merge."""
        if self._keys_cache is None or (
            width is not None and self._keys_cache.shape[1] != width + 1
        ):
            self._keys_cache = keys_mod.pack_blob(self.blob, self.offsets, width)
        return self._keys_cache

    @property
    def max_term_len(self) -> int:
        if self.n_terms == 0:
            return 0
        return int(np.max(np.diff(self.offsets)))

    # ---- binary search (host) ---------------------------------------------

    def _bisect(self, term: bytes, right: bool = False) -> int:
        lo, hi = 0, self.n_terms
        while lo < hi:
            mid = (lo + hi) // 2
            t = self.term(mid)
            if (t <= term) if right else (t < term):
                lo = mid + 1
            else:
                hi = mid
        return lo

    def lower_bound(self, term: Optional[bytes]) -> int:
        return 0 if term is None else self._bisect(term)

    def upper_bound(self, term: Optional[bytes]) -> int:
        return self.n_terms if term is None else self._bisect(term, right=True)

    def find(self, term: bytes) -> int:
        """Exact-match index or -1."""
        i = self._bisect(term)
        if i < self.n_terms and self.term(i) == term:
            return i
        return -1

    # ---- posting access ----------------------------------------------------

    def values(self, i: int) -> np.ndarray:
        if self.mode == MODE_DIRECT:
            return np.array([self.outs[i]], dtype=np.uint32)
        return packing.decode_postings(self.words, int(self.outs[i]))

    def value_count(self, i: int) -> int:
        if self.mode == MODE_DIRECT:
            return 1
        return int(self.words[int(self.outs[i])])

    def decode_all(self, lo: int = 0, hi: Optional[int] = None):
        """Bulk decode postings of terms [lo, hi): (values, counts, voffs)."""
        hi = self.n_terms if hi is None else hi
        if self.mode == MODE_DIRECT:
            vals = self.outs[lo:hi].astype(np.uint32)
            counts = np.ones(hi - lo, dtype=np.int64)
            voffs = np.arange(hi - lo + 1, dtype=np.int64)
            return vals, counts, voffs
        return packing.decode_bulk(self.words, self.outs[lo:hi].astype(np.int64))

    # ---- iteration ----------------------------------------------------------

    _ITER_CHUNK = 4096

    def iterate(
        self, min_term: Optional[bytes] = None, max_term: Optional[bytes] = None
    ) -> Iterator[tuple[bytes, np.ndarray]]:
        """Yield (term, values) over [min_term, max_term] inclusive.

        Range semantics match the reference Reader (reader.go:136-155 +
        manual right-boundary check at :54-58). Postings are bulk-decoded in
        chunks (C++/vectorized) instead of one Python decode per term — the
        reference's per-term streaming decode (reader.go:100) would make
        large host scans interpreter-bound.
        """
        lo = self.lower_bound(min_term)
        hi = self.upper_bound(max_term)
        if hi > lo:
            self.offsets  # materialize once: term() then skips the lazy path
        for c0 in range(lo, hi, self._ITER_CHUNK):
            c1 = min(c0 + self._ITER_CHUNK, hi)
            vals, counts, voffs = self.decode_all(c0, c1)
            for i in range(c0, c1):
                j = i - c0
                yield self.term(i), vals[voffs[j] : voffs[j + 1]]

    def overlaps(self, min_term: Optional[bytes], max_term: Optional[bytes]) -> bool:
        """True if the segment may contain terms in [min,max] — used to skip
        segments entirely (parity with the ErrIteratorDone skip at
        shard.go:257-260)."""
        if self.n_terms == 0:
            return False
        if min_term is not None and self.max_term < min_term:
            return False
        if max_term is not None and self.min_term > max_term:
            return False
        return True
