"""Fixed-width term sort keys: exact bytes.Compare order on TPU-friendly arrays.

The reference stores terms in a vellum FST (sorted byte-string dictionary,
file/writer.go:35, reader.go:139-150). A TPU cannot walk an
automaton; instead each term is packed into a fixed-width row of uint32 words:

    key(term) = [ big-endian 4-byte groups of term, zero-padded to W words,
                  len(term) ]                                  -> (W+1,) uint32

Claim (exactness): for any two byte strings a, b:
    bytes_compare(a, b) == lexicographic_compare(key(a), key(b))
Proof sketch: big-endian packing makes per-word uint32 comparison equal to
byte-wise comparison of that 4-byte group; zero padding can only make a
shorter string compare equal-up-to-its-length, and the trailing length word
breaks exactly the remaining ties (a proper prefix is smaller — matching Go's
bytes.Compare). Handles embedded zero bytes correctly ("ab" < "ab\\x00").

This file is pure numpy (host). ops/dict_search.py consumes the same layout in
torch for on-device batched binary search and hash resolve.
"""
from __future__ import annotations

import numpy as np


def width_words(max_len: int) -> int:
    """Number of 4-byte words needed for terms up to max_len bytes (min 1)."""
    return max(1, -(-max_len // 4))


def pack_blob(blob: bytes | np.ndarray, offsets: np.ndarray, width: int | None = None) -> np.ndarray:
    """Pack terms stored as (blob, offsets[n+1]) into an (n, W+1) uint32 key matrix.

    `width` (in words) may be given to force a common width across segments
    (needed when merging/searching multiple segments together).
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    arr = np.frombuffer(blob, dtype=np.uint8) if not isinstance(blob, np.ndarray) else blob
    lens = np.diff(offsets)
    W = width if width is not None else width_words(int(lens.max()) if n else 0)
    nbytes = W * 4
    if n == 0:
        return np.zeros((0, W + 1), dtype=np.uint32)
    if n >= 512:
        from . import native

        if native.available():
            return native.pack_keys(arr, offsets, W)
    if len(arr) == 0:
        mat = np.zeros((n, nbytes), dtype=np.uint32)
    else:
        idx = offsets[:-1, None] + np.arange(nbytes, dtype=np.int64)[None, :]
        mask = idx < offsets[1:, None]
        idx = np.minimum(idx, len(arr) - 1)
        mat = np.where(mask, arr[idx], 0).astype(np.uint32)
    g = mat.reshape(n, W, 4)
    words = (g[:, :, 0] << 24) | (g[:, :, 1] << 16) | (g[:, :, 2] << 8) | g[:, :, 3]
    out = np.empty((n, W + 1), dtype=np.uint32)
    out[:, :W] = words
    out[:, W] = lens.astype(np.uint32)
    return out


def pack_terms(terms: list[bytes], width: int | None = None) -> np.ndarray:
    """Pack a list of byte-string terms into an (n, W+1) uint32 key matrix."""
    blob = b"".join(terms)
    offsets = np.zeros(len(terms) + 1, dtype=np.int64)
    # fromiter(map(len, ...)) skips the intermediate Python list (~2x on
    # the 1-vCPU host; packing is on the serving hot path)
    np.cumsum(
        np.fromiter(map(len, terms), dtype=np.int64, count=len(terms)),
        out=offsets[1:],
    )
    return pack_blob(np.frombuffer(blob, dtype=np.uint8), offsets, width)


def pack_one(term: bytes, width: int) -> np.ndarray:
    """Pack a single term to a (width+1,) uint32 key row."""
    return pack_terms([term], width)[0]


def prefix_bounds(prefixes: list[bytes], width: int) -> tuple[np.ndarray, np.ndarray]:
    """Key-range bounds for prefix search: (lo (n, W+1), hi (n, W+1)).

    lo = the prefix packed as a key (sorts before every term sharing it);
    hi = the 0xff-saturated prefix with length word 0xFFFFFFFF (sorts
    strictly after every such term). A term t has prefix p iff
    lo_p <= key(t) < hi_p in packed-key order (bytes.Compare-exact,
    see pack_blob). Shared by QueryEngine.prefix_search and bench."""
    lo = pack_terms(prefixes, width=width)
    hi = np.zeros_like(lo)
    for i, p in enumerate(prefixes):
        padded = (p + b"\xff" * (width * 4 - len(p)))[: width * 4]
        hi[i] = pack_one(padded, width)
        hi[i, -1] = 0xFFFFFFFF
    return lo, hi


def widen(keys: np.ndarray, width: int) -> np.ndarray:
    """Re-pad an (n, W+1) key matrix to a larger word width (order-preserving)."""
    n, wp1 = keys.shape
    W = wp1 - 1
    if W == width:
        return keys
    if W > width:
        raise ValueError("cannot narrow keys")
    out = np.zeros((n, width + 1), dtype=np.uint32)
    out[:, :W] = keys[:, :W]
    out[:, width] = keys[:, W]
    return out


def unpack_keys(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of pack_blob: (n, W+1) key rows -> (blob uint8, offsets[n+1]).

    Keys losslessly store the full term bytes (width always covers the
    longest term), so snapshots need no separate host copy of the term blob.
    """
    n, wp1 = keys.shape
    W = wp1 - 1
    lens = keys[:, W].astype(np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    if n == 0:
        return np.zeros(0, dtype=np.uint8), offsets
    words = keys[:, :W]
    b = np.empty((n, W, 4), dtype=np.uint8)
    b[:, :, 0] = (words >> 24) & 0xFF
    b[:, :, 1] = (words >> 16) & 0xFF
    b[:, :, 2] = (words >> 8) & 0xFF
    b[:, :, 3] = words & 0xFF
    flat = b.reshape(n, W * 4)
    mask = np.arange(W * 4, dtype=np.int64)[None, :] < lens[:, None]
    return flat[mask], offsets


def lexsort_rows(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of key rows in lexicographic (= bytes.Compare) order.

    Dispatches to the native LSD radix sort when built (2-4x np.lexsort)."""
    from . import native

    if native.available() and keys.shape[0] > 4096:
        return native.sort_key_rows(keys).astype(np.int64)
    # np.lexsort sorts by the LAST key first -> pass columns reversed.
    return np.lexsort(tuple(keys[:, c] for c in range(keys.shape[1] - 1, -1, -1)))


def rows_equal(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.all(a == b, axis=-1)


def searchsorted_rows(keys: np.ndarray, queries: np.ndarray, side: str = "left") -> np.ndarray:
    """Vectorized lower/upper bound of query rows in sorted key rows (host numpy).

    Equivalent semantics to np.searchsorted on tuples. Device version lives in
    ops/dict_search.py.
    """
    n = keys.shape[0]
    q = queries.shape[0]
    lo = np.zeros(q, dtype=np.int64)
    hi = np.full(q, n, dtype=np.int64)
    if n == 0:
        return lo
    steps = max(1, int(np.ceil(np.log2(n + 1))) + 1)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        mid_c = np.minimum(mid, n - 1)
        rows = keys[mid_c]
        cmp = _cmp_rows(rows, queries)  # -1 if row<q, 0 eq, 1 gt
        if side == "left":
            go_right = cmp < 0
        else:
            go_right = cmp <= 0
        go_right &= mid < hi
        lo = np.where(go_right, mid + 1, lo)
        hi = np.where(go_right, hi, mid)
    return lo


def _cmp_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Lexicographic compare of row pairs: -1/0/1 per row."""
    diff = a != b
    any_diff = diff.any(axis=1)
    first = np.argmax(diff, axis=1)
    r = np.arange(a.shape[0])
    av = a[r, first]
    bv = b[r, first]
    out = np.zeros(a.shape[0], dtype=np.int8)
    lt = any_diff & (av < bv)
    gt = any_diff & (av > bv)
    out[lt] = -1
    out[gt] = 1
    return out
