"""Batched term-dictionary search on torch tensors (counterpart of
ops/dict_search.py).

The dictionary is the snapshot's sorted (N, W+1) u32 key matrix (int32
bits, codec/keys.py layout). Exact lookups probe the linear-probe hash
table; `lookup_rows` binary-searches for snapshots built without one.
"""
from __future__ import annotations

import math

import torch

from ..codec.hashing import hash_rows_torch
from ..utils.u32 import flip, to_i64


def rows_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def _rows_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over u32 key rows (int32 bits)."""
    diff = a != b
    any_diff = diff.any(dim=-1)
    first = diff.to(torch.int8).argmax(dim=-1, keepdim=True)
    av = flip(a.gather(-1, first))[..., 0]
    bv = flip(b.gather(-1, first))[..., 0]
    return any_diff & (av < bv)


def searchsorted_rows(keys: torch.Tensor, queries: torch.Tensor,
                      side: str = "left") -> torch.Tensor:
    """Lower (or upper) bound of each query row in the sorted key rows:
    (Q,) int64 insertion points, fixed trip count ceil(log2(N+1)) + 1."""
    n, q = keys.shape[0], queries.shape[0]
    lo = torch.zeros(q, dtype=torch.int64, device=queries.device)
    if n == 0:
        return lo
    hi = torch.full((q,), n, dtype=torch.int64, device=queries.device)
    for _ in range(max(1, int(math.ceil(math.log2(n + 1))) + 1)):
        mid = (lo + hi) >> 1
        rows = keys[mid.clamp(max=n - 1)]
        if side == "left":
            go_right = _rows_less(rows, queries)
        else:
            go_right = ~_rows_less(queries, rows)
        go_right &= mid < hi
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def lookup_rows(keys: torch.Tensor, queries: torch.Tensor):
    """Exact match by binary search: (idx (Q,) int64, found (Q,) bool)."""
    n = keys.shape[0]
    idx = searchsorted_rows(keys, queries)
    if n == 0:
        return idx, torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)
    idx_c = idx.clamp(max=n - 1)
    return idx_c, rows_equal(keys[idx_c], queries) & (idx < n)


def hash_lookup_rows(keys: torch.Tensor, slots: torch.Tensor,
                     queries: torch.Tensor, max_probes: int):
    """Exact match through the linear-probe table: (idx, found) like
    lookup_rows. slots: (S,) int32, S a power of two, -1 = empty. All
    max_probes probes run (no data-dependent exit, so no host sync); a
    query's chain ends at its first empty slot or its first hit, exactly
    as the JAX while-loop walks it."""
    n, q = keys.shape[0], queries.shape[0]
    dev = queries.device
    idx = torch.zeros(q, dtype=torch.int64, device=dev)
    found = torch.zeros(q, dtype=torch.bool, device=dev)
    if n == 0:
        return idx, found
    mask = slots.shape[0] - 1
    h = to_i64(hash_rows_torch(queries))
    dead = torch.zeros(q, dtype=torch.bool, device=dev)
    for p in range(max_probes):
        cand = slots[(h + p) & mask].to(torch.int64)
        empty = cand < 0
        cand_c = cand.clamp(min=0)
        hit = rows_equal(keys[cand_c], queries) & ~empty & ~found & ~dead
        idx = torch.where(hit, cand_c, idx)
        found |= hit
        dead |= empty
    return idx, found


def resolve(keys, qkeys, slots=None, max_probes: int = 0):
    """Term -> dictionary index: hash probe when a table exists, else
    binary search (steps._resolve)."""
    if slots is not None:
        return hash_lookup_rows(keys, slots, qkeys, max_probes)
    return lookup_rows(keys, qkeys)
