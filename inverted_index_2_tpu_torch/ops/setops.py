"""Sorted-set operations over padded posting matrices on torch tensors
(counterpart of ops/setops.py).

Posting lists are rows of (Q, L) or (Q, K, L) u32-bits matrices (int32,
utils/u32.py) with per-row counts: a row is valid in [0, count) and holds
garbage beyond. AND, OR and the tombstone filter are batched tensor
programs whose results are compacted ascending and padded with 0xFFFFFFFF.
0xFFFFFFFF is also a legal posting: counts, not the fill, define validity.

These are the plain versions. Their row sorts and compactions run through
K4 on the card, as the concat classes' do: a concatenation of K lists is K
ascending runs of L lanes (ops/cuda_sort.sort_rows with run=L, one merge
for the dual step's pair union), and every compaction keeps lanes of a
sorted row (ops/compaction.compact_rows);
the AND that the delta tier serves goes through K3
(ops/cuda_bool.intersect_many), whose plain version is `intersect_many`.
"""
from __future__ import annotations

import torch

from ..utils.u32 import SENT, flip
from .compaction import compact_rows
from .concat_bool import run_reaches_k
from .cuda_sort import sort_rows

# above this probe-matrix volume (P * L) the broadcast membership gives way
# to a binary search, and intersect_many to the sort regime (JAX's limit,
# kept so both regimes answer the same inputs)
_BROADCAST_LIMIT = 512 * 512


def _valid_mask(L: int, counts: torch.Tensor) -> torch.Tensor:
    return (torch.arange(L, device=counts.device)[None, :]
            < counts[:, None])


def member_mask(lists: torch.Tensor, counts: torch.Tensor,
                probes: torch.Tensor) -> torch.Tensor:
    """For each row: is probes[q, j] a member of lists[q, :counts[q]]?
    lists rows ascend (u32 order) within their count."""
    L = lists.shape[1]
    P = probes.shape[1]
    if P * L <= _BROADCAST_LIMIT:
        vm = _valid_mask(L, counts)
        eq = probes[:, :, None] == lists[:, None, :]
        return (eq & vm[:, None, :]).any(dim=-1)
    # the valid prefix ascends: its compaction is the masked ascending row
    clean = compact_rows(lists, _valid_mask(L, counts))
    pos = torch.searchsorted(flip(clean), flip(probes))
    hit = clean.gather(1, pos.clamp(max=L - 1)) == probes
    return hit & (pos < counts[:, None])


def intersect_many(lists: torch.Tensor, counts: torch.Tensor,
                   k_valid: torch.Tensor):
    """Plain AND of K sorted lists per query (plain version of K3).

    lists (Q, K, L) u32 bits, counts (Q, K), k_valid (Q,) lists present per
    query. Returns (vals (Q, L) compacted ascending, 0xFFFFFFFF after the
    count; counts (Q,) int32). An empty present list empties the AND.

    Two regimes, as in JAX: for L * L <= _BROADCAST_LIMIT, base-list
    membership by broadcast compares; above it the sort regime. They differ
    only on a k_valid = 0 row with a non-empty base, which the broadcast
    regime keeps and the sort regime empties; no caller makes such a row
    (see ops/cuda_bool.intersect_many)."""
    Q, K, L = lists.shape
    if L * L > _BROADCAST_LIMIT:
        return _intersect_sort(lists, counts, k_valid)
    base = lists[:, 0, :]
    keep = _valid_mask(L, counts[:, 0])
    for j in range(1, K):
        active = (j < k_valid)[:, None]
        keep &= member_mask(lists[:, j, :], counts[:, j], base) | ~active
    return compact_rows(base, keep), keep.sum(dim=1).to(torch.int32)


def _concat_valid(lists, counts, k_valid):
    """(kmask (Q, K, 1), flat (Q, K*L) with invalid lanes 0xFFFFFFFF,
    valid (Q, K*L)). Every L lanes of flat ascend: a list's valid prefix,
    then the fill, the largest u32."""
    Q, K, L = lists.shape
    dev = lists.device
    kmask = (torch.arange(K, device=dev)[None, :, None]
             < k_valid[:, None, None])
    vmask = torch.arange(L, device=dev)[None, None, :] < counts[:, :, None]
    valid = (kmask & vmask).reshape(Q, K * L)
    return kmask, torch.where(valid, lists.reshape(Q, K * L), SENT), valid


def _first_of_run(vals: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones((vals.shape[0], 1), dtype=torch.bool,
                                 device=vals.device),
                      vals[:, 1:] != vals[:, :-1]], dim=1)


def _intersect_sort(lists, counts, k_valid):
    """Sort-regime AND: sort the concatenated valid lanes, keep each run
    whose length reaches k_valid (values are unique within a list). A
    genuine 0xFFFFFFFF in every list merges with the fill, so each list's
    last valid value is tested for it instead."""
    Q, K, L = lists.shape
    kmask, flat, _ = _concat_valid(lists, counts, k_valid)
    svals = sort_rows(flat, run=L)
    keep = run_reaches_k(svals, k_valid, K) & _first_of_run(svals) & (
        svals != SENT)
    last_idx = (counts.to(torch.int64) - 1).clamp(min=0)[:, :, None]
    last = lists.gather(2, last_idx)[:, :, 0]
    has_ff = (counts > 0) & (last == SENT)
    ff_all = (has_ff | ~kmask[:, :, 0]).all(dim=1) & (k_valid > 0)
    oc = (keep.sum(dim=1) + ff_all.to(torch.int64)).to(torch.int32)
    return compact_rows(svals, keep)[:, :L], oc


def union_many(lists: torch.Tensor, counts: torch.Tensor,
               k_valid: torch.Tensor):
    """OR of K sorted lists per query: (vals (Q, K*L) compacted ascending
    unique, counts (Q,) int32). A genuine 0xFFFFFFFF has the fill's bits,
    so the first n_valid sorted lanes are exactly the valid multiset."""
    Q, K, L = lists.shape
    _, flat, valid = _concat_valid(lists, counts, k_valid)
    n_valid = valid.sum(dim=1)
    vals = sort_rows(flat, run=L)
    in_region = (torch.arange(K * L, device=lists.device)[None, :]
                 < n_valid[:, None])
    uniq = in_region & _first_of_run(vals)
    return compact_rows(vals, uniq), uniq.sum(dim=1).to(torch.int32)


def filter_removed(vals: torch.Tensor, counts: torch.Tensor,
                   removed: torch.Tensor):
    """Drop tombstoned values from each row's valid prefix and compact.

    vals (Q, L) u32 bits, counts (Q,), removed (R,) u32 bits sorted in u32
    order. Returns (vals, counts) with survivors ascending."""
    Q, L = vals.shape
    R = removed.shape[0]
    if R == 0:
        return vals, counts
    rf = flip(removed)
    vf = flip(vals)
    pos = torch.searchsorted(rf, vf.reshape(-1)).reshape(Q, L)
    hit = (rf[pos.clamp(max=R - 1)] == vf) & (pos < R)
    keep = _valid_mask(L, counts.to(torch.int64)) & ~hit
    return compact_rows(vals, keep), keep.sum(dim=1).to(torch.int32)
