"""Tombstone filter on torch tensors (counterpart of
ops/setops.filter_removed)."""
from __future__ import annotations

import torch

from ..utils.u32 import flip
from .compaction import compact_rows


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
    valid = (torch.arange(L, device=vals.device)[None, :]
             < counts.to(torch.int64)[:, None])
    keep = valid & ~hit
    return compact_rows(vals, keep), keep.sum(dim=1).to(torch.int32)
