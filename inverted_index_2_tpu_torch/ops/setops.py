"""Tombstone filter and row compaction on torch tensors (counterpart of
ops/setops.filter_removed and ops/compaction.compact_rows)."""
from __future__ import annotations

import torch

from ..utils.u32 import SENT, flip, sort_u32


def compact_rows(vals: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Kept lanes of each row packed to the front in ascending u32 order,
    0xFFFFFFFF after them (a kept genuine 0xFFFFFFFF is interchangeable
    with that fill at the count boundary)."""
    return sort_u32(torch.where(keep, vals, SENT), dim=1)


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
