"""Stable left-compaction of masked rows (counterpart of
ops/compaction.py::compact_rows): the SENTINEL-masked row sort, through
kernel K4 on the card."""
from __future__ import annotations

import torch

from ..utils.u32 import SENT
from .cuda_sort import sort_rows


def compact_rows(vals: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Kept lanes of each row packed to the front in ascending u32 order,
    0xFFFFFFFF after them. Equals the JAX package's compact_rows whenever
    the kept lanes of each row ascend (every caller: keep masks a sorted
    row). A kept genuine 0xFFFFFFFF has the fill's bits, so the first
    count values are exactly the kept ones."""
    return sort_rows(torch.where(keep, vals, SENT))
