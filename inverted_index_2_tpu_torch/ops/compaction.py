"""Stable left-compaction of masked rows (counterpart of
ops/compaction.py::compact_rows), through kernel K4's compaction entry on
the card (csrc/sort_rows.cu, tpi_compact_rows).

The JAX package compacts with a SENTINEL-masked row sort because a TPU has
no cheap scatter. This card has one: the kernel scans the keep mask and
writes each kept lane to its place, one read and one write of the row. The
plain version stays the masked sort, and the two are equal whenever the kept
lanes of each row ascend in u32 order, which every caller guarantees (keep
masks a sorted row or a list's ascending valid prefix).

`compact_rows` takes the plain version only for tensors on the CPU, where it
also verifies that precondition and raises ValueError when it fails; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build
from ..utils.u32 import SENT, flip
from .cuda_sort import count_entry, sort_rows_torch


def compact_rows_torch(vals: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Plain version: the SENTINEL-masked row sort."""
    return sort_rows_torch(torch.where(keep, vals, SENT))


def check_kept_ascend(vals: torch.Tensor, keep: torch.Tensor) -> None:
    """Raise ValueError unless the kept lanes of each row ascend (u32
    order, equal neighbours allowed)."""
    if vals.shape[1] < 2:
        return
    low = -(1 << 31)
    f = torch.where(keep, flip(vals), low)
    before = torch.cummax(f, dim=1).values[:, :-1]  # largest kept so far
    bad = keep[:, 1:] & (f[:, 1:] < before)
    if bool(bad.any()):
        q, c = (int(v) for v in bad.nonzero()[0])
        raise ValueError(f"compact_rows: row {q} keeps lane {c + 1} below "
                         "an earlier kept lane")


def compact_rows(vals: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Kept lanes of each row of vals (Q, M) u32 bits packed to the front
    in order, 0xFFFFFFFF after them; keep (Q, M) bool. The kept lanes of
    each row must ascend in u32 order; then this equals the JAX package's
    compact_rows (and compact_rows_torch). A kept genuine 0xFFFFFFFF has
    the fill's bits, so the first count values are exactly the kept ones.
    Rows may be column slices of wider matrices (a row pitch, unit stride
    along the row); anything else raises rather than copying."""
    if vals.shape != keep.shape or vals.dim() != 2:
        raise ValueError(f"vals {tuple(vals.shape)} and keep "
                         f"{tuple(keep.shape)}: want two equal (Q, M) shapes")
    dev = vals.device
    if dev.type == "cpu":
        check_kept_ascend(vals, keep)
        return compact_rows_torch(vals, keep)
    if dev.type != "cuda":
        raise ValueError(f"no K4 kernel for device {dev}")
    if vals.dtype != torch.int32 or keep.dtype != torch.bool:
        raise ValueError(f"want int32 vals and bool keep, got {vals.dtype} "
                         f"and {keep.dtype}")
    if keep.device != dev:
        raise ValueError(f"keep is on {keep.device}, vals on {dev}")
    Q, m = vals.shape
    out = torch.empty((Q, m), dtype=torch.int32, device=dev)
    if Q == 0 or m == 0:
        return out
    for name, t in (("vals", vals), ("keep", keep)):
        if t.stride(1) != 1 and m > 1:
            raise ValueError(f"{name}: stride {t.stride()} is not a row "
                             "pitch with unit stride along the row")
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.tpi_compact_rows(
            vals.data_ptr(), vals.stride(0), keep.data_ptr(), keep.stride(0),
            out.data_ptr(), Q, m, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "tpi_compact_rows")
    count_entry("compact")
    return out
