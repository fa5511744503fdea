"""Kernel K4: ascending row sort of u32 bits (csrc/sort_rows.cu), with its
plain torch version.

Replaces inverted_index_2_tpu/ops/pallas_sort.py::sort_rows_pallas, a drop-in
for the jnp.sort along rows that the concat classes run twice: the sort of
each query's concatenated decoded lists, and the SENTINEL-masked
compaction sort (ops/compaction.py). Bound on the card by device-memory
bytes (see the kernel's header).

`sort_rows` takes the plain version only for tensors on the CPU; for CUDA
tensors it launches K4 or raises.
"""
from __future__ import annotations

import torch

from . import _build
from .cuda_decode import _check_int32
from ..utils.u32 import sort_u32

LANES = 128


def padded_width(m: int) -> int:
    """The kernel's row width for m values: the next 128 * 2^k >= m."""
    w = LANES
    while w < m:
        w *= 2
    return w


def sort_rows_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: each row of x (Q, M) int32 holding u32 bits,
    sorted ascending in u32 order."""
    return sort_u32(x, dim=1)


def sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row of x (Q, M) int32 holding u32 bits, sorted ascending in u32
    order. Any M: the kernel sorts rows padded to padded_width(M) with
    0xFFFFFFFF and the result is sliced back to M columns. That is exact:
    every pad value has the bits of a genuine 0xFFFFFFFF, the largest u32,
    so the pads sort behind the row's own values and the first M sorted
    values are the row's own multiset."""
    dev = x.device
    if dev.type == "cpu":
        return sort_rows_torch(x)
    if dev.type != "cuda":
        raise ValueError(f"no K4 kernel for device {dev}")
    x = x.contiguous()
    _check_int32("x", x, 2, dev)
    Q, m = x.shape
    if Q == 0 or m == 0:
        return x.clone()
    M = padded_width(m)
    out = torch.empty((Q, M), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.tpi_sort_rows(x.data_ptr(), m, out.data_ptr(), Q, M,
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "tpi_sort_rows")
    sort_rows.launches += 1
    return out if M == m else out[:, :m]


sort_rows.launches = 0  # K4 launches in this process
