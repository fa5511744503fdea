"""Kernel K1: batched posting decode (csrc/decode_postings.cu).

Replaces inverted_index_2_tpu/ops/pallas_decode.py::decode_postings_pallas,
the TPU kernel whose XLA twin (ops/decode.py::gather_postings_arena) the
JAX lookup_step runs. Bound on the card by arena bytes: each block row a
term needs is read once, one warp per term, its rows staged through shared
memory with 16-byte asynchronous copies (see the kernel's header). Its
decode device functions (csrc/decode.cuh) share their scan with K2's.

`decode_postings` takes the plain version (ops/decode.py) only for tensors
on the CPU; for CUDA tensors it launches K1 or raises.
"""
from __future__ import annotations

import torch

from . import _build
from .decode import BLOCK, gather_postings_arena


def _check_int32(name: str, t: torch.Tensor, ndim: int, device) -> None:
    if t.dtype != torch.int32 or t.dim() != ndim:
        raise ValueError(f"{name}: want int32 with {ndim} dims, got "
                         f"{t.dtype} with shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the arena on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def decode_postings(blocks: torch.Tensor, term_block_start: torch.Tensor,
                    counts: torch.Tensor, term_idx: torch.Tensor, L: int,
                    found: torch.Tensor = None):
    """(vals (Q, L) u32 bits, raw counts (Q,) int32) for dictionary indexes
    `term_idx` (int32, each in [0, N)). Raw counts may exceed L; values past
    a row's count are undefined. With `found` (Q,) bool, a row whose flag is
    False is neither read nor written and reports a raw count of 0."""
    if L % BLOCK:
        raise ValueError(f"L={L} is not a multiple of {BLOCK}")
    dev = blocks.device
    if dev.type == "cpu":
        return gather_postings_arena(blocks, term_block_start, counts,
                                     term_idx, L, found)
    if dev.type != "cuda":
        raise ValueError(f"no K1 kernel for device {dev}")
    _check_int32("blocks", blocks, 2, dev)
    _check_int32("term_block_start", term_block_start, 1, dev)
    _check_int32("counts", counts, 1, dev)
    _check_int32("term_idx", term_idx, 1, dev)
    Q = term_idx.shape[0]
    if blocks.shape[1] % 4 or blocks.data_ptr() % 16:
        raise ValueError("blocks: K1 wants 16-byte-aligned arena rows "
                         f"(stride {blocks.shape[1]} words)")
    if found is not None and (
            found.dtype != torch.bool or found.shape != (Q,)
            or found.device != dev or not found.is_contiguous()):
        raise ValueError("found: want a contiguous (Q,) bool tensor on "
                         f"{dev}, got {found.dtype} {tuple(found.shape)}")
    vals = torch.empty((Q, L), dtype=torch.int32, device=dev)
    raw = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q:
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.tpi_decode_postings(
                blocks.data_ptr(), blocks.shape[1],
                term_block_start.data_ptr(), counts.data_ptr(),
                term_idx.data_ptr(),
                None if found is None else found.data_ptr(), Q, L,
                vals.data_ptr(), raw.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "tpi_decode_postings")
        decode_postings.launches += 1
    return vals, raw


decode_postings.launches = 0  # K1 launches in this process
