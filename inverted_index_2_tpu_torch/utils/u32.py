"""uint32 values in torch.

Postings, term keys and the block arena are uint32 data. torch has a
`uint32` dtype, but its CPU build raises NotImplementedError on `<`, `min`,
`+`, `>>` and `searchsorted` for it. The port therefore keeps every u32
tensor as an int32 tensor holding the same 32 bits, and:

  * orders and sorts through the order-preserving sign flip `flip`
    (x ^ 0x80000000 read as int32; the same bijection as `flip_v` in
    inverted_index_2_tpu/ops/pallas_fused.py), under which signed int32
    order is u32 order;
  * does arithmetic in int64 (`to_i64` / `from_i64`), where every u32 value
    is non-negative and sums wrap back mod 2^32 through `from_i64`.

0xFFFFFFFF is both the mask sentinel of the set operations and a legal
posting. As int32 bits it is -1; flipped it is INT32_MAX and sorts last, as
in u32 order.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
SENT = -1                 # 0xFFFFFFFF as int32 bits
_SIGN = -(1 << 31)        # 0x80000000 as int32


def flip(x: torch.Tensor) -> torch.Tensor:
    """u32 bits (int32) <-> order-preserving int32 (an involution)."""
    return x ^ _SIGN


def to_i64(x: torch.Tensor) -> torch.Tensor:
    """u32 bits (int32) -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def from_i64(x: torch.Tensor) -> torch.Tensor:
    """int64 -> u32 bits (int32), reduced mod 2^32."""
    return (((x & MASK32) ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def sort_u32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Ascending sort of u32 bits in u32 order."""
    return flip(torch.sort(flip(x), dim=dim).values)


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 `a` in [0, 2^32) and a u32 constant `b`,
    split in 16-bit halves so no int64 product overflows."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint32/int32 array -> int32 tensor on `device` (same bits)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy wants a writable buffer
        a = a.copy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor holding u32 bits -> numpy uint32 array on the host."""
    return t.detach().cpu().numpy().view(np.uint32)
