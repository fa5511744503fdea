"""Device-side term hash (counterpart of codec/hashing.hash_rows_jnp).

The table itself is built on the host by inverted_index_2_tpu.codec.hashing
(native or numpy); the device only hashes query key rows with the same
math, so a probe visits exactly the slots the builder assigned.
"""
from __future__ import annotations

import torch

from inverted_index_2_tpu.codec.hashing import FNV_OFFSET, FNV_PRIME

from ..utils.u32 import MASK32, from_i64, mul32, to_i64


def hash_rows_torch(keys: torch.Tensor) -> torch.Tensor:
    """FNV-1a fold + murmur-style avalanche over (..., W+1) u32 key rows
    (int32 bits); bit-identical to hash_rows_np. Returns int32 bits."""
    k = to_i64(keys)
    h = torch.full(k.shape[:-1], int(FNV_OFFSET), dtype=torch.int64,
                   device=keys.device)
    for c in range(k.shape[-1]):
        h = mul32(h ^ k[..., c], int(FNV_PRIME))
    h = h ^ (h >> 16)
    h = mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return from_i64(h & MASK32)
