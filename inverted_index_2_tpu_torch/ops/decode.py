"""Posting-block decode as plain torch ops (counterpart of ops/decode.py).

This is the executable spec of kernel K1 (ops/cuda_decode.py) and of the
decode inside kernel K2 (ops/cuda_fused.py): the CPU path runs it, and the
GPU tests hold the kernels against it.

Arena row layout (codec/packing.py with power-of-two byte widths):
    [header = b | n_blk << 8, anchor, packed deltas ...]
b in {0, 8, 16, 32}; delta j sits at byte/half/word j of the packed words.
Values: v[0] = anchor, v[j+1] = v[j] + d[j] + 1, mod 2^32. Lanes past a
block's n_blk, and rows past a term's count, are undefined: consumers mask
by count.
"""
from __future__ import annotations

import torch

from ..utils.u32 import MASK32, from_i64, to_i64

BLOCK = 128


def decode_blocks(win: torch.Tensor):
    """Decode arena rows (..., stride) u32 bits -> (values (..., 128) int64
    in [0, 2^32), n_blk (...,) int64). Follows
    decode_blocks_pow2(use_mxu=False): classes other than 1, 2 and 4 bytes
    decode as zero deltas, and words past the row read as zero."""
    w = to_i64(win)
    width = w.shape[-1]
    header = w[..., 0]
    cls = (header & 0xFF) >> 3
    n_blk = (header >> 8) & 0xFF
    anchor = w[..., 1]

    def sl(lo: int, hi: int) -> torch.Tensor:
        part = w[..., lo:min(hi, width)]
        short = (hi - lo) - part.shape[-1]
        if short > 0:
            part = torch.nn.functional.pad(part, (0, short))
        return part

    lane = torch.arange(BLOCK, dtype=torch.int64, device=w.device)
    d1 = (sl(2, 34).repeat_interleave(4, dim=-1) >> ((lane & 3) << 3)) & 0xFF
    d2 = (sl(2, 66).repeat_interleave(2, dim=-1) >> ((lane & 1) << 4)) & 0xFFFF
    d4 = sl(2, 130)
    c = cls[..., None]
    d = torch.where(c == 1, d1, torch.zeros_like(d1))
    d = torch.where(c == 2, d2, d)
    d = torch.where(c == 4, d4, d)
    csum = torch.cumsum(d[..., : BLOCK - 1] + 1, dim=-1)
    vals = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    return (anchor[..., None] + vals) & MASK32, n_blk


def decode_lists(blocks: torch.Tensor, row0: torch.Tensor, n: torch.Tensor,
                 L: int) -> torch.Tensor:
    """First L values of lists starting at arena rows `row0` (Q,) with
    counts `n` (Q,): (Q, L) int64. Window slots past a list's last block
    repeat that block (undefined lanes, never read)."""
    K = L // BLOCK
    nb = (n.to(torch.int64) + BLOCK - 1) // BLOCK
    k = torch.arange(K, dtype=torch.int64, device=blocks.device)
    g = row0.to(torch.int64)[:, None] + torch.minimum(
        k[None, :], (nb - 1).clamp(min=0)[:, None])
    vals, _ = decode_blocks(blocks[g])
    return vals.reshape(g.shape[0], K * BLOCK)


def gather_postings_arena(blocks, term_block_start, counts, term_idx,
                          L: int, found=None):
    """Plain version of K1: (vals (Q, L) u32 bits, raw counts (Q,) int32).
    Raw counts may exceed L; values past a row's count are undefined. With
    `found` (Q,) bool, a row whose flag is False reports a raw count of 0
    (and so has no defined value)."""
    assert L % BLOCK == 0
    t = term_idx.to(torch.int64)
    n = counts[t]
    if found is not None:
        n = torch.where(found, n, 0)
    vals = decode_lists(blocks, term_block_start[t], n, L)
    return from_i64(vals), n
