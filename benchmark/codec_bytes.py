"""The arena codec's size arithmetic, frozen here so that the benchmark counts
the bytes of a posting list the same way whatever implements the index.

A list of n sorted unique uint32 ids is stored as one count word, then one
block per 128 ids: a header word, an anchor word (the block's first id, raw)
and the block's n_blk - 1 gaps (v[j+1] - v[j] - 1) packed at b bits each,
b being the bit length of the block's largest gap rounded up to a whole
power-of-two number of bytes: 0, 8, 16 or 32 bits. So a block takes
2 + ceil((n_blk - 1) * b / 32) words.

This copy is the yardstick of `kernels_roofline_pct`; it reads nothing of
the program's codec. It works on torch tensors on any device.
"""
from __future__ import annotations

import torch

BLOCK = 128


def gap_bits(maxgap: torch.Tensor) -> torch.Tensor:
    """Bits per packed gap for a block whose largest gap is `maxgap`."""
    return torch.where(
        maxgap == 0, 0,
        torch.where(maxgap < (1 << 8), 8,
                    torch.where(maxgap < (1 << 16), 16, 32)))


def encoded_words(values: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Words of each list in the codec. `values` (int64) holds the lists one
    after another, each ascending; `counts` (int64) their lengths. Returns
    an int64 tensor of one word count per list."""
    dev = values.device
    counts = counts.to(torch.int64)
    n = counts.numel()
    nb = (counts + BLOCK - 1) // BLOCK
    words = 1 + 2 * nb
    total = int(values.numel())
    if total == 0:
        return words
    starts = torch.cumsum(counts, 0) - counts
    list_of = torch.repeat_interleave(torch.arange(n, device=dev), counts,
                                      output_size=total)
    j = torch.arange(total, device=dev) - starts[list_of]
    bstart = torch.cumsum(nb, 0) - nb
    block_of = bstart[list_of] + j // BLOCK
    gaps = torch.zeros(total, dtype=torch.int64, device=dev)
    gaps[1:] = values[1:].to(torch.int64) - values[:-1].to(torch.int64) - 1
    gaps = torch.where(j % BLOCK != 0, gaps, 0)
    n_blocks = int(nb.sum())
    maxgap = torch.zeros(n_blocks, dtype=torch.int64, device=dev)
    maxgap.scatter_reduce_(0, block_of, gaps, "amax")
    list_of_block = torch.repeat_interleave(torch.arange(n, device=dev), nb,
                                            output_size=n_blocks)
    in_list = torch.arange(n_blocks, device=dev) - bstart[list_of_block]
    blen = torch.clamp(counts[list_of_block] - BLOCK * in_list, max=BLOCK)
    packed = ((blen - 1) * gap_bits(maxgap) + 31) // 32
    words.scatter_add_(0, list_of_block, packed)
    return words
