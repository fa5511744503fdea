"""Concat-decode AND (counterpart of ops/concat_bool.py, AND branch only).

Serves the rare queries whose smallest list is longer than the largest
ladder level the fused kernel takes (cuda_fused.MAX_LEVEL). Each query's
block rows are laid out contiguously into SB slots, decoded, masked,
sorted once, and reduced by run length: a value is in the AND exactly when
its run covers every query term (lists are sorted-unique). Exact at any
length; no re-serve. In JAX this is plain XLA; here plain torch ops.
"""
from __future__ import annotations

import torch

from .decode import BLOCK, decode_blocks
from .dict_search import resolve
from ..utils.u32 import MASK32, from_i64

_SENT64 = MASK32  # 0xFFFFFFFF in the int64 value domain


def resolve_step(keys, counts, qkeys, slots=None, max_probes: int = 0):
    """Term resolution only: (idx (Q, K) int64, found (Q, K), raw (Q, K))."""
    Q, K, Wp1 = qkeys.shape
    idx, found = resolve(keys, qkeys.reshape(Q * K, Wp1), slots, max_probes)
    raw = torch.where(found, counts[idx], 0)
    return idx.reshape(Q, K), found.reshape(Q, K), raw.reshape(Q, K)


def concat_layout(tbs_q, cnt, SB: int):
    """Slot assignment of each query's blocks into SB contiguous slots:
    (rows (Q, SB) arena row per slot, in_use, bit = block index within its
    term, cnt_j = owning term's count, cum (Q, K+1) block prefix sums)."""
    Q, K = tbs_q.shape
    dev = tbs_q.device
    nb = (cnt + BLOCK - 1) // BLOCK
    cum = torch.cat([torch.zeros((Q, 1), dtype=torch.int64, device=dev),
                     torch.cumsum(nb, dim=1)], dim=1)
    s_idx = torch.arange(SB, dtype=torch.int64, device=dev)[None, :]
    j_of = torch.zeros((Q, SB), dtype=torch.int64, device=dev)
    for k in range(1, K):
        j_of += (s_idx >= cum[:, k:k + 1]).to(torch.int64)
    cum_j = cum.gather(1, j_of)
    tbs_j = tbs_q.gather(1, j_of)
    cnt_j = cnt.gather(1, j_of)
    in_use = s_idx < cum[:, K:]
    bit = s_idx - cum_j
    rows = torch.where(in_use, tbs_j + bit, 0)
    return rows, in_use, bit, cnt_j, cum


def run_reaches_k(svals, k_valid, K: int):
    """Run length >= k_valid at each position: svals[i] == svals[i+kv-1]."""
    Q, S = svals.shape
    keep = torch.zeros((Q, S), dtype=torch.bool, device=svals.device)
    for j in range(K):
        shifted = (svals if j == 0 else torch.cat(
            [svals[:, j:], torch.full((Q, j), _SENT64, dtype=svals.dtype,
                                      device=svals.device)], dim=1))
        keep = torch.where((k_valid == j + 1)[:, None], shifted == svals, keep)
    return keep


def boolean_concat_and_step(blocks, term_block_start, counts, idx, found,
                            k_valid, SB: int):
    """AND over each query's concatenated decoded lists.

    idx/found (Q, K) from resolve_step; SB a total-block budget that every
    query's blocks fit. Returns (out (Q, SB*128) u32 bits compacted
    ascending, oc (Q,) int32)."""
    Q, K = idx.shape
    S = SB * BLOCK
    dev = blocks.device
    kv = k_valid.to(torch.int64)
    kmask = torch.arange(K, device=dev)[None, :] < kv[:, None]
    live = found & kmask
    cnt = torch.where(live, counts[idx].to(torch.int64), 0)
    rows, in_use, bit, cnt_j, cum = concat_layout(
        term_block_start[idx].to(torch.int64), cnt, SB)
    vals, _ = decode_blocks(blocks[rows])                      # (Q, SB, 128)
    lanes = torch.arange(BLOCK, device=dev)[None, None, :]
    mask = in_use[..., None] & (lanes < (cnt_j - bit * BLOCK)[..., None])
    flat = torch.where(mask, vals, _SENT64).reshape(Q, S)
    svals = torch.sort(flat, dim=1).values
    first = torch.cat([torch.ones((Q, 1), dtype=torch.bool, device=dev),
                       svals[:, 1:] != svals[:, :-1]], dim=1)
    keep = run_reaches_k(svals, kv, K) & first & (svals != _SENT64)
    # a genuine 0xFFFFFFFF in every list merges with the fill: test each
    # list's LAST value instead
    last_slot = (cum[:, 1:] - 1).clamp(min=0)
    last_lane = ((cnt - 1) % BLOCK).clamp(min=0)
    last = vals.reshape(Q, S).gather(1, last_slot * BLOCK + last_lane)
    has_ff = (cnt > 0) & (last == _SENT64)
    ff_all = ((has_ff | ~live).all(dim=1) & (kv > 0) & live.any(dim=1))
    any_missing = (kmask & ~found).any(dim=1)
    keep &= ~any_missing[:, None]
    ff_all &= ~any_missing
    oc = (keep.sum(dim=1) + ff_all.to(torch.int64)).to(torch.int32)
    out = torch.sort(torch.where(keep, svals, _SENT64), dim=1).values
    return from_i64(out), oc
