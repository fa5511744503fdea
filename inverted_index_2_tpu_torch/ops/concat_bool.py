"""Concat-decode boolean queries (counterpart of ops/concat_bool.py).

Work proportional to each query's TOTAL posting count: every query's block
rows are laid out contiguously into SB slots (concat_layout), decoded and
masked to real lanes (decode_masked), sorted ONCE at (Q, SB*128) through
kernel K4 (every 128-lane block already ascends, so with run=128), and
reduced by run length (lists are sorted-unique, so a value appears once per
list that holds it):
    AND: run length == k_valid      OR: first of run
then the kept lanes are compacted (ops/compaction.py, K4's compaction).
Exact at any length; no truncation and no re-serve. The decode and the
run-length marks are plain torch ops, as they were plain XLA in JAX.

u32 values are int32 bits (utils/u32.py); 0xFFFFFFFF is both the mask fill
and a legal posting, handled as the JAX step does.
"""
from __future__ import annotations

import torch

from .compaction import compact_rows
from .cuda_sort import sort_rows
from .decode import BLOCK, decode_blocks
from .dict_search import resolve
from ..utils.u32 import SENT, from_i64


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


def decode_masked(blocks, rows, in_use, bit, cnt_j):
    """Decode the laid-out blocks and mask real lanes: (flat (Q, SB*128) u32
    bits with 0xFFFFFFFF on invalid lanes, vals (Q, SB, 128) the decoded
    u32 bits, mask (Q, SB, 128) the real lanes). Each 128-lane block of
    flat ascends: real lanes are a prefix of the block, then the fill."""
    Q, SB = rows.shape
    vals, _ = decode_blocks(blocks[rows])
    vals = from_i64(vals)
    lanes = torch.arange(BLOCK, device=rows.device)[None, None, :]
    vl = (cnt_j - bit * BLOCK).clamp(0, BLOCK)
    mask = in_use[..., None] & (lanes < vl[..., None])
    flat = torch.where(mask, vals, SENT).reshape(Q, SB * BLOCK)
    return flat, vals, mask


def run_reaches_k(svals, k_valid, K: int):
    """Run length >= k_valid at each position: svals[i] == svals[i+kv-1],
    among K static shifts (values are unique per list, so a run never
    exceeds k_valid)."""
    Q, S = svals.shape
    keep = torch.zeros((Q, S), dtype=torch.bool, device=svals.device)
    for j in range(K):
        shifted = (svals if j == 0 else torch.cat(
            [svals[:, j:], torch.full((Q, j), SENT, dtype=svals.dtype,
                                      device=svals.device)], dim=1))
        keep = torch.where((k_valid == j + 1)[:, None], shifted == svals, keep)
    return keep


def last_values(vals, cum, cnt):
    """Each term's LAST posting from the decoded matrix (the genuine
    0xFFFFFFFF membership test): (Q, K) u32 bits."""
    Q = cnt.shape[0]
    S = vals.shape[1] * BLOCK
    last_slot = (cum[:, 1:] - 1).clamp(min=0)
    last_lane = ((cnt - 1) % BLOCK).clamp(min=0)
    return vals.reshape(Q, S).gather(1, last_slot * BLOCK + last_lane)


def boolean_concat_step(blocks, term_block_start, counts, idx, found,
                        k_valid, SB: int, op: str, prefix_p: int = 0,
                        wire_dedup: bool = False):
    """Set op over each query's concatenated decoded lists.

    idx/found (Q, K) from resolve_step; k_valid (Q,); SB a total-block
    budget every query's blocks fit. Returns (out, oc (Q,) int32):
      * out (Q, SB*128) u32 bits compacted ascending, oc the result size;
      * prefix_p > 0 (OR only; callers must not tombstone-filter the
        result afterwards): out (Q, <= prefix_p), the first results, and oc
        still the TRUE full count. Only the first prefix_p * K sorted lanes
        are compacted: each value fills at most k_valid <= K adjacent
        lanes, so the j-th distinct value (j <= prefix_p) lies among them;
      * wire_dedup (full-result OR only; no tombstone filter afterwards):
        the sorted stream WITH cross-list duplicates and oc = the count of
        valid lanes; results are sorted unique, so a zero delta marks a
        duplicate and the host drops it (models/steps._dedup_adjacent)."""
    if op not in ("and", "or"):
        raise ValueError(f"op {op!r}: want 'and' or 'or'")
    if wire_dedup and (prefix_p or op != "or"):
        raise ValueError("wire_dedup is full-result OR only")
    if prefix_p and op != "or":
        raise ValueError("prefix_p windowed compaction is OR-only")
    Q, K = idx.shape
    S = SB * BLOCK
    dev = blocks.device
    kv = k_valid.to(torch.int64)
    kmask = torch.arange(K, device=dev)[None, :] < kv[:, None]
    live = found & kmask
    cnt = torch.where(live, counts[idx].to(torch.int64), 0)
    rows, in_use, bit, cnt_j, cum = concat_layout(
        term_block_start[idx].to(torch.int64), cnt, SB)
    flat, vals, mask = decode_masked(blocks, rows, in_use, bit, cnt_j)
    svals = sort_rows(flat, run=BLOCK)
    first = torch.cat([torch.ones((Q, 1), dtype=torch.bool, device=dev),
                       svals[:, 1:] != svals[:, :-1]], dim=1)
    if op == "and":
        keep = run_reaches_k(svals, kv, K) & first & (svals != SENT)
        # a genuine 0xFFFFFFFF in every list merges with the fill: test each
        # list's LAST value instead
        has_ff = (cnt > 0) & (last_values(vals, cum, cnt) == SENT)
        ff_all = ((has_ff | ~live).all(dim=1) & (kv > 0) & live.any(dim=1))
        # an absent REQUIRED term voids the AND
        any_missing = (kmask & ~found).any(dim=1)
        keep &= ~any_missing[:, None]
        ff_all &= ~any_missing
        oc = (keep.sum(dim=1) + ff_all.to(torch.int64)).to(torch.int32)
    else:
        n_valid = mask.reshape(Q, S).sum(dim=1).to(torch.int32)
        if wire_dedup:
            return svals, n_valid
        in_region = (torch.arange(S, device=dev)[None, :]
                     < n_valid.to(torch.int64)[:, None])
        keep = first & in_region
        oc = keep.sum(dim=1).to(torch.int32)
    if prefix_p:
        W = min(S, prefix_p * K)
        out = compact_rows(svals[:, :W], keep[:, :W])[:, : min(W, prefix_p)]
        return out, oc
    return compact_rows(svals, keep), oc
