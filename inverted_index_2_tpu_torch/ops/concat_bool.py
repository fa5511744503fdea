"""Concat-decode boolean queries (counterpart of ops/concat_bool.py).

Work proportional to each query's TOTAL posting count: every query's block
rows are laid out contiguously into SB slots (concat_layout), decoded and
masked to real lanes (decode_masked), sorted ONCE at (Q, SB*128) through
kernel K4 (every 128-lane block already ascends, so with run=128), and
reduced by run length (lists are sorted-unique, so a value appears once per
list that holds it):
    AND: run length == k_valid      OR: first of run
then the kept lanes are compacted (ops/compaction.py, K4's compaction).
Exact at any length; no truncation and no re-serve. Here the decode and the
run-length marks are plain torch ops, as they were plain XLA in JAX: the
executable spec, in two halves (concat_decode_torch, concat_compact_torch),
of the two kernels that run the step on the card (ops/cuda_concat.py).

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
    at = (last_slot * BLOCK + last_lane).clamp(max=S - 1)
    return vals.reshape(Q, S).gather(1, at)


def concat_decode_torch(blocks, term_block_start, counts, idx, found,
                        k_valid, SB: int):
    """The step's first half, plain version of the concat decode kernel
    (ops/cuda_concat.py): (flat (Q, SB*128) u32 bits, each query's live
    lists' blocks laid out and decoded, 0xFFFFFFFF on the other lanes;
    meta (4, Q) int32, rows n_valid (the lanes holding postings), k_valid,
    any_missing (a required term is absent) and ff_all (every live list's
    last posting is 0xFFFFFFFF, k_valid > 0, some list is live and none
    missing))."""
    Q, K = idx.shape
    dev = blocks.device
    kv = k_valid.to(torch.int64)
    kmask = torch.arange(K, device=dev)[None, :] < kv[:, None]
    live = found & kmask
    cnt = torch.where(live, counts[idx].to(torch.int64), 0)
    rows, in_use, bit, cnt_j, cum = concat_layout(
        term_block_start[idx].to(torch.int64), cnt, SB)
    flat, vals, mask = decode_masked(blocks, rows, in_use, bit, cnt_j)
    n_valid = mask.reshape(Q, SB * BLOCK).sum(dim=1)
    # a genuine 0xFFFFFFFF in every list merges with the fill: test each
    # list's LAST value instead
    has_ff = (cnt > 0) & (last_values(vals, cum, cnt) == SENT)
    any_missing = (kmask & ~found).any(dim=1)
    ff_all = ((has_ff | ~live).all(dim=1) & (kv > 0) & live.any(dim=1)
              & ~any_missing)
    meta = torch.stack([n_valid, kv, any_missing.to(torch.int64),
                        ff_all.to(torch.int64)]).to(torch.int32)
    return flat, meta


def concat_marks_torch(svals, meta, op: str, K: int):
    """The run-length marks over the sorted rows svals (Q, S): (keep (Q, S)
    bool, oc (Q,) int32, the result sizes)."""
    Q, S = svals.shape
    dev = svals.device
    n_valid, kv, any_missing, ff_all = meta.to(torch.int64)
    first = torch.cat([torch.ones((Q, 1), dtype=torch.bool, device=dev),
                       svals[:, 1:] != svals[:, :-1]], dim=1)
    if op == "and":
        # an absent REQUIRED term voids the AND
        keep = (run_reaches_k(svals, kv, K) & first & (svals != SENT)
                & (any_missing == 0)[:, None])
        return keep, (keep.sum(dim=1) + ff_all).to(torch.int32)
    in_region = torch.arange(S, device=dev)[None, :] < n_valid[:, None]
    keep = first & in_region
    return keep, keep.sum(dim=1).to(torch.int32)


def scatter_page(obuf, sel, o, oc):
    """Write one class chunk's P-slice into the batch's result buffer:
    obuf (QB, P+1) u32 bits, columns [0, P) the first P values and column P
    the true count, row sel[i] from chunk row i. In place; returns obuf.
    Every sel entry must be a real row: the caller slices pad rows off
    first, because a torch index of -1 writes the LAST row (JAX's did too,
    before mode="drop"), which would overwrite the last query's page."""
    P = obuf.shape[1] - 1
    o2 = o[:, :P]
    if o2.shape[1] < P:
        o2 = torch.nn.functional.pad(o2, (0, P - o2.shape[1]))
    row = torch.cat([o2.to(obuf.dtype), oc.to(obuf.dtype)[:, None]], dim=1)
    return obuf.index_copy_(0, sel.to(torch.int64), row)


def concat_compact_torch(svals, meta, op: str, K: int, prefix_p: int = 0,
                         obuf=None, rows=None):
    """The step's second half, plain version of the concat compaction
    kernel: the run-length marks and the kept lanes compacted, (out, oc) as
    boolean_concat_step returns them. With `obuf` (the page form) the
    windowed (out, oc) go into row rows[i] of it (scatter_page) and the
    call returns None."""
    keep, oc = concat_marks_torch(svals, meta, op, K)
    if prefix_p:
        W = min(svals.shape[1], prefix_p * K)
        out = compact_rows(svals[:, :W], keep[:, :W])[:, : min(W, prefix_p)]
        if obuf is not None:
            scatter_page(obuf, rows, out, oc)
            return None
        return out, oc
    return compact_rows(svals, keep), oc


def check_step_args(op: str, prefix_p: int, wire_dedup: bool) -> None:
    if op not in ("and", "or"):
        raise ValueError(f"op {op!r}: want 'and' or 'or'")
    if wire_dedup and (prefix_p or op != "or"):
        raise ValueError("wire_dedup is full-result OR only")
    if prefix_p and op != "or":
        raise ValueError("prefix_p windowed compaction is OR-only")


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
        duplicate and the host drops it (models/steps._dedup_adjacent).

    This is the plain chain, the executable spec of ops/cuda_concat.py's
    kernels; on CUDA tensors its sorts and compaction run through K4."""
    check_step_args(op, prefix_p, wire_dedup)
    flat, meta = concat_decode_torch(blocks, term_block_start, counts, idx,
                                     found, k_valid, SB)
    svals = sort_rows(flat, run=BLOCK)
    if wire_dedup:
        return svals, meta[0]
    return concat_compact_torch(svals, meta, op, idx.shape[1], prefix_p)
