"""Serving steps (functions of snapshot tensors) and small shared helpers
(counterpart of models/steps.py, main tier and AND only)."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from inverted_index_2_tpu.codec import hashing

from ..ops import setops
from ..ops.cuda_decode import decode_postings
from ..ops.cuda_fused import fused_and, reorder_smallest_base
from ..ops.dict_search import resolve
from ..utils.u32 import flip


def lookup_step(keys, blocks, term_block_start, counts, qkeys, L: int,
                slots=None, max_probes: int = 0, removed=None):
    """Batched exact-term lookup: (found (Q,), postings (Q, L) u32 bits,
    counts (Q,), raw_counts (Q,)). Resolve, then decode through K1. raw > L
    means the row holds only the first L postings and the caller re-serves
    it at a larger L. Pass `removed` to filter tombstones per row."""
    idx, found = resolve(keys, qkeys, slots, max_probes)
    vals, raw = decode_postings(blocks, term_block_start, counts,
                                idx.to(torch.int32), L)
    raw = torch.where(found, raw, 0)
    n = raw.clamp(max=L)
    if removed is not None and removed.shape[0] > 0:
        vals, n = setops.filter_removed(vals, n, removed)
    return found, vals, n, raw


def _compact_small(flat, P: int):
    """First P ascending values of each row of a masked fused output ->
    (Q, P). The kept values of a row are distinct and everything else is
    0xFFFFFFFF, so this equals the JAX step's P iterative masked mins."""
    return flip(torch.topk(flip(flat), P, dim=1, largest=False).values)


def fused_rows(keys, term_block_start, counts, qkeys, k_valid, slots=None,
               max_probes: int = 0):
    """K2's inputs for a packed query batch (Q, K, W+1): resolve every
    term, then (rows, counts, need) with each query's smallest list in slot
    0 (reorder_smallest_base). A missing required term carries count 0,
    wins the argmin, and empties the AND through an empty base."""
    Q, K, Wp1 = qkeys.shape
    idx, found = resolve(keys, qkeys.reshape(Q * K, Wp1), slots, max_probes)
    idx = idx.reshape(Q, K)
    kmask = (torch.arange(K, device=qkeys.device)[None, :]
             < k_valid.to(torch.int64)[:, None])
    live = found.reshape(Q, K) & kmask
    cnt = torch.where(live, counts[idx], 0).to(torch.int32)
    rows = torch.where(live, term_block_start[idx], 0).to(torch.int32)
    return reorder_smallest_base(rows, cnt, k_valid)


def boolean_fused_step(keys, blocks, term_block_start, counts, qkeys,
                       k_valid, L: int, removed=None, slots=None,
                       max_probes: int = 0, small_p: int = 0):
    """Batched AND through the fused kernel K2: resolve terms, swap each
    query's smallest list into the base slot, then decode + membership
    over the arena. Probe lists are walked to their full length, so `need`
    is the base (smallest) count only.

    Returns (out (Q, L) compacted ascending, oc (Q,), need (Q,)); with
    small_p > 0, (small (Q, small_p), oc, need, oc_pre) instead, oc_pre
    being the keep count before the tombstone filter."""
    rows2, cnt2, need = fused_rows(keys, term_block_start, counts, qkeys,
                                   k_valid, slots, max_probes)
    out, oc = fused_and(blocks, rows2, cnt2, k_valid, L,
                        compact=small_p == 0)
    if small_p:
        small = _compact_small(out, small_p)
        oc_pre = oc
        oc = oc.clamp(max=small_p)
        if removed is not None and removed.shape[0] > 0:
            small, oc = setops.filter_removed(small, oc, removed)
        return small, oc, need, oc_pre
    if removed is not None and removed.shape[0] > 0:
        out, oc = setops.filter_removed(out, oc, removed)
    return out, oc, need


def boolean_fused_staged_step(keys, blocks, term_block_start, counts,
                              qkeys, k_valid, L: int, levels, removed=None,
                              slots=None, max_probes: int = 0,
                              small_p: int = 8):
    """boolean_fused_step with the stream's compact outputs: (small (Q,
    small_p), oc u8, code u8). code 0 = exact result in small[:oc];
    1 = small_p overflow (re-run through the sort path); 2+li = ladder
    re-serve at levels[li]; 255 = beyond the ladder (concat path).
    levels: ascending int64 tensor of the levels K2 serves."""
    small, oc, need, oc_pre = boolean_fused_step(
        keys, blocks, term_block_start, counts, qkeys, k_valid, L,
        removed, slots, max_probes, small_p)
    li = torch.searchsorted(levels, need.to(torch.int64))
    code = torch.where(
        need <= L,
        torch.where(oc_pre <= small_p, 0, 1),
        torch.where(li < levels.shape[0], 2 + li, 255),
    ).to(torch.uint8)
    return small, oc.clamp(max=255).to(torch.uint8), code


def _host_resolve_sb(tables, qk: np.ndarray):
    """Host resolve for engines with retained tables: probe the host hash
    table (same probe sequence and full-key verification as the device
    resolve). Returns (idx (Q, K) int32 with -1 = miss, cnt (Q, K) int64
    true counts, sb (Q,) int64 per-query total blocks)."""
    Qb, K = qk.shape[0], qk.shape[1]
    idx = hashing.probe_rows_np(
        tables.slots, tables.max_probes, tables.keys,
        _narrow_keys(qk.reshape(Qb * K, -1), tables.width),
    ).reshape(Qb, K).astype(np.int32)
    cnt = np.where(
        idx >= 0, tables.counts[np.maximum(idx, 0)].astype(np.int64), 0)
    sb = (-(-cnt // 128)).sum(axis=1)
    return idx, cnt, sb


def _not_ported(what: str, item: int):
    raise NotImplementedError(
        f"{what} is not ported to inverted_index_2_tpu_torch yet "
        f"(ROADMAP.md, queue 1 item {item})")


def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


def _batch_as_lists(b):
    """One stream batch as a list of term lists (identity for list input;
    expands a columnar (blob, offsets, qoffs) triple)."""
    if not (isinstance(b, tuple) and len(b) == 3):
        return b
    blob, offsets, qoffs = b
    blob8 = (np.frombuffer(blob, dtype=np.uint8)
             if isinstance(blob, (bytes, bytearray))
             else np.asarray(blob, dtype=np.uint8))
    offsets = np.asarray(offsets, dtype=np.int64)
    terms = [blob8[offsets[i]:offsets[i + 1]].tobytes()
             for i in range(len(offsets) - 1)]
    return [terms[int(qoffs[i]):int(qoffs[i + 1])]
            for i in range(len(qoffs) - 1)]


def _rows_to_columnar(rows):
    """List of arrays -> (values, voffs[n+1]) columnar pair."""
    counts = np.array([0 if r is None else len(r) for r in rows],
                      dtype=np.int64)
    voffs = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(counts, out=voffs[1:])
    vals = (np.concatenate([r for r in rows if r is not None and len(r)])
            if voffs[-1] else np.zeros(0, np.uint32)).astype(np.uint32)
    return vals, voffs


def _narrow_keys(qk: np.ndarray, to_width: int) -> np.ndarray:
    """Drop trailing key words down to `to_width`, keeping the length word
    (safe toward a snapshot whose terms all fit `to_width`)."""
    W = qk.shape[-1] - 1
    if W == to_width:
        return qk
    assert W > to_width
    return np.concatenate([qk[..., :to_width], qk[..., -1:]], axis=-1)


# device-memory budget for one re-serve batch (uint32 elements)
_RESERVE_BUDGET = 1 << 24


def _ladder(L: int, max_count: int, step: int = 4) -> List[int]:
    """Exact re-serve sizes: 4L, 16L, ... capped at the longest posting
    list rounded up to a block."""
    levels = []
    cur = L
    top = _round_up(max_count, 128)
    while cur < top:
        cur = min(cur * step, top)
        levels.append(cur)
    return levels
