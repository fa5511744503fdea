"""Serving steps (functions of snapshot tensors), the result wire codec and
small shared helpers (counterpart of models/steps.py)."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..codec import hashing
from ..codec import keys as keys_mod
from ..ops import setops
from ..ops.concat_bool import boolean_concat_step, resolve_step
from ..ops.cuda_bool import intersect_many
from ..ops.cuda_decode import decode_postings
from ..ops.cuda_fused import fused_and, reorder_smallest_base
from ..ops.dict_search import resolve, searchsorted_rows
from ..utils.u32 import MASK32, to_i64


def lookup_step(keys, blocks, term_block_start, counts, qkeys, L: int,
                slots=None, max_probes: int = 0, removed=None):
    """Batched exact-term lookup: (found (Q,), postings (Q, L) u32 bits,
    counts (Q,), raw_counts (Q,)). Resolve, then decode through K1. raw > L
    means the row holds only the first L postings and the caller re-serves
    it at a larger L. Pass `removed` to filter tombstones per row."""
    idx, found = resolve(keys, qkeys, slots, max_probes)
    vals, raw = decode_postings(blocks, term_block_start, counts,
                                idx.to(torch.int32), L, found)
    n = raw.clamp(max=L)
    if removed is not None and removed.shape[0] > 0:
        vals, n = setops.filter_removed(vals, n, removed)
    return found, vals, n, raw


def prefix_range_step(keys, lo_keys, hi_keys):
    """Prefixes -> dictionary ranges [lo, hi) by two batched binary
    searches of the sorted key rows. hi_keys is each prefix saturated with
    0xFF bytes and a length word of 0xFFFFFFFF (-1 as int32 bits), above
    every term that holds the prefix (codec/keys.prefix_bounds)."""
    return searchsorted_rows(keys, lo_keys), searchsorted_rows(keys, hi_keys)


def _decode_tier(keys, blocks, term_block_start, counts, slots, max_probes,
                 qflat, L: int):
    """Resolve packed terms (T, W+1) in one tier and decode their first L
    postings through K1: (vals (T, L) u32 bits, raw counts (T,), 0 for a
    miss, whose row K1 neither reads nor writes)."""
    idx, found = resolve(keys, qflat, slots, max_probes)
    return decode_postings(blocks, term_block_start, counts,
                           idx.to(torch.int32), L, found)


def _set_op(lists, ncnt, k_valid, op: str):
    """AND through K3, OR through the plain union (K runs merged and the
    unique values compacted on K4)."""
    if op == "and":
        return intersect_many(lists, ncnt, k_valid)
    if op == "or":
        return setops.union_many(lists, ncnt, k_valid)
    raise ValueError(f"op {op!r}: want 'and' or 'or'")


def _max_live(raw_qk, k_valid):
    """Largest raw count among each query's present terms (Q,) int32."""
    K = raw_qk.shape[1]
    kmask = (torch.arange(K, device=raw_qk.device)[None, :]
             < k_valid.to(torch.int64)[:, None])
    return torch.where(kmask, raw_qk, 0).max(dim=1).values.to(torch.int32)


def boolean_step(keys, blocks, term_block_start, counts, qkeys, k_valid,
                 L: int, op: str, removed=None, slots=None,
                 max_probes: int = 0):
    """Padded single-tier boolean step: qkeys (Q, K, W+1), k_valid (Q,).
    Each term's first L postings are decoded through K1, then AND (K3) or
    OR over the (Q, K, L) lists. Returns (out, oc, need): need is the
    largest raw count among the present terms, and need > L means a list
    was clipped, so the caller re-serves the query at a ladder level."""
    Q, K, Wp1 = qkeys.shape
    vals, raw = _decode_tier(keys, blocks, term_block_start, counts, slots,
                             max_probes, qkeys.reshape(Q * K, Wp1), L)
    raw_qk = raw.reshape(Q, K)
    out, oc = _set_op(vals.reshape(Q, K, L), raw_qk.clamp(max=L), k_valid,
                      op)
    if removed is not None and removed.shape[0] > 0:
        out, oc = setops.filter_removed(out, oc, removed)
    return out, oc, _max_live(raw_qk, k_valid)


def dual_lists(keys1, blocks1, tbs1, counts1, slots1,
               keys2, blocks2, tbs2, counts2, slots2,
               qkeys1, qkeys2, L: int, max_probes1: int = 0,
               max_probes2: int = 0):
    """The lists the dual step's set op runs on: each term's first L
    postings in each tier (K1), united per term (union_many: one K4 merge
    of the two tiers' runs and one K4 compaction). Returns (lists (Q, K,
    2L) u32 bits, counts (Q, K), raw (Q, K) the summed true counts of both
    tiers)."""
    Q, K = qkeys1.shape[:2]
    v1, r1 = _decode_tier(keys1, blocks1, tbs1, counts1, slots1,
                          max_probes1, qkeys1.reshape(Q * K, -1), L)
    v2, r2 = _decode_tier(keys2, blocks2, tbs2, counts2, slots2,
                          max_probes2, qkeys2.reshape(Q * K, -1), L)
    pair = torch.stack([v1, v2], dim=1)
    del v1, v2
    pcnt = torch.stack([r1.clamp(max=L), r2.clamp(max=L)], dim=1)
    two = torch.full((Q * K,), 2, dtype=torch.int32, device=pair.device)
    u, uc = setops.union_many(pair, pcnt, two)
    return u.reshape(Q, K, 2 * L), uc.reshape(Q, K), (r1 + r2).reshape(Q, K)


def boolean_step_dual(keys1, blocks1, tbs1, counts1, slots1,
                      keys2, blocks2, tbs2, counts2, slots2,
                      qkeys1, qkeys2, k_valid, L: int, op: str, removed=None,
                      max_probes1: int = 0, max_probes2: int = 0):
    """boolean_step over a main + delta snapshot pair: each term's postings
    are the union of its rows in both tiers (dual_lists), then the set op
    runs on the (Q, K, 2L) lists (AND through K3). qkeys1 / qkeys2 are the
    queries packed at each tier's width. Returns (out (Q, 2L) for AND,
    (Q, 2KL) for OR; oc; need), need summing both tiers' raw counts, so a
    re-serve level covers the union."""
    lists, ncnt, raw = dual_lists(
        keys1, blocks1, tbs1, counts1, slots1, keys2, blocks2, tbs2, counts2,
        slots2, qkeys1, qkeys2, L, max_probes1, max_probes2)
    out, oc = _set_op(lists, ncnt, k_valid, op)
    del lists
    if removed is not None and removed.shape[0] > 0:
        out, oc = setops.filter_removed(out, oc, removed)
    return out, oc, _max_live(raw, k_valid)


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
    out, oc = fused_and(blocks, rows2, cnt2, k_valid, L, width=small_p)
    if small_p:
        # the first small_p members come compacted out of K2 (on the CPU, out
        # of its plain versions: the masked rows, then compact_small)
        small = out
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


def _resolve_sb_step(keys, counts, qkeys, slots=None, max_probes: int = 0):
    """resolve_step plus each query's total block count, reduced on the
    device: (idx (Q, K), found (Q, K), sb (Q,) int32)."""
    idx, found, raw = resolve_step(keys, counts, qkeys, slots, max_probes)
    nb = (raw.to(torch.int64) + 127) // 128
    return idx, found, nb.sum(dim=1).to(torch.int32)


def _split_idx_step(idx_signed):
    """Host-resolved signed term rows (-1 = miss) -> the (idx, found) pair
    the concat steps take."""
    return idx_signed.clamp(min=0).to(torch.int64), idx_signed >= 0


def _concat_bool_sel_step(blocks, tbs, counts, idx_full, found_full,
                          kv_full, sel, SB: int, op: str, prefix_p: int = 0,
                          wire_dedup: bool = False):
    """boolean_concat_step over the rows `sel` (B,) of one resolved batch
    (the stream launches no pad rows, so every entry is a real row)."""
    s2 = sel.to(torch.int64)
    return boolean_concat_step(blocks, tbs, counts, idx_full[s2],
                               found_full[s2], kv_full[s2], SB, op,
                               prefix_p=prefix_p, wire_dedup=wire_dedup)


def _scatter_p_step(obuf, sel, o, oc):
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


def _u16_bits(x):
    """int64 values in [0, 2^16) -> int16 tensor with the same low 16 bits
    (the host reads it as uint16)."""
    return torch.where(x >= 1 << 15, x - (1 << 16), x).to(torch.int16)


def _pack_p_step(obuf):
    """u16 delta-pack of one batch's pagination buffer, one (QB, P+3) plane
    (int16 bits of u16 values):
      cols [0, P-1): value deltas truncated to u16 (invalid lanes zeroed)
      col P-1, P:    first value lo/hi
      col P+1, P+2:  true count lo / hi, with bit 15 of hi the OVERFLOW flag
                     (some kept delta >= 2^16; the harvest then reads those
                     rows raw from the resident buffer)
    Count hi bit 15 is free: counts are non-negative int32."""
    P = obuf.shape[1] - 1
    vals = to_i64(obuf[:, :P])
    cnt = to_i64(obuf[:, P])
    kept = cnt.clamp(max=P)
    d = (vals[:, 1:] - vals[:, :-1]) & MASK32
    j = torch.arange(P - 1, device=obuf.device)[None, :]
    d = torch.where(j < (kept - 1)[:, None], d, 0)
    flag = (d >= 1 << 16).any(dim=1).to(torch.int64)
    first = vals[:, 0]
    cols = [d & 0xFFFF, (first & 0xFFFF)[:, None], (first >> 16)[:, None],
            (cnt & 0xFFFF)[:, None], ((cnt >> 16) | (flag << 15))[:, None]]
    return _u16_bits(torch.cat(cols, dim=1))


# -- result wire codec (full-result fetch compression) ----------------------
#
# Result rows are sorted, so their deltas are small: a dispatch ships (first
# value u32, deltas u8 or u16) and the host rebuilds rows with one cumsum.
# The width is chosen per dispatch from the masked max delta, which rides
# the counts copy; a dispatch whose max delta needs 17+ bits ships raw u32.


def _wire_meta_step(o, oc):
    """Masked max result delta of a dispatch (int64 scalar); deltas past a
    row's count are fill and must not widen the choice."""
    if o.shape[1] < 2:
        return torch.zeros((), dtype=torch.int64, device=o.device)
    d = (to_i64(o[:, 1:]) - to_i64(o[:, :-1])) & MASK32
    col = torch.arange(o.shape[1] - 1, device=o.device)[None, :]
    mask = col < (oc.to(torch.int64) - 1)[:, None]
    return torch.where(mask, d, 0).max()


def _wire_pack_step(o, bits: int):
    """(first column (B, 1) u32 bits, delta plane (B, M-1) uint8 or int16
    bits of u16). Deltas past a row's count may wrap; the host trims to the
    row count before it reads them."""
    d = (to_i64(o[:, 1:]) - to_i64(o[:, :-1])) & MASK32
    if bits == 8:
        return o[:, :1], (d & 0xFF).to(torch.uint8)
    return o[:, :1], _u16_bits(d & 0xFFFF)


def _wire_unpack(first: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    """Host half: rebuild the (B, 1 + deltas.shape[1]) u32 result matrix."""
    out = np.empty((first.shape[0], 1 + deltas.shape[1]), dtype=np.uint32)
    out[:, :1] = first
    out[:, 1:] = deltas
    return np.cumsum(out, axis=1, dtype=np.uint32)


def _dedup_adjacent(v: np.ndarray) -> np.ndarray:
    """Drop adjacent duplicates from one sorted row: the host half of the
    wire-dedup OR contract (result sets are sorted unique, so a repeat can
    only be a cross-list duplicate the device left in the stream)."""
    if len(v) < 2:
        return v
    m = np.empty(len(v), dtype=bool)
    m[0] = True
    np.not_equal(v[1:], v[:-1], out=m[1:])
    return v[m]


def _pack_queries(queries, W: int):
    """Query batch (term lists) -> (qk (Q, K, W+1) uint32, kv (Q,) int32);
    one pack over the flattened terms."""
    nq = len(queries)
    kv = np.fromiter(map(len, queries), np.int32, count=nq)
    K = max(1, int(kv.max(initial=0)))
    qk = np.zeros((nq, K, W + 1), dtype=np.uint32)
    packed = keys_mod.pack_terms(
        [t for q in queries for t in q], width=W)
    kvq = kv.astype(np.int64)
    rows = np.repeat(np.arange(nq), kvq)
    qoffs = np.zeros(nq + 1, dtype=np.int64)
    np.cumsum(kvq, out=qoffs[1:])
    cols = np.arange(qoffs[-1], dtype=np.int64) - np.repeat(qoffs[:-1], kvq)
    qk[rows, cols] = packed
    return qk, kv


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
