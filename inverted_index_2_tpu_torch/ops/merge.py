"""Device k-way segment merge as torch ops (counterpart of ops/merge.py).

Shard.merge takes this path once a merge reaches DEVICE_MERGE_MIN_VALUES
postings (shard.py); smaller merges run merge_views on the host. The steps:

    1. stable lexicographic sort of the packed term key rows (u32 order,
       the bytes.Compare order of codec/keys.py), one stable sort a column
    2. adjacent-equal grouping -> group ids (cumsum)
    3. (group, value) sort -> each group's values ascending
    4. duplicate drop + tombstone mask (searchsorted in u32 order)
    5. kept-first compaction of the survivors (stable), survivors per group
       by scatter_add_

merge_views_device() keeps shard.merge_views' contract (blob, offsets,
values, value_offsets, or None), bit for bit. Shapes are the merge's own:
the JAX package pads every dimension to a power of two so that XLA does
not compile again for each merge, and nothing here compiles. The key rows,
the decode of the inputs and the gather of the term bytes stay on the host.

u32 data travels as int32 bits (utils/u32.py).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..utils.u32 import MASK32, flip, from_i64, to_device, to_i64, to_numpy_u32


def _sort_key_rows(keys: torch.Tensor):
    """Stable lexicographic sort of (N, W+1) u32 rows in u32 order: (perm
    (N,) int64, the sorted rows). One stable sort a column, last first."""
    N, Wp1 = keys.shape
    perm = torch.arange(N, dtype=torch.int64, device=keys.device)
    for c in range(Wp1 - 1, -1, -1):
        col = flip(keys[perm, c])
        perm = perm[torch.sort(col, stable=True).indices]
    return perm, keys[perm]


def merge_device_step(keys_all, term_of_value, values, removed):
    """The merge on the device. keys_all (N, W+1) u32 bits; term_of_value
    (V,) the key row of each value; values (V,) u32 bits; removed (R,) u32
    bits sorted in u32 order (R may be 0).

    Returns:
      perm (N,) int64            original row of each sorted position
      group_head (N,) bool       sorted position starts a new term group
      group_of_pos (N,) int64    group id per sorted position
      kept_count () int64        total surviving values
      out_values (V,) u32 bits   survivors first, in (group, value) order,
                                 then the dropped values in that order
      out_group (V,) int64       group id of each out_values lane
      group_counts (N,) int32    survivors per group id
    """
    N = keys_all.shape[0]
    dev = keys_all.device
    perm, sorted_keys = _sort_key_rows(keys_all)
    neq = (sorted_keys[1:] != sorted_keys[:-1]).any(dim=1)
    group_head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), neq])
    group_of_pos = torch.cumsum(group_head.to(torch.int64), dim=0) - 1
    group_of_term = torch.empty(N, dtype=torch.int64, device=dev)
    group_of_term[perm] = group_of_pos

    g = group_of_term[term_of_value.to(torch.int64)]
    # (group, value) as one int64 key: group ids are below 2^31
    key = torch.sort((g << 32) | to_i64(values)).values
    gs = key >> 32
    vs = from_i64(key & MASK32)
    keep = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                      key[1:] != key[:-1]])
    R = removed.shape[0]
    if R > 0:
        rf = flip(removed)
        vf = flip(vs)
        pos = torch.searchsorted(rf, vf)
        keep &= ~((rf[pos.clamp(max=R - 1)] == vf) & (pos < R))
    # survivors to the front, (group, value) order kept on both sides
    order = torch.sort((~keep).to(torch.int8), stable=True).indices
    out_group = gs[order]
    out_values = vs[order]
    kept_count = keep.sum()
    group_counts = torch.zeros(N, dtype=torch.int32, device=dev).scatter_add_(
        0, gs, keep.to(torch.int32))
    return (perm, group_head, group_of_pos, kept_count, out_values,
            out_group, group_counts)


def merge_views_device(views: List, removed: Optional[np.ndarray] = None, *,
                       device="cuda"):
    """shard.merge_views with its sort, grouping, duplicate drop and
    tombstone purge on `device` (the card unless the caller asks for the
    CPU); same inputs and the same result, bit for bit. Raises when
    `device` is CUDA and no CUDA device is present."""
    from ..codec import keys as keys_mod
    from ..utils.ragged import ragged_gather

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("merge_views_device: device 'cuda' asked for and "
                           "no CUDA device is present")
    views = [v for v in views if v.n_terms > 0]
    if not views:
        return None
    W = max(keys_mod.width_words(v.max_term_len) for v in views)
    keys_all = np.concatenate([v.keys(W) for v in views], axis=0)

    vals_parts, tov_parts = [], []
    base = 0
    for v in views:
        vals, counts, _ = v.decode_all()
        vals_parts.append(vals)
        tov_parts.append(
            np.repeat(np.arange(v.n_terms, dtype=np.int32) + base, counts))
        base += v.n_terms
    all_vals = np.concatenate(vals_parts).astype(np.uint32, copy=False)
    if len(all_vals) == 0:
        return None
    rem = (np.asarray(removed, dtype=np.uint32) if removed is not None
           else np.zeros(0, np.uint32))

    (perm, group_head, _, kept, out_values, out_group,
     group_counts) = merge_device_step(
        to_device(keys_all, device), to_device(np.concatenate(tov_parts),
                                               device),
        to_device(all_vals, device), to_device(rem, device))
    kept = int(kept)
    if kept == 0:
        return None
    out_values = to_numpy_u32(out_values[:kept])
    out_group = out_group[:kept].cpu().numpy()
    group_counts = group_counts.cpu().numpy()
    perm = perm.cpu().numpy()
    head_pos = np.nonzero(group_head.cpu().numpy())[0]

    # out_group ascends: its run heads are the groups with survivors, in
    # term order
    heads = np.empty(kept, dtype=bool)
    heads[0] = True
    np.not_equal(out_group[1:], out_group[:-1], out=heads[1:])
    kept_groups = out_group[heads]
    rep_orig = perm[head_pos[kept_groups]]
    voffs = np.zeros(len(kept_groups) + 1, dtype=np.int64)
    np.cumsum(group_counts[kept_groups], out=voffs[1:])
    n_per = np.array([v.n_terms for v in views], dtype=np.int64)
    view_base = np.zeros(len(views) + 1, dtype=np.int64)
    np.cumsum(n_per, out=view_base[1:])
    view_idx = np.searchsorted(view_base, rep_orig, side="right") - 1
    blob_parts = [v.blob for v in views]
    blob_base = np.zeros(len(views) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blob_parts], out=blob_base[1:])
    all_blob = np.concatenate(blob_parts)
    term_starts = np.concatenate([v.offsets[:-1] for v in views])
    term_lens = np.concatenate([np.diff(v.offsets) for v in views])
    g_tlen = term_lens[rep_orig]
    out_blob, _ = ragged_gather(all_blob, term_starts[rep_orig]
                                + blob_base[view_idx], g_tlen)
    out_offsets = np.zeros(len(kept_groups) + 1, dtype=np.int64)
    np.cumsum(g_tlen, out=out_offsets[1:])
    return out_blob.tobytes(), out_offsets, out_values, voffs
