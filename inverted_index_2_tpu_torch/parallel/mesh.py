"""Partitioned serving: the index's shard axis cut over a list of torch
devices (counterpart of parallel/mesh.py).

The 10-bit shard-key space (or, from a checkpoint, the term space) is cut
into contiguous ranges, one partition each; partition d holds the frozen
snapshot of its range on devices[d], padded to the shape every partition
shares. Queries go to every partition; each answers for the terms it owns
and zero elsewhere, and the answers meet in a sum (collectives.psum /
psum_scatter): a term's postings live in exactly one partition, so each sum
has one non-zero term. Device order is term order, which range reads rely
on.

One process drives every partition (a single controller, as the JAX mesh
is). A device may repeat in the list, so D partitions can share one card;
the same code runs on several cards and, in the tests, on the CPU. Each
per-partition step launches the port's kernels: the lookup resolves and
decodes through K1, the AND runs K3, the OR and the dual tier's pair union
K4's merge and compaction, the concat factories sort their gathered rows
with K4, and the range and prefix reads decode through K1.

Each factory returns a `call`: the JAX package's shard_map programs and
their compile cache have no counterpart here. Results come back on
devices[0]; the scatter forms compute each query tile on its partition's
device and join the tiles there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..codec import hashing
from ..codec import keys as keys_mod
from ..codec import native
from ..models.snapshot import (
    STRIDE_ALIGN,
    HostTables,
    IndexSnapshot,
    _empty_tables,
    build_host_tables,
)
from ..models.steps import (
    _RESERVE_BUDGET,
    _dedup_adjacent,
    _ladder,
    _max_live,
    _set_op,
    lookup_step,
    prefix_range_step,
)
from ..ops import concat_bool as cb
from ..ops import setops
from ..ops.compaction import compact_rows
from ..ops.cuda_decode import decode_postings
from ..ops.cuda_sort import sort_rows
from ..ops.dict_search import hash_lookup_rows
from ..shard import merge_views
from ..utils.u32 import SENT, to_device, to_numpy_u32
from .collectives import all_gather, all_to_all, psum, psum_scatter, replicate

# padding key row: sorts after every real term (length word 0xFFFFFFFF is
# impossible for a real term) and never equals a real query key
_PAD_WORD = 0xFFFFFFFF


@dataclass
class ShardedSnapshot:
    """Per-partition snapshot tensors, padded to one shape; element d of
    each list lives on devices[d]. The host keeps each partition's real
    term count, counts and block starts (small) for the ladder, the range
    reads and partition_stats."""

    keys: List[torch.Tensor]              # (Nmax, W+1) u32 bits
    blocks: List[torch.Tensor]            # (Bmax, stride) block row arenas
    term_block_start: List[torch.Tensor]  # (Nmax+1,) int32
    counts: List[torch.Tensor]            # (Nmax,) int32
    hash_slots: List[torch.Tensor]        # (S,) int32, one S for all
    devices: List[torch.device]
    width: int
    n_real: np.ndarray                    # (D,) real terms per partition
    host_counts: np.ndarray               # (D, Nmax) int32
    host_tbs: np.ndarray                  # (D, Nmax+1) int32
    max_probes: int = 1
    max_count: int = 0                    # longest list over partitions

    @property
    def n_devices(self) -> int:
        return len(self.devices)


def default_mesh(n_devices: Optional[int] = None,
                 device="cuda") -> List[torch.device]:
    """n_devices partitions' devices: CUDA cards in turn (partition d on
    card d mod count, so partitions share cards when there are more of
    them), or the CPU. Defaults to one partition a card (one on the CPU).
    Raises for "cuda" when no CUDA device is present."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("default_mesh: device 'cuda' asked for and no "
                               "CUDA device is present")
        count = torch.cuda.device_count()
        return [torch.device("cuda", d % count)
                for d in range(n_devices or count)]
    if kind != "cpu":
        raise ValueError(f"device {device}: want 'cuda' or 'cpu'")
    return [torch.device("cpu")] * (n_devices or 1)


def _devices(mesh: Sequence) -> List[torch.device]:
    """Device list with every CUDA device indexed (one key per card)."""
    out = []
    for d in mesh:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return out


# ---------------------------------------------------------------------------
# host half: key ranges, partition tables, padding (numpy)
# ---------------------------------------------------------------------------


def _pad_table_keys(keys: np.ndarray, Nmax: int, W: int) -> np.ndarray:
    """Pad a (n, w+1) key matrix to (Nmax, W+1) with _PAD_WORD rows,
    widening real rows by zero-filling before the length word."""
    n, w1 = keys.shape
    out = np.full((Nmax, W + 1), _PAD_WORD, dtype=np.uint32)
    if n:
        out[:n, : w1 - 1] = keys[:, :-1]
        out[:n, w1 - 1: W] = 0
        out[:n, W] = keys[:, -1]
    return out


def _pad_partition(snap: IndexSnapshot, Nmax: int, Bmax: int, stride: int,
                   W: int):
    """One partition's snapshot padded to the common shape, on the host:
    (keys, blocks, tbs, counts)."""
    keys = _pad_table_keys(to_numpy_u32(snap.keys), Nmax, W)
    blocks = np.zeros((Bmax, stride), dtype=np.uint32)
    bl = to_numpy_u32(snap.blocks)
    blocks[: bl.shape[0], : bl.shape[1]] = bl
    tbs = np.zeros(Nmax + 1, dtype=np.int32)
    t = snap.term_block_start.cpu().numpy()
    tbs[: len(t)] = t
    tbs[len(t):] = t[-1] if len(t) else 0
    counts = np.zeros(Nmax, dtype=np.int32)
    c = snap.counts.cpu().numpy()
    counts[: len(c)] = c
    return keys, blocks, tbs, counts


def shard_ranges(n_devices: int, fanout: int = 1024) -> List[range]:
    """Contiguous split of the shard-key space ("0000".."1023") per device."""
    per = -(-fanout // n_devices)
    return [range(d * per, min((d + 1) * per, fanout))
            for d in range(n_devices)]


def _shard_block_rows(sh) -> int:
    """Upper-bound arena BLOCK rows a shard contributes: sum of ceil(len/128)
    per term per segment (union across segments can only shrink it).
    Direct segments hold one value per term = one block row each."""
    total = 0
    for seg in sh.segments.snapshot():
        v = seg.view
        if v is None:
            continue
        if v.mode == 1:  # MODE_DIRECT
            total += v.n_terms
        elif v.n_terms:
            cnts = v.words[v.outs.astype(np.int64)].astype(np.int64)
            total += int(np.sum((cnts + 127) // 128))
    return total


def balanced_ranges(index, n_devices: int, fanout: int = 1024,
                    by: str = "blocks") -> List[range]:
    """Contiguous shard-key ranges cut at about equal BLOCK volume
    (by="terms" cuts on term counts instead). Contiguity keeps device order
    equal to term order; cutting by volume instead of key count fixes the
    skew of real corpora, whose prefixes crowd a narrow band of the 10-bit
    space. Blocks are the measure because every partition pads to the
    largest one's (Bmax, stride) arena."""
    per_key = np.zeros(fanout, dtype=np.int64)
    for sh in index._snapshot():
        try:
            k = int(sh.get_key())
        except ValueError:
            continue
        if by == "blocks":
            per_key[k] = _shard_block_rows(sh)
        else:
            per_key[k] = sum(s.terms for s in sh.segments.snapshot())
    total = int(per_key.sum())
    if total == 0:
        return shard_ranges(n_devices, fanout)
    cum = np.cumsum(per_key)
    bounds = [0]
    for d in range(1, n_devices):
        cut = int(np.searchsorted(cum, total * d // n_devices,
                                  side="left")) + 1
        bounds.append(min(max(cut, bounds[-1]), fanout))
    bounds.append(fanout)
    return [range(bounds[d], bounds[d + 1]) for d in range(n_devices)]


def partition_tables(t: HostTables, n_dev: int) -> List[HostTables]:
    """Cut one global HostTables (a loaded checkpoint) into n_dev contiguous
    TERM ranges balanced by block volume: the skew rule of balanced_ranges,
    in term space. Any disjoint contiguous cut keeps one owner per term.
    The partitions' hash tables are left empty: stack_tables builds one per
    partition at a common size over the widened key rows."""
    N = t.n_terms
    if N == 0:
        return [_empty_tables(t.width) for _ in range(n_dev)]
    cum = t.tbs.astype(np.int64)[1:]  # block rows after each term
    total = int(cum[-1])
    bounds = [0]
    for d in range(1, n_dev):
        cut = int(np.searchsorted(cum, total * d // n_dev, side="left")) + 1
        bounds.append(min(max(cut, bounds[-1]), N))
    bounds.append(N)
    return [_slice_tables(t, bounds[d], bounds[d + 1])
            if bounds[d + 1] > bounds[d] else _empty_tables(t.width)
            for d in range(n_dev)]


def _slice_tables(t: HostTables, t0: int, t1: int) -> HostTables:
    """Term range [t0, t1) of host tables, without a hash table."""
    N = t.n_terms
    tbs64 = t.tbs.astype(np.int64)
    b0, b1 = int(tbs64[t0]), int(tbs64[t1])
    w0 = int(t.flat[b0]) - 1  # the count word precedes the first block
    w1 = int(t.flat[b1]) - 1 if t1 < N else len(t.words)
    counts = t.counts[t0:t1]
    return HostTables(
        keys=t.keys[t0:t1],
        words=t.words[w0:w1],
        flat=(t.flat[b0:b1] - w0).astype(np.int32),
        tbs=(t.tbs[t0: t1 + 1] - t.tbs[t0]).astype(np.int32),
        counts=counts,
        removed=np.zeros(0, np.uint32),  # the engine keeps the tombstones
        slots=np.full(8, -1, dtype=np.int32),
        max_probes=1,
        max_count=int(counts.max()) if len(counts) else 0,
        width=t.width,
        # every partition shares one stride: the global widest block
        max_bw=t.max_bw,
    )


def _partition_slots(keys_real: np.ndarray, S: int):
    """Hash table of a partition's real (widened) key rows at size S:
    (slots, max_probes)."""
    n = keys_real.shape[0]
    if n == 0:
        return np.full(S, -1, dtype=np.int32), 1
    h = hashing.hash_rows_np(keys_real)
    if native.available():
        return native.hash_build_with_probes(h, S=S)
    slots = np.full(S, -1, dtype=np.int32)
    mask = np.uint32(S - 1)
    for i, hv in enumerate(h):
        pos = np.uint32(hv) & mask
        while slots[pos] >= 0:
            pos = (pos + np.uint32(1)) & mask
        slots[pos] = i
    return slots, hashing.max_probe_len(slots, h)


def _hash_tables(keys_pad: List[np.ndarray], n_real: Sequence[int], S: int):
    tables, probes = [], 1
    for kp, n in zip(keys_pad, n_real):
        slots, mp = _partition_slots(kp[:n], S)
        tables.append(slots)
        probes = max(probes, mp)
    return tables, probes


def build_sharded_snapshot(index, mesh: Sequence,
                           width: Optional[int] = None) -> ShardedSnapshot:
    """Freeze an InvertedIndex into one partition per entry of `mesh`:
    shard directories route by contiguous shard-key ranges cut at about
    equal block volume (balanced_ranges), each range merges on the host
    into compact tables, and stack_tables uploads them."""
    devices = _devices(mesh)
    ranges = balanced_ranges(index, len(devices))
    parts: List[HostTables] = []
    for r in ranges:
        views = []
        for sh in index._snapshot():
            try:
                k = int(sh.get_key())
            except ValueError:
                continue
            if k in r:
                views.extend(s.view for s in sh.segments.snapshot()
                             if s.view is not None)
        merged = merge_views(views, None)
        if merged is None:
            parts.append(_empty_tables(width or 1))
        else:
            blob, offsets, values, voffs = merged
            parts.append(build_host_tables(blob, offsets, values, voffs, None,
                                           width, build_hash=False))
    return stack_tables(parts, devices)


def _stack(devices, W, keys_pad, tbs_pad, counts_pad, n_real, tables,
           probes, max_count, arenas) -> ShardedSnapshot:
    """Ship the padded host arrays to each partition's device; `arenas`
    gives partition d's block arena on its device."""
    return ShardedSnapshot(
        keys=[to_device(k, dev) for k, dev in zip(keys_pad, devices)],
        blocks=[arenas(d, dev) for d, dev in enumerate(devices)],
        term_block_start=[to_device(t, dev)
                          for t, dev in zip(tbs_pad, devices)],
        counts=[to_device(c, dev) for c, dev in zip(counts_pad, devices)],
        hash_slots=[to_device(s, dev) for s, dev in zip(tables, devices)],
        devices=list(devices),
        width=W,
        n_real=np.asarray(n_real, dtype=np.int64),
        host_counts=np.stack(counts_pad),
        host_tbs=np.stack(tbs_pad),
        max_probes=probes,
        max_count=max_count,
    )


def stack_tables(parts: List[HostTables], mesh: Sequence) -> ShardedSnapshot:
    """Pad host-table partitions to one shape, build each partition's hash
    table at one power-of-two size, ship only the compressed words and
    block offsets, and expand each partition's (Bmax, stride) arena with one
    row gather on its device. The stride is the widest block plus one word,
    aligned to 4 words for K1."""
    devices = _devices(mesh)
    W = max(p.width for p in parts)
    Nmax = max(max(p.n_terms for p in parts), 1)
    Bmax = max(max(len(p.flat) for p in parts), 1)
    Tmax = max(max(len(p.words) for p in parts), 1)
    stride = max(4, max(p.max_bw for p in parts) + 1)
    stride = -(-stride // STRIDE_ALIGN) * STRIDE_ALIGN
    S = hashing.table_size(Nmax)

    keys_pad, tbs_pad, counts_pad, flat_pad, words_pad = [], [], [], [], []
    for p in parts:
        n = p.n_terms
        keys_pad.append(_pad_table_keys(p.keys, Nmax, W))
        tbs = np.zeros(Nmax + 1, dtype=np.int32)
        tbs[: len(p.tbs)] = p.tbs
        tbs[len(p.tbs):] = p.tbs[-1] if len(p.tbs) else 0
        tbs_pad.append(tbs)
        c = np.zeros(Nmax, dtype=np.int32)
        c[:n] = p.counts
        counts_pad.append(c)
        # pad rows point one past the real words: the zero tail decodes as
        # an empty block, and no term reaches them (tbs caps real rows)
        fl = np.full(Bmax, len(p.words), dtype=np.int64)
        fl[: len(p.flat)] = p.flat
        flat_pad.append(fl)
        wp = np.zeros(Tmax + stride, dtype=np.uint32)
        wp[: len(p.words)] = p.words
        words_pad.append(wp)
    n_real = [p.n_terms for p in parts]
    tables, probes = _hash_tables(keys_pad, n_real, S)

    def arena(d, dev):
        wp = to_device(words_pad[d], dev)
        return wp.unfold(0, stride, 1)[to_device(flat_pad[d], dev)]

    return _stack(devices, W, keys_pad, tbs_pad, counts_pad, n_real, tables,
                  probes, max(p.max_count for p in parts), arena)


def stack_partitions(parts: List[IndexSnapshot],
                     mesh: Sequence) -> ShardedSnapshot:
    """Pad snapshot partitions (on any device) to one shape on the host and
    ship each to its partition's device, with one hash table size for all
    (the delta tier of MeshQueryEngine: one snapshot and empty ones)."""
    devices = _devices(mesh)
    W = max(p.width for p in parts)
    Nmax = max(max(p.n_terms for p in parts), 1)
    Bmax = max(max(int(p.blocks.shape[0]) for p in parts), 1)
    stride = max(int(p.blocks.shape[1]) for p in parts)
    stride = -(-stride // STRIDE_ALIGN) * STRIDE_ALIGN
    padded = [_pad_partition(p, Nmax, Bmax, stride, W) for p in parts]
    keys_pad = [pp[0] for pp in padded]
    n_real = [p.n_terms for p in parts]
    tables, probes = _hash_tables(keys_pad, n_real, hashing.table_size(Nmax))
    return _stack(devices, W, keys_pad, [pp[2] for pp in padded],
                  [pp[3] for pp in padded], n_real, tables, probes,
                  max(p.max_count for p in parts),
                  lambda d, dev: to_device(padded[d][1], dev))


# ---------------------------------------------------------------------------
# device half: the per-partition steps and the factories
# ---------------------------------------------------------------------------


def _local_lookup(snap: ShardedSnapshot, d: int, qkeys: torch.Tensor,
                  L: int):
    """Partition d's answer: (found, vals, n, raw) for the terms it owns,
    zero elsewhere. n is the served count (clamped to L), raw the term's
    true count: raw > L flags a clipped row, which the caller re-serves at
    a larger ladder L. K1 neither reads nor writes the row of a term the
    partition does not hold, so those rows are selected to zero here,
    before any sum adds them."""
    found, vals, n, raw = lookup_step(
        snap.keys[d], snap.blocks[d], snap.term_block_start[d],
        snap.counts[d], qkeys, L, snap.hash_slots[d], snap.max_probes)
    vals = torch.where((found & (n > 0))[:, None], vals, 0)
    n = torch.where(found, n, 0)
    return found, vals, n, raw


def _pad_rows(x: torch.Tensor, Qp: int) -> torch.Tensor:
    """x with zero rows appended up to Qp rows."""
    Q = x.shape[0]
    if Qp == Q:
        return x
    return torch.cat([x, torch.zeros((Qp - Q, *x.shape[1:]), dtype=x.dtype,
                                     device=x.device)])


def _as_tensor(x, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if dtype is not None:
        a = a.astype(dtype, copy=False)
    return to_device(a, "cpu")


def _join(tiles: List[torch.Tensor], Q: int, dev) -> torch.Tensor:
    """Query tiles (one per partition) joined in order on `dev`, cut to Q."""
    return torch.cat([t.to(dev, non_blocking=True) for t in tiles])[:Q]


def _tiles(xs: List[torch.Tensor], devs, scatter: bool) -> List[torch.Tensor]:
    """The partitions' sum of xs (rows are queries): with scatter, one
    query tile a partition (a reduce-scatter), else the whole sum once, on
    devices[0] (an all-reduce's first copy)."""
    return psum_scatter(xs, devs) if scatter else psum(xs, devs)[:1]


def _lookup_call(snap: ShardedSnapshot, L: int, scatter: bool) -> Callable:
    devs = snap.devices
    D = len(devs) if scatter else 1

    def call(qkeys):
        qkeys = _as_tensor(qkeys, np.uint32)
        Q = qkeys.shape[0]
        qs = replicate(_pad_rows(qkeys, -(-Q // D) * D), devs)
        parts = [_local_lookup(snap, d, qs[d], L) for d in range(len(devs))]
        found = _join(_tiles([p[0].to(torch.int32) for p in parts], devs,
                             scatter), Q, devs[0]) > 0
        vals, n, raw = (_join(_tiles([p[i] for p in parts], devs, scatter),
                              Q, devs[0]) for i in (1, 2, 3))
        return found, vals, n, raw
    return call


def make_sharded_lookup(snap: ShardedSnapshot, L: int) -> Callable:
    """Fan-out lookup: the queries go to every partition, the answers meet
    in a psum (one owner per term, so the sum is the owner's answer).
    call(qkeys (Q, W+1)) -> (found, vals (Q, L), n, raw) on devices[0]; raw
    > L flags truncation (misses add 0, so the owner's true count
    survives)."""
    return _lookup_call(snap, L, scatter=False)


def make_sharded_lookup_scatter(snap: ShardedSnapshot, L: int) -> Callable:
    """make_sharded_lookup with the sum as a reduce-scatter over the query
    axis: partition d reduces only its Q/D tile, and the tiles join on
    devices[0]. Same (found, vals, n, raw); Q pads to a multiple of D."""
    return _lookup_call(snap, L, scatter=True)


def _boolean_tile(lists, ncnt, raw, kv, op: str):
    """The set op over one tile's (Qt, K, L) lists: (out, oc, need)."""
    out, oc = _set_op(lists, ncnt, kv, op)
    return out, oc, _max_live(raw, kv)


def _boolean_call(snap: ShardedSnapshot, L: int, op: str,
                  scatter: bool) -> Callable:
    devs = snap.devices
    D = len(devs) if scatter else 1

    def call(qkeys, k_valid):
        qkeys = _as_tensor(qkeys, np.uint32)
        Q, K, Wp1 = qkeys.shape
        Qp = -(-Q // D) * D
        Qd = Qp // D
        qs = replicate(_pad_rows(qkeys, Qp).reshape(Qp * K, Wp1), devs)
        kv = _pad_rows(_as_tensor(k_valid, np.int32), Qp)
        parts = [_local_lookup(snap, d, qs[d], L) for d in range(len(devs))]
        vals, n, raw = (_tiles([p[i].reshape(Qp, -1) for p in parts], devs,
                               scatter) for i in (1, 2, 3))
        tiles = [_boolean_tile(vals[d].reshape(Qd, K, L), n[d], raw[d],
                               kv[d * Qd:(d + 1) * Qd].to(vals[d].device), op)
                 for d in range(D)]
        return tuple(_join([t[i] for t in tiles], Q, devs[0])
                     for i in range(3))
    return call


def make_sharded_boolean(snap: ShardedSnapshot, L: int, op: str) -> Callable:
    """Fan-out boolean: each term's first L postings come from its owner
    (psum), then the set op runs once over the whole (global) lists: AND
    through K3, OR through union_many (K4). call(qkeys (Q, K, W+1), k_valid
    (Q,)) -> (out, oc, need) on devices[0]; need > L means a list was
    clipped, and the caller re-serves the query at a larger ladder L."""
    return _boolean_call(snap, L, op, scatter=False)


def make_sharded_boolean_scatter(snap: ShardedSnapshot, L: int,
                                 op: str) -> Callable:
    """make_sharded_boolean with the owner decode followed by a
    reduce-scatter over the query axis: partition d gets the whole lists
    of its Q/D query tile and runs the set op on that tile alone, so the
    set op runs once per query across the partitions. The same (out, oc,
    need); Q pads to a multiple of D."""
    return _boolean_call(snap, L, op, scatter=True)


def _pair_union(v1, n1, v2, n2):
    """Each term's rows in the two tiers united: (lists (T, 2L), counts):
    one K4 merge of the two runs and one K4 compaction (union_many)."""
    pair = torch.stack([v1, v2], dim=1)
    pcnt = torch.stack([n1, n2], dim=1)
    two = torch.full((pair.shape[0],), 2, dtype=torch.int32,
                     device=pair.device)
    return setops.union_many(pair, pcnt, two)


def _dual_call(snap, dsnap, L: int, op: str, scatter: bool) -> Callable:
    devs = snap.devices
    D = len(devs) if scatter else 1

    def call(qk1, qk2, k_valid):
        qk1 = _as_tensor(qk1, np.uint32)
        qk2 = _as_tensor(qk2, np.uint32)
        Q, K = qk1.shape[:2]
        Qp = -(-Q // D) * D
        Qd = Qp // D
        kv = _pad_rows(_as_tensor(k_valid, np.int32), Qp)
        tiers = []
        for s, qk in ((snap, qk1), (dsnap, qk2)):
            qs = replicate(_pad_rows(qk, Qp).reshape(Qp * K, -1), devs)
            parts = [_local_lookup(s, d, qs[d], L) for d in range(len(devs))]
            tiers.append([_tiles([p[i].reshape(Qp, -1) for p in parts], devs,
                                 scatter) for i in (1, 2, 3)])
        (v1, n1, r1), (v2, n2, r2) = tiers
        tiles = []
        for d in range(D):
            u, uc = _pair_union(v1[d].reshape(Qd * K, L), n1[d].reshape(-1),
                                v2[d].reshape(Qd * K, L), n2[d].reshape(-1))
            tiles.append(_boolean_tile(
                u.reshape(Qd, K, 2 * L), uc.reshape(Qd, K), r1[d] + r2[d],
                kv[d * Qd:(d + 1) * Qd].to(u.device), op))
        return tuple(_join([t[i] for t in tiles], Q, devs[0])
                     for i in range(3))
    return call


def make_sharded_boolean_dual(snap: ShardedSnapshot, dsnap: ShardedSnapshot,
                              L: int, op: str) -> Callable:
    """Fan-out boolean over a main + delta pair of sharded snapshots: each
    tier's per-term postings meet in their own psum (a term may live in
    different partitions in the two tiers; each sum has one owner), the
    pair unites per (query, slot) through K4, then the set op runs once
    over the global lists: the partitioned steps.boolean_step_dual.
    call(qk1, qk2, k_valid) -> (out, oc, need), qk1 / qk2 the same queries
    packed at each tier's width."""
    return _dual_call(snap, dsnap, L, op, scatter=False)


def make_sharded_boolean_dual_scatter(snap: ShardedSnapshot,
                                      dsnap: ShardedSnapshot, L: int,
                                      op: str) -> Callable:
    """make_sharded_boolean_dual with both tiers reduce-scattered over the
    query axis: the pair union and the set op run on each partition's Q/D
    tile. The same (out, oc, need); Q pads to a multiple of D."""
    return _dual_call(snap, dsnap, L, op, scatter=True)


def _concat_local(snap: ShardedSnapshot, d: int, qkeys, kv, SB: int):
    """Partition d's part of a concat-decode query: its owned terms' blocks
    laid out into SB slots and decoded, (local (Q, SB*128) u32 bits with
    0xFFFFFFFF on invalid lanes, live (Q, K), has_ff (Q, K): the term's
    last value is a genuine 0xFFFFFFFF)."""
    Q, K, Wp1 = qkeys.shape
    idx, found = hash_lookup_rows(snap.keys[d], snap.hash_slots[d],
                                  qkeys.reshape(Q * K, Wp1), snap.max_probes)
    idx = idx.reshape(Q, K)
    kmask = (torch.arange(K, device=qkeys.device)[None, :]
             < kv.to(torch.int64)[:, None])
    live = found.reshape(Q, K) & kmask
    cnt = torch.where(live, snap.counts[d][idx].to(torch.int64), 0)
    rows, in_use, bit, cnt_j, cum = cb.concat_layout(
        snap.term_block_start[d][idx].to(torch.int64), cnt, SB)
    local, vals, _ = cb.decode_masked(snap.blocks[d], rows, in_use, bit,
                                      cnt_j)
    has_ff = (cnt > 0) & (cb.last_values(vals, cum, cnt) == SENT)
    return local, live, has_ff


def _concat_reduce(svals, kv, K: int, ff_cnt, n_found, op: str):
    """Run-length reduction of one tile's sorted concat rows: (out, oc).
    AND keeps runs that reach k_valid, OR the first of each run; a genuine
    0xFFFFFFFF sorts with the fill and is counted from ff_cnt, the number
    of the query's terms whose last value it is."""
    Qt = svals.shape[0]
    first = torch.cat([torch.ones((Qt, 1), dtype=torch.bool,
                                  device=svals.device),
                       svals[:, 1:] != svals[:, :-1]], dim=1)
    if op == "and":
        keep = cb.run_reaches_k(svals, kv, K) & first & (svals != SENT)
        # a required term found nowhere voids the AND (the run length
        # handles every other value; this guards the 0xFFFFFFFF count)
        ff_all = (ff_cnt == kv) & (kv > 0) & (n_found == kv)
        oc = keep.sum(dim=1) + ff_all.to(torch.int64)
    else:
        keep = first & (svals != SENT)
        oc = keep.sum(dim=1) + (ff_cnt > 0).to(torch.int64)
    return compact_rows(svals, keep), oc.to(torch.int32)


def _concat_call(snap: ShardedSnapshot, SB: int, op: str,
                 scatter: bool) -> Callable:
    if op not in ("and", "or"):
        raise ValueError(f"op {op!r}: want 'and' or 'or'")
    devs = snap.devices
    D = len(devs)

    def call(qkeys, k_valid):
        qkeys = _as_tensor(qkeys, np.uint32)
        k_valid = _as_tensor(k_valid, np.int32)
        Q, K = qkeys.shape[:2]
        Qp = -(-Q // D) * D if scatter else Q
        qs = replicate(_pad_rows(qkeys, Qp), devs)
        kvs = replicate(_pad_rows(k_valid, Qp), devs)
        parts = [_concat_local(snap, d, qs[d], kvs[d], SB) for d in range(D)]
        ff_cnt = psum([p[2].sum(dim=1) for p in parts], devs)
        n_found = psum([p[1].sum(dim=1) for p in parts], devs)
        if scatter:
            # partition d gets every partition's slice of its query tile
            rows = all_to_all([p[0] for p in parts], devs, 0, 1)
            Qd = Qp // D
            tiles = [slice(d * Qd, (d + 1) * Qd) for d in range(D)]
        else:
            rows = [all_gather([p[0] for p in parts], devs)[0]
                    .movedim(0, 1).reshape(Q, -1)]
            tiles = [slice(0, Q)]
        outs = []
        for d, sl in enumerate(tiles):
            # every 128-lane block of every slice ascends (decode_masked)
            svals = sort_rows(rows[d], run=cb.BLOCK)
            outs.append(_concat_reduce(
                svals, kvs[d][sl].to(torch.int64), K, ff_cnt[d][sl],
                n_found[d][sl], op))
        return tuple(_join([o[i] for o in outs], Q, devs[0])
                     for i in range(2))
    return call


def make_sharded_boolean_concat(snap: ShardedSnapshot, SB: int,
                                op: str) -> Callable:
    """Concat-decode boolean over the partitions (ops/concat_bool.py,
    partitioned): each partition decodes only the terms it owns into its
    (Q, SB*128) slice, the slices gather, and the (Q, D*SB*128) rows sort
    through K4 and reduce by run length once. SB is a per-partition block
    budget (every partition's owned blocks of a query must fit). Exact at
    any posting length, so there is no truncation signal.
    call(qkeys (Q, K, W+1), k_valid (Q,)) -> (out, oc) on devices[0]."""
    return _concat_call(snap, SB, op, scatter=False)


def make_sharded_boolean_concat_scatter(snap: ShardedSnapshot, SB: int,
                                        op: str) -> Callable:
    """make_sharded_boolean_concat with the reduction query-sharded: the
    slices exchange with an all_to_all over the query axis, so partition d
    sorts and reduces only its Q/D tile. The same (out, oc); Q pads to a
    multiple of D."""
    return _concat_call(snap, SB, op, scatter=True)


def make_sharded_prefix_ranges(snap: ShardedSnapshot) -> Callable:
    """Fan-out prefix range search: every partition resolves each prefix to
    its local dictionary span [lo, hi) by two row searches. call(lo_keys,
    hi_keys) -> (lo (D, P), hi (D, P)) int64 on the host; pad rows sort
    after every real term and every hi key, so no span takes one."""
    devs = snap.devices

    def call(lo_keys, hi_keys):
        los = replicate(_as_tensor(lo_keys, np.uint32), devs)
        his = replicate(_as_tensor(hi_keys, np.uint32), devs)
        res = [prefix_range_step(snap.keys[d], los[d], his[d])
               for d in range(len(devs))]
        return (np.stack([r[0].cpu().numpy() for r in res]),
                np.stack([r[1].cpu().numpy() for r in res]))
    return call


def make_sharded_decode(snap: ShardedSnapshot, L: int) -> Callable:
    """Partition-local decode by dictionary index, no collective: call(idx
    (D, M)) -> (vals, raw), lists of D tensors: partition d's (M, L) rows
    through K1 (values past a row's count undefined) and true counts."""
    def call(idx):
        idx = np.asarray(idx, dtype=np.int32)
        vals, raw = [], []
        for d, dev in enumerate(snap.devices):
            v, r = decode_postings(snap.blocks[d], snap.term_block_start[d],
                                   snap.counts[d], to_device(idx[d], dev), L)
            vals.append(v)
            raw.append(r)
        return vals, raw
    return call


def _decode_spans(snap: ShardedSnapshot, spans, L: int = 1024):
    """The rows of each span decoded exactly; spans: [(device, lo, hi)].
    Returns, per span, its rows' value arrays in row order. Rows group by
    the smallest ladder level that holds their true count (host counts),
    so long lists are exact, and each group decodes through
    make_sharded_decode in batches of the re-serve budget."""
    D = snap.n_devices
    results = [[None] * max(0, hi - lo) for _, lo, hi in spans]
    levels = np.array([L] + _ladder(L, snap.max_count), dtype=np.int64)
    by_level = {}  # level -> device -> [(row, span, row-in-span, count)]
    for si, (d, lo, hi) in enumerate(spans):
        if hi <= lo:
            continue
        cnts = snap.host_counts[d, lo:hi].astype(np.int64)
        lvl = levels[np.searchsorted(levels, np.maximum(cnts, 1))]
        for r in range(hi - lo):
            by_level.setdefault(int(lvl[r]), {}).setdefault(d, []).append(
                (lo + r, si, r, int(cnts[r])))
    for lv, dev_items in sorted(by_level.items()):
        dec = make_sharded_decode(snap, lv)
        M = max(len(v) for v in dev_items.values())
        qb = max(8, _RESERVE_BUDGET // lv)
        for c0 in range(0, M, qb):
            B = min(qb, M - c0)
            batch = np.zeros((D, B), dtype=np.int32)
            meta = {}
            for d, items in dev_items.items():
                part = items[c0: c0 + B]
                batch[d, : len(part)] = [it[0] for it in part]
                meta[d] = part
            vals, _ = dec(batch)
            for d, part in meta.items():
                if not part:
                    continue
                w = max(1, min(max(it[3] for it in part), lv))
                v = to_numpy_u32(vals[d][: len(part), :w])
                for j, (_, si, r, c) in enumerate(part):
                    results[si][r] = v[j, : min(c, lv)].copy()
    return results


def sharded_prefix_search(snap: ShardedSnapshot, prefixes, L: int = 1024):
    """PrefixSearch over the partitions: every partition resolves each
    prefix's local span, the spans decode partition-locally (exact through
    the ladder), and the host unites them. Unmatched prefixes are absent;
    values sorted unique (InvertedIndex.prefix_search)."""
    if not prefixes:
        return {}
    lo_k, hi_k = keys_mod.prefix_bounds(list(prefixes), snap.width)
    lo, hi = make_sharded_prefix_ranges(snap)(lo_k, hi_k)
    spans, span_prefix = [], []
    for i in range(len(prefixes)):
        for d in range(snap.n_devices):
            if hi[d, i] > lo[d, i]:
                spans.append((d, int(lo[d, i]), int(hi[d, i])))
                span_prefix.append(i)
    decoded = _decode_spans(snap, spans, L)
    parts = {}
    for si, rows in enumerate(decoded):
        parts.setdefault(span_prefix[si], []).extend(rows)
    return {prefixes[i]: _dedup_adjacent(np.sort(np.concatenate(rows)))
            for i, rows in sorted(parts.items())}


def _read_range_keys(snap: ShardedSnapshot, min_term, max_term):
    """[min, max] inclusive -> one (lo_key, hi_key) search pair. hi_key
    sorts after max_term and before any longer term that extends it: the
    packed max_term with its length word plus one."""
    W = snap.width
    if min_term is None:
        lo_k = np.zeros((1, W + 1), dtype=np.uint32)
    else:
        lo_k = keys_mod.pack_terms([min_term], width=W)
    if max_term is None:
        hi_k = np.full((1, W + 1), _PAD_WORD, dtype=np.uint32)  # a pad row
    else:
        hi_k = keys_mod.pack_terms([max_term], width=W)
        hi_k[0, -1] += 1
    return lo_k, hi_k


def sharded_read_range(snap: ShardedSnapshot, min_term=None, max_term=None,
                       L: int = 1024):
    """Sorted (term, values) stream over the partitions, [min, max]
    inclusive. Partitions are contiguous key ranges, so device order is
    term order; each partition's span resolves and decodes locally. As in
    the reference's shard concatenation, terms shorter than two bytes
    (shard 0 whatever their bytes) can come out of byte order across
    partitions."""
    lo_k, hi_k = _read_range_keys(snap, min_term, max_term)
    lo, hi = make_sharded_prefix_ranges(snap)(lo_k, hi_k)
    for d in range(snap.n_devices):
        a, b = int(lo[d, 0]), int(hi[d, 0])
        if b <= a:
            continue
        blob, offs = keys_mod.unpack_keys(to_numpy_u32(snap.keys[d][a:b]))
        rows = _decode_spans(snap, [(d, a, b)], L)[0]
        for j in range(b - a):
            yield blob[offs[j]: offs[j + 1]].tobytes(), rows[j]


def partition_stats(snap: ShardedSnapshot) -> dict:
    """Skew report: each partition's real term and block-row counts against
    the padded (Nmax, Bmax). Partitions pad to the largest one's terms and
    blocks, so an uneven cut wastes device memory in proportion to max /
    mean; blocks are the larger table, which is why balanced_ranges cuts on
    block volume."""
    n_real = snap.n_real
    nmax = int(snap.host_counts.shape[1])
    b_real = np.array([int(snap.host_tbs[d, int(n_real[d])])
                       for d in range(snap.n_devices)], dtype=np.int64)
    bmax = int(snap.blocks[0].shape[0])
    return {
        "n_terms_per_device": n_real.tolist(),
        "padded_to": nmax,
        "padding_overhead": round(
            float(nmax * snap.n_devices / max(1, n_real.sum())), 3),
        "blocks_per_device": b_real.tolist(),
        "blocks_padded_to": bmax,
        "block_padding_overhead": round(
            float(bmax * snap.n_devices / max(1, b_real.sum())), 3),
    }
