"""Batched query serving over a frozen snapshot on a torch device
(counterpart of models/query_engine.py).

QueryEngine.from_index(index, L) freezes the index into compact host
tables, uploads them to the card (one gather expands the block arena), and
serves
    lookup(terms)                   resolve -> K1 decode -> ladder re-serve
    boolean(queries, "and")         resolve -> reorder -> K2 fused AND
    boolean(queries, "or")          the concat classes (below)
    boolean_staged(batches, op)     the same, depth-pipelined (staged.py)
    lookup_staged(batches)          single-term OR through the concat stream
Lists longer than the fast-path pad L are re-served exactly at the
smallest ladder level (4L, 16L, ...) that fits; a base list above the
largest level K2 takes (cuda_fused.MAX_LEVEL) goes to the concat AND. The
concat classes (ops/concat_bool.py) size each query by its total postings
and sort through K4; they serve OR, pagination (prefix_p) and staged
lookup. OR serves on the device: the JAX engine's host route is ROADMAP
queue 1 item 7.

refresh(index) keeps the engine current while the index takes writes: an
additive change becomes a small DELTA snapshot beside the untouched main
one, and while a delta is live every boolean and staged call serves the
padded dual step (steps.boolean_step_dual: K1 decode of both tiers, the
pair union, the AND through K3), and lookup unions both tiers. A delta
above DELTA_FRACTION of main folds into a new main; a compaction rebuilds.

What the JAX engine does beyond this slice raises NotImplementedError that
names its ROADMAP item: the host route (item 7), prefix and range reads,
checkpoints and warmup (item 8).
"""
from __future__ import annotations

import itertools as it
import os
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..codec import keys as keys_mod
from ..ops.cuda_decode import decode_postings
from ..ops.cuda_fused import MAX_LEVEL
from ..shard import merge_views
from ..utils.u32 import to_device, to_numpy_u32
from .snapshot import (
    HostTables,
    IndexSnapshot,
    _collect_removed,
    _index_fingerprint,
    _SnapshotTier,
    build_host_tables,
    snapshot_new_segments,
    snapshot_tables,
    upload_tables,
)
from .staged import StagedStreamsMixin
from .steps import (
    _RESERVE_BUDGET,
    _ladder,
    _narrow_keys,
    _not_ported,
    _round_up,
    boolean_fused_staged_step,
    boolean_fused_step,
    boolean_step_dual,
    lookup_step,
)


class ServingState:
    """One immutable bundle of everything a serve path reads: the main and
    delta snapshots, the tombstone array, the retained host tables and the
    freeze fingerprints. refresh() builds a whole new bundle and publishes
    it with one reference assignment, and every entry point captures one
    reference up front, so a reader sees the old state or the new one,
    never a new main beside a stale delta or stale tombstones."""

    __slots__ = ("snap", "delta", "removed", "tables", "delta_tables",
                 "fingerprint", "main_fp", "_removed_host")

    def __init__(self, snap: IndexSnapshot,
                 delta: Optional[IndexSnapshot] = None,
                 removed: Optional[torch.Tensor] = None,
                 tables: Optional[HostTables] = None,
                 delta_tables: Optional[HostTables] = None,
                 fingerprint=None, main_fp=None,
                 removed_host: Optional[np.ndarray] = None):
        self.snap = snap
        self.delta = delta
        self.removed = removed
        self.tables = tables
        self.delta_tables = delta_tables
        self.fingerprint = fingerprint
        self.main_fp = main_fp
        self._removed_host = removed_host

    def replace(self, **kw) -> "ServingState":
        """A copy with the given fields replaced (the rest shared)."""
        args = {"delta": self.delta, "removed": self.removed,
                "tables": self.tables, "delta_tables": self.delta_tables,
                "fingerprint": self.fingerprint, "main_fp": self.main_fp,
                "removed_host": self._removed_host}
        snap = kw.pop("snap", self.snap)
        args.update(kw)
        return ServingState(snap, **args)

    def removed_host(self) -> Optional[np.ndarray]:
        """Host copy of the tombstone array (lazy; racing calls compute the
        same value)."""
        rh = self._removed_host
        if rh is None and self.removed is not None:
            rh = to_numpy_u32(self.removed)
            self._removed_host = rh
        return rh

    def host_ready(self) -> bool:
        """Retained host tables cover both tiers."""
        return self.tables is not None and (
            self.delta is None or self.delta_tables is not None)

    def max_count(self) -> int:
        m = self.snap.max_count
        if self.delta is not None:
            m += self.delta.max_count  # a term's union can reach the sum
        return m

    def width(self) -> int:
        """Query key width across the live tiers."""
        w = self.snap.width
        if self.delta is not None:
            w = max(w, self.delta.width)
        return w


class QueryEngine(StagedStreamsMixin):
    """Batched lookup, AND and OR serving over a frozen IndexSnapshot on
    `device` (the card unless the caller asks for the CPU). L is the
    fast-path pad: longer lists re-serve exactly at a ladder level."""

    # a delta with more terms than this fraction of main folds into a new
    # main (the serving analogue of an LSM compaction)
    DELTA_FRACTION = 0.25

    # one-shot boolean() batches at least this large go through the staged
    # stream (same contract, pipelined)
    _STAGED_DELEGATE_MIN = 512

    # first results shipped with the counts by the one-shot fused pass; the
    # rare wider rows re-run through the sort path
    _FUSED_SMALL_P = 32

    # the stream's narrower result prefix (same overflow rule)
    _STAGED_SMALL_P = 8

    def __init__(self, snapshot: IndexSnapshot, L: int = 1024,
                 tables: Optional[HostTables] = None, *, device="cuda"):
        want = torch.device(device)
        have = snapshot.device
        if want.type not in ("cuda", "cpu"):
            raise ValueError(f"device {want}: the port serves on CUDA (kernels "
                             "K1/K2) or on the CPU (their plain versions)")
        if have.type != want.type or want.index not in (None, have.index):
            raise ValueError(f"snapshot lives on {have}, engine device is "
                             f"{want}")
        self.device = have
        self._state = ServingState(
            snapshot, removed=snapshot.removed, tables=tables,
            removed_host=tables.removed if tables is not None else None)
        # writers (refresh, promotion) serialize here; serve paths never
        # take it: they read self._state once and run on that bundle
        self._refresh_lock = threading.Lock()
        self.L = max(128, _round_up(L, 128))
        self._staged_levels_cache = None
        self.last_stream_stats = None  # set by boolean_staged

    @classmethod
    def from_index(cls, index, L: int = 1024, apply_removed: bool = False,
                   keep_tables: bool = True, *, device="cuda"):
        """Freeze `index` and serve it on `device`. keep_tables retains the
        compact host tables (the concat classes then resolve on the
        host). The freeze's fingerprint is recorded for refresh()."""
        fp = _index_fingerprint(index, apply_removed)
        t = snapshot_tables(index, apply_removed=apply_removed)
        eng = cls(upload_tables(t, device=device), L=L,
                  tables=t if keep_tables else None, device=device)
        eng._publish(eng._state.replace(fingerprint=fp, main_fp=fp))
        return eng

    # -- serving-state access (introspection and tests; serve paths read
    # self._state once and pass it down) -----------------------------------

    @property
    def snap(self) -> IndexSnapshot:
        return self._state.snap

    @property
    def delta(self) -> Optional[IndexSnapshot]:
        return self._state.delta

    @property
    def tables(self) -> Optional[HostTables]:
        return self._state.tables

    @property
    def delta_tables(self) -> Optional[HostTables]:
        return self._state.delta_tables

    def _publish(self, st: ServingState) -> None:
        """Swap the serving state: one reference assignment, atomic under
        the GIL, so a reader in flight keeps the whole old state."""
        self._state = st

    # -- refresh -----------------------------------------------------------

    def refresh(self, index, apply_removed: bool = False) -> bool:
        """Bring the engine up to date with the live index; False when it
        is unchanged since the last freeze. Queries keep serving the old
        state until the new one is published.

        An additive change (every segment of the main freeze still live,
        and, under apply_removed, the tombstones unchanged) freezes only
        the new segments into a DELTA snapshot; main is not touched. A
        delta above DELTA_FRACTION of main folds both tiers into a new
        main (_promote_delta); a compaction, or a tombstone change under
        apply_removed, rebuilds from the index. The key width is derived
        anew on every rebuild, so longer new terms cannot alias.

        Unlike the JAX engine, no checkpoint is saved on a rebuild:
        checkpoints are ROADMAP queue 1 item 8."""
        with self._refresh_lock:
            base = self._state
            fp = _index_fingerprint(index, apply_removed)
            if fp == base.fingerprint:
                return False
            if base.fingerprint is not None and self._try_delta_refresh(
                    index, fp, apply_removed):
                return True
            t = snapshot_tables(index, apply_removed=apply_removed)
            self._publish_main(base, t, fp)
            return True

    def _publish_main(self, base: ServingState, t: HostTables, fp) -> None:
        """Publish a new main tier built from tables `t`, with no delta."""
        snap = upload_tables(t, device=self.device)
        keep = base.tables is not None
        self._publish(ServingState(
            snap, removed=snap.removed, tables=t if keep else None,
            removed_host=t.removed if keep else None,
            fingerprint=fp, main_fp=fp))

    def _try_delta_refresh(self, index, fp, apply_removed: bool) -> bool:
        """The O(delta) refresh; publishes the new state and returns True
        when it applies. Runs under _refresh_lock."""
        base = self._state
        main_fp = base.main_fp
        if main_fp is None or main_fp[0] != apply_removed:
            return False
        main_shards = {k: (segs, rl) for k, segs, rl in main_fp[1]}
        for key, segs, rl in fp[1]:
            base_segs, base_rl = main_shards.get(key, ((), 0))
            if not set(base_segs).issubset(segs):
                return False  # a main segment was merged away
            if apply_removed and rl != base_rl:
                return False  # the purge baseline changed
        base_map = {k: frozenset(segs) for k, segs, _ in main_fp[1]}
        # under apply_removed main was purged at build: purge the delta
        # against the same (unchanged, checked above) tombstones
        rem = _collect_removed(index) if apply_removed else None
        keep = base.tables is not None
        built = snapshot_new_segments(index, base_map, removed=rem,
                                      with_tables=keep, device=self.device)
        if built is None:
            # nothing new survives (e.g. only tombstones): keep the tiers,
            # refresh the tombstone array below
            delta, dt = base.delta, base.delta_tables
        else:
            delta, dt = built if keep else (built, None)
            if delta.n_terms > self.DELTA_FRACTION * max(1, base.snap.n_terms):
                return self._promote_delta(index, fp, apply_removed, delta)
        removed, removed_host = base.removed, base._removed_host
        if not apply_removed:
            removed_host = _collect_removed(index)
            removed = to_device(removed_host, self.device)
        self._publish(base.replace(
            delta=delta, delta_tables=dt, removed=removed,
            removed_host=removed_host, fingerprint=fp))
        return True

    def _promote_delta(self, index, fp, apply_removed: bool, delta) -> bool:
        """Fold an oversized delta into main by merging the two snapshots'
        own arrays (decoded on the device through K1, one two-way key
        merge, re-encoded): equal to a rebuild from the index under this
        path's preconditions (every main segment live; tombstones unchanged
        under apply_removed), without re-reading a segment."""
        base = self._state
        merged = merge_views([_SnapshotTier(base.snap, self),
                              _SnapshotTier(delta, self)], None)
        if merged is None:  # both tiers empty
            return False
        blob, offsets, values, voffs = merged
        rem = None if apply_removed else _collect_removed(index)
        self._publish_main(
            base, build_host_tables(blob, offsets, values, voffs, rem), fp)
        return True

    def _decode_indices(self, idx: np.ndarray, s: IndexSnapshot):
        """Exact postings of dictionary indexes `idx` in snapshot `s`:
        (values, voffs[n+1]). Rows decode through K1 in batches grouped by
        the smallest ladder level that holds each row's count."""
        counts = s.host_counts[idx].astype(np.int64)
        voffs = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(counts, out=voffs[1:])
        flat = np.empty(int(voffs[-1]), dtype=np.uint32)
        if len(idx) == 0:
            return flat, voffs
        levels = np.array([self.L] + _ladder(self.L, s.max_count),
                          dtype=np.int64)
        lvl_idx = np.searchsorted(levels, counts, side="left")
        for li in np.unique(lvl_idx):
            lv = int(levels[li])
            sel = np.nonzero(lvl_idx == li)[0]
            qb = max(1, _RESERVE_BUDGET // lv)
            for c0 in range(0, len(sel), qb):
                ss = sel[c0: c0 + qb]
                v, _ = decode_postings(s.blocks, s.term_block_start, s.counts,
                                       self._dev(idx[ss].astype(np.int32)),
                                       lv)
                w = min(max(1, int(counts[ss].max())), lv)
                v = to_numpy_u32(v[:, :w])
                m = np.arange(w)[None, :] < counts[ss][:, None]
                dst = (voffs[ss][:, None] + np.arange(w)[None, :])[m]
                flat[dst] = v[m]
        return flat, voffs

    def _levels(self, st: Optional[ServingState] = None) -> List[int]:
        st = st if st is not None else self._state
        return _ladder(self.L, st.max_count())

    def _level_for(self, need: int, st: Optional[ServingState] = None) -> int:
        for lv in self._levels(st):
            if lv >= need:
                return lv
        return _round_up(need, 128)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return to_device(a, self.device)

    # -- not in this slice -------------------------------------------------

    @classmethod
    def from_checkpoint(cls, *a, **kw):
        _not_ported("QueryEngine.from_checkpoint", 8)

    def warmup(self, *a, **kw):
        _not_ported("QueryEngine.warmup", 8)

    def read_range(self, *a, **kw):
        _not_ported("QueryEngine.read_range", 8)

    def prefix_search(self, *a, **kw):
        _not_ported("QueryEngine.prefix_search", 8)

    def lookup_host(self, *a, **kw):
        _not_ported("QueryEngine.lookup_host (host route)", 7)

    def boolean_host(self, *a, **kw):
        _not_ported("QueryEngine.boolean_host (host route)", 7)

    # -- exact lookup ------------------------------------------------------

    def _lookup_on(self, s: IndexSnapshot, qkeys: torch.Tensor, removed,
                   L: Optional[int] = None):
        return lookup_step(
            s.keys, s.blocks, s.term_block_start, s.counts, qkeys,
            L or self.L, s.hash_slots, s.max_probes, removed)

    def lookup(self, terms: Sequence[bytes],
               filter_removed: bool = False) -> List[Optional[np.ndarray]]:
        """Exact postings per term (None for misses). filter_removed drops
        tombstoned values. Lists longer than L are re-served at a ladder
        level, so results are always exact. With a delta live, a term's
        result is the union of its rows in both tiers."""
        if not terms:
            return []
        st = self._state
        main = self._exact_rows(st, st.snap, terms, filter_removed)
        if st.delta is None:
            return main
        dl = self._exact_rows(st, st.delta, terms, filter_removed)
        return [b if a is None else a if b is None else np.union1d(a, b)
                for a, b in zip(main, dl)]

    def _exact_rows(self, st: ServingState, s: IndexSnapshot,
                    terms: Sequence[bytes],
                    filter_removed: bool) -> List[Optional[np.ndarray]]:
        if s.n_terms == 0:
            return [None] * len(terms)
        removed = st.removed if filter_removed else None
        qk = keys_mod.pack_terms(list(terms), width=s.width)
        found, vals, n, raw = self._lookup_on(s, self._dev(qk), removed)
        found = found.cpu().numpy()
        n = n.cpu().numpy()
        raw = raw.cpu().numpy()
        vals = to_numpy_u32(vals)
        out: List[Optional[np.ndarray]] = [None] * len(terms)
        long_idx = []
        for i in range(len(terms)):
            if not found[i]:
                continue
            if raw[i] > self.L:
                long_idx.append(i)
            else:
                out[i] = vals[i, : n[i]].copy()
        # largest need first: each batch re-serves at ITS level
        long_idx.sort(key=lambda i: -raw[i])
        while long_idx:
            lv = self._level_for(int(max(raw[i] for i in long_idx)), st)
            qb = max(1, _RESERVE_BUDGET // lv)
            batch, long_idx = long_idx[:qb], long_idx[qb:]
            _, v2, n2, _ = self._lookup_on(s, self._dev(qk[batch]), removed,
                                           L=lv)
            n2 = n2.cpu().numpy()
            v2 = to_numpy_u32(v2[:, : max(1, int(n2.max(initial=0)))])
            for j, i in enumerate(batch):
                out[i] = v2[j, : n2[j]].copy()
        return out

    # -- boolean AND -------------------------------------------------------

    def _pack_boolean(self, st: ServingState, queries):
        """Query batch -> (qk (Q, K, W+1) uint32, kv (Q,) int32); one pack
        over the flattened terms."""
        nq = len(queries)
        kv = np.fromiter(map(len, queries), np.int32, count=nq)
        K = max(1, int(kv.max(initial=0)))
        W = st.width()
        qk = np.zeros((nq, K, W + 1), dtype=np.uint32)
        packed = keys_mod.pack_terms(list(it.chain.from_iterable(queries)),
                                     width=W)
        kvq = kv.astype(np.int64)
        rows = np.repeat(np.arange(nq), kvq)
        qoffs = np.zeros(nq + 1, dtype=np.int64)
        np.cumsum(kvq, out=qoffs[1:])
        cols = np.arange(qoffs[-1], dtype=np.int64) - np.repeat(qoffs[:-1], kvq)
        qk[rows, cols] = packed
        return qk, kv

    def _pack_boolean_cols(self, st: ServingState, blob, offsets, qoffs):
        """Columnar batch (blob, offsets[T+1], qoffs[Q+1]) -> (qk, kv)."""
        W = st.width()
        offsets = np.asarray(offsets, dtype=np.int64)
        qoffs = np.asarray(qoffs, dtype=np.int64)
        nq = len(qoffs) - 1
        kvq = np.diff(qoffs)
        K = max(1, int(kvq.max(initial=1)))
        qk = np.zeros((nq, K, W + 1), dtype=np.uint32)
        kv = kvq.astype(np.int32)
        blob8 = (np.frombuffer(blob, dtype=np.uint8)
                 if isinstance(blob, (bytes, bytearray))
                 else np.asarray(blob, dtype=np.uint8))
        packed = keys_mod.pack_blob(blob8, offsets, W)
        rows = np.repeat(np.arange(nq), kvq)
        cols = np.arange(qoffs[-1], dtype=np.int64) - np.repeat(qoffs[:-1], kvq)
        qk[rows, cols] = packed
        return qk, kv

    def _batch_pack(self, st: ServingState, queries):
        """One stream batch (term lists or a columnar triple) -> (nq, qk,
        kv)."""
        if isinstance(queries, tuple) and len(queries) == 3:
            nq = len(queries[2]) - 1
            if nq <= 0:
                return 0, None, None
            qk, kv = self._pack_boolean_cols(st, *queries)
            return nq, qk, kv
        if not queries:
            return 0, None, None
        qk, kv = self._pack_boolean(st, queries)
        return len(queries), qk, kv

    def boolean(self, queries: Sequence[Sequence[bytes]], op: str,
                filter_removed: bool = False):
        """Batch of AND/OR queries of 1..K terms -> sorted unique arrays. A
        missing term empties an AND query and adds nothing to an OR query.
        Exact at any list length."""
        if op not in ("and", "or"):
            raise ValueError(f"op {op!r}: want 'and' or 'or'")
        if not queries:
            return []
        st = self._state
        if len(queries) >= self._STAGED_DELEGATE_MIN and st.snap.n_terms > 0:
            return self.boolean_staged(
                [queries], op, filter_removed, _st=st)[0]
        if st.snap.n_terms == 0 and st.delta is None:
            return [np.zeros(0, np.uint32) for _ in queries]
        qk, kv = self._pack_boolean(st, queries)
        removed = st.removed if filter_removed else None
        if st.delta is None:
            if op == "and":
                return self._boolean_fused(st, queries, qk, kv, removed)
            return self._boolean_concat(st, queries, qk, kv, op, removed)
        # delta window: the padded dual step at L, then ladder re-serves of
        # the rows whose tiers' summed count exceeds L (the JAX engine's
        # _reserve_ladder: the same batching rule as _drain_levels)
        run = self._dual_run(st, op, removed)
        out, oc, need = run(self.L, qk, kv)
        oc = oc.cpu().numpy()
        need = need.cpu().numpy()
        out = to_numpy_u32(out[:, : max(1, int(oc.max(initial=0)))])
        results: List[Optional[np.ndarray]] = [None] * len(queries)
        longs = []
        for i in range(len(queries)):
            if need[i] <= self.L:
                results[i] = out[i, : oc[i]].copy()
            else:
                longs.append((i, qk[i], int(kv[i]),
                              self._level_for(int(need[i]), st)))
        self._drain_levels(longs, run, results.__setitem__)
        return results

    def _dual_run(self, st: ServingState, op: str, removed):
        """run(lv, qk, kv) -> (out, oc, need): one pass of the padded dual
        step at pad lv over the state's main and delta tiers. Queries are
        packed at st.width() and narrowed to each tier's width."""
        s, d = st.snap, st.delta

        def run(lv, qk_sub, kv_sub):
            return boolean_step_dual(
                s.keys, s.blocks, s.term_block_start, s.counts, s.hash_slots,
                d.keys, d.blocks, d.term_block_start, d.counts, d.hash_slots,
                self._dev(_narrow_keys(qk_sub, s.width)),
                self._dev(_narrow_keys(qk_sub, d.width)),
                self._dev(kv_sub), lv, op, removed, s.max_probes,
                d.max_probes)
        return run

    def _fused_run(self, st, lv, qk_sub, kv_sub, removed, small_p: int = 0):
        s = st.snap
        return boolean_fused_step(
            s.keys, s.blocks, s.term_block_start, s.counts,
            self._dev(_narrow_keys(qk_sub, s.width)), self._dev(kv_sub), lv,
            removed, s.hash_slots, s.max_probes, small_p)

    def _staged_levels(self, st: ServingState) -> torch.Tensor:
        """Ascending ladder levels K2 serves (<= MAX_LEVEL), on the device;
        cached per ladder."""
        lvls = tuple(lv for lv in self._levels(st) if lv <= MAX_LEVEL)
        cached = self._staged_levels_cache
        if cached is None or cached[0] != lvls:
            arr = torch.tensor(lvls or (self.L,), dtype=torch.int64,
                               device=self.device)
            cached = (lvls, arr)
            self._staged_levels_cache = cached
        return cached[1]

    def _fused_run_staged(self, st, qk_sub, kv_sub, removed):
        s = st.snap
        return boolean_fused_staged_step(
            s.keys, s.blocks, s.term_block_start, s.counts,
            self._dev(_narrow_keys(qk_sub, s.width)), self._dev(kv_sub),
            self.L, self._staged_levels(st), removed, s.hash_slots,
            s.max_probes, self._STAGED_SMALL_P)

    def _dedup_batch(self, nq: int, qk, kv, row_cost_us: float = None):
        """Cross-query dedup for a staged batch: group identical packed
        rows on the host, serve each distinct query once, and fan results
        out through `inv` at assembly. Returns (nu, qk_u, kv_u, inv), inv
        None when dedup does not pay (fewer than 64 queries,
        TPI_STAGED_DEDUP=0, or too few duplicates to shrink the batch by a
        grid step of batch/16 rows; TPI_STAGED_DEDUP=force skips the cost
        gate, never the shrink check). row_cost_us replaces the fused AND's
        per-row cost (L x 0.003 us) for the concat stream's rows."""
        mode = os.environ.get("TPI_STAGED_DEDUP", "1")
        if nq < 64 or mode == "0":
            return nq, qk, kv, None
        comb = np.concatenate(
            [qk.reshape(nq, -1).astype(np.int64),
             kv.astype(np.int64).reshape(nq, 1)], axis=1)
        # 64-bit row hash: collisions only merge candidate groups, which
        # the full-row verify below splits again exactly
        h = comb @ self._dedup_mults(comb.shape[1])
        grid = max(8, _round_up(nq, 8) // 16)
        target = _round_up(len(np.unique(h)), grid)
        if target >= _round_up(nq, grid):
            return nq, qk, kv, None
        saved_rows = _round_up(nq, grid) - target
        # cost gate: the JAX engine's constants (saved rows x L x 0.003,
        # or row_cost_us, against 4000), carried over unmeasured on the
        # card (PERF.md)
        rc = row_cost_us if row_cost_us is not None else self.L * 0.003
        if mode != "force" and saved_rows * rc < 2 * 2000.0:
            return nq, qk, kv, None
        order = np.argsort(h, kind="stable")
        sc = comb[order]
        neq = np.empty(nq, dtype=bool)
        neq[0] = True
        np.any(sc[1:] != sc[:-1], axis=1, out=neq[1:])
        first = order[neq]
        inv = np.empty(nq, dtype=np.int32)
        inv[order] = (np.cumsum(neq) - 1).astype(np.int32)
        nu = len(first)
        target = _round_up(nu, grid)
        qk_u = np.zeros((target,) + qk.shape[1:], dtype=qk.dtype)
        kv_u = np.zeros(target, dtype=kv.dtype)
        qk_u[:nu] = qk[first]
        kv_u[:nu] = kv[first]
        return nu, qk_u, kv_u, inv

    @staticmethod
    def _dedup_mults(n: int) -> np.ndarray:
        """Fixed odd multipliers for the dedup row hash."""
        return np.array(
            [(0x9E3779B97F4A7C15 - (i * 2 + 1) * 0x61C8864680B583EB)
             & 0xFFFFFFFFFFFFFFFF for i in range(max(n, 64))],
            dtype=np.uint64,
        ).astype(np.int64)[:n]

    def _classify_fused(self, st, fetched, positions, qk, kv, setter,
                        wide, longs, overs):
        """Assign direct results from a small-P fetch; defer the rare
        classes: small-P overflow (sort path), base count over L (ladder
        re-serve), ladder level over MAX_LEVEL (concat AND)."""
        small, oc, need, oc_pre = fetched
        P = self._FUSED_SMALL_P
        for j, pos in enumerate(positions):
            if need[j] <= self.L and oc_pre[j] <= P:
                setter(pos, small[j, : oc[j]].copy())
            elif need[j] <= self.L:
                wide.append((pos, qk[j], int(kv[j])))
            elif self._level_for(int(need[j]), st) <= MAX_LEVEL:
                longs.append((pos, qk[j], int(kv[j]), int(need[j])))
            else:
                overs.append((pos, qk[j], int(kv[j])))

    def _drain_levels(self, items, run, setter):
        """Exact re-serve drain. items: (pos, qk_row (K_i, W+1), kv, lv),
        served in batches at the level of their largest member (exact for
        every smaller one). All dispatches are issued before any fetch;
        in-flight results are capped at 4x the reserve budget."""
        dispatches = []  # (members, out, cnt)
        pend = 0

        def drain():
            nonlocal pend
            counts = [d[2].cpu().numpy() for d in dispatches]
            for (members, o, _), c in zip(dispatches, counts):
                o = to_numpy_u32(o[:, : max(1, int(c.max(initial=0)))])
                for j, t in enumerate(members):
                    setter(t[0], o[j, : c[j]].copy())
            dispatches.clear()
            pend = 0

        items.sort(key=lambda t: -t[3])
        i = 0
        while i < len(items):
            lv = int(items[i][3])
            K = max(t[1].shape[0] for t in items)
            qb = max(1, _RESERVE_BUDGET // (K * lv))
            batch = items[i: i + qb]
            i += len(batch)
            bq = self._stack_rows([t[1] for t in batch])
            bkv = np.array([t[2] for t in batch], dtype=np.int32)
            o2, c2, _ = run(lv, bq, bkv)
            dispatches.append((batch, o2, c2))
            pend += len(batch) * lv * 4
            if pend > 4 * _RESERVE_BUDGET:
                drain()
        if dispatches:
            drain()

    @staticmethod
    def _stack_rows(rows):
        """Stack per-query (K_b, W+1) key rows into (B, Kmax, W+1)."""
        Kmax = max(r.shape[0] for r in rows)
        bq = np.zeros((len(rows), Kmax, rows[0].shape[1]), dtype=np.uint32)
        for j, r in enumerate(rows):
            bq[j, : r.shape[0]] = r
        return bq

    def _fused_followups(self, st, setter, wide, longs, overs, removed):
        """Serve the deferred classes once per call (shared by boolean()
        and the staged stream)."""
        items = [(t[0], t[1], t[2], self.L) for t in wide]
        items += [(t[0], t[1], t[2], self._level_for(int(t[3]), st))
                  for t in longs]
        self._drain_levels(
            items, lambda lv, q, k2: self._fused_run(st, lv, q, k2, removed),
            setter)
        if overs:
            bq = self._stack_rows([t[1] for t in overs])
            bkv = np.array([t[2] for t in overs], dtype=np.int32)
            res = self._boolean_concat(st, [None] * len(overs), bq, bkv,
                                       "and", removed)
            for t, v in zip(overs, res):
                setter(t[0], v)

    def _boolean_fused(self, st, queries, qk, kv, removed):
        """AND through K2: one pass + one fetch for the common case;
        ladder re-serves keyed on the base (smallest-list) count."""
        small, oc, need, oc_pre = self._fused_run(
            st, self.L, qk, kv, removed, small_p=self._FUSED_SMALL_P)
        fetched = (to_numpy_u32(small), oc.cpu().numpy(),
                   need.cpu().numpy(), oc_pre.cpu().numpy())
        results: List[Optional[np.ndarray]] = [None] * len(queries)
        wide, longs, overs = [], [], []

        def setter(i, v):
            results[i] = v

        self._classify_fused(st, fetched, range(len(queries)), qk, kv,
                             setter, wide, longs, overs)
        self._fused_followups(st, setter, wide, longs, overs, removed)
        return results
