"""MeshQueryEngine: QueryEngine's serving over partitions (counterpart of
parallel/mesh_engine.py).

Wraps the factories of parallel/mesh.py in the lifecycle the single-device
engine has (models/query_engine.py):

 * the tombstone filter per query batch (setops.filter_removed on the
   joined results), so answers equal the single-device engine's;
 * incremental refresh: a fingerprint no-op check, a delta tier for a
   purely additive change (new segments visible to the next query), and a
   full rebuild past DELTA_FRACTION or after a compaction;
 * exact ladder re-serves of queries whose lists exceed the fast-path L;
 * warmup() running each serving path once before traffic.

The delta tier is stacked onto partition 0, with empty partitions
elsewhere: a delta stays under DELTA_FRACTION of main, so the imbalance is
short-lived and goes at the next rebuild. Partitions may share a card; the
default mesh is one partition a CUDA card, and without CUDA it raises.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..codec import keys as keys_mod
from ..models.snapshot import (
    _collect_removed,
    _empty_snapshot,
    _index_fingerprint,
    snapshot_new_segments,
)
from ..models.staged import _finish_host_copy, _start_host_copy, _wire_fetch
from ..models.steps import (
    _RESERVE_BUDGET,
    _ladder,
    _narrow_keys,
    _pack_queries,
    _round_up,
    _rows_to_columnar,
    _wire_meta_step,
)
from ..ops import _build, setops
from ..utils.u32 import to_device
from . import mesh as pm


class MeshServingState:
    """One immutable bundle of everything a mesh serve path reads (the
    counterpart of ServingState). refresh() publishes a whole new bundle
    with one reference assignment, so a reader never pairs a new main with
    a stale delta or stale tombstones."""

    __slots__ = ("snap", "delta", "removed", "fingerprint", "main_fp",
                 "base_map", "main_n_terms")

    def __init__(self, snap, delta=None, removed=None, fingerprint=None,
                 main_fp=None, base_map=None, main_n_terms=0):
        self.snap: pm.ShardedSnapshot = snap
        self.delta: Optional[pm.ShardedSnapshot] = delta
        self.removed: torch.Tensor = removed  # (R,) u32 bits, devices[0]
        self.fingerprint = fingerprint
        self.main_fp = main_fp
        self.base_map = base_map if base_map is not None else {}
        self.main_n_terms = main_n_terms

    def replace(self, **kw) -> "MeshServingState":
        args = {"delta": self.delta, "removed": self.removed,
                "fingerprint": self.fingerprint, "main_fp": self.main_fp,
                "base_map": self.base_map, "main_n_terms": self.main_n_terms}
        snap = kw.pop("snap", self.snap)
        args.update(kw)
        return MeshServingState(snap, **args)

    def max_count(self) -> int:
        m = self.snap.max_count
        if self.delta is not None:
            m += self.delta.max_count  # a term's tier union can reach the sum
        return m

    def width(self) -> int:
        w = self.snap.width
        if self.delta is not None:
            w = max(w, self.delta.width)
        return w


def _base_map(fp):
    return {} if fp is None else {k: frozenset(segs) for k, segs, _ in fp[1]}


class MeshQueryEngine:
    """Batched serving over a pair of sharded snapshots (main + delta).
    mesh: the partitions' devices (parallel/mesh.default_mesh; a device may
    repeat). L is the fast-path pad: longer lists re-serve exactly at a
    ladder level."""

    DELTA_FRACTION = 0.25

    def __init__(self, index, mesh=None, L: int = 1024):
        if L % 128 != 0 or L <= 0:
            raise ValueError(f"L must be a positive multiple of 128, got {L}")
        self.mesh = pm._devices(mesh if mesh is not None
                                else pm.default_mesh())
        self.L = L
        self._full_build(index)

    # -- serving-state access (introspection and tests; serve paths read
    # self._state once and pass it down) -----------------------------------

    @property
    def snap(self) -> pm.ShardedSnapshot:
        return self._state.snap

    @property
    def delta(self) -> Optional[pm.ShardedSnapshot]:
        return self._state.delta

    @property
    def _removed(self) -> torch.Tensor:
        return self._state.removed

    @property
    def _fingerprint(self):
        return self._state.fingerprint

    @property
    def _main_fp(self):
        return self._state.main_fp

    @property
    def _main_n_terms(self) -> int:
        return self._state.main_n_terms

    # -- build / refresh ---------------------------------------------------

    def _removed_dev(self, removed: np.ndarray) -> torch.Tensor:
        return to_device(np.asarray(removed, dtype=np.uint32), self.mesh[0])

    def _full_build(self, index) -> None:
        snap = pm.build_sharded_snapshot(index, self.mesh)
        fp = _index_fingerprint(index, False)
        self._state = MeshServingState(
            snap, removed=self._removed_dev(_collect_removed(index)),
            fingerprint=fp, main_fp=fp, base_map=_base_map(fp),
            main_n_terms=int(snap.n_real.sum()))

    @classmethod
    def from_checkpoint(cls, path: str, index=None, mesh=None,
                        L: int = 1024) -> "MeshQueryEngine":
        """Start from a checkpoint written by models/checkpoint.py (by either
        package): the global host tables are cut into term ranges balanced
        by block volume (partition_tables) and stacked, with no segment
        scan, merge or re-encode. With `index`, drift since the save
        reconciles through refresh(). Only apply_removed=False checkpoints
        serve here: the mesh engine filters tombstones per query."""
        from ..models.checkpoint import load_checkpoint, load_fingerprint

        t, meta = load_checkpoint(path)
        if meta["apply_removed"]:
            raise ValueError("mesh serving needs an apply_removed=False "
                             "checkpoint (tombstones filter per query)")
        if L % 128 != 0 or L <= 0:
            raise ValueError(f"L must be a positive multiple of 128, got {L}")
        eng = cls.__new__(cls)
        eng.mesh = pm._devices(mesh if mesh is not None
                               else pm.default_mesh())
        eng.L = L
        fp = load_fingerprint(meta)
        eng._state = MeshServingState(
            pm.stack_tables(pm.partition_tables(t, len(eng.mesh)), eng.mesh),
            removed=eng._removed_dev(t.removed), fingerprint=fp, main_fp=fp,
            base_map=_base_map(fp), main_n_terms=t.n_terms)
        if index is not None:
            if fp is None:
                eng._full_build(index)
            else:
                eng.refresh(index)
        return eng

    def refresh(self, index) -> bool:
        """Re-freeze from the live index; False when it is unchanged. A
        purely additive change uploads only the new segments as a delta
        tier; a compaction or an oversized delta rebuilds (the policy of
        QueryEngine.refresh)."""
        fp = _index_fingerprint(index, False)
        if fp == self._state.fingerprint:
            return False
        if self._try_delta_refresh(index, fp):
            return True
        self._full_build(index)
        return True

    def _try_delta_refresh(self, index, fp) -> bool:
        """The O(delta) tier; publishes the new state (fingerprint too, one
        assignment) and returns True when it applies."""
        base = self._state
        if base.main_fp is None:  # a checkpoint without a fingerprint
            return False
        main_shards = {k: segs for k, segs, _ in base.main_fp[1]}
        for key, segs, _ in fp[1]:
            if not set(main_shards.get(key, ())).issubset(segs):
                return False  # a main segment was merged away: rebuild
        delta1 = snapshot_new_segments(index, base.base_map, device="cpu")
        if delta1 is None:
            delta = base.delta  # tombstones only: refresh `removed` below
        else:
            if delta1.n_terms > self.DELTA_FRACTION * max(1,
                                                          base.main_n_terms):
                return False  # promote: the rebuild folds the delta in
            empty = _empty_snapshot(delta1.width, "cpu")
            delta = pm.stack_partitions(
                [delta1] + [empty] * (len(self.mesh) - 1), self.mesh)
        self._state = base.replace(
            delta=delta, removed=self._removed_dev(_collect_removed(index)),
            fingerprint=fp)
        return True

    # -- helpers -----------------------------------------------------------

    def _levels(self, st: Optional[MeshServingState] = None) -> List[int]:
        st = st if st is not None else self._state
        return _ladder(self.L, st.max_count())

    def _level_for(self, need: int, st: MeshServingState) -> int:
        for lv in self._levels(st):
            if lv >= need:
                return lv
        return _round_up(need, 128)

    @staticmethod
    def _filter(out, oc, removed):
        if removed.shape[0] == 0:
            return out, oc
        return setops.filter_removed(out, oc, removed)

    def warmup(self, k_max: int = 8, ops: Sequence[str] = ("and", "or")
               ) -> int:
        """Run each serving path once on 8 empty queries before traffic
        (on the card, the kernel library is built or loaded first): the
        lookup, the boolean per op (the dual form with a delta live, the
        tombstone filter when tombstones exist) and the prefix ranges.
        Returns the number of paths run."""
        st = self._state
        s = st.snap
        if self.mesh[0].type == "cuda":
            _build.library()
        Q = 8
        pm.make_sharded_lookup_scatter(s, self.L)(
            np.zeros((Q, s.width + 1), dtype=np.uint32))
        n = 1
        bqk = np.zeros((Q, k_max, st.width() + 1), dtype=np.uint32)
        kv = np.zeros(Q, dtype=np.int32)
        for op in ops:
            o, oc, _ = self._boolean_dispatch(st, self.L, bqk, kv, op)
            self._filter(o, oc, st.removed)
            n += 1
        pm.make_sharded_prefix_ranges(s)(
            np.zeros((1, s.width + 1), dtype=np.uint32),
            np.full((1, s.width + 1), pm._PAD_WORD, dtype=np.uint32))
        n += 1
        if self.mesh[0].type == "cuda":
            for dev in set(self.mesh):
                torch.cuda.synchronize(dev)
        return n

    def stats(self) -> Dict:
        st = self._state
        d = st.delta
        return {
            "devices": st.snap.n_devices,
            "n_terms": st.main_n_terms,
            "delta_terms": 0 if d is None else int(d.n_real.sum()),
            "removed": int(st.removed.shape[0]),
            "ladder": self._levels(st),
            "partition": pm.partition_stats(st.snap),
        }

    # -- exact lookup ------------------------------------------------------

    def lookup(self, terms: Sequence[bytes], filter_removed: bool = False
               ) -> List[Optional[np.ndarray]]:
        """Exact postings per term (None for misses), united across the
        main and delta tiers, re-served at a ladder level past L."""
        if not terms:
            return []
        st = self._state
        main = self._exact_rows(st, st.snap, terms, filter_removed)
        if st.delta is None:
            return main
        dl = self._exact_rows(st, st.delta, terms, filter_removed)
        return [b if a is None else a if b is None else np.union1d(a, b)
                for a, b in zip(main, dl)]

    def _lookup_pass(self, st, s, qk: np.ndarray, lv: int,
                     filter_removed: bool):
        """One lookup pass at pad lv, fetched: (found, n, raw, vals)."""
        found, vals, n, raw = pm.make_sharded_lookup_scatter(s, lv)(qk)
        if filter_removed:
            vals, n = self._filter(vals, n, st.removed)
        md = _wire_meta_step(vals, n)
        found, n, raw, md = _finish_host_copy(
            _start_host_copy([found, n, raw, md]))
        return found, n, raw, self._fetch_trimmed(vals, n, md)

    def _exact_rows(self, st: MeshServingState, s: pm.ShardedSnapshot,
                    terms, filter_removed: bool):
        qk = keys_mod.pack_terms(list(terms), width=s.width)
        found, n, raw, vals = self._lookup_pass(st, s, qk, self.L,
                                                filter_removed)
        out: List[Optional[np.ndarray]] = [None] * len(terms)
        long_idx = []
        for i in range(len(terms)):
            if not found[i]:
                continue
            if raw[i] > self.L:
                long_idx.append(i)
            else:
                out[i] = vals[i, : n[i]].copy()
        long_idx.sort(key=lambda i: -raw[i])
        while long_idx:
            lv = self._level_for(int(max(raw[i] for i in long_idx)), st)
            qb = max(1, _RESERVE_BUDGET // lv)
            batch, long_idx = long_idx[:qb], long_idx[qb:]
            _, n2, _, v2 = self._lookup_pass(st, s, qk[batch], lv,
                                             filter_removed)
            for j, i in enumerate(batch):
                out[i] = v2[j, : n2[j]].copy()
        return out

    # -- boolean -----------------------------------------------------------

    @staticmethod
    def _fetch_trimmed(out: torch.Tensor, oc_h: np.ndarray,
                       md_h) -> np.ndarray:
        """Result matrix to the host through the wire codec (models/steps.py;
        staged._wire_fetch)."""
        return _wire_fetch([out], [oc_h], [md_h])[0]

    def _boolean_dispatch(self, st: MeshServingState, lv: int,
                          qk: np.ndarray, kv: np.ndarray, op: str):
        """One pass at pad lv over main (and the delta when live): the
        decode reduce-scatters, so each partition runs the set op on its
        query tile."""
        s = st.snap
        if st.delta is None:
            call = pm.make_sharded_boolean_scatter(s, lv, op)
            return call(_narrow_keys(qk, s.width), kv)
        d = st.delta
        call = pm.make_sharded_boolean_dual_scatter(s, d, lv, op)
        return call(_narrow_keys(qk, s.width), _narrow_keys(qk, d.width), kv)

    def _reserve(self, st, longs, op: str, filter_removed: bool, setter):
        """Exact re-serves: longs (key, qk_row (K_i, W+1), kv, need), served
        largest need first, each batch at the level of its first (largest)
        member."""
        longs = sorted(longs, key=lambda t: -t[3])
        W = st.width()
        while longs:
            lv = self._level_for(longs[0][3], st)
            K = max(t[1].shape[0] for t in longs)
            qb = max(1, _RESERVE_BUDGET // (K * lv))
            batch, longs = longs[:qb], longs[qb:]
            bq = np.zeros((len(batch), K, W + 1), dtype=np.uint32)
            bkv = np.zeros(len(batch), dtype=np.int32)
            for j, t in enumerate(batch):
                bq[j, : t[1].shape[0]] = t[1]
                bkv[j] = t[2]
            o2, c2, _ = self._boolean_dispatch(st, lv, bq, bkv, op)
            if filter_removed:
                o2, c2 = self._filter(o2, c2, st.removed)
            md2 = _wire_meta_step(o2, c2)
            c2, md2 = _finish_host_copy(_start_host_copy([c2, md2]))
            o2 = self._fetch_trimmed(o2, c2, md2)
            for j, t in enumerate(batch):
                setter(t[0], o2[j, : c2[j]].copy())

    def boolean(self, queries: Sequence[Sequence[bytes]], op: str,
                filter_removed: bool = False) -> List[Optional[np.ndarray]]:
        """Batch of AND/OR queries over the partitions; the single-device
        engine's results, tombstones included."""
        if not queries:
            return []
        st = self._state
        qk, kv = _pack_queries(queries, st.width())
        out, oc, need = self._boolean_dispatch(st, self.L, qk, kv, op)
        if filter_removed:
            out, oc = self._filter(out, oc, st.removed)
        md = _wire_meta_step(out, oc)
        oc, need, md = _finish_host_copy(_start_host_copy([oc, need, md]))
        out = self._fetch_trimmed(out, oc, md)
        results: List[Optional[np.ndarray]] = [None] * len(queries)
        longs = []
        for i in range(len(queries)):
            if need[i] <= self.L:
                results[i] = out[i, : oc[i]].copy()
            else:
                longs.append((i, qk[i], int(kv[i]), int(need[i])))
        self._reserve(st, longs, op, filter_removed, results.__setitem__)
        return results

    def lookup_staged(self, batches, filter_removed: bool = False,
                      depth: int = 3, columnar: bool = False,
                      prefix_p: int = 0):
        """Pipelined stream lookup: each term serves as a single-term OR
        query through the staged stream, so a miss is a count-0 row, not
        lookup()'s None (without filter_removed a present term has at least
        one posting). Returns per batch what boolean_staged returns."""
        return self.boolean_staged(
            [[[t] for t in b] for b in batches], "or",
            filter_removed, depth, columnar, prefix_p)

    def boolean_staged(self, batches, op: str, filter_removed: bool = False,
                       depth: int = 3, columnar: bool = False,
                       prefix_p: int = 0):
        """Depth-pipelined stream serving: batch i+depth is dispatched, and
        its result copies started, before batch i is fetched, so the host's
        fetches overlap the partitions' work. Ladder re-serves (need > L)
        are deferred and served once for the whole stream, largest level
        first. Per-batch results equal boolean()'s.

        prefix_p > 0 (requires columnar) is pagination: each batch returns
        (values, voffs, counts) with the first min(count, prefix_p) results
        a query and the true counts; the harvest fetches one (Q, P) slice a
        batch. Rows over L still re-serve exactly, so counts stay exact.
        While a delta is live every batch serves through boolean()."""
        batches = list(batches)
        P = int(prefix_p)
        if P and not columnar:
            raise ValueError("prefix_p requires columnar=True")
        st = self._state
        if st.delta is not None:
            # the dual step serves one batch at a time; the window lasts
            # until the next rebuild folds the delta in
            per = [self.boolean(b, op, filter_removed) for b in batches]
            if P:
                out = []
                for rows in per:
                    counts = np.fromiter(map(len, rows), np.int64,
                                         count=len(rows))
                    vals, voffs = _rows_to_columnar([r[:P] for r in rows])
                    out.append((vals, voffs, counts))
                return out
            return [_rows_to_columnar(r) for r in per] if columnar else per
        W = st.width()
        fetched: List = [None] * len(batches)
        longs = []  # ((batch, row), qk_row (K, W+1), kv, need)
        pend = deque()

        def harvest(item):
            bi, nq, qk, kv, out, pending = item
            if P:
                out_h, oc_h, need_h = _finish_host_copy(pending)
                out_h = out_h.view(np.uint32)
            else:
                oc_h, need_h, md = _finish_host_copy(pending)
                out_h = self._fetch_trimmed(out, oc_h, md)
            fetched[bi] = (nq, out_h, oc_h)
            for i in np.nonzero(need_h > self.L)[0]:
                longs.append(((bi, int(i)), qk[i], int(kv[i]),
                              int(need_h[i])))

        for bi, queries in enumerate(batches):
            if not queries:
                fetched[bi] = (0, None, None)
                continue
            qk, kv = _pack_queries(queries, W)
            out, oc, need = self._boolean_dispatch(st, self.L, qk, kv, op)
            if filter_removed:
                out, oc = self._filter(out, oc, st.removed)
            if P:
                # the page is cut on the device; it is the bounded fetch
                out = out[:, : min(P, out.shape[1])].contiguous()
                pending = _start_host_copy([out, oc, need])
            else:
                pending = _start_host_copy([oc, need,
                                            _wire_meta_step(out, oc)])
            pend.append((bi, len(queries), qk, kv, out, pending))
            if len(pend) > depth:
                harvest(pend.popleft())
        while pend:
            harvest(pend.popleft())

        overrides: Dict[int, Dict[int, np.ndarray]] = {}

        def setter(pos, v):
            overrides.setdefault(pos[0], {})[pos[1]] = v

        self._reserve(st, longs, op, filter_removed, setter)

        results = []
        for bi in range(len(batches)):
            nq, out_h, oc_h = fetched[bi]
            if nq == 0:
                if P:
                    results.append((np.zeros(0, np.uint32),
                                    np.zeros(1, np.int64),
                                    np.zeros(0, np.int64)))
                elif columnar:
                    results.append((np.zeros(0, np.uint32),
                                    np.zeros(1, np.int64)))
                else:
                    results.append([])
                continue
            ovr = overrides.get(bi, {})
            if P:
                counts = oc_h[:nq].astype(np.int64)
                rows = []
                for i in range(nq):
                    if i in ovr:
                        counts[i] = len(ovr[i])
                        rows.append(ovr[i][:P])
                    else:
                        rows.append(out_h[i, : min(int(oc_h[i]), P)])
                vals, voffs = _rows_to_columnar(rows)
                results.append((vals, voffs, counts))
                continue
            rows = [ovr[i] if i in ovr else out_h[i, : oc_h[i]].copy()
                    for i in range(nq)]
            results.append(_rows_to_columnar(rows) if columnar else rows)
        return results

    # -- prefix search / range read ---------------------------------------

    def prefix_search(self, prefixes: Sequence[bytes]
                      ) -> Dict[bytes, np.ndarray]:
        """PrefixSearch over both tiers (values sorted unique; unmatched
        prefixes absent). Not tombstone-filtered, as in the reference:
        reads do not filter, only a merge purges."""
        st = self._state
        out = pm.sharded_prefix_search(st.snap, prefixes, L=self.L)
        if st.delta is not None:
            for p, v in pm.sharded_prefix_search(st.delta, prefixes,
                                                 L=self.L).items():
                out[p] = np.union1d(out[p], v) if p in out else v
        return out

    def read_range(self, min_term: Optional[bytes] = None,
                   max_term: Optional[bytes] = None):
        """Sorted (term, values) stream over both tiers, [min, max]
        inclusive; the tiers merge by term, values united on a tie."""
        st = self._state
        main = pm.sharded_read_range(st.snap, min_term, max_term, L=self.L)
        if st.delta is None:
            yield from main
            return
        dl = pm.sharded_read_range(st.delta, min_term, max_term, L=self.L)
        a = next(main, None)
        b = next(dl, None)
        while a is not None or b is not None:
            if b is None or (a is not None and a[0] < b[0]):
                yield a
                a = next(main, None)
            elif a is None or b[0] < a[0]:
                yield b
                b = next(dl, None)
            else:
                yield a[0], np.union1d(a[1], b[1])
                a = next(main, None)
                b = next(dl, None)
