"""Depth-pipelined stream serving (counterpart of models/staged.py), mixed
into QueryEngine.

Batch i+depth is packed and launched before batch i's results are read:
the device-to-host copies of each batch go into pinned buffers with
non_blocking copies behind the batch's kernels, and harvest waits on the
CUDA event recorded after them, so host packing overlaps device work.
Three streams:
  * AND: the fused stream through K2 (the main branch of boolean_staged);
  * OR, pagination (prefix_p) and lookup_staged: the concat-class stream
    (_staged_concat_stream), whose steps run the concat kernels around K4's
    row sort (ops/cuda_concat.py);
  * every op while a delta tier is live: the dual stream
    (_staged_dual_stream), the padded dual step with its AND through K3.
With retained host tables, lookup_staged serves on the host, and
boolean_staged does when the router picks the host route; the AND stream
can also run hybrid, the host serving batches from the tail while the
device takes them from the head (TPI_HYBRID=1).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.cuda_concat import concat_step
from ..ops.cuda_wire import wire_meta, wire_pack
from ..ops.setops import filter_removed as _filter_removed
from ..utils import tracing
from ..utils.u32 import to_numpy_u32
from .host_serve import _page_columnar
from .steps import (
    _RESERVE_BUDGET,
    _batch_as_lists,
    _dedup_adjacent,
    _host_resolve_sb,
    _narrow_keys,
    _pack_p_step,
    _resolve_sb_step,
    _round_up,
    _rows_to_columnar,
    _scatter_p_step,
    _split_idx_step,
    _wire_unpack,
)


def _start_host_copy(tensors):
    """Begin copying device tensors to the host: (host tensors, event).
    CPU tensors are already on the host."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return list(tensors), None
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in tensors]
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return hosts, ev


def _finish_host_copy(pending):
    hosts, ev = pending
    if ev is not None:
        with tracing.span("tpi.wait"):
            ev.synchronize()
    return [h.numpy() for h in hosts]


def _wire_fetch(outs, ocs, mds):
    """Second copy of a full-result harvest: per result matrix (with its
    host counts and masked max delta), the delta-packed plane at the width
    that delta allows (u8 or u16), or the raw u32 trim when deltas need
    more than 16 bits; every copy is started before the first is waited
    on. Returns the u32 matrices on the host."""
    pending, wire = [], []
    for o, oc_h, md_h in zip(outs, ocs, mds):
        maxc = int(oc_h.max(initial=0))
        if maxc <= 1:
            pending.append(_start_host_copy([o[:, :1]]))
            wire.append(False)
        elif int(md_h) < (1 << 16):
            f, dd = wire_pack(o, 8 if int(md_h) < 256 else 16, maxc)
            pending.append(_start_host_copy([f, dd]))
            wire.append(True)
        else:
            pending.append(_start_host_copy([o[:, :maxc]]))
            wire.append(False)
    hosts = []
    for p, w in zip(pending, wire):
        h = _finish_host_copy(p)
        if w:
            dd = h[1] if h[1].dtype == np.uint8 else h[1].view(np.uint16)
            hosts.append(_wire_unpack(h[0].view(np.uint32), dd))
        else:
            hosts.append(h[0].view(np.uint32))
    return hosts


def _empty_result(columnar: bool, P: int):
    if not columnar:
        return []
    empty = (np.zeros(0, np.uint32), np.zeros(1, np.int64))
    return empty + (np.zeros(0, np.int64),) if P else empty


# last_stream_stats' counters: every stream sets each of them, 0 where it
# does not apply, beside "route" ("device", "host" or "hybrid")
STREAM_COUNTERS = ("queries", "served_rows", "small_p_overflow",
                   "ladder_reserve", "concat", "concat_singles",
                   "concat_chunks", "device_batches", "host_batches",
                   "host_queries")


def _stream_stats(route: str, **counts) -> dict:
    """One call's last_stream_stats."""
    stats = dict.fromkeys(STREAM_COUNTERS, 0)
    stats.update(counts)
    stats["route"] = route
    return stats


def _batch_len(b) -> int:
    """Queries in one stream batch (term lists or a columnar triple)."""
    if isinstance(b, tuple) and len(b) == 3:
        return max(0, len(b[2]) - 1)
    return len(b)


class StagedStreamsMixin:
    """Pipelined stream serving and the concat classes; mixed into
    QueryEngine."""

    # size classes of the concat path: total-block budgets per query (the
    # JAX engine's ladder, kept as the contract; not re-measured on the card)
    _SB_CLASSES = (8, 32, 64, 128, 512, 2048, 8192, 32768)

    def lookup_staged(self, batches, filter_removed: bool = False,
                      depth: int = 3, columnar: bool = False,
                      prefix_p: int = 0):
        """Pipelined stream lookup: `batches` is an iterable of term lists.
        Each term serves as a single-term OR query through the concat-class
        stream on the device (exact at any posting length: classes size by
        true counts), and each batch returns what boolean_staged returns
        (rows, a columnar pair, or the pagination triple with prefix_p).
        Misses give count-0 results instead of lookup()'s None.

        With retained tables covering the live tiers (host_ready) every
        batch serves on the host instead (_host_lookup_stream): a
        full-result lookup is pure output, so not crossing the link at all
        is the fastest it can go."""
        st = self._serving_state()
        batches = [list(b) for b in batches]
        with tracing.span("tpi.stream") as root:
            if st.host_ready():
                out = self._host_lookup_stream(st, batches, filter_removed,
                                               columnar, prefix_p)
                n = sum(len(b) for b in batches)
                self.last_stream_stats = _stream_stats(
                    "host", queries=n, host_queries=n,
                    host_batches=sum(1 for b in batches if b))
            else:
                out = self._serve_staged(
                    [[[t] for t in b] for b in batches], "or",
                    filter_removed, depth, columnar, prefix_p, st)
        self._add_spans(root)
        return out

    def boolean_staged(self, batches, op: str = "and",
                       filter_removed: bool = False, depth: int = 3,
                       columnar: bool = False, prefix_p: int = 0,
                       _st=None):
        """Serve a stream of AND or OR batches with `depth` batches in
        flight. Per-batch results equal boolean()'s. AND streams through
        K2; the rare follow-ups (small-P overflow, ladder re-serves, bases
        beyond the level cap) are deferred and served once for the whole
        stream. OR and any prefix_p stream through the concat classes.
        With a delta tier live, every batch streams through the padded dual
        step (_staged_dual_stream), AND through K3.

        batches: iterable of batches, each a sequence of term lists or a
        columnar (blob, offsets[T+1], qoffs[Q+1]) triple. columnar=False
        returns one list of arrays per batch; columnar=True one (values,
        voffs[n+1]) pair per batch. prefix_p > 0 (requires columnar) is
        pagination: each batch returns (values, voffs, counts) with only
        the first min(count, prefix_p) results per query and the true
        counts. Afterwards `last_stream_stats` holds the call's counters
        (STREAM_COUNTERS: the queries, the rows the device served after
        dedup, each follow-up class, the concat singles, the concat steps
        launched (class chunks plus singles), the batches each
        side served, where a hybrid stream's host thread may serve a batch
        the device has served too, and the queries the host served) and its
        route; while tracing is on (utils/tracing.py) also the call's spans,
        reduced, under "spans".

        When the router picks the host route (_host_boolean_route) every
        batch serves on the host; with TPI_HYBRID=1 (_hybrid_staged) the
        AND stream's batches are shared between the device and a host
        thread."""
        with tracing.span("tpi.stream") as root:
            out = self._serve_staged(
                list(batches), op, filter_removed, depth, columnar, prefix_p,
                _st if _st is not None else self._serving_state())
        self._add_spans(root)
        return out

    def _add_spans(self, root) -> None:
        """The finished root span's reduced spans into last_stream_stats
        (tracing on)."""
        if root is not None and self.last_stream_stats is not None:
            self.last_stream_stats["spans"] = root.spans

    def _serve_staged(self, batches, op, filter_removed, depth, columnar,
                      prefix_p, st):
        """boolean_staged's body, inside its root span."""
        if op not in ("and", "or"):
            raise ValueError(f"op {op!r}: want 'and' or 'or'")
        if prefix_p and not columnar:
            raise ValueError("prefix_p requires columnar=True")
        if self._host_boolean_route(op, prefix_p, staged=True, st=st):
            out = [self._host_batch(b, op, filter_removed, columnar,
                                    prefix_p, st) for b in batches]
            n = [_batch_len(b) for b in batches]
            self.last_stream_stats = _stream_stats(
                "host", queries=sum(n), host_queries=sum(n),
                host_batches=sum(1 for k in n if k))
            return out
        removed = st.removed if filter_removed else None
        if st.delta is not None:
            return self._staged_dual_stream(st, batches, op, removed, depth,
                                            columnar, prefix_p)
        if st.snap.n_terms == 0:
            self.last_stream_stats = _stream_stats(
                "device", queries=sum(_batch_len(b) for b in batches))
            return [self._empty_index_batch(b, op, filter_removed, columnar,
                                            prefix_p) for b in batches]
        if op != "and" or prefix_p:
            return self._staged_concat_stream(st, batches, op, removed,
                                              depth, columnar, prefix_p)
        P = self._STAGED_SMALL_P
        levels_h = self._levels(st)
        fetched: List = [None] * len(batches)
        wide, longs, overs = [], [], []

        def harvest(item):
            bi, nq, inv, nu, qk, kv, pending = item
            with tracing.span("tpi.harvest"):
                small, oc, code = _finish_host_copy(pending)
                small = small.view(np.uint32)
                fetched[bi] = (nq, inv, nu, (small, oc, code))
                # served rows are the unique queries (code[:nu]); follow-up
                # positions are unique-row indexes, fanned out at assembly
                for i in np.nonzero(code[:nu] != 0)[0]:
                    c = int(code[i])
                    if c == 1:
                        wide.append(((bi, int(i)), qk[i], int(kv[i])))
                    elif c != 255:
                        longs.append(((bi, int(i)), qk[i], int(kv[i]),
                                      levels_h[c - 2]))
                    else:
                        overs.append(((bi, int(i)), qk[i], int(kv[i])))

        # hybrid work-stealing: the device claims batches from the head and
        # a host thread (the native serve releases the GIL) from the tail
        host_res: Dict[int, tuple] = {}
        ends = [0, len(batches) - 1]
        ends_lock = threading.Lock()

        def claim(device_side: bool):
            with ends_lock:
                if ends[0] > ends[1]:
                    return None
                if device_side:
                    ends[0] += 1
                    return ends[0] - 1
                ends[1] -= 1
                return ends[1] + 1

        worker, host_err = None, []
        if len(batches) > 1 and self._hybrid_staged(op, st=st):
            if filter_removed:
                st.removed_host()  # the host tombstones, made on this thread

            def host_worker():
                try:
                    while (hbi := claim(False)) is not None:
                        host_res[hbi] = self._boolean_host_columnar(
                            batches[hbi], op, filter_removed, st=st)
                    # the tail is spent: serve again, newest first, the
                    # batches the device claimed and has not harvested;
                    # assembly takes the host's copy of a batch served twice
                    for hbi in range(len(batches) - 1, -1, -1):
                        if fetched[hbi] is None and hbi not in host_res:
                            host_res[hbi] = self._boolean_host_columnar(
                                batches[hbi], op, filter_removed, st=st)
                except BaseException as e:  # raised after the join
                    host_err.append(e)

            worker = threading.Thread(target=host_worker, daemon=True,
                                      name="tpi-hybrid-host")
            worker.start()

        pend = deque()
        try:
            while (bi := claim(True)) is not None:
                with tracing.span("tpi.pack"):
                    nq, qk, kv = self._batch_pack(st, batches[bi])
                if nq == 0:
                    fetched[bi] = (0, None, 0, None)
                    continue
                with tracing.span("tpi.dedup"):
                    nu, qk, kv, inv = self._dedup_batch(nq, qk, kv)
                with tracing.span("tpi.dispatch"):
                    devs = self._fused_run_staged(st, qk, kv, removed)
                    pending = _start_host_copy(devs)
                pend.append((bi, nq, inv, nu, qk, kv, pending))
                if len(pend) > depth:
                    harvest(pend.popleft())
            while pend:
                harvest(pend.popleft())
        finally:
            if worker is not None:
                worker.join()
        if host_err:
            raise host_err[0]

        overrides: Dict[int, Dict[int, np.ndarray]] = {}

        def setter(pos, v):
            overrides.setdefault(pos[0], {})[pos[1]] = v

        singles, chunks = self._fused_followups(st, setter, wide, longs,
                                                overs, removed)
        harvested = [bi for bi, f in enumerate(fetched)
                     if f is not None and f[0]]
        served = [fetched[bi] for bi in harvested if bi not in host_res]
        host_q = sum(len(r[1]) - 1 for r in host_res.values())
        self.last_stream_stats = _stream_stats(
            "device" if worker is None else "hybrid",
            queries=sum(f[0] for f in served) + host_q,
            served_rows=sum(f[2] for f in served),
            small_p_overflow=len(wide), ladder_reserve=len(longs),
            concat=len(overs), concat_singles=singles, concat_chunks=chunks,
            # a batch the host stole back may count on both sides
            device_batches=len(harvested), host_batches=len(host_res),
            host_queries=host_q)
        with tracing.span("tpi.assemble"):
            return [self._host_result(host_res[bi], columnar)
                    if bi in host_res
                    else self._assemble(fetched[bi], overrides.get(bi, {}),
                                        P, columnar)
                    for bi in range(len(batches))]

    def _host_batch(self, b, op, filter_removed, columnar, P, st):
        """One batch of boolean_staged on the host route. A page (prefix_p)
        reaches here only in a warm start's window: the full results are
        cut to the pagination triple."""
        if not columnar:
            return self.boolean_host(_batch_as_lists(b), op, filter_removed,
                                     _st=st)
        vals, voffs = self._boolean_host_columnar(b, op, filter_removed,
                                                  st=st)
        return _page_columnar(vals, voffs, P) if P else (vals, voffs)

    @staticmethod
    def _host_result(res, columnar: bool):
        """A hybrid stream's host-served batch in the stream's form."""
        vals, voffs = res
        if columnar:
            return vals, voffs
        return [vals[voffs[i]: voffs[i + 1]].copy()
                for i in range(len(voffs) - 1)]

    def _empty_index_batch(self, b, op, filter_removed, columnar, prefix_p):
        """One batch over an empty index: every result is empty."""
        rows = self.boolean(_batch_as_lists(b), op, filter_removed)
        if not columnar:
            return rows
        vals, voffs = _rows_to_columnar(rows)
        if prefix_p:
            return vals, voffs, np.zeros(len(rows), dtype=np.int64)
        return vals, voffs

    @staticmethod
    def _assemble(f, ovr, P: int, columnar: bool):
        """One batch's results from its small-P fetch plus the follow-up
        overrides (keyed by served row), fanned out to duplicates."""
        nq, inv, nu, got = f
        if nq == 0:
            return _empty_result(columnar, 0)
        small, oc8, code = got
        oc = oc8.astype(np.int32)
        normal = code[:nu] == 0
        if columnar:
            cnt_u = np.where(normal, oc[:nu], 0).astype(np.int64)
            for i, arr in ovr.items():
                cnt_u[i] = len(arr)
            counts = cnt_u if inv is None else cnt_u[inv]
            small_n = small[:nu] if inv is None else small[:nu][inv]
            msk_n = np.where(normal, oc[:nu], 0)
            if inv is not None:
                msk_n = msk_n[inv]
            voffs = np.zeros(nq + 1, dtype=np.int64)
            np.cumsum(counts, out=voffs[1:])
            vals = np.empty(int(voffs[-1]), dtype=np.uint32)
            m2 = np.arange(P)[None, :] < msk_n[:, None]
            dst = (voffs[:-1, None] + np.arange(P)[None, :])[m2]
            vals[dst] = small_n[m2]
            for u, arr in ovr.items():
                for i in ([u] if inv is None else np.nonzero(inv == u)[0]):
                    vals[voffs[i]: voffs[i + 1]] = arr
            return vals, voffs
        rows: List[Optional[np.ndarray]] = [None] * nq
        seen_ovr = set()
        for i in range(nq):
            u = i if inv is None else int(inv[i])
            if u in ovr:
                # duplicates get their own copy (callers may mutate rows)
                rows[i] = ovr[u].copy() if u in seen_ovr else ovr[u]
                seen_ovr.add(u)
            elif normal[u]:
                rows[i] = small[u, : oc[u]].copy()
        return rows

    # -- the delta window ---------------------------------------------------

    def _staged_dual_stream(self, st, batches, op: str, removed, depth: int,
                            columnar: bool, prefix_p: int):
        """Depth-pipelined stream over the main + delta pair (the padded
        dual step, steps.boolean_step_dual): each batch's pass at L is
        launched before batch i-depth is harvested, and the ladder
        re-serves of every batch drain once at the end (_drain_levels).
        prefix_p slices each result row on the device, so a page ships
        (Q, P) values beside the true counts."""
        P = int(prefix_p)
        run = self._dual_run(st, op, removed)
        fetched: List = [None] * len(batches)
        longs = []
        pend = deque()

        def harvest(item):
            bi, nq, qk, kv, out, pending = item
            got = _finish_host_copy(pending)
            if P:
                out_h, oc_h, need_h = got
                out_h = out_h.view(np.uint32)
            else:
                oc_h, need_h = got
                out_h = to_numpy_u32(
                    out[:, : max(1, int(oc_h[:nq].max(initial=0)))])
            fetched[bi] = (nq, out_h, oc_h)
            for i in np.nonzero(need_h[:nq] > self.L)[0]:
                longs.append(((bi, int(i)), qk[i], int(kv[i]),
                              self._level_for(int(need_h[i]), st)))

        for bi, b in enumerate(batches):
            nq, qk, kv = self._batch_pack(st, b)
            if nq == 0:
                fetched[bi] = (0, None, None)
                continue
            out, oc, need = run(self.L, qk, kv)
            if P:
                pending = _start_host_copy([out[:, :P].contiguous(), oc,
                                            need])
                out = None
            else:
                pending = _start_host_copy([oc, need])
            pend.append((bi, nq, qk, kv, out, pending))
            if len(pend) > depth:
                harvest(pend.popleft())
        while pend:
            harvest(pend.popleft())

        overrides: Dict[int, Dict[int, np.ndarray]] = {}

        def setter(pos, v):
            overrides.setdefault(pos[0], {})[pos[1]] = v

        self._drain_levels(longs, run, setter)
        nqs = sum(f[0] for f in fetched)
        self.last_stream_stats = _stream_stats(
            "device", queries=nqs, served_rows=nqs, ladder_reserve=len(longs),
            device_batches=sum(1 for f in fetched if f[0]))
        results = []
        for bi in range(len(batches)):
            nq, out_h, oc_h = fetched[bi]
            if nq == 0:
                results.append(_empty_result(columnar, P))
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
                results.append(_rows_to_columnar(rows) + (counts,))
                continue
            rows = [ovr[i] if i in ovr else out_h[i, : oc_h[i]].copy()
                    for i in range(nq)]
            results.append(_rows_to_columnar(rows) if columnar else rows)
        return results

    # -- the concat classes -------------------------------------------------

    def _dispatch_classes(self, s, sb_q, idx_dev, found_dev, kv_dev, op,
                          removed, win: int = 0, wd: bool = False,
                          obuf=None):
        """Launch every class chunk of one resolved batch: queries grouped
        by total blocks sb_q into the _SB_CLASSES, in chunks whose decoded
        rows stay within the reserve budget, one concat step each
        (ops/cuda_concat.py); queries beyond the largest class go singly at
        their own block budget. The class order is uploaded once and each
        step reads its queries through a slice of it.

        Returns (dispatches, singles, chunks): dispatches are (query
        indexes, out, oc, pending copy of oc and the masked max delta),
        singles {query: exact values} (fetched here: they are rare), chunks
        the steps launched (class chunks plus singles). With `obuf`
        (pagination) each chunk and single writes its P-slice into it,
        dispatches is empty and the singles' values are None."""
        stride = int(s.blocks.shape[1])
        filt = removed is not None and removed.shape[0] > 0
        nq = len(sb_q)
        order = np.argsort(sb_q, kind="stable")
        order_dev = self._dev(order.astype(np.int32))

        def run(lo, hi, SB, wire_dedup):
            rows = order_dev[lo:hi]
            res = concat_step(
                s.blocks, s.term_block_start, s.counts, idx_dev, found_dev,
                kv_dev, rows, SB, op, prefix_p=win, wire_dedup=wire_dedup,
                obuf=obuf if win else None)
            if res is None:  # the step wrote the page
                return None, None
            o, oc = res
            if filt:
                o, oc = _filter_removed(o, oc, removed)
            if obuf is not None:  # AND or tombstone-filtered pages
                _scatter_p_step(obuf, rows, o, oc)
            return o, oc

        sb_sorted = sb_q[order]
        dispatches, singles, chunks = [], {}, 0
        pos = 0
        for SB in self._SB_CLASSES:
            hi = int(np.searchsorted(sb_sorted, SB, side="right"))
            qb = max(8, (_RESERVE_BUDGET // (SB * max(stride, 128))) // 8 * 8)
            for lo in range(pos, hi, qb):
                end = min(lo + qb, hi)
                o, oc = run(lo, end, SB, wd)
                chunks += 1
                if obuf is None:
                    md = wire_meta(o, oc)
                    dispatches.append((order[lo:end], o, oc,
                                       _start_host_copy([oc, md])))
            pos = hi
            if pos >= nq:
                break
        # beyond the largest class: one at a time at their exact budget
        for at in range(pos, nq):
            qi = int(order[at])
            o, oc = run(at, at + 1, _round_up(int(sb_q[qi]), 8), False)
            chunks += 1
            if obuf is not None:
                singles[qi] = None
                continue
            with tracing.span("tpi.wait"):
                c = int(oc[0])
                singles[qi] = to_numpy_u32(o[0, :c]).copy()
        return dispatches, singles, chunks

    def _harvest_rows(self, nq, dispatches, singles, wd: bool):
        """Full results of one batch's dispatches: (nq,) list of arrays
        (with wire dedup, adjacent duplicates dropped on the host)."""
        with tracing.span("tpi.harvest"):
            ocs, mds = [], []
            for d in dispatches:
                oc_h, md_h = _finish_host_copy(d[3])
                ocs.append(oc_h)
                mds.append(md_h)
            outs = _wire_fetch([d[1] for d in dispatches], ocs, mds)
            rows: List[Optional[np.ndarray]] = [None] * nq
            for (batch, _, _, _), oc, o in zip(dispatches, ocs, outs):
                for j, qi in enumerate(batch):
                    row = o[j, : oc[j]]
                    rows[qi] = _dedup_adjacent(row) if wd else row
            for qi, v in singles.items():
                rows[qi] = v
            return rows

    def _resolve_concat(self, st, qk, nq):
        """(idx, found) on the device and each query's total blocks on the
        host. With retained tables the dictionary is probed on the host,
        which the class grouping needs anyway."""
        s = st.snap
        if st.host_ready():
            idxs, cnt, _ = _host_resolve_sb(st.tables, qk)
            idx_dev, found_dev = _split_idx_step(self._dev(idxs))
            sb_q = np.minimum(-(-cnt[:nq] // 128), 1 << 30).sum(axis=1)
            return idx_dev, found_dev, sb_q
        idx_dev, found_dev, sb = _resolve_sb_step(
            s.keys, s.counts, self._dev(_narrow_keys(qk, s.width)),
            s.hash_slots, s.max_probes)
        with tracing.span("tpi.wait"):
            sb_h = sb.cpu().numpy()
        return idx_dev, found_dev, sb_h[:nq].astype(np.int64)

    def _boolean_concat(self, st, queries, qk, kv, op: str, removed):
        """Exact AND/OR sized by each query's real total postings: resolve,
        group into total-block classes, one concat-decode + K4 sort +
        run-length pass per class chunk (ops/cuda_concat.py). Full-result
        OR without a tombstone filter ships the sorted stream with
        cross-list duplicates, dropped on the host (wire dedup). Returns
        (rows, the number of queries served singly past the classes, the
        concat steps launched)."""
        nq = len(queries)
        with tracing.span("tpi.resolve"):
            idx_dev, found_dev, sb_q = self._resolve_concat(st, qk, nq)
        wd = op == "or" and (removed is None or removed.shape[0] == 0)
        with tracing.span("tpi.dispatch"):
            dispatches, singles, chunks = self._dispatch_classes(
                st.snap, sb_q, idx_dev, found_dev, self._dev(kv), op,
                removed, wd=wd)
        rows = self._harvest_rows(nq, dispatches, singles, wd)
        return [r.copy() for r in rows], len(singles), chunks

    def _staged_concat_stream(self, st, batches, op: str, removed,
                              depth: int, columnar: bool, prefix_p: int):
        """Depth-pipelined stream over the concat classes, three stages per
        batch, each overlapping the others' device time:

          resolve:  pack, dedup, and resolve (host tables, or on the device
                    with the (Q,) block sums copied back behind it)
          classes:  group queries into classes and launch every chunk; with
                    prefix_p each chunk scatters its P-slice into one
                    (Q, P+1) buffer that is u16 delta-packed at once
          harvest:  wait for the copies and assemble the batch

        prefix_p=0 returns exact full results; prefix_p > 0 the
        (values, voffs, true counts) pagination triple. Full-result OR
        without a tombstone filter uses the wire-dedup contract, and
        pagination OR without one compacts only the first prefix_p * K
        sorted lanes (boolean_concat_step)."""
        s = st.snap
        P = int(prefix_p)
        filt = removed is not None and removed.shape[0] > 0
        wd = not P and op == "or" and not filt
        win = P if (P and op == "or" and not filt) else 0
        out_all: List = [None] * len(batches)
        resq: deque = deque()
        clsq: deque = deque()
        counts = dict(queries=0, served_rows=0, concat_singles=0,
                      concat_chunks=0, device_batches=0)

        def stage_resolve(bi):
            with tracing.span("tpi.pack"):
                nq, qk, kv = self._batch_pack(st, batches[bi])
            if nq == 0:
                resq.append((bi, 0, None, None, None))
                return
            counts["queries"] += nq
            counts["device_batches"] += 1
            # cross-query dedup: serve each distinct query once, fan out at
            # harvest; the flat 10 us row cost is the JAX engine's concat
            # row estimate, not re-measured on the card
            with tracing.span("tpi.dedup"):
                nu, qk_u, kv_u, inv = self._dedup_batch(nq, qk, kv,
                                                        row_cost_us=10.0)
            if inv is not None:
                nq, qk, kv = nu, qk_u, kv_u
            counts["served_rows"] += nq
            with tracing.span("tpi.resolve"):
                if st.host_ready():
                    r = self._resolve_concat(st, qk, nq)
                else:
                    idx_dev, found_dev, sb = _resolve_sb_step(
                        s.keys, s.counts,
                        self._dev(_narrow_keys(qk, s.width)), s.hash_slots,
                        s.max_probes)
                    r = (idx_dev, found_dev, _start_host_copy([sb]))
                resq.append((bi, nq, inv, self._dev(kv), r))

        def stage_classes(item):
            bi, nq, inv, kv_dev, r = item
            if nq == 0:
                clsq.append((bi, 0, None, None, None))
                return
            idx_dev, found_dev, sb = r
            sb_q = (sb if isinstance(sb, np.ndarray)
                    else _finish_host_copy(sb)[0])[:nq].astype(np.int64)
            with tracing.span("tpi.dispatch"):
                if P:
                    obuf = torch.zeros((nq, P + 1), dtype=torch.int32,
                                       device=self.device)
                    _, singles, chunks = self._dispatch_classes(
                        s, sb_q, idx_dev, found_dev, kv_dev, op, removed,
                        win=win, obuf=obuf)
                    pk = _pack_p_step(obuf)
                    clsq.append((bi, nq, inv,
                                 (_start_host_copy([pk]), obuf), None))
                else:
                    dispatches, singles, chunks = self._dispatch_classes(
                        s, sb_q, idx_dev, found_dev, kv_dev, op, removed,
                        wd=wd)
                    clsq.append((bi, nq, inv, dispatches, singles))
            counts["concat_singles"] += len(singles)
            counts["concat_chunks"] += chunks

        def stage_harvest(item):
            bi, nq, inv, dispatches, singles = item
            if nq == 0:
                out_all[bi] = _empty_result(columnar, P)
                return
            if P:
                out_all[bi] = self._harvest_page(nq, inv, P, *dispatches)
                return
            rows = self._harvest_rows(nq, dispatches, singles, wd)
            with tracing.span("tpi.assemble"):
                if inv is not None:
                    # dedup fan-out; both output forms below copy per row
                    rows = [rows[int(u)] for u in inv]
                if columnar:
                    out_all[bi] = _rows_to_columnar(rows)
                else:
                    out_all[bi] = [np.array(r, dtype=np.uint32)
                                   for r in rows]

        for bi in range(len(batches)):
            stage_resolve(bi)
            if len(resq) > depth:
                stage_classes(resq.popleft())
            if len(clsq) > depth:
                stage_harvest(clsq.popleft())
        while resq:
            stage_classes(resq.popleft())
            if len(clsq) > depth:
                stage_harvest(clsq.popleft())
        while clsq:
            stage_harvest(clsq.popleft())
        self.last_stream_stats = _stream_stats("device", **counts)
        return out_all

    def _harvest_page(self, nq, inv, P, pending, obuf):
        """The pagination triple of one batch from its u16 delta plane (see
        _pack_p_step); rows whose overflow flag is set are read raw from
        the resident buffer."""
        with tracing.span("tpi.harvest"):
            pk = _finish_host_copy(pending)[0].view(np.uint16)[:nq]
            with tracing.span("tpi.assemble"):
                d = pk[:, : P - 1].astype(np.uint32)
                first = pk[:, P - 1].astype(np.uint32) | (
                    pk[:, P].astype(np.uint32) << 16)
                hi = pk[:, P + 2].astype(np.int64)
                counts = pk[:, P + 1].astype(np.int64) | (
                    (hi & 0x7FFF) << 16)
                vals = np.empty((nq, P), np.uint32)
                vals[:, 0] = first
                vals[:, 1:] = first[:, None] + np.cumsum(d, axis=1,
                                                         dtype=np.uint32)
                ovr = np.nonzero(hi >> 15)[0]
                if len(ovr):
                    with tracing.span("tpi.wait"):
                        raw = to_numpy_u32(
                            obuf[torch.from_numpy(ovr).to(obuf.device)])
                    vals[ovr] = raw[:, :P]
                    counts[ovr] = raw[:, P].astype(np.int64)
                if inv is not None:
                    counts = counts[inv]
                    vals = vals[inv]
                    nq = len(inv)
                kept = np.minimum(counts, P)
                pvoffs = np.zeros(nq + 1, dtype=np.int64)
                np.cumsum(kept, out=pvoffs[1:])
                m = np.arange(P, dtype=np.int64)[None, :] < kept[:, None]
                return vals[m], pvoffs, counts
