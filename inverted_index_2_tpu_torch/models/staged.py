"""Depth-pipelined AND stream serving (counterpart of the fused branch of
models/staged.py::boolean_staged), mixed into QueryEngine.

Batch i+depth is packed and launched before batch i's results are read:
the device-to-host copies of each batch go into pinned buffers with
non_blocking copies behind the batch's kernels, and harvest waits on the
CUDA event recorded after them, so host packing overlaps device work.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from .steps import _batch_as_lists, _not_ported, _rows_to_columnar


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
        ev.synchronize()
    return [h.numpy() for h in hosts]


class StagedStreamsMixin:
    """Pipelined AND streams; mixed into QueryEngine."""

    def boolean_staged(self, batches, op: str = "and",
                       filter_removed: bool = False, depth: int = 3,
                       columnar: bool = False, prefix_p: int = 0,
                       _st=None):
        """Serve a stream of AND batches with `depth` batches in flight.
        Per-batch results equal boolean()'s. The rare follow-ups (small-P
        overflow, ladder re-serves, bases beyond the level cap) are
        deferred and served once for the whole stream.

        batches: iterable of batches, each a sequence of term lists or a
        columnar (blob, offsets[T+1], qoffs[Q+1]) triple. columnar=False
        returns one list of arrays per batch; columnar=True one (values,
        voffs[n+1]) pair per batch. Afterwards `last_stream_stats` counts
        the stream's queries, the rows served after dedup, and each
        follow-up class."""
        if op != "and":
            _not_ported(f"boolean_staged op {op!r}", 5)
        if prefix_p:
            _not_ported("boolean_staged prefix_p (pagination)", 5)
        batches = list(batches)
        st = _st if _st is not None else self._state
        removed = st.snap.removed if filter_removed else None
        if st.snap.n_terms == 0:
            out = []
            for b in batches:
                rows = self.boolean(_batch_as_lists(b), op, filter_removed)
                out.append(_rows_to_columnar(rows) if columnar else rows)
            return out
        P = self._STAGED_SMALL_P
        levels_h = self._levels(st)
        fetched: List = [None] * len(batches)
        wide, longs, overs = [], [], []

        def harvest(item):
            bi, nq, inv, nu, qk, kv, pending = item
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

        pend = deque()
        for bi, b in enumerate(batches):
            nq, qk, kv = self._batch_pack(st, b)
            if nq == 0:
                fetched[bi] = (0, None, 0, None)
                continue
            nu, qk, kv, inv = self._dedup_batch(nq, qk, kv)
            devs = self._fused_run_staged(st, qk, kv, removed)
            pend.append((bi, nq, inv, nu, qk, kv, _start_host_copy(devs)))
            if len(pend) > depth:
                harvest(pend.popleft())
        while pend:
            harvest(pend.popleft())

        overrides: Dict[int, Dict[int, np.ndarray]] = {}

        def setter(pos, v):
            overrides.setdefault(pos[0], {})[pos[1]] = v

        self._fused_followups(st, setter, wide, longs, overs, removed)
        served = [f for f in fetched if f[0]]
        self.last_stream_stats = {
            "queries": sum(f[0] for f in served),
            "served_rows": sum(f[2] for f in served),
            "small_p_overflow": len(wide),
            "ladder_reserve": len(longs),
            "concat": len(overs),
        }
        return [self._assemble(fetched[bi], overrides.get(bi, {}), P,
                               columnar) for bi in range(len(batches))]

    @staticmethod
    def _assemble(f, ovr, P: int, columnar: bool):
        """One batch's results from its small-P fetch plus the follow-up
        overrides (keyed by served row), fanned out to duplicates."""
        nq, inv, nu, got = f
        if nq == 0:
            return ((np.zeros(0, np.uint32), np.zeros(1, np.int64))
                    if columnar else [])
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
