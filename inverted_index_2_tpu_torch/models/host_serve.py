"""Host-side full-result serving from the retained tables (counterpart of
models/host_serve.py), mixed into QueryEngine.

Full-result lookups, ORs and range reads are output: their results are
O(sum of posting lengths) whoever computes them. With the compact host
tables retained (keep_tables), they can serve entirely on the host: a hash
probe (codec/hashing.probe_rows_np) and a block decode of the same
compressed stream the device arena expands from, or the native fused serve
(tpi_boolean_serve: decode, set op and tombstone filter in one C++ pass per
query). Nothing here touches torch. The policy that picks between this
route and the device (_host_boolean_route) lives on QueryEngine, beside the
link probe it reads.

The numpy path serves when the native codec is not built; it is host code
of the reference, bit-identical to the native serve, not a stand-in for the
device.
"""
from __future__ import annotations

import os
from typing import TYPE_CHECKING, List, Optional, Sequence

import numpy as np

from ..codec import hashing
from ..codec import keys as keys_mod
from ..codec import native as _native
from ..codec import packing
from .snapshot import HostTables
from .steps import _narrow_keys, _rows_to_columnar

if TYPE_CHECKING:  # query_engine imports this mixin
    from .query_engine import ServingState


def _fanout_columnar(uvals: np.ndarray, uvoffs: np.ndarray, gid: np.ndarray):
    """Expand a deduplicated columnar result (uvals, uvoffs) back to the
    whole batch: output row i is group gid[i]'s row. The native path is one
    memcpy a row (tpi_fanout_u32); the numpy path copies slice by slice,
    since a flat gather's int64 index array alone would be twice the
    output."""
    counts = np.diff(uvoffs)[gid]
    voffs = np.zeros(len(gid) + 1, dtype=np.int64)
    np.cumsum(counts, out=voffs[1:])
    out = np.empty(int(voffs[-1]), dtype=uvals.dtype)
    if _native.available() and uvals.dtype == np.uint32:
        _native.fanout_u32(uvals, uvoffs, gid, out, voffs)
    else:
        for i, g in enumerate(gid):
            out[voffs[i]: voffs[i + 1]] = uvals[uvoffs[g]: uvoffs[g + 1]]
    return out, voffs


class HostServingMixin:
    """Host-route serving methods; mixed into QueryEngine."""

    def host_ready(self) -> bool:
        """True when the retained tables cover the current tiers (main, and
        the delta when one is live)."""
        return self._state.host_ready()

    @staticmethod
    def _host_decode(t: HostTables, idx: np.ndarray):
        """Posting lists of term indexes `idx` (all >= 0) decoded from the
        retained compressed stream: (values, voffs). List i's count word
        sits one word before its first block (codec/packing.py layout)."""
        starts = t.flat[t.tbs[:-1].astype(np.int64)[idx]].astype(np.int64) - 1
        values, _, voffs = packing.decode_bulk(t.words, starts)
        return values, voffs

    @staticmethod
    def _filter_sorted_columnar(values, voffs, rem):
        """Drop tombstoned values from a columnar (values, voffs) pair with
        one searchsorted membership test (rem is sorted)."""
        if rem is None or len(rem) == 0 or len(values) == 0:
            return values, voffs
        pos = np.searchsorted(rem, values)
        hit = rem[np.minimum(pos, len(rem) - 1)] == values
        kept = np.zeros(len(values) + 1, dtype=np.int64)
        np.cumsum(~hit, out=kept[1:])
        return values[~hit], kept[voffs]

    def _host_tier_columnar(self, t: HostTables, qk: np.ndarray, rem):
        """One tier's lookups as (found, values, voffs): probe, decode the
        hits (already in query order), filter tombstones, misses at count
        0."""
        nq = qk.shape[0]
        if t.n_terms == 0:
            return (np.zeros(nq, bool), np.zeros(0, np.uint32),
                    np.zeros(nq + 1, np.int64))
        idx = hashing.probe_rows_np(t.slots, t.max_probes, t.keys,
                                    _narrow_keys(qk, t.width))
        found = idx >= 0
        values, hvoffs = self._host_decode(t, idx[found])
        counts = np.zeros(nq, dtype=np.int64)
        counts[found] = np.diff(hvoffs)
        voffs = np.zeros(nq + 1, dtype=np.int64)
        np.cumsum(counts, out=voffs[1:])
        values, voffs = self._filter_sorted_columnar(values, voffs, rem)
        return found, values, voffs

    def _host_tier_starts(self, t: HostTables, qk: np.ndarray) -> np.ndarray:
        """Count-word offsets into t.words of each packed term (-1 for a
        miss): what the native fused serve decodes from."""
        nq = qk.shape[0]
        if t.n_terms == 0:
            return np.full(nq, -1, np.int64)
        idx = hashing.probe_rows_np(t.slots, t.max_probes, t.keys,
                                    _narrow_keys(qk, t.width))
        starts = (t.flat[t.tbs[:-1].astype(np.int64)[np.maximum(idx, 0)]]
                  .astype(np.int64) - 1)
        starts[idx < 0] = -1
        return starts

    def lookup_host(self, terms: Sequence[bytes],
                    filter_removed: bool = False
                    ) -> List[Optional[np.ndarray]]:
        """lookup() served on the host from the retained tables: the same
        contract (None for a miss, sorted postings, both tiers unioned in a
        delta window), exact at any length. Needs host_ready()."""
        if not terms:
            return []
        st = self._serving_state()
        if not st.host_ready():
            raise RuntimeError(
                "host serving needs retained tables (keep_tables=True)")
        rem = st.removed_host() if filter_removed else None
        qk = keys_mod.pack_terms(list(terms), width=st.host_q_width())
        found, values, voffs = self._host_tier_columnar(st.tables, qk, rem)
        rows: List[Optional[np.ndarray]] = [
            values[voffs[i]: voffs[i + 1]].copy() if found[i] else None
            for i in range(len(terms))]
        if st.delta is not None:
            f2, v2, o2 = self._host_tier_columnar(st.delta_tables, qk, rem)
            for i in np.nonzero(f2)[0]:
                d = v2[o2[i]: o2[i + 1]]
                rows[i] = d if rows[i] is None else np.union1d(rows[i], d)
        return rows

    def _host_lookup_stream(self, st: "ServingState", batches,
                            filter_removed: bool, columnar: bool,
                            prefix_p: int):
        """lookup_staged on the host: each batch assembled columnar, with
        misses as count-0 rows, as the device stream gives them."""
        rem = st.removed_host() if filter_removed else None
        P = int(prefix_p)
        W = st.host_q_width()
        out = []
        for b in batches:
            terms = list(b)
            if not terms:
                if columnar:
                    empty = (np.zeros(0, np.uint32), np.zeros(1, np.int64))
                    out.append(empty + (np.zeros(0, np.int64),) if P
                               else empty)
                else:
                    out.append([])
                continue
            qk = keys_mod.pack_terms(terms, width=W)
            _, values, voffs = self._host_tier_columnar(st.tables, qk, rem)
            if st.delta is not None:
                f2, v2, o2 = self._host_tier_columnar(st.delta_tables, qk,
                                                      rem)
                if f2.any():
                    rows = [values[voffs[i]: voffs[i + 1]]
                            for i in range(len(terms))]
                    for i in np.nonzero(f2)[0]:
                        rows[i] = np.union1d(rows[i], v2[o2[i]: o2[i + 1]])
                    values, voffs = _rows_to_columnar(rows)
            if P:
                out.append(_page_columnar(values, voffs, P))
            elif columnar:
                out.append((values, voffs))
            else:
                out.append([values[voffs[i]: voffs[i + 1]].copy()
                            for i in range(len(terms))])
        return out

    def boolean_host(self, queries: Sequence[Sequence[bytes]], op: str,
                     filter_removed: bool = False,
                     _st: Optional["ServingState"] = None
                     ) -> List[np.ndarray]:
        """boolean() served on the host from the retained tables, exact at
        any length: sorted unique arrays; a missing term empties an AND and
        adds nothing to an OR; in a delta window each term's rows union
        across both tiers before the set op. Needs host_ready()."""
        if op not in ("and", "or"):
            raise ValueError(f"op must be 'and' or 'or', got {op!r}")
        st = _st if _st is not None else self._serving_state()
        if not st.host_ready():
            raise RuntimeError(
                "host serving needs retained tables (keep_tables=True)")
        if not queries:
            return []
        values, voffs = self._boolean_host_columnar(queries, op,
                                                    filter_removed, st=st)
        return [values[voffs[i]: voffs[i + 1]].copy()
                for i in range(len(queries))]

    def _boolean_host_columnar(self, queries, op: str, filter_removed: bool,
                               st: Optional["ServingState"] = None):
        """boolean_host's columnar core: (values, voffs) over one batch of
        term lists or a columnar (blob, offsets, qoffs) triple, identical
        queries served once (_host_dedup_group)."""
        st = st if st is not None else self._serving_state()
        if isinstance(queries, tuple) and len(queries) == 3:
            blob, offsets, qoffs = queries
            blob8 = (np.frombuffer(blob, dtype=np.uint8)
                     if isinstance(blob, (bytes, bytearray))
                     else np.asarray(blob, dtype=np.uint8))
            offsets = np.asarray(offsets, dtype=np.int64)
            koffs = np.asarray(qoffs, dtype=np.int64)
            if len(offsets) <= 1:
                return np.zeros(0, np.uint32), koffs * 0
            qk = keys_mod.pack_blob(blob8, offsets, st.host_q_width())
        else:
            flat_terms = [t for q in queries for t in q]
            koffs = np.zeros(len(queries) + 1, dtype=np.int64)
            np.cumsum([len(q) for q in queries], out=koffs[1:])
            if not flat_terms:
                return np.zeros(0, np.uint32), koffs * 0
            qk = keys_mod.pack_terms(flat_terms, width=st.host_q_width())
        dd = self._host_dedup_group(qk, koffs, op)
        if dd is not None:
            # a duplicate query is the same function of (state, query): serve
            # each distinct one once and copy its row out to the others
            qk_u, koffs_u, gid = dd
            uvals, uvoffs = self._host_serve_columnar(qk_u, koffs_u, op,
                                                      filter_removed, st)
            return _fanout_columnar(uvals, uvoffs, gid)
        return self._host_serve_columnar(qk, koffs, op, filter_removed, st)

    def _host_dedup_group(self, qk: np.ndarray, koffs: np.ndarray, op: str):
        """Group identical queries of a packed host batch. Returns (qk_u,
        koffs_u, gid): the distinct queries in the order of their 64-bit row
        hash (ties in first-occurrence order), not in the order they first
        occur, and each query's group; or None when dedup does not pay:
        fewer than 256 queries, TPI_HOST_DEDUP=0, or an estimated saving
        (duplicates x per-query serve cost) under twice the grouping cost
        (TPI_HOST_DEDUP=force skips that gate). The hash only merges
        candidate groups; the full-row compare of neighbours splits them
        again, so distinct queries never share a group.

        A query is one padded int64 row [k, key words..., 0...]; k leads the
        row, so zero padding cannot make two queries of different lengths
        equal. The cost constants (OR 12 us, AND 3 us a query; 2 ms to
        group) are the JAX engine's, not measured on the card's host."""
        nq = len(koffs) - 1
        mode = os.environ.get("TPI_HOST_DEDUP", "1")
        if mode == "0" or nq < 256:
            return None
        k = np.diff(koffs)
        mk = int(k.max())
        Wc = qk.shape[1]
        M = np.zeros((nq, 1 + mk * Wc), dtype=np.int64)
        M[:, 0] = k
        T = qk.shape[0]
        if T:
            qidx = np.repeat(np.arange(nq), k)
            tpos = np.arange(T) - np.repeat(koffs[:-1], k)
            cols = 1 + tpos[:, None] * Wc + np.arange(Wc)[None, :]
            M[qidx[:, None], cols] = qk.astype(np.int64)
        h = M @ self._dedup_mults(M.shape[1])
        saved = nq - len(np.unique(h))
        cost_us = 12.0 if op == "or" else 3.0
        if mode != "force" and saved * cost_us < 2 * 2000.0:
            return None
        order = np.argsort(h, kind="stable")
        sm = M[order]
        neq = np.empty(nq, dtype=bool)
        neq[0] = True
        np.any(sm[1:] != sm[:-1], axis=1, out=neq[1:])
        nu = int(neq.sum())
        if nu >= nq:
            return None  # the hash duplicates were collisions
        first = order[neq]
        gid = np.empty(nq, dtype=np.int64)
        gid[order] = np.cumsum(neq) - 1
        ku = k[first]
        koffs_u = np.zeros(nu + 1, dtype=np.int64)
        np.cumsum(ku, out=koffs_u[1:])
        tidx = (np.repeat(koffs[:-1][first], ku) + np.arange(koffs_u[-1])
                - np.repeat(koffs_u[:-1], ku))
        return qk[tidx], koffs_u, gid

    def _host_serve_columnar(self, qk: np.ndarray, koffs: np.ndarray,
                             op: str, filter_removed: bool,
                             st: "ServingState"):
        """Serve a packed (qk, koffs) batch: the native fused serve, which
        decodes, intersects (shortest list first, skipping blocks) or
        unites, and filters tombstones per query straight from the
        compressed streams; or the numpy loop when the native codec is not
        built (bit-identical; TPI_DISABLE_NATIVE forces it)."""
        rem = st.removed_host() if filter_removed else None
        dual = st.delta is not None
        if _native.available():
            s1 = self._host_tier_starts(st.tables, qk)
            if dual:
                s2 = self._host_tier_starts(st.delta_tables, qk)
                return _native.boolean_serve(
                    st.tables.words, s1, st.delta_tables.words, s2, koffs,
                    rem, op == "or")
            return _native.boolean_serve(st.tables.words, s1, None, None,
                                         koffs, rem, op == "or")
        # numpy: each tier resolved and decoded once for the batch;
        # tombstones filter each query's result, as the device does
        found, values, voffs = self._host_tier_columnar(st.tables, qk, None)
        if dual:
            f2, v2, o2 = self._host_tier_columnar(st.delta_tables, qk, None)
        out: List[np.ndarray] = []
        empty = np.zeros(0, np.uint32)
        for qi in range(len(koffs) - 1):
            rows = []
            miss = koffs[qi] == koffs[qi + 1]
            for j in range(koffs[qi], koffs[qi + 1]):
                a = values[voffs[j]: voffs[j + 1]] if found[j] else None
                if dual and f2[j]:
                    d = v2[o2[j]: o2[j + 1]]
                    a = d if a is None else np.union1d(a, d)
                if a is None:
                    miss = True
                    if op == "and":
                        break
                else:
                    rows.append(a)
            if op == "and":
                if miss or not rows:
                    res = empty
                else:
                    rows.sort(key=len)  # shortest first: stops when empty
                    res = rows[0]
                    for r in rows[1:]:
                        if len(res) == 0:
                            break
                        res = np.intersect1d(res, r, assume_unique=True)
            elif not rows:
                res = empty
            elif len(rows) == 1:
                res = rows[0]
            else:
                res = np.unique(np.concatenate(rows))
            if rem is not None and len(rem) and len(res):
                pos = np.searchsorted(rem, res)
                res = res[rem[np.minimum(pos, len(rem) - 1)] != res]
            out.append(res)
        return _rows_to_columnar(out)


def _page_columnar(values: np.ndarray, voffs: np.ndarray, P: int):
    """Full columnar results -> the pagination triple (values, voffs,
    counts): the first min(count, P) values of each row and the true
    counts."""
    counts = np.diff(voffs)
    rid = np.searchsorted(voffs, np.arange(len(values)), side="right") - 1
    keep = (np.arange(len(values)) - voffs[rid]) < P
    pvoffs = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(np.minimum(counts, P), out=pvoffs[1:])
    return values[keep], pvoffs, counts
