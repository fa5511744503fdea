#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port on one NVIDIA card: the phases of
bench.py over the port (inverted_index_2_tpu_torch), in bench.py's order.

    python3 bench_torch.py [--phases a,b,...] [--seed S] [--quick]

Phases (BASELINE.md configs): ingest (config 1, the put path), compaction
(config 2, 16 segments merged to one with tombstones), compression (the
codec's ratio), query (config 1 serving: lookup_step, boolean_step AND and
OR, prefix_range_step, one dispatch's latency), postlen1k (config 3, mean
posting length 1k: AND through K2 and through K1+K3, OR through the concat
classes), api_postlen1k (the public QueryEngine API on that corpus),
host_contended (the host route idle and beside an ingest-and-merge thread),
checkpoint (cold build, save, warm start, first answer), mesh (the
partitioned lookup and AND over every card present, each partition holding
the whole corpus), api (the public API on the config-1 corpus) and scale
(config 5: 10M terms, mean 10, device engine without tables and host engine
with them).

Sizes come from the same environment variables as bench.py (BENCH_TERMS,
BENCH_MEAN_POSTLEN, BENCH_Q, BENCH_ITERS, BENCH_POSTLEN1K_TERMS,
BENCH_SCALE_TERMS, BENCH_DIR); a flag overrides a variable. --quick runs
every phase at a size that takes seconds. Every QPS and rate is the median
of at least 5 timed repetitions; each repetition ends in
torch.cuda.synchronize(). Every serving phase holds a sample of its results
against a numpy oracle over the generated corpus and fails on a mismatch; a
failing phase makes the run exit non-zero. Without CUDA the run exits 1
with one line and measures nothing.

Each phase prints "[bench] <phase>: <seconds>" to stderr, then its peak
device memory and its kernel launches. The last line of stdout is one JSON
object: the headline keys with the prefix "cuda_", the minimum of the
floor keys, the noisy keys (spread over 25% of the median) and the card.
Everything else goes to build/bench_torch_details.json.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from inverted_index_2_tpu_torch import InvertedIndex, QueryEngine, Shard
from inverted_index_2_tpu_torch import shard as shard_mod
from inverted_index_2_tpu_torch.codec import keys as keys_mod
from inverted_index_2_tpu_torch.codec import packing
from inverted_index_2_tpu_torch.models import query_engine
from inverted_index_2_tpu_torch.models.checkpoint import (
    load_checkpoint,
    save_tables,
)
from inverted_index_2_tpu_torch.models.snapshot import (
    build_host_tables,
    upload_tables,
)
from inverted_index_2_tpu_torch.models.steps import (
    _dedup_adjacent,
    boolean_fused_step,
    boolean_step,
    lookup_step,
    prefix_range_step,
)
from inverted_index_2_tpu_torch.ops import cuda_bool, cuda_decode, cuda_fused
from inverted_index_2_tpu_torch.ops import cuda_sort
from inverted_index_2_tpu_torch.ops.cuda_concat import concat_step
from inverted_index_2_tpu_torch.parallel import mesh as pm
from inverted_index_2_tpu_torch.utils.u32 import to_device, to_numpy_u32

ROOT = os.path.dirname(os.path.abspath(__file__))
# the sidecar; the repository's BENCH_DETAILS.json is the TPU bench's record
DETAILS_PATH = os.path.join(ROOT, "build", "bench_torch_details.json")
TERM_BYTES = 12    # gen_corpus's term length
SAMPLE = 64        # results each oracle check holds
NOISY = 0.25       # a spread past this share of the median is noisy
PREFIX = "cuda_"   # the prefix of every key a card run prints

PHASES = ("ingest", "compaction", "compression", "query", "postlen1k",
          "api_postlen1k", "host_contended", "checkpoint", "mesh", "api",
          "scale")

# bench.py's headline keys, in its order (prefixed on output)
HEADLINE_KEYS = (
    "ingest_terms_per_s", "ingest_put_many_docs_per_s",
    "compaction_postings_per_s", "ratio",
    "lookup_qps", "and_qps", "or_qps", "intersect_gbps",
    "and_qps_postlen1k", "or_qps_postlen1k",
    "api_postlen1k_staged_and_dev_qps", "api_postlen1k_staged_and_qps",
    "api_postlen1k_staged_or_prefix_qps", "api_postlen1k_staged_or_qps",
    "api_postlen1k_and_qps", "api_postlen1k_and_dev_qps",
    "api_postlen1k_and_dev_bulk_qps",
    "api_postlen1k_staged_lookup_qps",
    "checkpoint_first_query_s", "checkpoint_warm_start_s",
    "api_postlen1k_staged_and_dev_zipf_qps",
    "api_postlen1k_staged_and_dev_zipf_nodedup_qps",
    "api_postlen1k_staged_or_zipf_qps",
    "api_postlen1k_staged_or_zipf_nodedup_qps",
    "api_postlen1k_staged_or_zipf_wire_qps",
    "scale_staged_and_dev_qps", "scale_staged_or_prefix_dev_qps",
    "scale_staged_lookup_dev_qps", "scale_staged_lookup_host_qps",
    "scale_terms", "scale_postings_m",
    "mesh_overhead_x", "mesh_lookup_qps",
    "host_contended_and_qps", "host_contended_or_qps",
    "checkpoint_cold_build_s",
)
# keys whose minimum repetition the last line carries too
FLOOR_KEYS = (
    "api_postlen1k_staged_and_dev_qps",
    "or_qps_postlen1k",
    "api_postlen1k_staged_or_prefix_qps",
    "api_postlen1k_staged_or_zipf_wire_qps",
)


class BenchError(RuntimeError):
    """A result disagreed with the oracle, or the run cannot measure."""


def check(cond, msg: str) -> None:
    if not cond:
        raise BenchError(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _reps(fn, reps: int = 5, sync: bool = False, *, device):
    """Wall seconds of `reps` calls of fn, each ended by a synchronise of
    `device`; sync=True drains dirty-page writeback before each call (the
    host phases that follow heavy file writes, as bench.py does)."""
    ts = []
    for _ in range(reps):
        if sync:
            os.sync()
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return ts


def _qps_stat(spreads: dict, name: str, work: float, ts) -> float:
    """Median of work / t over the repetitions; [min, median, max] goes to
    `spreads` under `name`."""
    rates = sorted(work / t for t in ts)
    med = rates[len(rates) // 2]
    spreads[name] = [rates[0], med, rates[-1]]
    if rates[0] < (1 - NOISY) * med:
        print(f"[bench] SPREAD>25% {name}: {spreads[name]}", file=sys.stderr)
    return med


@contextlib.contextmanager
def env(**kw):
    """Set (a string) or unset (None) environment variables for the block
    and restore the caller's values after it. A change of TPI_LINK_MBPS
    drops the engine's cached link probe, on entry and on exit."""
    old = {k: os.environ.get(k) for k in kw}

    def put(vals):
        for k, v in vals.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if "TPI_LINK_MBPS" in vals:
            query_engine._LINK_MBPS = None

    put(kw)
    try:
        yield
    finally:
        put(old)


def _bench_dir(prefix: str) -> str:
    """A fresh working directory under BENCH_DIR (default: the temporary
    directory)."""
    return tempfile.mkdtemp(prefix=prefix, dir=os.environ.get("BENCH_DIR"))


# ---------------------------------------------------------------------------
# corpus, queries and the oracle
# ---------------------------------------------------------------------------


def gen_corpus(n_terms: int, mean_len: int, seed: int = 0):
    """Synthetic sorted dictionary + posting lists (bench.py gen_corpus):
    12-byte terms of random lower-case letters, geometric list lengths with
    the given mean (min 1), gaps 1..1999. Returns (blob, offsets, values
    uint32, voffs)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(97, 123, size=(n_terms, TERM_BYTES), dtype=np.uint8)
    terms_mat = np.unique(raw, axis=0)
    n = len(terms_mat)
    blob = terms_mat.tobytes()
    offsets = np.arange(n + 1, dtype=np.int64) * TERM_BYTES
    lens = np.maximum(1, rng.geometric(1.0 / mean_len, size=n)).astype(np.int64)
    total = int(lens.sum())
    gaps = rng.integers(1, 2 * 1000, size=total, dtype=np.uint16)
    voffs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=voffs[1:])
    csum = np.cumsum(gaps, dtype=np.int64)
    base = csum[np.maximum(voffs[:-1] - 1, 0)]
    base[0] = 0
    # per-list rebase without np.repeat: mark list heads, cumsum to a group
    # index, gather the base
    heads = np.zeros(total, dtype=np.int8)
    heads[voffs[1:-1]] = 1
    gidx = np.cumsum(heads, dtype=np.int64)
    values = (csum - base[gidx]).astype(np.uint32)
    return blob, offsets, values, voffs


def and_oracle(lst, idxs) -> np.ndarray:
    """The AND of lists lst(i) for i in idxs, by numpy."""
    out = None
    for i in idxs:
        v = lst(int(i))
        out = v if out is None else np.intersect1d(out, v, assume_unique=True)
    return np.zeros(0, np.uint32) if out is None else out


def or_oracle(lst, idxs) -> np.ndarray:
    """The OR of lists lst(i) for i in idxs, by numpy."""
    out = np.zeros(0, np.uint32)
    for i in idxs:
        out = np.union1d(out, lst(int(i)))
    return out.astype(np.uint32)


class Oracle:
    """Exact answers over a gen_corpus tuple, by plain numpy: term i of the
    corpus is row i of a snapshot built from it (both sorted)."""

    def __init__(self, corpus):
        blob, _, self.values, self.voffs = corpus
        self.terms = np.frombuffer(blob, dtype=f"S{TERM_BYTES}")

    def lst(self, i: int) -> np.ndarray:
        return self.values[self.voffs[i]:self.voffs[i + 1]]

    def index(self, term: bytes) -> int:
        i = int(np.searchsorted(self.terms, term))
        check(i < len(self.terms) and self.terms[i] == term,
              f"term {term!r} is not in the corpus")
        return i

    def and_(self, idxs) -> np.ndarray:
        return and_oracle(self.lst, idxs)

    def or_(self, idxs) -> np.ndarray:
        return or_oracle(self.lst, idxs)

    def query(self, terms, op: str) -> np.ndarray:
        idxs = [self.index(t) for t in terms]
        return self.and_(idxs) if op == "and" else self.or_(idxs)

    def prefix_count(self, p: bytes) -> int:
        lo = np.searchsorted(self.terms, p, side="left")
        hi = np.searchsorted(self.terms, p + b"\xff" * (TERM_BYTES - len(p)),
                             side="right")
        return int(hi - lo)


def _picks(n: int, seed: int) -> np.ndarray:
    return np.sort(np.random.default_rng(seed).choice(
        n, size=min(SAMPLE, n), replace=False))


def check_rows(name: str, out, oc, need, L: int, want, picks,
               page: int = 0, dedup: bool = False) -> int:
    """Rows `picks` of a device result against the oracle: row j holds
    want(j) in out[j, :oc[j]] wherever need[j] <= L (a larger need is a
    clipped row that a caller re-serves at a larger L). With `page`, out
    holds the first `page` values and oc the true count; with `dedup`,
    out[j, :oc[j]] is the sorted stream with duplicates (the wire form).
    Returns the number of rows held."""
    picks = np.asarray(picks)
    sel = torch.as_tensor(picks, device=out.device)
    o = to_numpy_u32(out[sel])
    c = oc[sel].cpu().numpy().astype(np.int64)
    nd = (np.zeros(len(picks), np.int64) if need is None
          else need[sel].cpu().numpy().astype(np.int64))
    held = 0
    for r, j in enumerate(picks):
        if nd[r] > L:
            continue
        w = want(int(j))
        got = o[r, :min(c[r], page) if page else c[r]]
        if dedup:
            got = _dedup_adjacent(got)
            check(np.array_equal(got, w), f"{name}: row {j} differs from "
                  f"the oracle ({len(got)} values, want {len(w)})")
        else:
            check(c[r] == len(w), f"{name}: row {j} counts {c[r]}, the "
                  f"oracle {len(w)}")
            check(np.array_equal(got, w[:page] if page else w),
                  f"{name}: row {j} differs from the oracle")
        held += 1
    return held


def check_columnar(name: str, res, batches, oracle: Oracle, op: str,
                   seed: int, page: int = 0, lookup: bool = False) -> None:
    """Sampled queries of a staged stream's columnar results (one (values,
    voffs) pair a batch, or (values, voffs, counts) with `page`) against
    the oracle."""
    for bi in (0, len(batches) - 1):
        b, r = batches[bi], res[bi]
        vals, voffs = r[0], r[1]
        for j in _picks(len(b), seed + bi):
            terms = [b[j]] if lookup else b[j]
            w = oracle.query(terms, "or" if lookup else op)
            got = vals[voffs[j]:voffs[j + 1]]
            if page:
                check(int(r[2][j]) == len(w), f"{name}: batch {bi} query "
                      f"{j} counts {int(r[2][j])}, the oracle {len(w)}")
                w = w[:page]
            check(np.array_equal(got, w), f"{name}: batch {bi} query {j} "
                  "differs from the oracle")


def _sample_terms(snap, cap=50_000):
    """Reconstruct a term sample from a snapshot's key matrix."""
    step = max(1, snap.n_terms // cap)
    kb, ko = keys_mod.unpack_keys(to_numpy_u32(snap.keys[::step]))
    return [kb[ko[i]: ko[i + 1]].tobytes() for i in range(len(ko) - 1)]


def uniform_stream(rng, n_terms, n_batches, Q, k_lo=2, k_hi=9):
    """n_batches batches of Q queries, each k_lo..k_hi-1 distinct term
    indices drawn uniformly."""
    return [[rng.choice(n_terms, size=int(rng.integers(k_lo, k_hi)),
                        replace=False) for _ in range(Q)]
            for _ in range(n_batches)]


def zipf_stream(rng, n_terms, n_batches, Q, pool_n=4096):
    """Batches of term indices drawn rank-Zipf (s=1) from a pool of pool_n
    distinct queries of 2-8 terms (real query logs repeat whole
    queries)."""
    pool = [rng.choice(n_terms, size=int(rng.integers(2, 9)), replace=False)
            for _ in range(pool_n)]
    w = 1.0 / np.arange(1, len(pool) + 1, dtype=np.float64)
    w /= w.sum()
    return [[pool[i] for i in rng.choice(len(pool), size=Q, p=w)]
            for _ in range(n_batches)]


def _as_terms(terms, stream):
    return [[[terms[i] for i in q] for q in b] for b in stream]


def _boolean_stream(terms, nb, Q, seed=23, k_lo=2, k_hi=9):
    return _as_terms(terms, uniform_stream(np.random.default_rng(seed),
                                           len(terms), nb, Q, k_lo, k_hi))


def _zipf_stream(terms, n_batches, Q, pool_n, seed):
    return _as_terms(terms, zipf_stream(np.random.default_rng(seed),
                                        len(terms), n_batches, Q, pool_n))


def _to_wire(b):
    """A batch of term lists in wire form: (term bytes, term offsets,
    query offsets)."""
    blob = b"".join(t for q in b for t in q)
    toffs = np.zeros(sum(len(q) for q in b) + 1, np.int64)
    np.cumsum([len(t) for q in b for t in q], out=toffs[1:])
    qoffs = np.zeros(len(b) + 1, np.int64)
    np.cumsum([len(q) for q in b], out=qoffs[1:])
    return (np.frombuffer(blob, np.uint8), toffs, qoffs)


def build_snapshot(corpus, device):
    """Host tables, then their upload to `device`; (snap, seconds, tables)."""
    t0 = time.perf_counter()
    tables = build_host_tables(*corpus)
    snap = upload_tables(tables, device=device)
    _sync(device)
    return snap, time.perf_counter() - t0, tables


# ---------------------------------------------------------------------------
# host phases: ingest, compaction, compression
# ---------------------------------------------------------------------------


def bench_ingest(n_terms=1_000_000, batch=250_000, runs=5, *, n_routed=200_000,
                 n_docs=2000, seed=0, device="cuda", spreads=None):
    """The put path, BASELINE config 1's shape: 1M terms of one 2-byte
    prefix (one shard) through put_packed; the routed variant (random
    prefixes, config 4's shape); per-document put(); put_many in batches of
    100 documents. A host phase: `device` is not used. Each rate is the
    median of `runs` fresh-index runs."""
    spreads = {} if spreads is None else spreads
    rng = np.random.default_rng(2 + seed)
    width = TERM_BYTES
    raw = rng.integers(97, 123, size=(n_terms, width), dtype=np.uint8)
    raw[:, 0] = ord("a")
    raw[:, 1] = ord("a")  # common 2-byte prefix -> one shard
    blob = np.ascontiguousarray(raw).reshape(-1)
    raw2 = np.random.default_rng(3 + seed).integers(
        97, 123, size=(n_routed, width), dtype=np.uint8)
    blob2 = np.ascontiguousarray(raw2).reshape(-1)
    offsets2 = np.arange(n_routed + 1, dtype=np.int64) * width
    rng3 = np.random.default_rng(4 + seed)
    docs = [[bytes(rng3.integers(97, 123, size=8, dtype=np.uint8))
             for _ in range(10)] for _ in range(n_docs)]

    def timed(prefix, fn, sync):
        ts = []
        for _ in range(runs):
            d = _bench_dir(prefix)
            ii = InvertedIndex(d)
            if sync:
                os.sync()  # drain writeback out of the timed region
            t0 = time.perf_counter()
            fn(ii)
            ts.append(time.perf_counter() - t0)
            shutil.rmtree(d, ignore_errors=True)
        return ts

    def one_shard(ii):
        val = 0
        for s in range(0, n_terms, batch):
            e = min(s + batch, n_terms)
            offsets = np.arange(e - s + 1, dtype=np.int64) * width
            val += 1
            ii.put_packed(blob[s * width: e * width], offsets, val)

    def per_doc(ii):
        for i, terms in enumerate(docs):
            ii.put(terms, i + 1)

    def many(ii):
        for c0 in range(0, len(docs), 100):
            ii.put_many([(docs[i], i + 1)
                         for i in range(c0, min(c0 + 100, len(docs)))])

    t1 = timed("bench_idx_", one_shard, True)
    out = {"ingest_terms_per_s": _qps_stat(spreads, "ingest_terms_per_s",
                                           n_terms, t1),
           "ingest_s": sorted(t1)[len(t1) // 2]}
    out["ingest_routed_terms_per_s"] = _qps_stat(
        spreads, "ingest_routed_terms_per_s", n_routed,
        timed("bench_idx2_", lambda ii: ii.put_packed(blob2, offsets2, 1),
              True))
    out["ingest_doc_puts_per_s"] = _qps_stat(
        spreads, "ingest_doc_puts_per_s", n_docs,
        timed("bench_idx3_", per_doc, False))
    out["ingest_put_many_docs_per_s"] = _qps_stat(
        spreads, "ingest_put_many_docs_per_s", n_docs,
        timed("bench_idx4_", many, False))
    return out


def _merge_branch(postings: int) -> str:
    """The branch Shard.merge takes for an input of at most `postings`
    postings (it merges on the device from DEVICE_MERGE_MIN_VALUES on)."""
    return ("host" if postings < shard_mod.DEVICE_MERGE_MIN_VALUES
            else "host or device")


def bench_compaction(n_segments=16, terms_per_seg=50_000, reps=5, *, seed=0,
                     device="cuda", spreads=None):
    """BASELINE config 2: n_segments segments merged to one with tombstones
    purged. Input postings a second through the merge, the median of `reps`
    fresh shards, writeback drained before each. `compaction_merge` names
    the branch of shard.py that ran, from the merge's input against
    shard.DEVICE_MERGE_MIN_VALUES (TPI_DEVICE_MERGE_MIN, default 2M; this
    input has 800,000): under it the host merge, so `device` is not
    used."""
    spreads = {} if spreads is None else spreads
    ts, total_in = [], 0
    for _ in range(reps):
        rng = np.random.default_rng(5 + seed)
        d = _bench_dir("bench_merge_")
        sh = Shard(os.path.join(d, "0000"))
        width = 10
        for s in range(n_segments):
            raw = rng.integers(97, 123, size=(terms_per_seg, width),
                               dtype=np.uint8)
            offsets = np.arange(terms_per_seg + 1, dtype=np.int64) * width
            sh.put_packed(np.ascontiguousarray(raw).reshape(-1), offsets,
                          s + 1)
        sh.remove(np.arange(1, n_segments, 3, dtype=np.uint32))
        total_in = sum(seg.terms for seg in sh.segments.snapshot())
        os.sync()
        t0 = time.perf_counter()
        merged = sh.merge(2, n_segments)
        ts.append(time.perf_counter() - t0)
        check(merged == n_segments, f"compaction merged {merged} of "
              f"{n_segments} segments")
        sh.close()
        shutil.rmtree(d, ignore_errors=True)
    return {
        "compaction_segments": n_segments,
        "compaction_s": sorted(ts)[len(ts) // 2],
        "compaction_postings_per_s": _qps_stat(
            spreads, "compaction_postings_per_s", total_in, ts),
        "compaction_merge": _merge_branch(total_in),
    }


def bench_compression(values, voffs, *, device="cuda"):
    """The arena codec's size against raw uint32 postings (a host count)."""
    words, _ = packing.encode_bulk(values, voffs)
    ours = len(words) * 4
    raw = len(values) * 4
    return {"compressed_bytes": ours, "raw_bytes": raw, "ratio": raw / ours}


# ---------------------------------------------------------------------------
# device phases: the steps
# ---------------------------------------------------------------------------


def _tables_of(snap):
    return snap.keys, snap.blocks, snap.term_block_start, snap.counts


def bench_query(corpus, Q=10_000, iters=20, L=128, *, seed=0, device="cuda",
                spreads=None):
    """Config 1 serving through the steps: `iters` batches of Q queries
    already on the device, each batch's result reduced there to counts and
    a checksum, one synchronise at the end of a pass: batched lookup
    (lookup_step: resolve, K1), AND of 4 and of 8 terms and OR of 4
    (boolean_step: K1, then K3 or the union through K4), prefix ->
    dictionary range (prefix_range_step), and the latency of one lookup
    dispatch. Sampled rows of the first batch of each against the oracle."""
    spreads = {} if spreads is None else spreads
    oracle = Oracle(corpus)
    snap, build_s, _ = build_snapshot(corpus, device)
    n = snap.n_terms
    rng = np.random.default_rng(1 + seed)
    hk = to_numpy_u32(snap.keys)
    tables = _tables_of(snap)
    slots, mp = snap.hash_slots, snap.max_probes

    # ---- batched exact lookup ----
    idx = rng.integers(0, n, size=(iters, Q))
    staged = to_device(hk[idx], device)  # (I, Q, W+1)

    def lookup_pass():
        chk = torch.zeros((), dtype=torch.int64, device=device)
        for i in range(iters):
            f, v, c, _ = lookup_step(*tables, staged[i], L, slots, mp)
            chk += v[:, 0].sum(dtype=torch.int64) + c.sum(dtype=torch.int64)
        return chk

    lookup_pass()
    f, v, c, raw = lookup_step(*tables, staged[0], L, slots, mp)
    check(bool(f.all()), "lookup: a corpus term was not found")
    check_rows("lookup", v, c, None, L, lambda j: oracle.lst(idx[0, j])[:L],
               _picks(Q, seed))
    lookup_qps = _qps_stat(spreads, "lookup_qps", Q * iters,
                           _reps(lookup_pass, device=device))

    # single-dispatch latency: one batch, one synchronise
    dispatch = _reps(lambda: lookup_step(*tables, staged[0], L, slots, mp),
                     device=device)
    dispatch_ms = sorted(dispatch)[len(dispatch) // 2] * 1e3

    def bool_pass(st, kv, op):
        def run():
            chk = torch.zeros((), dtype=torch.int64, device=device)
            for i in range(st.shape[0]):
                o, oc, _ = boolean_step(*tables, st[i], kv, L, op, None,
                                        slots, mp)
                chk += oc.sum(dtype=torch.int64) + o[:, 0].sum(
                    dtype=torch.int64)
            return chk
        return run

    def bool_check(name, st, bidx, kv, op):
        o, oc, need = boolean_step(*tables, st[0], kv, L, op, None, slots, mp)
        want = oracle.and_ if op == "and" else oracle.or_
        check_rows(name, o, oc, need, L, lambda j: want(bidx[0, j]),
                   _picks(Q, seed + 1))

    # ---- boolean AND of 4 terms ----
    K = 4
    and_iters = max(4, iters // 2)
    bidx = rng.integers(0, n, size=(and_iters, Q, K))
    bstaged = to_device(hk[bidx], device)  # (I, Q, K, W+1)
    kv = torch.full((Q,), K, dtype=torch.int32, device=device)
    run = bool_pass(bstaged, kv, "and")
    run()
    bool_check("and", bstaged, bidx, kv, "and")
    and_ts = _reps(run, device=device)
    and_qps = _qps_stat(spreads, "and_qps", Q * and_iters, and_ts)
    mean_cnt = float(np.minimum(np.diff(corpus[3]), L).mean())
    dt = sorted(and_ts)[len(and_ts) // 2]
    and_gbps = (Q * and_iters * K * mean_cnt * 4) / dt / 1e9

    extra = {}
    # ---- prefix -> dictionary range resolution ----
    pblob, poffs = keys_mod.unpack_keys(hk[rng.integers(0, n, size=Q)])
    tb = pblob.tobytes()
    plens = rng.integers(2, 5, size=Q)
    prefixes = [
        tb[poffs[i]: poffs[i] + max(1, min(int(plens[i]),
                                           int(poffs[i + 1] - poffs[i])))]
        for i in range(Q)
    ]
    lo_k, hi_k = keys_mod.prefix_bounds(prefixes, snap.width)
    pit = max(2, iters // 2)
    plo, phi = to_device(lo_k, device), to_device(hi_k, device)

    def prefix_pass():
        chk = torch.zeros((), dtype=torch.int64, device=device)
        for _ in range(pit):
            lo, hi = prefix_range_step(snap.keys, plo, phi)
            chk += (hi - lo).sum()
        return chk

    prefix_pass()
    lo, hi = prefix_range_step(snap.keys, plo, phi)
    span = (hi - lo).cpu().numpy()
    for j in _picks(Q, seed + 2):
        check(span[j] == oracle.prefix_count(prefixes[j]),
              f"prefix_range: prefix {prefixes[j]!r} spans {span[j]} terms, "
              f"the oracle {oracle.prefix_count(prefixes[j])}")
    extra["prefix_range_qps"] = _qps_stat(spreads, "prefix_range_qps",
                                          Q * pit, _reps(prefix_pass,
                                                         device=device))

    # ---- AND of 8 terms, OR of 4 (config 3 spans 2-8 terms, both ops) ----
    for K2, op, name in ((8, "and", "and8_qps"), (4, "or", "or_qps")):
        it2 = max(2, and_iters // 2)
        bi = rng.integers(0, n, size=(it2, Q, K2))
        st2 = to_device(hk[bi], device)
        kv2 = torch.full((Q,), K2, dtype=torch.int32, device=device)
        run = bool_pass(st2, kv2, op)
        run()
        bool_check(name, st2, bi, kv2, op)
        extra[name] = _qps_stat(spreads, name, Q * it2,
                                _reps(run, device=device))

    return {
        "snapshot_build_s": build_s,
        "lookup_qps": lookup_qps,
        "lookup_dispatch_ms": dispatch_ms,
        "and_qps": and_qps,
        **extra,
        "intersect_gbps": and_gbps,
        "n_terms": n,
        "n_postings": int(corpus[3][-1]),
    }


# the concat classes of the config-3 OR: total blocks a query, as bench.py
_OR_CLASSES = (32, 64, 128, 512, 1024)


def bench_postlen1k(corpus, snap, build_s, Q=2048, iters=12, L=2048, *,
                    seed=0, device="cuda", spreads=None):
    """BASELINE config 3's shape: AND and OR of 2-8 terms over posting
    lists of mean length 1k, L=2048 (longer lists re-serve at a ladder
    level; the re-serve fraction is reported). `iters` batches of Q
    queries on the device, reduced there to counts and a checksum:
      * AND through K2 (boolean_fused_step, the first 32 members: the
        serving form), and_qps_postlen1k (= _fused), its re-serve fraction
        (the smallest list past L);
      * AND through K1 + K3 (boolean_step), _sort, its re-serve fraction
        (the longest list past L);
      * OR padded (boolean_step: K1, the union through K4);
      * OR through the concat classes (the serving form, sized by each
        query's real postings: decode, K4 sort from 128-lane runs, the
        stream with duplicates that the host drops), all classes in one
        pass, and with the compaction on the device;
      * the fused AND's fixed cost a query, over a corpus of the same term
        count whose lists are all one block.
    Sampled rows of each against the oracle."""
    spreads = {} if spreads is None else spreads
    oracle = Oracle(corpus)
    n = snap.n_terms
    hk = to_numpy_u32(snap.keys)
    tables = _tables_of(snap)
    slots, mp = snap.hash_slots, snap.max_probes
    rng = np.random.default_rng(seed + 12)
    out = {
        "postlen1k_n_terms": n,
        "postlen1k_build_s": build_s,
        "postlen1k_snapshot_mb": snap.device_bytes() / 1e6,
    }
    K = 8
    kvs = rng.integers(2, K + 1, size=(iters, Q)).astype(np.int32)
    bidx = rng.integers(0, n, size=(iters, Q, K))
    staged = to_device(hk[bidx], device)
    kvs_d = to_device(kvs, device)

    def want(op):
        f = oracle.and_ if op == "and" else oracle.or_
        return lambda j: f(bidx[0, j, :kvs[0, j]])

    def step(op, st_tabs, qk, kv):
        t_keys, t_blocks, t_tbs, t_counts, t_slots, t_mp = st_tabs
        if op == "fused_and":
            small, oc, need, oc_pre = boolean_fused_step(
                t_keys, t_blocks, t_tbs, t_counts, qk, kv, L, None, t_slots,
                t_mp, small_p=32)
            return small, oc_pre, need
        return boolean_step(t_keys, t_blocks, t_tbs, t_counts, qk, kv, L, op,
                            None, t_slots, t_mp)

    main_tabs = (*tables, slots, mp)

    def bool_pass(op, st_tabs, st):
        def run():
            chk = torch.zeros((), dtype=torch.int64, device=device)
            nres = torch.zeros((), dtype=torch.int64, device=device)
            for i in range(iters):
                o, oc, need = step(op, st_tabs, st[i], kvs_d[i])
                chk += oc.sum(dtype=torch.int64) + o[:, 0].sum(
                    dtype=torch.int64)
                nres += (need > L).sum()
            return chk, nres
        return run

    for op, name, frac_name, want_op in (
            ("fused_and", "and_qps_postlen1k_fused", "postlen1k_reserve_frac",
             "and"),
            ("and", "and_qps_postlen1k_sort", "postlen1k_reserve_frac_sort",
             "and"),
            ("or", "or_qps_postlen1k_padded", None, "or")):
        run = bool_pass(op, main_tabs, staged)
        _, nres = run()
        o, oc, need = step(op, main_tabs, staged[0], kvs_d[0])
        check_rows(name, o, oc, need, L, want(want_op), _picks(Q, seed + 3),
                   page=32 if op == "fused_and" else 0)
        out[name] = _qps_stat(spreads, name, Q * iters,
                              _reps(run, device=device))
        if frac_name:
            out[frac_name] = int(nres) / (Q * iters)
    # the production AND on the card is K2's (QueryEngine's fused path)
    out["and_qps_postlen1k"] = out["and_qps_postlen1k_fused"]

    # fixed cost a query: the same fused pass over one-block lists
    tiny = gen_corpus(n, 2, seed=seed + 18)
    tsnap, _, _ = build_snapshot(tiny, device)
    tstaged = to_device(to_numpy_u32(tsnap.keys)[bidx % tsnap.n_terms],
                        device)
    trun = bool_pass("fused_and", (*_tables_of(tsnap), tsnap.hash_slots,
                                   tsnap.max_probes), tstaged)
    trun()
    tiny_qps = _qps_stat(spreads, "fused_tiny_qps", Q * iters,
                         _reps(trun, device=device))
    out["fused_overhead_us_per_q"] = 1e6 / tiny_qps
    del tsnap, tstaged, trun

    # OR through the concat classes, each query at its real total blocks
    hc64 = snap.host_counts.astype(np.int64)
    flat_idx = bidx.reshape(-1, K).astype(np.int32)
    kv_flat = kvs.reshape(-1)
    kmask_f = np.arange(K)[None, :] < kv_flat[:, None]
    sbq = (-(-np.where(kmask_f, hc64[flat_idx], 0) // 128)).sum(axis=1)
    order_q = np.argsort(sbq, kind="stable")
    stride = max(128, int(snap.blocks.shape[1]))
    work, pos = [], 0
    for SB in _OR_CLASSES:
        hi_i = int(np.searchsorted(sbq[order_q], SB, side="right"))
        members = order_q[pos:hi_i]
        pos = hi_i
        # batches that fill the re-serve budget (a per-step fixed cost
        # dominates small ones)
        B = max(128, min(2048, ((1 << 24) // (SB * stride)) // 8 * 8))
        B = min(B, (len(members) // 128) * 128)  # small class: one step
        if B == 0:
            continue
        nt = len(members) // B
        m = members[: nt * B].reshape(nt, B)
        work.append((SB, m, to_device(flat_idx[m].astype(np.int64), device),
                     torch.ones(m.shape + (K,), dtype=torch.bool,
                                device=device),
                     to_device(kv_flat[m], device)))
    covered = sum(w[1].size for w in work)

    def or_pass(wire_dedup):
        def run():
            chk = torch.zeros((), dtype=torch.int64, device=device)
            for SB, m, bi, bf, bk in work:
                rows = torch.arange(m.shape[1], dtype=torch.int32,
                                    device=device)
                for t in range(bi.shape[0]):
                    o, oc = concat_step(
                        snap.blocks, snap.term_block_start, snap.counts,
                        bi[t], bf[t], bk[t], rows, SB, "or",
                        wire_dedup=wire_dedup)
                    chk += oc.sum(dtype=torch.int64) + o[:, 0].sum(
                        dtype=torch.int64)
            return chk
        return run

    if covered >= (iters * Q) // 2:
        for SB, m, bi, bf, bk in work:
            o, oc = concat_step(
                snap.blocks, snap.term_block_start, snap.counts, bi[0], bf[0],
                bk[0], torch.arange(m.shape[1], dtype=torch.int32,
                                    device=device), SB, "or", wire_dedup=True)
            q = m[0]
            check_rows(f"or_concat SB={SB}", o, oc, None, L,
                       lambda j: oracle.or_(flat_idx[q[j], :kv_flat[q[j]]]),
                       _picks(len(q), seed + SB), dedup=True)
        for name, wd in (("or_qps_postlen1k", True),
                         ("or_qps_postlen1k_devcompact", False)):
            run = or_pass(wd)
            run()
            out[name] = _qps_stat(spreads, name, covered,
                                  _reps(run, device=device))
        out["or_postlen1k_covered_frac"] = covered / (iters * Q)
    else:  # a degenerate class mix: the padded number stands in
        out["or_qps_postlen1k"] = out["or_qps_postlen1k_padded"]
    # the posting bytes an AND batch must consider (every queried term's
    # true length), a second
    kmask = np.arange(K)[None, None, :] < kvs[:, :, None]
    qbytes = (np.where(kmask, hc64[bidx], 0).sum() * 4) / (iters * Q)
    out["intersect_gbps_postlen1k"] = out["and_qps_postlen1k"] * qbytes / 1e9
    return out


# ---------------------------------------------------------------------------
# the public API
# ---------------------------------------------------------------------------


def bench_checkpoint(corpus, *, device="cuda"):
    """Warm start from a serving checkpoint: the cold build (host tables,
    then their upload), the save, the load and upload a restart pays, and
    from_checkpoint's time to its first answer, which the host tables give
    while the arena uploads on a side stream; then the upload's end."""
    oracle = Oracle(corpus)
    workdir = _bench_dir("bench_ckpt_")
    path = os.path.join(workdir, "serving.ckpt")
    try:
        t0 = time.perf_counter()
        tables = build_host_tables(*corpus)
        host_build_s = time.perf_counter() - t0
        snap = upload_tables(tables, device=device)
        _sync(device)
        cold_s = time.perf_counter() - t0
        del snap
        t0 = time.perf_counter()
        save_tables(tables, path)
        save_s = time.perf_counter() - t0
        size_mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        tables2, _ = load_checkpoint(path)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        snap = upload_tables(tables2, device=device)
        _sync(device)
        upload_s = time.perf_counter() - t0
        del snap
        kb, ko = keys_mod.unpack_keys(tables2.keys[:64])
        qterms = [kb[ko[i]: ko[i + 1]].tobytes()
                  for i in range(min(8, len(ko) - 1))]
        t0 = time.perf_counter()
        eng = QueryEngine.from_checkpoint(path, L=128, device=device)
        r = eng.boolean([qterms[:2], qterms[2:5]], "or")
        first_q_s = time.perf_counter() - t0
        eng.device_wait()
        swap_s = time.perf_counter() - t0
        for got, q in zip(r, (qterms[:2], qterms[2:5])):
            check(np.array_equal(got, oracle.query(q, "or")),
                  "checkpoint: the first answer differs from the oracle")
        after = eng.boolean([qterms[:2]], "or")[0]
        check(np.array_equal(after, r[0]),
              "checkpoint: the answer changed across the upload")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {
        "checkpoint_mb": size_mb,
        "checkpoint_save_s": save_s,
        "checkpoint_load_s": load_s,
        "checkpoint_upload_s": upload_s,
        "checkpoint_warm_start_s": load_s + upload_s,
        "checkpoint_first_query_s": first_q_s,
        "checkpoint_device_swap_s": swap_s,
        "checkpoint_cold_build_s": cold_s,
        "checkpoint_host_tables_s": host_build_s,
    }


def bench_api(corpus, Q=4096, iters=3, L=128, name="api", snap=None,
              tables=None, *, stream_q=8192, stream_nb=12, pool=4096,
              seed=0, device="cuda", spreads=None):
    """QueryEngine through its public API: query packing, dispatch, result
    download and exact ladder re-serves. `tables` retains the compact host
    tables, as from_index does (the host route and the router); without
    them every op is device-routed. One-shot boolean AND on the route the
    router picks and pinned to the device; the staged AND stream, uniform
    and Zipf, with the staged dedup on and off; full-result OR, OR pages
    (prefix_p=32), Zipf OR with the host dedup on and off and in wire form;
    lookup_staged. Every environment pin is restored after its block."""
    spreads = {} if spreads is None else spreads
    oracle = Oracle(corpus)
    if snap is None:
        snap, _, tables = build_snapshot(corpus, device)
    eng = QueryEngine(snap, L=L, tables=tables, device=device)
    terms = _sample_terms(snap)
    rng = np.random.default_rng(13 + seed)
    batches = []
    for _ in range(iters):
        batches.append([[terms[i] for i in rng.choice(
            len(terms), size=int(rng.integers(2, 9)), replace=False)]
            for _ in range(Q)])
    sq = max(Q, stream_q)
    out = {}

    def timed(key, work, fn, reps=5, sync=False, warm=True):
        if warm:  # with the timed work itself
            fn()
        out[key] = _qps_stat(spreads, key, work,
                             _reps(fn, reps, sync, device=device))

    def one_shot(qs, key):
        got = eng.boolean(qs, op="and")
        for j in _picks(len(qs), seed):
            check(np.array_equal(got[j], oracle.query(qs[j], "and")),
                  f"{key}: query {j} differs from the oracle")

    one_shot(batches[0], f"{name}_and_qps")
    timed(f"{name}_and_qps", Q * iters,
          lambda: [eng.boolean(qs, op="and") for qs in batches])
    if tables is not None:
        with env(TPI_HOST_BOOL="0"):  # the device route, pinned
            one_shot(batches[0], f"{name}_and_dev_qps")
            timed(f"{name}_and_dev_qps", Q * iters,
                  lambda: [eng.boolean(qs, op="and") for qs in batches])
            bulk = _boolean_stream(terms, 1, sq, seed=19 + seed)[0]
            one_shot(bulk, f"{name}_and_dev_bulk_qps")
            timed(f"{name}_and_dev_bulk_qps", sq,
                  lambda: eng.boolean(bulk, op="and"))

    def staged(key, stream, op, sync=False, check_p=0, **kw):
        # the warm pass, held against the oracle
        res = eng.boolean_staged(stream, op, columnar=True, **kw)
        check_columnar(key, res, stream, oracle, op, seed, page=check_p)
        timed(key, sum(len(b) for b in stream),
              lambda: eng.boolean_staged(stream, op, columnar=True, **kw),
              sync=sync, warm=False)

    stream = _boolean_stream(terms, stream_nb, sq, seed=17 + seed)
    staged(f"{name}_staged_and_qps", stream, "and", depth=3)
    if tables is not None:
        with env(TPI_HOST_BOOL="0"):
            dev_stream = stream + stream
            staged(f"{name}_staged_and_dev_qps", dev_stream, "and", depth=4)
            zipf = _zipf_stream(terms, len(dev_stream), sq, pool,
                                seed=29 + seed)
            staged(f"{name}_staged_and_dev_zipf_qps", zipf, "and", depth=4)
            with env(TPI_STAGED_DEDUP="0"):
                staged(f"{name}_staged_and_dev_zipf_nodedup_qps", zipf,
                       "and", depth=4)
    # full-result OR: with tables the router serves it on the host
    or_stream = (stream[:2] if tables is not None
                 else [b[:2048] for b in stream[:2]])
    staged(f"{name}_staged_or_qps", or_stream, "or")
    staged(f"{name}_staged_or_prefix_qps", stream + stream, "or",
           check_p=32, prefix_p=32, depth=4)
    if tables is not None:
        zor = _zipf_stream(terms, 2, sq, pool, seed=31 + seed)
        staged(f"{name}_staged_or_zipf_qps", zor, "or", sync=True)
        with env(TPI_HOST_DEDUP="0"):
            staged(f"{name}_staged_or_zipf_nodedup_qps", zor, "or",
                   sync=True)
        zorw = [_to_wire(b) for b in zor]
        res = eng.boolean_staged(zorw, "or", columnar=True)
        check_columnar(f"{name}_staged_or_zipf_wire_qps", res, zor, oracle,
                       "or", seed)
        timed(f"{name}_staged_or_zipf_wire_qps", len(zorw) * sq,
              lambda: eng.boolean_staged(zorw, "or", columnar=True),
              sync=True, warm=False)
    lk_stream = [[q[0] for q in b] for b in stream[:4]]
    res = eng.lookup_staged(lk_stream, columnar=True, depth=3)
    check_columnar(f"{name}_staged_lookup_qps", res, lk_stream, oracle, "or",
                   seed, lookup=True)
    timed(f"{name}_staged_lookup_qps", sum(len(b) for b in lk_stream),
          lambda: eng.lookup_staged(lk_stream, columnar=True, depth=3),
          warm=False)
    return out


def bench_host_contended(corpus, snap, tables, Q=8192, nb=6, *, seed=0,
                         device="cuda", spreads=None):
    """The host route's staged AND and full-result OR (TPI_HOST_BOOL=all),
    idle and then while a thread ingests documents and merges (the same
    interpreter and cores). The contender's merges run through the port's
    shard.py: host_contended_merges counts them, host_contended_merge names
    the branch they took, from the postings the contender wrote (no merge
    input holds more)."""
    spreads = {} if spreads is None else spreads
    oracle = Oracle(corpus)
    eng = QueryEngine(snap, L=2048, tables=tables, device=device)
    stream = _boolean_stream(_sample_terms(snap), nb, Q, seed=23 + seed)
    or_stream = stream[:2]
    out = {}
    stop = threading.Event()
    failed = []
    written, merges = [0], [0]
    cdir = _bench_dir("contend")

    def contender():
        try:
            ii = InvertedIndex(cdir)
            vocab = [f"c{i:05d}".encode() for i in range(2000)]
            r2 = np.random.default_rng(5 + seed)
            doc = 0
            while not stop.is_set():
                doc += 1
                terms = [vocab[i] for i in r2.integers(0, 2000, size=30)]
                ii.put(terms, doc)
                written[0] += len(set(terms))
                if doc % 50 == 0:
                    ii.merge(2, 10_000, 1)
                    merges[0] += 1
        except BaseException as e:  # reported after the join
            failed.append(e)

    def timed(key, st, op):
        out[key] = _qps_stat(spreads, key, len(st) * Q, _reps(
            lambda: eng.boolean_staged(st, op, columnar=True), 5, True,
            device=device))

    th = threading.Thread(target=contender, daemon=True)
    try:
        with env(TPI_HOST_BOOL="all"):
            for op, st in (("and", stream), ("or", or_stream)):
                res = eng.boolean_staged(st, op, columnar=True)
                check_columnar(f"host_idle_{op}_qps", res, st, oracle, op,
                               seed)
            timed("host_idle_and_qps", stream, "and")
            timed("host_idle_or_qps", or_stream, "or")
            th.start()
            time.sleep(1.0)  # let the contender ramp up
            timed("host_contended_and_qps", stream, "and")
            timed("host_contended_or_qps", or_stream, "or")
            res = eng.boolean_staged(stream[:1], "and", columnar=True)
            check_columnar("host_contended_and_qps", res, stream[:1], oracle,
                           "and", seed)
    finally:
        stop.set()
        th.join(timeout=120)
        shutil.rmtree(cdir, ignore_errors=True)
    check(not th.is_alive(), "the contender did not stop")
    if failed:
        raise failed[0]
    out["host_contended_merges"] = merges[0]
    out["host_contended_merge"] = _merge_branch(written[0])
    return out


def bench_mesh(corpus, Q=10_000, iters=8, L=128, *, seed=0, device="cuda",
               spreads=None):
    """The partitioned lookup over every card present
    (parallel.mesh.default_mesh; D partitions, each holding the whole
    corpus, so a partition's rate compares across D): the psum form and
    the reduce-scatter form, the same-shape lookup_step on one unpartitioned
    snapshot (mesh_overhead_x is its rate over the scatter form's), and the
    reduce-scatter AND of 4 terms. Each pass is `iters` calls and one
    synchronise; sampled rows against the oracle."""
    spreads = {} if spreads is None else spreads
    oracle = Oracle(corpus)
    mesh = pm.default_mesh(None, device)
    D = len(mesh)
    tables = build_host_tables(*corpus)
    t0 = time.perf_counter()
    snap = pm.stack_tables([tables] * D, mesh)
    for dev in set(mesh):  # a device may repeat in the mesh
        _sync(dev)
    freeze_s = time.perf_counter() - t0
    rng = np.random.default_rng(7 + seed)
    hk = tables.keys
    n = tables.n_terms
    qi = rng.integers(0, n, size=Q)
    qk = to_device(hk[qi], mesh[0])
    out = {
        "mesh_devices": D,
        "mesh_freeze_s": freeze_s,
        "mesh_words_mb": D * tables.words.nbytes / 1e6,
        "mesh_arena_mb": sum(b.numel() for b in snap.blocks) * 4 / 1e6,
    }

    def passes(key, call, work):
        def run():
            for _ in range(iters):
                call()
            for dev in set(mesh):
                _sync(dev)
        run()
        out[key] = _qps_stat(spreads, key, work * iters,
                             _reps(run, device=device))

    for key, fac in (("mesh_lookup_qps", pm.make_sharded_lookup),
                     ("mesh_lookup_rs_qps", pm.make_sharded_lookup_scatter)):
        lookup = fac(snap, L)
        f, v, c, _ = lookup(qk)
        check(bool(f.all()), f"{key}: a corpus term was not found")
        check_rows(key, v, c, None, L, lambda j: oracle.lst(qi[j])[:L],
                   _picks(Q, seed))
        passes(key, lambda lookup=lookup: lookup(qk), Q)
    psnap = upload_tables(tables, device=mesh[0])
    qk1 = qk.clone()
    passes("plain_lookup_same_shape_qps", lambda: lookup_step(
        *_tables_of(psnap), qk1, L, psnap.hash_slots, psnap.max_probes), Q)
    out["mesh_overhead_x"] = (out["plain_lookup_same_shape_qps"]
                              / out["mesh_lookup_rs_qps"])
    del psnap
    Qb, Kb = 2048, 4
    bi = rng.integers(0, n, size=(Qb, Kb))
    bq = to_device(hk[bi], mesh[0])
    kv = torch.full((Qb,), Kb, dtype=torch.int32, device=mesh[0])
    rs_and = pm.make_sharded_boolean_scatter(snap, L, "and")
    o, oc, need = rs_and(bq, kv)
    check_rows("mesh_and_rs_qps", o, oc, need, L,
               lambda j: oracle.and_(bi[j]), _picks(Qb, seed + 1))
    passes("mesh_and_rs_qps", lambda: rs_and(bq, kv), Qb)
    return out


def bench_scale(n_terms=10_000_000, Q=8192, nb=6, L=128, *, seed=0,
                device="cuda", spreads=None):
    """BASELINE config 5's shape on one card: 10M terms of mean length 10
    (~100M postings), batches of Q queries. The device engine holds no
    tables, so every staged stream is device-routed: AND, OR pages
    (prefix_p=32) and lookup_staged; the host engine (tables retained)
    serves lookup_staged and, pinned, the staged AND."""
    spreads = {} if spreads is None else spreads
    corpus = gen_corpus(n_terms, 10, seed=29 + seed)
    oracle = Oracle(corpus)
    t0 = time.perf_counter()
    tables = build_host_tables(*corpus)
    tables_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    snap = upload_tables(tables, device=device)
    _sync(device)
    upload_s = time.perf_counter() - t0
    out = {
        "scale_terms": int(tables.n_terms),
        "scale_postings_m": float(corpus[3][-1]) / 1e6,
        "scale_tables_build_s": tables_s,
        "scale_upload_s": upload_s,
        "scale_hbm_gb": snap.device_bytes() / 1e9,
    }
    dev_eng = QueryEngine(snap, L=L, device=device)  # no tables: the card
    terms = _sample_terms(snap)
    stream = _boolean_stream(terms, nb, Q, seed=29 + seed)
    lk_stream = [[q[0] for q in b] for b in stream[:4]]
    dev_eng.warmup(k_max=8)

    def timed(key, eng, st, fn, op, page=0, lookup=False, sync=False):
        res = fn()  # warm with the timed stream itself
        check_columnar(key, res, st, oracle, op, seed, page=page,
                       lookup=lookup)
        out[key] = _qps_stat(spreads, key, sum(len(b) for b in st),
                             _reps(fn, 5, sync, device=device))
        return res

    timed("scale_staged_and_dev_qps", dev_eng, stream, lambda:
          dev_eng.boolean_staged(stream, "and", columnar=True, depth=4),
          "and")
    timed("scale_staged_or_prefix_dev_qps", dev_eng, stream, lambda:
          dev_eng.boolean_staged(stream, "or", columnar=True, prefix_p=32,
                                 depth=4), "or", page=32)
    lk_res = timed("scale_staged_lookup_dev_qps", dev_eng, lk_stream,
                   lambda: dev_eng.lookup_staged(lk_stream, columnar=True,
                                                 depth=4), "or", lookup=True)
    lk_postings = int(sum(int(v[1][-1]) for v in lk_res))
    out["scale_lookup_postings_per_q"] = lk_postings / (len(lk_stream) * Q)
    host_eng = QueryEngine(snap, L=L, tables=tables, device=device)
    timed("scale_staged_lookup_host_qps", host_eng, lk_stream, lambda:
          host_eng.lookup_staged(lk_stream, columnar=True), "or",
          lookup=True, sync=True)
    with env(TPI_HOST_BOOL="all"):
        timed("scale_staged_and_host_qps", host_eng, stream, lambda:
              host_eng.boolean_staged(stream, "and", columnar=True), "and",
              sync=True)
    return out


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def sizes(quick: bool) -> dict:
    """The run's sizes: bench.py's defaults and BENCH_* variables, or the
    --quick sizes (each phase in seconds)."""
    e = os.environ.get
    if quick:
        return dict(terms=20_000, mean_len=10, Q=1024, iters=5,
                    ingest=dict(n_terms=50_000, batch=25_000,
                                n_routed=20_000, n_docs=50),
                    compaction=dict(terms_per_seg=2_000),
                    postlen1k_terms=2_000,
                    postlen1k=dict(Q=256, iters=5),
                    api_postlen1k=dict(Q=256, iters=2, stream_q=512,
                                       stream_nb=3, pool=512),
                    host_contended=dict(Q=512, nb=2),
                    mesh=dict(Q=1024, iters=2),
                    api=dict(Q=512, iters=2, stream_q=512, stream_nb=3,
                             pool=512),
                    scale=dict(n_terms=50_000, Q=512, nb=2))
    return dict(terms=int(e("BENCH_TERMS", 1_000_000)),
                mean_len=int(e("BENCH_MEAN_POSTLEN", 10)),
                Q=int(e("BENCH_Q", 10_000)),
                iters=int(e("BENCH_ITERS", 20)),
                ingest={}, compaction={},
                postlen1k_terms=int(e("BENCH_POSTLEN1K_TERMS", 200_000)),
                postlen1k={},
                api_postlen1k=dict(Q=1024, iters=2),
                host_contended={},
                mesh={},
                api={},
                scale=dict(n_terms=int(e("BENCH_SCALE_TERMS", 10_000_000))))


def card_info() -> dict:
    """The card this run measures: torch's name and count, and nvidia-smi's
    name and power limit."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    limit = smi.rsplit(",", 1)[1].strip()
    return {"name": torch.cuda.get_device_name(0), "smi": smi,
            "power_limit_w": float(limit.split()[0]),
            "count": torch.cuda.device_count()}


_COUNTERS = {"K1": cuda_decode.decode_postings, "K2": cuda_fused.fused_and,
             "K3": cuda_bool.intersect_many, "K4": cuda_sort.sort_rows}


def _reset_peak(device) -> None:
    torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device))


def emit(details: dict, spreads: dict, card: dict, meta: dict):
    """Write every measured key (with the prefix), its spread, and `meta`
    (phase times, peaks, launch counts, sizes) to the sidecar
    (DETAILS_PATH), then print the headline line: the headline keys, the
    floor keys' minimum, the noisy keys and the card."""
    path = DETAILS_PATH
    noisy = sorted(PREFIX + k for k, (lo, med, hi) in spreads.items()
                   if med and max(med - lo, hi - med) > NOISY * med)
    side = {PREFIX + k: v for k, v in details.items()}
    side["spreads"] = {PREFIX + k: v for k, v in spreads.items()}
    side["noisy"] = noisy
    side["device"] = card
    side.update(meta)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(side, f, indent=1, default=float)
    head = {PREFIX + k: details[k] for k in HEADLINE_KEYS if k in details}
    for k in FLOOR_KEYS:
        if k in spreads:
            head[PREFIX + k + "_min"] = spreads[k][0]
    head["noisy"] = noisy
    head["device"] = {"name": card["name"],
                      "power_limit_w": card["power_limit_w"],
                      "count": card["count"]}
    head["details_file"] = os.path.relpath(path, ROOT)
    print(json.dumps(head, separators=(",", ":"), default=float))
    return head


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run, of: "
                    + ", ".join(PHASES))
    ap.add_argument("--seed", type=int, default=0,
                    help="added to every seed of the generated data")
    ap.add_argument("--quick", action="store_true",
                    help="every phase at a size that takes seconds")
    args = ap.parse_args(argv)
    want = [p for p in args.phases.split(",") if p]
    bad = sorted(set(want) - set(PHASES))
    if bad:
        ap.error(f"unknown phases {bad}")
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device; the bench measures the card and "
              "does not run on the CPU", file=sys.stderr)
        return 1
    card = card_info()
    dev = "cuda"
    sz = sizes(args.quick)
    seed = args.seed
    spreads: dict = {}
    details: dict = {}
    meta: dict = {"phase_s": {}, "phase_peak_bytes": {},
                  "phase_launches": {}, "sizes": sz, "seed": seed}
    start = time.perf_counter()

    def phase(label, fn, *a, **kw):
        _reset_peak(dev)
        for c in _COUNTERS.values():
            c.launches = 0
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        _sync(dev)
        dt = time.perf_counter() - t0
        launches = {k: c.launches for k, c in _COUNTERS.items()}
        meta["phase_s"][label] = dt
        meta["phase_peak_bytes"][label] = _peak(dev)
        meta["phase_launches"][label] = launches
        print(f"[bench] {label}: {dt:.6f}", file=sys.stderr)
        print(f"[bench] {label}: max_memory_allocated "
              f"{meta['phase_peak_bytes'][label]} bytes, launches "
              f"{launches}", file=sys.stderr)
        return res

    skw = dict(seed=seed, device=dev, spreads=spreads)
    corpus = phase("gen_corpus", gen_corpus, sz["terms"], sz["mean_len"],
                   seed)
    if "ingest" in want:
        details.update(phase("ingest", bench_ingest, **sz["ingest"], **skw))
    if "compaction" in want:
        details.update(phase("compaction", bench_compaction,
                             **sz["compaction"], **skw))
    if "compression" in want:
        details.update(phase("compression", bench_compression, corpus[2],
                             corpus[3], device=dev))
    if "query" in want:
        details.update(phase("query", bench_query, corpus, sz["Q"],
                             sz["iters"], **skw))
    if {"postlen1k", "api_postlen1k", "host_contended"} & set(want):
        c1k = phase("gen_postlen1k", gen_corpus, sz["postlen1k_terms"], 1000,
                    11 + seed)
        snap1k, build1k_s, tables1k = phase("snap_postlen1k", build_snapshot,
                                            c1k, dev)
        if "postlen1k" in want:
            details.update(phase("postlen1k", bench_postlen1k, c1k, snap1k,
                                 build1k_s, **sz["postlen1k"], **skw))
        if "api_postlen1k" in want:
            details.update(phase(
                "api_postlen1k", bench_api, c1k, L=2048, name="api_postlen1k",
                snap=snap1k, tables=tables1k, **sz["api_postlen1k"], **skw))
        if "host_contended" in want:
            details.update(phase("host_contended", bench_host_contended, c1k,
                                 snap1k, tables1k, **sz["host_contended"],
                                 **skw))
        # free the config-3 corpus before the next ones are built
        del c1k, snap1k, tables1k
    if "checkpoint" in want:
        details.update(phase("checkpoint", bench_checkpoint, corpus,
                             device=dev))
    if "mesh" in want:
        details.update(phase("mesh", bench_mesh, corpus,
                             **{"Q": sz["Q"], **sz["mesh"]}, **skw))
    if "api" in want:
        details.update(phase("api", bench_api, corpus, **sz["api"], **skw))
    if "scale" in want:
        del corpus
        details.update(phase("scale", bench_scale, **sz["scale"], **skw))
    meta["wall_s"] = time.perf_counter() - start
    print(f"[bench] total: {meta['wall_s']:.6f}", file=sys.stderr)
    emit(details, spreads, card, meta)
    return 0


if __name__ == "__main__":
    sys.exit(main())
