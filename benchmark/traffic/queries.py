"""The general generator of boolean query traffic: every mix of this kind
(a .json file beside this one) names it and gives its parameters, and the
harness (benchmark/harness.py) serves and checks the mix through the
functions below. A generator of another kind of traffic is another module
here with the same functions.

A mix describes batched boolean queries over a corpus (benchmark/corpus.py):

    op               "and" or "or"
    prefix_p         0 for full results; P > 0 for a page of the first P ids
                     and the true count
    depth            batches in flight in one boolean_staged call
    batch_q          queries in a batch
    batches_per_call batches in one call
    pool             distinct queries for the window: the first
                     min(MAX_CALLS, pool // (batch_q * batches_per_call))
                     calls' worth of them are made into calls, each query
                     once, and a window that outlasts them serves them again
    warmup_calls     calls for set-up, of queries that are not in the pool
    term_draw        "df": each term drawn in proportion to its document
                     frequency among the indexed ranks, k terms a query with
                     k uniform on terms_per_query = [lo, hi], no term twice;
                     "bins": two terms a query, each uniform in a band of
                     document frequency (bins: name -> [lo, hi) as shares of
                     D), the pairs of `tasks` in equal shares
    stream_seed      fixes the queries in rank space
    check            per_class: how many answers of each class the check
                     compares (classes(), below)

No query appears twice in a pool. The queries, in ranks, come from
stream_seed alone, so every run serves the same set of query sizes; the
run's seed picks the terms behind the ranks and the documents (the corpus)
and the order in which the window's queries arrive. Warm-up queries share
no query with the window.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

# the benchmark's folder is on the path (harness.py)
import work
from codec_bytes import BLOCK

# Each window is made of at most this many calls: a call lasts 0.25 s or
# more (a time on the host's clock has to), so a window of 51 s, the most a
# run may measure, serves fewer; a longer window serves them again.
MAX_CALLS = 160
# The paths of the staged server that classes() names: the fast path's pad
# (the engine's default L), the ladder's cap (cuda_fused.MAX_LEVEL) and the
# largest budget of the concat classes, in blocks.
PAD_IDS = 1024
LADDER_MAX_IDS = 16384
CONCAT_MAX_BLOCKS = 32768

_MULT = np.uint64(0x9E3779B97F4A7C15)


@dataclass
class Stream:
    """A mix made for one corpus and seed. Rows of `qpos` are the window's
    queries in the order they are sent: call c, batch b, row i is row
    (c * batches_per_call + b) * batch_q + i."""

    op: str
    prefix_p: int
    depth: int
    batch_q: int
    batches_per_call: int
    warm: List[list]          # calls of wire batches, for set-up
    calls: List[list]         # calls of wire batches, for the window
    qpos: np.ndarray          # (N, K) int64 term positions, -1 past kv
    kv: np.ndarray            # (N,) int64 terms per query
    qid: np.ndarray           # (N,) int64 the query's index in the pool

    @property
    def queries_per_call(self) -> int:
        return self.batch_q * self.batches_per_call


def _canon_hash(ranks: np.ndarray) -> np.ndarray:
    """A 64-bit hash of each row's sorted ranks (-1 padding sorts first)."""
    s = np.sort(ranks, axis=1).astype(np.uint64)
    h = np.zeros(len(s), np.uint64)
    with np.errstate(over="ignore"):
        for c in range(s.shape[1]):
            h = (h ^ (s[:, c] + np.uint64(c + 1))) * _MULT
            h ^= h >> np.uint64(29)
    return h


def _draw(rng, cdf, m: int) -> np.ndarray:
    """m independent draws of indexes by `cdf` (the sorted uniforms are
    looked up in order, then shuffled: the same law, cache-friendly)."""
    idx = np.searchsorted(cdf, np.sort(rng.random(m)), side="right")
    return idx[rng.permutation(m)]


def _df_queries(rng, ranks, cdf, n: int, lo: int, hi: int) -> np.ndarray:
    """n queries of lo..hi distinct ranks drawn by `cdf` over `ranks`;
    (n, hi) int64, -1 past a query's length."""
    k = rng.integers(lo, hi + 1, size=n)
    out = np.full((n, hi), -1, np.int64)
    for c in range(hi):
        rows = np.nonzero(k > c)[0]
        while len(rows):
            pick = ranks[_draw(rng, cdf, len(rows))]
            out[rows, c] = pick
            again = (out[rows, :c] == pick[:, None]).any(axis=1)
            rows = rows[again]
    return out


def _distinct_pool(rng, ranks, cdf, n: int, lo: int, hi: int,
                   avoid: np.ndarray) -> np.ndarray:
    """n distinct queries (as sets of ranks), none hashing into `avoid`."""
    got = np.zeros((0, hi), np.int64)
    seen = np.asarray(avoid, np.uint64)
    while len(got) < n:
        cand = _df_queries(rng, ranks, cdf, (n - len(got)) * 5 // 4 + 16, lo,
                           hi)
        h = _canon_hash(cand)
        _, first = np.unique(h, return_index=True)
        first = np.sort(first)
        cand, h = cand[first], h[first]
        fresh = ~np.isin(h, seen)
        got = np.concatenate([got, cand[fresh][: n - len(got)]])
        seen = np.concatenate([seen, h[fresh]])
    return got


def _pairs(rng, a: np.ndarray, b: np.ndarray, m: int) -> np.ndarray:
    """m distinct unordered pairs, one rank of `a` and one of `b` (a pair
    within one band when a is b), in random order within each pair."""
    same = a is b
    total = len(a) * (len(a) - 1) // 2 if same else len(a) * len(b)
    if m > total:
        raise ValueError(f"{m} distinct pairs asked of {total}")
    t = rng.choice(total, size=m, replace=False).astype(np.int64)
    if same:
        i = ((1 + np.sqrt(1 + 8 * t.astype(np.float64))) // 2).astype(np.int64)
        i -= (i * (i - 1) // 2 > t)
        i += ((i + 1) * i // 2 <= t)
        j = t - i * (i - 1) // 2
        out = np.stack([a[i], a[j]], axis=1)
    else:
        out = np.stack([a[t // len(b)], b[t % len(b)]], axis=1)
    flip = rng.random(m) < 0.5
    out[flip] = out[flip][:, ::-1]
    return out


def _calls(corpus, pos, kv, batch_q: int, bpc: int) -> List[list]:
    """Calls of batches in wire form: (term bytes uint8, term offsets,
    query offsets), terms in query order. The batches are slices of one
    stream-wide blob."""
    flat = pos[np.arange(pos.shape[1])[None, :] < kv[:, None]]
    lens = corpus.term_len[flat]
    tstart = np.zeros(len(flat) + 1, np.int64)
    np.cumsum(lens, out=tstart[1:])
    qstart = np.zeros(len(kv) + 1, np.int64)
    np.cumsum(kv, out=qstart[1:])
    # the bytes of every term in order, gathered on the corpus's device
    dev = corpus.device
    mat = torch.from_numpy(corpus.term_mat).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    inside = torch.arange(mat.shape[1], device=dev)[None, :] < lens_t[:, None]
    blob = mat[torch.from_numpy(flat).to(dev)][inside].cpu().numpy()
    del mat, inside
    batches = []
    for b0 in range(0, len(kv), batch_q):
        b1 = min(len(kv), b0 + batch_q)
        t0, t1 = qstart[b0], qstart[b1]
        batches.append((blob[tstart[t0]:tstart[t1]],
                        tstart[t0:t1 + 1] - tstart[t0],
                        qstart[b0:b1 + 1] - qstart[b0]))
    return [batches[c: c + bpc] for c in range(0, len(batches), bpc)]


def build(mix: dict, corpus, seed: int) -> Stream:
    """The stream of `mix` over `corpus` for the run's `seed`."""
    rng = np.random.default_rng(int(mix["stream_seed"]))
    bq, bpc = int(mix["batch_q"]), int(mix["batches_per_call"])
    n_pool = int(mix["pool"])
    n_win = min(MAX_CALLS, n_pool // (bq * bpc)) * bq * bpc
    n_warm = int(mix["warmup_calls"]) * bq * bpc
    model = corpus.df_by_rank
    ranks = np.nonzero(corpus.pos_of_rank[1:] >= 0)[0] + 1
    if mix["term_draw"] == "df":
        lo, hi = mix["terms_per_query"]
        cdf = np.cumsum(model[ranks - 1].astype(np.float64))
        cdf /= cdf[-1]
        pool = _distinct_pool(rng, ranks, cdf, n_pool, lo, hi,
                              np.zeros(0, np.uint64))
        warm = _distinct_pool(rng, ranks, cdf, n_warm, lo, hi,
                              _canon_hash(pool))
    elif mix["term_draw"] == "bins":
        D = corpus.D
        bands = {}
        for name, (lo_sh, hi_sh) in mix["bins"].items():
            df = model[ranks - 1]
            bands[name] = ranks[(df >= lo_sh * D) & (df < hi_sh * D)
                                if hi_sh < 1 else (df >= lo_sh * D)]
        tasks = mix["tasks"]
        n_all = n_pool + n_warm
        share = -(-n_all // len(tasks))
        parts = [_pairs(rng, bands[a], bands[b], share) for a, b in tasks]
        allq = np.stack(parts, axis=1).reshape(-1, 2)[:n_all]
        allq = allq[rng.permutation(n_all)]
        warm, pool = allq[:n_warm], allq[n_warm:]
    else:
        raise ValueError(f"term_draw {mix['term_draw']!r}")

    def to_pos(q):
        return np.where(q >= 0, corpus.pos_of_rank[np.maximum(q, 0)], -1)

    # the window's queries are the pool's first n_win, in an order drawn
    # from the run's seed
    qid = np.random.default_rng([int(seed), 1]).permutation(n_win)
    win_pos = to_pos(pool[qid])
    kv = (pool[qid] >= 0).sum(axis=1)
    return Stream(
        op=mix["op"], prefix_p=int(mix.get("prefix_p", 0)),
        depth=int(mix["depth"]), batch_q=bq, batches_per_call=bpc,
        warm=_calls(corpus, to_pos(warm), (warm >= 0).sum(axis=1), bq, bpc),
        calls=_calls(corpus, win_pos, kv, bq, bpc),
        qpos=win_pos, kv=kv, qid=qid)


def serve(eng, stream: Stream, call):
    """One call of the window (or of the warm-up) on the engine: (its
    results, the engine's stream counters for it)."""
    res = eng.boolean_staged(call, stream.op, False, stream.depth, True,
                             stream.prefix_p)
    return res, eng.last_stream_stats


def written(stream: Stream, results) -> np.ndarray:
    """Ids each query of one call's `results` wrote, in row order."""
    return np.concatenate([np.diff(r[1]) for r in results])


def least_bytes(stream: Stream, corpus, rows: np.ndarray,
                ids: np.ndarray) -> int:
    """The roofline's bytes for window rows `rows` (work.py)."""
    return work.least_bytes(stream, corpus, rows, ids)


def classes(stream: Stream, corpus, rows: np.ndarray
            ) -> Dict[str, np.ndarray]:
    """The check's classes: rows of `rows` by the path their query takes
    through the staged server (they steer the sample, never the verdict).

      AND   k2      shortest list at most PAD_IDS (served at the pad)
            ladder  shortest list up to LADDER_MAX_IDS (re-served at a level)
            concat  longer; all lists together at most CONCAT_MAX_BLOCKS
                    blocks (the concat classes)
            single  longer still (served one query at a time)
      OR    classes all lists together at most CONCAT_MAX_BLOCKS blocks
            single  more
    """
    pos = stream.qpos[rows]
    have = pos >= 0
    df = np.where(have, corpus.df[np.maximum(pos, 0)], 0)
    blocks = np.where(have, -(-df // BLOCK), 0).sum(axis=1)
    big = blocks > CONCAT_MAX_BLOCKS
    if stream.op == "and":
        short = np.where(have, df, np.iinfo(np.int64).max).min(axis=1)
        k2 = short <= PAD_IDS
        ladder = ~k2 & (short <= LADDER_MAX_IDS)
        rest = ~k2 & ~ladder
        return dict(k2=rows[k2], ladder=rows[ladder],
                    concat=rows[rest & ~big], single=rows[rest & big])
    return dict(classes=rows[~big], single=rows[big])


def answer_of(stream: Stream, results, row: int):
    """The program's answer to window row `row` from its call's results:
    the id array, or (first ids, true count) for a page. None when the
    call gave nothing for it."""
    qpc = stream.queries_per_call
    b = (row % qpc) // stream.batch_q
    i = row % stream.batch_q
    if b >= len(results):
        return None
    res = results[b]
    vals, offs = res[0], res[1]
    if i + 1 >= len(offs):
        return None
    got = np.asarray(vals[offs[i]:offs[i + 1]])
    if stream.prefix_p:
        counts = res[2]
        if i >= len(counts):
            return None
        return got, int(counts[i])
    return got


def expected(stream: Stream, ref, row: int):
    """The answer to window row `row` by `ref` (reference.Reference), in
    answer_of's form."""
    terms = stream.qpos[row][: stream.kv[row]]
    if stream.prefix_p:
        return ref.page(terms, stream.prefix_p)
    return ref.and_(terms)


def same(stream: Stream, got, want) -> bool:
    """An AND must equal the reference's set; a page must hold the
    reference's first P ids and its true count."""
    if stream.prefix_p:
        return got[1] == want[1] and np.array_equal(got[0], want[0])
    return np.array_equal(got, want)
