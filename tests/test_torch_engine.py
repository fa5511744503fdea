"""The port's QueryEngine on the CPU against the JAX engine (fused AND in
Pallas interpret mode, device route pinned) and against a numpy oracle:
lookup, boolean AND and boolean_staged AND, with ladder re-serves, missing
terms, single-term queries, small-P overflow, tombstones, forced
cross-query dedup and the concat class for bases above the level cap.

The AND tests share one corpus, one pair of engines and one tombstone set,
so the JAX engine compiles each of its interpret-mode programs once."""
import numpy as np
import pytest
import torch

from inverted_index_2_tpu import InvertedIndex, to_slice
from inverted_index_2_tpu.models import query_engine as jax_qe
from inverted_index_2_tpu.ops import pallas_decode as jax_pallas_decode

from inverted_index_2_tpu_torch import QueryEngine
from inverted_index_2_tpu_torch.models import query_engine as port_qe
from inverted_index_2_tpu_torch.models.snapshot import (
    STRIDE_ALIGN,
    _empty_tables,
    build_host_tables,
    upload_tables,
)

torch.set_num_threads(1)

L = 256


@pytest.fixture
def jax_env(monkeypatch):
    monkeypatch.setenv("TPI_FUSED_AND", "interp")
    monkeypatch.setenv("TPI_HOST_BOOL", "0")


def _tables(lists, terms, removed):
    voffs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    offs = np.arange(len(lists) + 1, dtype=np.int64) * 6
    return build_host_tables(b"".join(terms), offs, np.concatenate(lists),
                             voffs, removed)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0xC0FFEE)
    lists = [np.unique(rng.integers(0, 2_000, size=int(s), dtype=np.uint32))
             for s in [400, 420, 380, 350, 500, 30, 410, 390]]
    big = np.unique(rng.integers(0, 4_000, size=200, dtype=np.uint32))
    lists += [big, big.copy(),
              np.unique(np.concatenate([lists[5][::2], [0xFFFFFFFF]]))
              .astype(np.uint32),
              np.unique(np.concatenate([lists[5], [0xFFFFFFFF]]))
              .astype(np.uint32)]
    terms = [f"t{i:05d}".encode() for i in range(len(lists))]
    removed = np.unique(lists[0][::4]).astype(np.uint32)
    t = _tables(lists, terms, removed)
    port = QueryEngine(upload_tables(t, device="cpu"), L=L, device="cpu")
    jax_eng = jax_qe.QueryEngine(
        jax_qe.upload_tables(t, stride_align=STRIDE_ALIGN), L=L, q_bucket=8)
    t_ = terms
    queries = [
        [t_[0], t_[1]],             # both lists > L: ladder re-serve
        [t_[5], t_[2]],             # small base, long probe
        [t_[3], b"missing-term"],   # absent required term
        [t_[4]],                    # single term, > L
        [t_[6], t_[7], t_[1]],
        [t_[8], t_[9]],             # result wider than small P
        [t_[10], t_[11]],           # genuine 0xFFFFFFFF member
        [t_[5]],
    ]
    return lists, terms, queries, removed, port, jax_eng


def _oracle(lists, terms, q, removed=None):
    out = None
    for term in q:
        if term not in terms:
            return np.zeros(0, np.uint32)
        v = lists[terms.index(term)]
        out = v if out is None else np.intersect1d(out, v)
    if removed is not None:
        out = np.setdiff1d(out, removed)
    return out.astype(np.uint32)


def _assert_rows(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is not None and np.array_equal(g, w), (i, g, w)


def test_boolean_and_matches_jax(corpus, jax_env):
    lists, terms, queries, removed, port, jax_eng = corpus
    assert jax_eng._use_fused()
    for fr in (False, True):
        want = [_oracle(lists, terms, q, removed if fr else None)
                for q in queries]
        _assert_rows(port.boolean(queries, "and", filter_removed=fr), want)
    _assert_rows(jax_eng.boolean(queries, "and", filter_removed=True),
                 port.boolean(queries, "and", filter_removed=True))
    singles = [[terms[0]], [terms[2]], [b"missing"]]
    _assert_rows(port.boolean(singles, "and"),
                 [_oracle(lists, terms, q) for q in singles])


def test_boolean_staged_dedup_matches_jax(corpus, jax_env, monkeypatch):
    monkeypatch.setenv("TPI_STAGED_DEDUP", "force")
    lists, terms, queries, removed, port, jax_eng = corpus
    rq = np.random.default_rng(7)
    batches = [[queries[i] for i in rq.integers(0, len(queries), size=n)]
               for n in (80, 72)]
    qk, kv = port._pack_boolean(port._state, batches[0])
    assert port._dedup_batch(80, qk, kv)[3] is not None
    rows = port.boolean_staged(batches, "and", True, depth=1)
    cols = port.boolean_staged(batches, "and", True, columnar=True)
    jcols = jax_eng.boolean_staged(batches, "and", True, columnar=True)
    for bi, qs in enumerate(batches):
        want = [_oracle(lists, terms, q, removed) for q in qs]
        _assert_rows(rows[bi], want)
        vals, voffs = cols[bi]
        jvals, jvoffs = jcols[bi]
        assert np.array_equal(voffs, jvoffs) and np.array_equal(vals, jvals)
        _assert_rows([vals[voffs[i]:voffs[i + 1]] for i in range(len(qs))],
                     want)


def test_bases_above_level_cap_go_to_concat(corpus, jax_env, monkeypatch):
    lists, terms, queries, removed, port, jax_eng = corpus
    # cap the ladder at L values in both packages: every base over L
    # leaves the fused path for the concat AND
    monkeypatch.setattr(port_qe, "MAX_LEVEL", L)
    over = sum(all(t in terms for t in q)
               and min(len(lists[terms.index(t)]) for t in q) > L
               for q in queries)
    assert over >= 2
    monkeypatch.setattr(jax_pallas_decode, "SLACK_ROWS", L // 128)
    want = [_oracle(lists, terms, q, removed) for q in queries]
    got = port.boolean(queries, "and", filter_removed=True)
    _assert_rows(got, want)
    _assert_rows(jax_eng.boolean(queries, "and", filter_removed=True), got)
    assert len(got[0]) > 0
    port.boolean_staged([queries[::-1]], "and", True)
    assert port.last_stream_stats["concat"] == over
    _assert_rows(port.boolean_staged([queries, queries[::-1]], "and",
                                     True)[1], want[::-1])


def test_lookup_matches_jax_and_host_read(tmp_path, rng, monkeypatch):
    monkeypatch.setenv("TPI_HOST_BOOL", "0")
    ii = InvertedIndex(str(tmp_path))
    vocab = [f"w{i:02d}".encode() for i in range(30)]
    for v in range(1, 600):
        ii.put([b"common"] + [vocab[j] for j in
                              rng.choice(len(vocab), size=2, replace=False)], v)
    ii.put_removed([3, 50, 51, 400])
    while ii.merge(1, 100, 2) > 0:
        pass
    ii.put([b"common", b"late"], 700)
    port = QueryEngine.from_index(ii, L=128, device="cpu")
    jax_eng = jax_qe.QueryEngine.from_index(ii, L=128, stride_align=STRIDE_ALIGN)
    terms = [b"common", b"late", b"absent", b"w07", b"w29", b"common"]
    host = {tv.term: tv.values for tv in to_slice(ii.read(None, None))}
    removed = port.tables.removed
    assert len(host[b"common"]) > 4 * 128  # spans two ladder levels
    for fr in (False, True):
        got = port.lookup(terms, filter_removed=fr)
        want = jax_eng.lookup(terms, filter_removed=fr)
        for term, g, w in zip(terms, got, want):
            if term not in host:
                assert g is None and w is None
                continue
            h = np.setdiff1d(host[term], removed) if fr else host[term]
            assert np.array_equal(g, w) and np.array_equal(g, h), term
    q = [[b"common", b"w07"], [b"late", b"common"], [b"w07", b"absent"]]
    _assert_rows(port.boolean(q, "and", filter_removed=True),
                 jax_eng.boolean(q, "and", filter_removed=True))


def test_outside_the_slice_raises(corpus):
    """The host route and the range and prefix reads answer what the JAX
    engine answers, on the host route (retained tables) and, for the
    reads, the device route."""
    lists, terms, queries, removed, port, jax_eng = corpus
    t = _tables(lists, terms, removed)
    host = QueryEngine(upload_tables(t, device="cpu"), L=L, tables=t,
                       device="cpu")
    jax_host = jax_qe.QueryEngine(
        jax_qe.upload_tables(t, stride_align=STRIDE_ALIGN), L=L, q_bucket=8,
        tables=t)
    probe = terms + [b"missing-term"]
    for fr in (False, True):
        got = host.lookup_host(probe, filter_removed=fr)
        want = jax_host.lookup_host(probe, filter_removed=fr)
        assert got[-1] is None and want[-1] is None  # the miss
        _assert_rows(got[:-1], want[:-1])
        for op in ("and", "or"):
            _assert_rows(host.boolean_host(queries, op, filter_removed=fr),
                         jax_host.boolean_host(queries, op,
                                               filter_removed=fr))
    for a, b in ((host, jax_host), (port, jax_eng)):
        rows = [(x, v.tolist()) for x, v in a.read_range()]
        assert rows == [(x, v.tolist()) for x, v in b.read_range()]
        assert [x for x, _ in rows] == terms
        got = a.prefix_search([b"t0000", b"t", b"u"])
        want = b.prefix_search([b"t0000", b"t", b"u"])
        assert set(got) == set(want) == {b"t0000", b"t"}
        assert all(np.array_equal(got[p], want[p]) for p in got)
    with pytest.raises(RuntimeError, match="keep_tables"):
        port.lookup_host(queries[0])


def test_empty_index_serves_empty_results():
    port = QueryEngine(upload_tables(_empty_tables(2), device="cpu"), L=128,
                       device="cpu")
    assert port.lookup([b"a", b"b"]) == [None, None]
    assert [len(r) for r in port.boolean([[b"a", b"b"], [b"c"]], "and")] == [0, 0]
    vals, voffs = port.boolean_staged([[[b"a"], [b"b", b"c"]]], "and",
                                      columnar=True)[0]
    assert len(vals) == 0 and voffs.tolist() == [0, 0, 0]
