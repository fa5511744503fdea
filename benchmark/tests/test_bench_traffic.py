"""The query generator: reproducible, seed-ordered, warm-up apart."""
import numpy as np
import pytest

import check
import harness
from conftest import CELLS, tiny_mix


def _sets(stream, rows=None):
    q = stream.qpos if rows is None else stream.qpos[rows]
    return [tuple(sorted(int(p) for p in r if p >= 0)) for r in q]


def _warm_sets(stream):
    out = []
    for call in stream.warm:
        for blob, toffs, qoffs in call:
            terms = [blob[toffs[i]:toffs[i + 1]].tobytes()
                     for i in range(len(toffs) - 1)]
            out += [tuple(sorted(terms[qoffs[j]:qoffs[j + 1]]))
                    for j in range(len(qoffs) - 1)]
    return out


@pytest.mark.parametrize("workload", CELLS)
def test_stream_reproducible_and_seed_orders_it(decl, tiny_corpus, workload):
    mix = tiny_mix(decl, workload)
    a = harness.make_stream(mix, tiny_corpus, 7)
    b = harness.make_stream(mix, tiny_corpus, 7)
    c = harness.make_stream(mix, tiny_corpus, 8)
    assert np.array_equal(a.qpos, b.qpos) and np.array_equal(a.qid, b.qid)
    for ca, cb in zip(a.calls, b.calls):
        for x, y in zip(ca, cb):
            assert all(np.array_equal(u, v) for u, v in zip(x, y))
    # another seed: the same queries, in another order
    assert not np.array_equal(a.qpos, c.qpos)
    assert sorted(_sets(a)) == sorted(_sets(c))
    n = len(a.kv)
    qpc = mix["batch_q"] * mix["batches_per_call"]
    gen = harness.traffic(mix)
    assert n == min(gen.MAX_CALLS, mix["pool"] // qpc) * qpc
    assert len(a.calls) == n // qpc
    lo, hi = mix.get("terms_per_query", (2, 2))
    assert a.kv.min() >= lo and a.kv.max() <= hi
    for s in _sets(a):
        assert len(set(s)) == len(s)   # no term twice in a query


@pytest.mark.parametrize("workload", CELLS)
def test_wire_batches_spell_the_queries(decl, tiny_corpus, workload):
    mix = tiny_mix(decl, workload)
    st = harness.make_stream(mix, tiny_corpus, 3)
    c = tiny_corpus
    qpc = st.queries_per_call
    for ci in (0, len(st.calls) - 1):
        assert len(st.calls[ci]) == st.batches_per_call
        for bi, (blob, toffs, qoffs) in enumerate(st.calls[ci]):
            assert len(qoffs) == st.batch_q + 1
            for i in range(0, st.batch_q, 37):
                row = ci * qpc + bi * st.batch_q + i
                pos = st.qpos[row][: st.kv[row]]
                got = [blob[toffs[t]:toffs[t + 1]].tobytes()
                       for t in range(qoffs[i], qoffs[i + 1])]
                want = [c.blob[c.offsets[p]:c.offsets[p + 1]].tobytes()
                        for p in pos]
                assert got == want


@pytest.mark.parametrize("workload", CELLS)
def test_warm_up_shares_no_query_with_the_window(decl, tiny_corpus,
                                                 workload):
    mix = tiny_mix(decl, workload)
    st = harness.make_stream(mix, tiny_corpus, 5)
    c = tiny_corpus
    term = [c.blob[c.offsets[p]:c.offsets[p + 1]].tobytes()
            for p in range(c.n_terms)]
    window = {tuple(sorted(term[p] for p in s)) for s in _sets(st)}
    warm = set(_warm_sets(st))
    assert warm and not (warm & window)


@pytest.mark.parametrize("workload", CELLS)
def test_the_window_sends_each_query_of_its_pool_once(decl, tiny_corpus,
                                                      workload):
    mix = tiny_mix(decl, workload)
    st = harness.make_stream(mix, tiny_corpus, 5)
    assert len(np.unique(st.qid)) == len(st.qid)
    sets = _sets(st)
    assert len(set(sets)) == len(sets)


def test_calls_are_capped_and_the_pool_is_cut_not_redrawn(decl,
                                                           tiny_corpus):
    mix = tiny_mix(decl, "msmarco-passage.and-distinct")
    gen = harness.traffic(mix)
    qpc = mix["batch_q"] * mix["batches_per_call"]
    small = harness.make_stream(dict(mix, pool=2 * qpc), tiny_corpus, 5)
    big = harness.make_stream(mix, tiny_corpus, 5)
    assert len(small.calls) == 2 and len(big.calls) == mix["pool"] // qpc
    cap = len(big.calls) - 1
    gen.MAX_CALLS, keep = cap, gen.MAX_CALLS
    try:
        capped = harness.make_stream(mix, tiny_corpus, 5)
    finally:
        gen.MAX_CALLS = keep
    assert len(capped.calls) == cap


def test_terms_drawn_by_document_frequency(decl, tiny_corpus):
    mix = dict(tiny_mix(decl, "msmarco-passage.and-distinct"), pool=2500)
    st = harness.make_stream(mix, tiny_corpus, 5)
    pos = st.qpos[st.qpos >= 0]
    df = tiny_corpus.df
    heavy = df >= np.quantile(df, 0.99)
    # terms of the top 1% of frequencies carry a large share of the draws
    assert heavy[pos].mean() > 0.2


def test_two_term_tasks_in_their_bands_and_never_repeated(decl,
                                                          tiny_corpus):
    mix = tiny_mix(decl, "wikimedium10m.and-2term")
    st = harness.make_stream(mix, tiny_corpus, 5)
    D = tiny_corpus.D
    df = tiny_corpus.df[st.qpos]
    hi_df, lo_df = df.max(axis=1), df.min(axis=1)
    assert (hi_df >= 0.05 * D).all()
    med = (lo_df >= 0.01 * D) & (lo_df < 0.05 * D)
    low = (lo_df >= 0.001 * D) & (lo_df < 0.01 * D)
    high = lo_df >= 0.05 * D
    assert (high | med | low).all()
    for part in (high, med, low):
        assert abs(part.mean() - 1 / 3) < 0.05
    sets = _sets(st)
    assert len(set(sets)) == len(sets)
    assert len(np.unique(st.qid)) == len(st.qid)


@pytest.mark.parametrize("workload", CELLS)
def test_sample_covers_every_class_it_can(decl, tiny_corpus, workload):
    mix = tiny_mix(decl, workload)
    gen = harness.traffic(mix)
    st = gen.build(mix, tiny_corpus, 5)
    rows = harness.rows_of_calls(st, [0, 1])
    cls = gen.classes(st, tiny_corpus, rows)
    per_class = mix["check"]["per_class"]
    assert set(cls) == set(per_class)
    picks = check.draw_sample(cls, per_class, 9)
    got = {name for name, _ in picks}
    assert got == {k for k, v in cls.items() if len(v)}
    assert len(got) >= (2 if st.op == "and" else 1)
    assert picks == check.draw_sample(cls, per_class, 9)
