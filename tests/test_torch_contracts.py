"""Twins of engine contracts of tests/test_query_engine.py that the other
port tests do not cover, on the CPU: the port writes the index, its
QueryEngine(device="cpu") serves it, and every answer is held against the
original test's expectation and against the JAX engine over the same
directory (JAX's host route, lookup_host / boolean_host, where a device
call would only add compiles; its own tests hold the two routes equal)."""
import numpy as np
import pytest
import torch

import inverted_index_2_tpu as jax_pkg
from inverted_index_2_tpu.models import query_engine as jax_qe

import inverted_index_2_tpu_torch as port_pkg
from inverted_index_2_tpu_torch import QueryEngine

torch.set_num_threads(1)


def _jax(path, L=128):
    return jax_qe.QueryEngine.from_index(jax_pkg.InvertedIndex(str(path)),
                                         L=L, q_bucket=8)


def _same_rows(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        if x is None or y is None:
            assert x is None and y is None, i
        else:
            assert np.array_equal(x, y), (i, x, y)


def _build(path, rng, n_docs=60, n_terms=40):
    """build_index of tests/test_query_engine.py on the port."""
    ii = port_pkg.InvertedIndex(str(path))
    vocab = [f"term{i:03d}".encode() for i in range(n_terms)] + [
        b"a", b"", b"\xff\xff"]
    truth = {}
    for doc in range(1, n_docs + 1):
        k = int(rng.integers(1, 6))
        terms = [vocab[i] for i in rng.choice(len(vocab), size=k,
                                              replace=False)]
        ii.put(terms, doc)
        for t in terms:
            truth.setdefault(t, set()).add(doc)
    return ii, truth


def test_lookup_longer_than_L_is_exact(tmp_path):
    ii = port_pkg.InvertedIndex(str(tmp_path))
    for v in range(1, 300):  # b"big" gathers 299 values; L=128 below
        ii.put([b"big", f"f{v:03d}".encode()], v)
    while ii.merge(2, 1000, 2) > 0:
        pass
    eng = QueryEngine.from_index(ii, L=128, device="cpu")
    got = eng.lookup([b"big", b"f005"])
    assert got[0].tolist() == list(range(1, 300))
    assert got[1].tolist() == [5]
    ref = _jax(tmp_path)
    _same_rows(got, ref.lookup([b"big", b"f005"]))


def test_failed_merge_releases_claims(tmp_path, monkeypatch):
    """A merge that raises unclaims its segments, so a retry merges them,
    in both packages; the merged shards read the same."""
    import inverted_index_2_tpu.shard as jax_shard
    import inverted_index_2_tpu_torch.shard as port_shard

    def boom(*a, **k):
        raise RuntimeError("injected")

    reads = []
    for name, pkg, mod in (("port", port_pkg, port_shard),
                           ("jax", jax_pkg, jax_shard)):
        sh = pkg.Shard(str(tmp_path / name))
        sh.put([b"t1"], 1)
        sh.put([b"t1"], 2)
        monkeypatch.setattr(mod, "merge_views", boom)
        with pytest.raises(RuntimeError, match="injected"):
            sh.merge(2, 10)
        monkeypatch.undo()
        assert all(not seg.merging for seg in sh.segments.snapshot()), name
        assert sh.merge(2, 10) == 2, name  # the retry succeeds
        reads.append([(tv.term, tv.values.tolist())
                      for tv in pkg.to_slice(sh.read(None, None))])
    assert reads[0] == reads[1] == [(b"t1", [1, 2])]


def test_very_long_terms(tmp_path):
    ii = port_pkg.InvertedIndex(str(tmp_path))
    long1 = b"x" * 100 + b"-one"
    long2 = b"x" * 100 + b"-two"
    ii.put([long1, b"short"], 1)
    ii.put([long2], 2)
    ii.put([long1], 3)
    while ii.merge(2, 10, 2) > 0:
        pass
    host = {tv.term: tv.values.tolist()
            for tv in port_pkg.to_slice(ii.read(None, None))}
    assert host[long1] == [1, 3] and host[long2] == [2]
    eng = QueryEngine.from_index(ii, L=128, device="cpu")
    terms = [long1, long2, b"short", b"x" * 100]
    got = eng.lookup(terms)
    assert got[0].tolist() == [1, 3]
    assert got[1].tolist() == [2]
    assert got[2].tolist() == [1]
    assert got[3] is None  # a proper prefix of a long term is no match
    pref = eng.prefix_search([b"x" * 100])
    assert pref[b"x" * 100].tolist() == [1, 2, 3]
    ref = _jax(tmp_path)
    _same_rows(got, ref.lookup_host(terms))
    assert np.array_equal(pref[b"x" * 100],
                          ref.prefix_search([b"x" * 100])[b"x" * 100])


def test_boolean_concat_fuzz(tmp_path, rng, monkeypatch):
    """The concat path over lists of several block classes, missing terms,
    genuine 0xFFFFFFFF members, 1..6-term queries, AND and OR, with and
    without the tombstone filter, on the device route."""
    monkeypatch.setenv("TPI_HOST_BOOL", "0")
    ii = port_pkg.InvertedIndex(str(tmp_path))
    truth = {}
    vocab = []
    for i in range(30):
        t = f"t{i:02d}".encode()
        vocab.append(t)
        n = int(rng.integers(1, 700))
        vals = np.unique(rng.integers(0, 5000, size=n, dtype=np.uint32))
        if i % 7 == 0:
            vals = np.unique(np.concatenate([vals, [0xFFFFFFFF]])).astype(
                np.uint32)
        truth[t] = set(int(v) for v in vals)
        ii.put_many([([t], int(v)) for v in vals])
    while ii.merge(2, 10000, 2) > 0:
        pass
    eng = QueryEngine.from_index(ii, L=128, device="cpu")
    queries = []
    for _ in range(40):
        k = int(rng.integers(1, 7))
        q = [vocab[i] for i in rng.choice(len(vocab), size=k, replace=False)]
        if rng.random() < 0.2:
            q[-1] = b"missing-term"
        queries.append(q)
    ref = _jax(tmp_path)
    for op in ("and", "or"):
        got = eng.boolean(queries, op=op)
        for q, g in zip(queries, got):
            sets = [truth.get(t, set()) for t in q]
            want = set.intersection(*sets) if op == "and" else set.union(
                *sets)
            assert g.tolist() == sorted(want), (op, q)
        _same_rows(got, ref.boolean_host(queries, op))
    rm = [int(v) for v in rng.integers(0, 5000, size=50)]
    ii.put_removed(rm)
    assert eng.refresh(ii) is True
    got = eng.boolean(queries[:10], op="or", filter_removed=True)
    for q, g in zip(queries[:10], got):
        want = set.union(*[truth.get(t, set()) for t in q]) - set(rm)
        assert g.tolist() == sorted(want), q
    ref = _jax(tmp_path)
    _same_rows(got, ref.boolean_host(queries[:10], "or",
                                     filter_removed=True))


def test_boolean_staged_prefix_fallback_with_delta(tmp_path):
    """With a delta tier live the prefix_p mode keeps the contract:
    (values, voffs, counts), the first P of each result and its count."""
    ii = port_pkg.InvertedIndex(str(tmp_path))
    for v in range(1, 40):
        ii.put([b"aa", f"b{v:02d}".encode()], v)
    eng = QueryEngine.from_index(ii, L=128, device="cpu")
    ii.put([b"aa", b"zz"], 99)
    assert eng.refresh(ii) is True and eng.delta is not None
    qs = [[b"aa"], [b"aa", b"zz"]]
    (pv, pvo, pc), = eng.boolean_staged([qs], "or", columnar=True,
                                        prefix_p=4)
    plain = eng.boolean(qs, "or")
    assert pc[0] == len(plain[0]) and pc[1] == len(plain[1])
    assert np.array_equal(pv[pvo[0]: pvo[1]], plain[0][:4])
    assert np.array_equal(pv[pvo[1]: pvo[2]], plain[1][:4])
    ref = _jax(tmp_path)
    ii_j = jax_pkg.InvertedIndex(str(tmp_path))
    assert ref.refresh(ii_j) is False  # built after the put: no delta
    _same_rows(plain, ref.boolean_host(qs, "or"))
    (rv, rvo, rc), = ref.boolean_staged([qs], "or", columnar=True,
                                        prefix_p=4)
    assert np.array_equal(pv, rv) and np.array_equal(pvo, rvo)
    assert np.array_equal(pc, rc)


def test_boolean_delegates_to_staged_at_bulk_q(tmp_path, rng, monkeypatch):
    """boolean() at bulk Q on the device route hands the batch to the
    staged stream and stays bit-identical to the direct path, tombstones
    and a delta tier included."""
    ii, truth = _build(tmp_path, rng)
    ii.put_removed(np.asarray([2, 9], dtype=np.uint32))
    eng = QueryEngine.from_index(ii, L=128, device="cpu")
    monkeypatch.setenv("TPI_HOST_BOOL", "0")
    monkeypatch.setattr(QueryEngine, "_STAGED_DELEGATE_MIN", 16)
    vocab = sorted(truth)
    rq = np.random.default_rng(3)
    qs = [[vocab[i] for i in rq.choice(len(vocab),
                                       size=int(rq.integers(1, 4)),
                                       replace=False)]
          for _ in range(20)] + [[b"zz-missing", vocab[0]]]
    called = []
    orig = QueryEngine.boolean_staged

    def spy(self, batches, *a, **kw):
        called.append(len(batches))
        return orig(self, batches, *a, **kw)

    monkeypatch.setattr(QueryEngine, "boolean_staged", spy)
    for delta_live in (False, True):
        if delta_live:
            ii.put([vocab[0], b"zz-new"], 777)
            assert eng.refresh(ii) is True and eng.delta is not None
        ref = _jax(tmp_path)
        for op in ("and", "or"):
            for fr in (False, True):
                called.clear()
                got = eng.boolean(qs, op, filter_removed=fr)
                assert called == [1], "bulk Q must delegate to staged"
                for qi in range(len(qs)):
                    called.clear()
                    want = eng.boolean([qs[qi]], op, filter_removed=fr)[0]
                    assert not called  # below the threshold: direct path
                    assert np.array_equal(got[qi], want), (
                        delta_live, op, fr, qi)
                _same_rows(got, ref.boolean_host(qs, op, filter_removed=fr))


def test_result_wire_codec_boundary_deltas(tmp_path):
    """Full-result fetches delta-pack on the wire: deltas of exactly
    255/256/65535/65536, huge first values, single-value rows."""
    ii = port_pkg.InvertedIndex(str(tmp_path))
    lists = {
        b"u8-edge": [10, 10 + 255, 10 + 255 + 255],
        b"u16-lo": [0, 256, 512],
        b"u16-edge": [7, 7 + 65535],
        b"u32-fb": [1, 1 + 65536, 2**32 - 2],
        b"huge-first": [2**32 - 3, 2**32 - 2],
        b"single": [42],
    }
    for t, vs in lists.items():
        for v in vs:
            ii.put([t], v)
    eng = QueryEngine.from_index(ii, L=128, keep_tables=False, device="cpu")
    terms = list(lists)
    got = eng.boolean_staged([[[t] for t in terms]], "or")[0]
    for qi, t in enumerate(terms):
        assert got[qi].tolist() == lists[t], t
    got2 = eng.boolean([[t] for t in terms], "or")
    for qi, t in enumerate(terms):
        assert got2[qi].tolist() == lists[t], t
    mix = eng.boolean([[b"u8-edge"], [b"u32-fb"], [b"u16-edge"]], "or")
    assert mix[0].tolist() == lists[b"u8-edge"]
    assert mix[1].tolist() == lists[b"u32-fb"]
    assert mix[2].tolist() == lists[b"u16-edge"]
    ref = _jax(tmp_path)
    want = ref.boolean_host([[t] for t in terms], "or")
    _same_rows(got, want)
    _same_rows(got2, want)


def test_host_resolve_device_serve_matches_oracle(tmp_path, rng,
                                                  monkeypatch):
    """An engine with retained tables resolves the dictionary on the host
    for the device concat stream and the one-shot concat path; its results
    equal the device-resolve engine's across found/missing mixes, both
    ops, pagination and full results, and JAX's."""
    ii = port_pkg.InvertedIndex(str(tmp_path))
    terms = [b"t%03d" % i for i in range(60)]
    for d in range(1, 400):
        ii.put([terms[int(x)] for x in rng.choice(60, size=1 + d % 5,
                                                  replace=False)], d)
    eng_t = QueryEngine.from_index(ii, L=128, device="cpu")
    eng_d = QueryEngine.from_index(ii, L=128, keep_tables=False,
                                   device="cpu")
    assert eng_t.host_ready() and not eng_d.host_ready()
    queries = [
        [terms[0], b"missing", terms[7]],
        [terms[3]],
        [b"missing-a", b"missing-b"],
        [terms[11], terms[13], terms[17], terms[19]],
    ] + [[terms[int(a)], terms[int(b)]]
         for a, b in rng.integers(0, 60, size=(17, 2))]
    monkeypatch.setenv("TPI_HOST_BOOL", "0")
    ref = _jax(tmp_path)
    for op in ("or", "and"):
        want = eng_d.boolean(queries, op)
        got = eng_t.boolean(queries, op)
        _same_rows(got, want)
        _same_rows(got, ref.boolean_host(queries, op))
        for P in (0, 8):
            kw = dict(columnar=True, prefix_p=P) if P else dict(
                columnar=True)
            a = eng_d.boolean_staged([queries], op, **kw)[0]
            b = eng_t.boolean_staged([queries], op, **kw)[0]
            for x, y in zip(a, b):
                assert np.array_equal(x, y), (op, P)


def test_staged_dedup_zipf_mix_bit_identical(tmp_path, monkeypatch):
    """Cross-query dedup in the staged AND stream: a Zipf mix repeating
    whole queries serves each distinct term set once and fans the results
    out, bit-identical to the stream without dedup in every output form,
    wide rows (past the small-P page) duplicated too; fewer rows served."""
    ii = port_pkg.InvertedIndex(str(tmp_path))
    truth = {}
    for d in range(1, 41):  # a hot pair whose AND (40) passes small P (8)
        ii.put([b"hot1", b"hot2"], d)
        truth.setdefault(b"hot1", set()).add(d)
        truth.setdefault(b"hot2", set()).add(d)
    for i in range(30):
        t = b"cold%02d" % i
        for d in range(100 + i * 3, 103 + i * 3):
            ii.put([t], d)
            truth.setdefault(t, set()).add(d)
    ii.put_removed([2, 101])
    eng = QueryEngine.from_index(ii, L=128, keep_tables=False, device="cpu")
    monkeypatch.setenv("TPI_HOST_BOOL", "0")
    monkeypatch.setenv("TPI_STAGED_DEDUP", "force")
    rng2 = np.random.default_rng(11)
    batches = []
    for _ in range(3):
        qs = []
        for _ in range(96):
            r = rng2.random()
            if r < 0.55:
                qs.append([b"hot1", b"hot2"])
            elif r < 0.8:
                qs.append([b"cold%02d" % int(rng2.integers(0, 30)), b"hot1"])
            else:
                i, j = rng2.choice(30, size=2, replace=False)
                qs.append([b"cold%02d" % int(i), b"cold%02d" % int(j)])
        batches.append(qs)
    served_rows = []
    orig_run = QueryEngine._fused_run_staged

    def spy_run(self, st, qk, kv, removed):
        served_rows.append(qk.shape[0])
        return orig_run(self, st, qk, kv, removed)

    monkeypatch.setattr(QueryEngine, "_fused_run_staged", spy_run)
    ref = _jax(tmp_path)
    for fr in (False, True):
        ded_cols = eng.boolean_staged(batches, "and", columnar=True,
                                      filter_removed=fr)
        ded_rows = eng.boolean_staged(batches, "and", filter_removed=fr)
        monkeypatch.setenv("TPI_STAGED_DEDUP", "0")
        ref_cols = eng.boolean_staged(batches, "and", columnar=True,
                                      filter_removed=fr)
        ref_rows = eng.boolean_staged(batches, "and", filter_removed=fr)
        monkeypatch.setenv("TPI_STAGED_DEDUP", "force")
        for (va, oa), (vb, ob) in zip(ded_cols, ref_cols):
            assert np.array_equal(va, vb) and np.array_equal(oa, ob)
        for ba, bb, qs in zip(ded_rows, ref_rows, batches):
            _same_rows(ba, bb)
            _same_rows(ba, ref.boolean_host(qs, "and", filter_removed=fr))
        want = sorted(truth[b"hot1"] & truth[b"hot2"] - ({2} if fr else
                                                         set()))
        for qs, rows in zip(batches, ded_rows):
            for q, r in zip(qs, rows):
                if q == [b"hot1", b"hot2"]:
                    assert r.tolist() == want
    # per fr the calls are ded_cols, ded_rows, ref_cols, ref_rows, three
    # batches each; the dedup stream served fewer rows
    n = len(batches)
    assert len(served_rows) == 8 * n
    for base in (0, 4 * n):
        ded = sum(served_rows[base: base + 2 * n])
        full = sum(served_rows[base + 2 * n: base + 4 * n])
        assert ded < full, served_rows


def test_concat_stream_dedup_zipf_bit_identical(tmp_path, monkeypatch):
    """Cross-query dedup in the staged concat stream (OR, full and paged,
    tombstones included): each distinct query served once, bit-identical
    to the stream without dedup, and equal to the oracle and to JAX."""
    ii = port_pkg.InvertedIndex(str(tmp_path))
    truth = {}
    rng2 = np.random.default_rng(23)
    for i in range(24):
        t = b"w%02d" % i
        for d in np.unique(rng2.integers(1, 300, size=40)):
            ii.put([t], int(d))
            truth.setdefault(t, set()).add(int(d))
    ii.put_removed([7, 30])
    eng = QueryEngine.from_index(ii, L=64, keep_tables=True, device="cpu")
    monkeypatch.setenv("TPI_HOST_BOOL", "0")
    monkeypatch.setenv("TPI_STAGED_DEDUP", "force")
    pool = [[b"w%02d" % int(i) for i in rng2.choice(24, size=k,
                                                    replace=False)]
            for k in (1, 2, 2, 3, 4) for _ in range(4)]
    zw = 1.0 / np.arange(1, len(pool) + 1)
    zw /= zw.sum()
    batches = [[pool[i] for i in rng2.choice(len(pool), size=96, p=zw)]
               for _ in range(3)]
    served_nq = []
    orig = QueryEngine._dedup_batch

    def spy(self, nq, qk, kv, row_cost_us=None):
        r = orig(self, nq, qk, kv, row_cost_us)
        served_nq.append((nq, r[0], r[3] is not None))
        return r

    monkeypatch.setattr(QueryEngine, "_dedup_batch", spy)
    for kwargs in (dict(columnar=True), dict(),
                   dict(columnar=True, prefix_p=8),
                   dict(columnar=True, filter_removed=True),
                   dict(columnar=True, prefix_p=8, filter_removed=True)):
        ded = eng.boolean_staged(batches, "or", depth=2, **kwargs)
        assert served_nq and all(e[2] and e[1] < e[0]
                                 for e in served_nq[-3:])
        monkeypatch.setenv("TPI_STAGED_DEDUP", "0")
        full = eng.boolean_staged(batches, "or", depth=2, **kwargs)
        monkeypatch.setenv("TPI_STAGED_DEDUP", "force")
        for a, b in zip(ded, full):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
    vals, voffs = eng.boolean_staged(batches[:1], "or", columnar=True,
                                     depth=2)[0]
    ref = _jax(tmp_path).boolean_host(batches[0], "or")
    for q, want_terms in enumerate(batches[0]):
        want = sorted(set().union(*(truth[t] for t in want_terms)))
        assert vals[voffs[q]: voffs[q + 1]].tolist() == want
        assert np.array_equal(vals[voffs[q]: voffs[q + 1]], ref[q])
