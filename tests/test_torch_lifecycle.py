"""The write-while-serving lifecycle of the port on the CPU, against a
dict-of-sets oracle and the JAX engine: twins of the random put /
put_removed / merge / reopen workloads of tests/test_differential.py and
tests/test_differential_shards.py, with a port QueryEngine kept current by
refresh() between the steps. At every quiet state (after each refresh) the
port's answers equal the oracle's and the JAX engine's over the same
directory (the JAX package reopens it at every refresh), bit for bit, in
every form: lookup, AND, OR, pages, lookup_staged, read_range and
prefix_search, with and without the tombstone filter where the form has
one. Each workload takes all four refresh kinds (an additive delta,
tombstones only, a promotion past DELTA_FRACTION, a rebuild after a
merge). Then chip_smoke's phase 9 at a small size, and the refresh race
of tests/test_query_engine.py."""
import threading

import numpy as np
import pytest
import torch

import inverted_index_2_tpu as jax_pkg
from inverted_index_2_tpu.models import query_engine as jax_qe

import chip_smoke
import inverted_index_2_tpu_torch as port_pkg
from inverted_index_2_tpu_torch import QueryEngine
from inverted_index_2_tpu_torch.models.snapshot import _collect_removed

from test_differential_shards import (HOSTILE_VOCAB, ShardOracle,
                                      _oracle_put_many)

torch.set_num_threads(1)

KINDS = {"delta", "tombstones", "promotion", "rebuild"}


@pytest.fixture(autouse=True)
def _device_route(monkeypatch):
    # the device route of both engines (the host route serves lookup_staged
    # and the reads, which retained tables always take)
    monkeypatch.setenv("TPI_HOST_BOOL", "0")


def _segments(st):
    return [(key, segs) for key, segs, _ in st.fingerprint[1]]


class Lifecycle:
    """The port's InvertedIndex at `path`; once started, a port engine on
    the CPU over it and the JAX engine over the same directory, both
    refreshed at every quiet state. `kinds` lists the port engine's
    refreshes by kind. The JAX engine answers lookups and boolean queries
    on its host route (lookup_host, boolean_host; its own tests hold them
    equal to its device route), which compiles nothing: a page is held
    against the first values and the length of its row."""

    def __init__(self, path, rng, L=128):
        self.dir = str(path)
        self.ii = port_pkg.InvertedIndex(self.dir)
        self.rng = rng
        self.L = L
        self.port = self.jax = None
        self.kinds = []
        self.states = 0
        # the tombstones the engines filter with: the index's at the last
        # refresh that saw a change. A put_removed whose GC drops as many
        # batches as it adds leaves the fingerprint as it was, so both
        # packages' refresh() returns False and keeps the old tombstones
        # (ROADMAP queue 3; test_tombstones_missed_when_batch_counts_hold)
        self.published = set()
        self.missed = 0
        self.reopened = False

    def wants(self, kind) -> bool:
        """True once the engines run and no refresh has been of `kind`."""
        return self.port is not None and kind not in self.kinds

    def reopen(self):
        self.ii = port_pkg.InvertedIndex(self.dir)
        self.reopened = True

    def refresh(self, data, vocab):
        """Refresh both engines (start them on the first call) and hold
        their answers against `data` (term -> set of ids, the index's
        reads) and each other."""
        if self.port is None:
            self.port = QueryEngine.from_index(self.ii, L=self.L,
                                               device="cpu")
            self.jax = jax_qe.QueryEngine.from_index(
                jax_pkg.InvertedIndex(self.dir), L=self.L, q_bucket=8)
            calls = self.calls = []
            orig = self.port._promote_delta

            def spy(*a, **kw):
                calls.append("promote")
                return orig(*a, **kw)

            self.port._promote_delta = spy
        else:
            before = self.port._state
            self.calls.clear()
            a = self.port.refresh(self.ii)
            b = self.jax.refresh(jax_pkg.InvertedIndex(self.dir))
            after = self.port._state
            if a != b:
                # a reopened shard lists its segments in directory order,
                # the index that wrote them in write order; the JAX engine
                # reads a reopened index every time, so only the port's
                # fingerprint moved, by order alone
                assert self.reopened and a and not b
                assert ({k: set(v) for k, v in _segments(after)}
                        == {k: set(v) for k, v in _segments(before)})
                a = False
            self.reopened = False
            if not a:
                kind = None
            elif after.snap is not before.snap:
                kind = "promotion" if self.calls else "rebuild"
            elif _segments(after) != _segments(before):
                kind = "delta"
            else:
                kind = "tombstones"
            if kind:
                self.kinds.append(kind)
        removed = set(_collect_removed(self.ii).tolist())
        if self.port._state is not getattr(self, "_seen", None):
            self.published = removed
            self._seen = self.port._state
        elif removed != self.published:
            self.missed += 1
        assert (self.port.delta is None) == (self.jax.delta is None)
        self.check(data, vocab)

    def check(self, data, vocab):
        self.states += 1
        port, jx = self.port, self.jax
        removed = self.published
        terms = sorted(data) + [b"zz-missing"]
        rng = self.rng
        qs = [[vocab[i] for i in rng.choice(len(vocab), size=int(k),
                                            replace=False)]
              for k in rng.integers(1, min(5, len(vocab)) + 1, size=8)]
        qs.append([terms[0], b"zz-missing"])

        def want(t, fr):
            v = data.get(t, set())
            return sorted(v - removed) if fr else sorted(v)

        def oracle(q, op, fr):
            sets = [set(want(t, fr)) for t in q]
            out = set.intersection(*sets) if op == "and" else set.union(
                *sets)
            return np.array(sorted(out), dtype=np.uint32)

        for fr in (False, True):
            got, ref = port.lookup(terms, fr), jx.lookup_host(terms, fr)
            for t, g, r in zip(terms, got, ref):
                assert (g is None) == (r is None), t
                if g is None:
                    assert t not in data, t
                else:
                    assert np.array_equal(g, r), t
                    assert g.tolist() == want(t, fr), t
            for op in ("and", "or"):
                got = port.boolean(qs, op, filter_removed=fr)
                ref = jx.boolean_host(qs, op, filter_removed=fr)
                for q, g, r in zip(qs, got, ref):
                    assert np.array_equal(g, r), (op, fr, q)
                    assert np.array_equal(g, oracle(q, op, fr)), (op, fr, q)
                (pv, pvo, pc), = port.boolean_staged(
                    [qs], op, fr, columnar=True, prefix_p=2)
                for i, q in enumerate(qs):
                    w = oracle(q, op, fr)
                    assert pc[i] == len(w) == len(ref[i]), (op, fr, q)
                    assert np.array_equal(pv[pvo[i]:pvo[i + 1]], w[:2])
                    assert np.array_equal(pv[pvo[i]:pvo[i + 1]], ref[i][:2])
            (gv, gvo), = port.lookup_staged([terms], fr, columnar=True)
            (rv, rvo), = jx.lookup_staged([terms], fr, columnar=True)
            assert np.array_equal(gv, rv) and np.array_equal(gvo, rvo)
            for i, t in enumerate(terms):
                assert gv[gvo[i]:gvo[i + 1]].tolist() == want(t, fr), t
        mid = terms[len(terms) // 2]
        for lo, hi in ((None, None), (terms[0], mid), (mid, None)):
            got = list(port.read_range(lo, hi))
            ref = list(jx.read_range(lo, hi))
            assert [t for t, _ in got] == [t for t, _ in ref], (lo, hi)
            assert all(np.array_equal(a[1], b[1]) for a, b in zip(got, ref))
            assert [(t, v.tolist()) for t, v in got] == [
                (t, want(t, False)) for t in sorted(data)
                if (lo is None or t >= lo) and (hi is None or t <= hi)]
        prefixes = sorted({t[:2] for t in terms[::3]} | {b"zz-none"})
        got, ref = port.prefix_search(prefixes), jx.prefix_search(prefixes)
        assert set(got) == set(ref)
        for p in prefixes:
            vs = [data[t] for t in data if t.startswith(p)]
            if not vs:
                assert p not in got, p
            else:
                assert np.array_equal(got[p], ref[p]), p
                assert got[p].tolist() == sorted(set().union(*vs)), p


def _dump(ii):
    return {tv.term: set(tv.values.tolist())
            for tv in port_pkg.to_slice(ii.read(None, None))}


@pytest.mark.parametrize("seed", [0xC0FFEE, 1, 2024])
def test_random_workload_vs_oracle(tmp_path, seed):
    """Twin of test_differential.py's workload: rounds of puts (each shard
    at >= 2 segments), removals, merge-until-zero and a reopen every other
    round, refreshed after a round's first document (a delta once main
    has grown), after its other puts (past DELTA_FRACTION: a promotion),
    after the removals (tombstones only), after the merge (a rebuild) and
    after a reopen (unchanged)."""
    rng = np.random.default_rng(seed)
    life = Lifecycle(tmp_path, np.random.default_rng(seed + 1))
    data = {}
    vocab = [bytes(rng.integers(97, 105, size=int(rng.integers(1, 9)),
                                dtype=np.uint8)) for _ in range(60)]
    vocab = sorted(set(vocab))

    def put(terms, v):
        life.ii.put(terms, v)
        for t in set(terms):
            data.setdefault(t, set()).add(v)

    value = 0
    for round_ in range(6):
        for j in range(8):
            value += 1
            k = int(rng.integers(1, 8))
            terms = [vocab[i] for i in rng.choice(len(vocab), size=k,
                                                  replace=False)]
            put(terms, value)
            life.ii.put(terms, value)  # duplicate put: idempotent by union
            if j == 0 and life.port is not None:
                life.refresh(data, vocab)
        value += 1
        put(list(vocab), value)  # every shard at >= 2 segments
        assert _dump(life.ii) == data
        life.refresh(data, vocab)
        doomed = list(rng.choice(value, size=min(3, value), replace=False)
                      + 1)
        life.ii.put_removed(doomed)
        life.refresh(data, vocab)
        while life.ii.merge(2, 100, 2) > 0:
            pass
        data = {t: v - set(int(x) for x in doomed) for t, v in data.items()}
        data = {t: v for t, v in data.items() if v}
        assert _dump(life.ii) == data, round_
        life.refresh(data, vocab)
        if round_ % 2 == 1:
            life.reopen()
            assert _dump(life.ii) == data, round_
            life.refresh(data, vocab)
    assert KINDS <= set(life.kinds), life.kinds


def _mixed_workload(tmp_path, seed, vocab, rounds, put_many_every=0):
    """The workload of test_differential_shards.py (uneven puts, optional
    put_many, removals, merges at a random req that some shards skip,
    reopens) against its ShardOracle, refreshed after every step the
    original checks (the puts, the removals, the merges, a reopen) and
    after a put of at most two terms until one has given a delta."""
    rng = np.random.default_rng(seed)
    life = Lifecycle(tmp_path, np.random.default_rng(seed + 1))
    oracle = ShardOracle()
    value = 0
    for round_ in range(rounds):
        for _ in range(int(rng.integers(1, 6))):
            value += 1
            k = int(rng.integers(1, 7))
            terms = [vocab[i] for i in rng.choice(len(vocab), size=k,
                                                  replace=False)]
            life.ii.put(terms, value)
            oracle.put(terms, value)
            if k <= 2 and life.wants("delta"):
                life.refresh(oracle.dump(), vocab)
        if put_many_every and round_ % put_many_every == 1:
            docs = []
            for _ in range(3):
                value += 1
                k = int(rng.integers(1, 5))
                docs.append(([vocab[i] for i in rng.choice(
                    len(vocab), size=k, replace=False)], value))
            life.ii.put_many(docs)
            _oracle_put_many(oracle, docs)
        assert _dump(life.ii) == oracle.dump(), round_
        life.refresh(oracle.dump(), vocab)
        if rng.random() < 0.7 and value:
            doomed = (rng.choice(value, size=min(4, value), replace=False)
                      + 1).tolist()
            life.ii.put_removed(doomed)
            oracle.put_removed(doomed)
            life.refresh(oracle.dump(), vocab)
        req = int(rng.integers(2, 5))
        while True:
            want = oracle.merge(req)
            got = life.ii.merge(req, 100, 3)
            assert got == want, (round_, req)
            if got == 0:
                break
        assert _dump(life.ii) == oracle.dump(), round_
        life.refresh(oracle.dump(), vocab)
        if round_ % 3 == 2:
            life.reopen()
            life.refresh(oracle.dump(), vocab)
    return life


@pytest.mark.parametrize("seed", [7, 0xBEEF, 20260816])
def test_mixed_regime_random_workload(tmp_path, seed):
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, size=int(rng.integers(1, 9)),
                                dtype=np.uint8)) for _ in range(50)]
    vocab = sorted(set(v for v in vocab + [b"a", b"z"] if v))
    life = _mixed_workload(tmp_path, seed, vocab, rounds=8)
    assert KINDS <= set(life.kinds), life.kinds


@pytest.mark.parametrize("seed", [3, 0xC0FFEE, 20260817])
def test_hostile_terms_differential(tmp_path, seed):
    life = _mixed_workload(tmp_path, seed, HOSTILE_VOCAB, rounds=6,
                           put_many_every=2)
    assert KINDS <= set(life.kinds), life.kinds


def test_tombstones_missed_when_batch_counts_hold(tmp_path):
    """A fault of the reference, copied: Shard.remove drops the batches
    older than every live segment before it appends its own, so after a
    merge a put_removed can leave each shard's batch count, and with it
    the index fingerprint, as it was. refresh() then returns False in both
    packages and filter_removed keeps the old tombstones: id 2, removed,
    is still served (JAX: [2, 3]) and id 1, long purged, stays listed."""
    out = {}
    for name, pkg in (("jax", jax_pkg), ("port", port_pkg)):
        ii = pkg.InvertedIndex(str(tmp_path / name))
        for v in (1, 2, 3):
            ii.put([b"kk"], v)
        ii.put_removed([1])
        while ii.merge(2, 100, 1) > 0:
            pass
        eng = (jax_qe.QueryEngine.from_index(ii, L=128) if name == "jax"
               else QueryEngine.from_index(ii, L=128, device="cpu"))
        ii.put_removed([2])
        counts = [len(sh.removed_list) for sh in ii._snapshot()]
        out[name] = (counts, eng.refresh(ii),
                     eng.lookup([b"kk"], filter_removed=True)[0].tolist())
    assert out["jax"] == ([1], False, [2, 3])
    assert out["port"] == out["jax"]


def test_phase_lifecycle_small(monkeypatch):
    """chip_smoke.py's phase 9 on the CPU at 2,000 terms of mean length
    200: the corpus as segment files, both engines, the readers racing the
    writer, every refresh kind, the oracle and the mesh at every quiet
    state."""
    for name, value in (("BATCH", 32), ("L_MAIN", 256), ("LIFE_DOCS", 64),
                        ("LIFE_SAMPLE", 8), ("LIFE_IDLE_S", 0.2),
                        ("LIFE_WINDOW", 32)):
        monkeypatch.setattr(chip_smoke, name, value)
    terms_mat, _, values, voffs = chip_smoke.gen_corpus(2000, 200, 0)
    out = chip_smoke.phase_lifecycle(torch, terms_mat, values, voffs, 9,
                                     device="cpu", mesh=["cpu"] * 4)
    assert out["kinds"]["single"] == ["delta", "tombstones", "promotion",
                                      "tombstones", "delta", "tombstones",
                                      "rebuild"]
    assert all(q[1] > 0 for q in out["qps"].values())


def test_refresh_concurrent_with_writers(tmp_path):
    """Twin of tests/test_query_engine.py's: delta refreshes racing two
    writers and a merger stay exact; once quiet, a refresh equals the host
    read and the JAX engine over the same directory."""
    ii = port_pkg.InvertedIndex(str(tmp_path))
    ii.put([b"seed"], 1)
    eng = QueryEngine.from_index(ii, L=128, device="cpu")
    stop = threading.Event()

    def writer(base):
        v = base
        while not stop.is_set():
            v += 1
            ii.put([f"w{base}-{v % 37:02d}".encode()], v)

    def merger():
        while not stop.is_set():
            ii.merge(2, 100, 2)

    threads = [threading.Thread(target=writer, args=(b,))
               for b in (1000, 2000)]
    threads.append(threading.Thread(target=merger))
    for t in threads:
        t.start()
    try:
        for _ in range(15):
            eng.refresh(ii)  # mixes delta and full rebuilds under churn
            got = eng.lookup([b"seed"])[0]
            assert got is not None and got.tolist() == [1]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    eng.refresh(ii)
    host = {tv.term: tv.values.tolist()
            for tv in port_pkg.to_slice(ii.read(None, None))}
    terms = sorted(host)
    ref = jax_qe.QueryEngine.from_index(jax_pkg.InvertedIndex(str(tmp_path)),
                                        L=128, q_bucket=8)
    for t, g, r in zip(terms, eng.lookup(terms), ref.lookup_host(terms)):
        assert g is not None and g.tolist() == host[t] == r.tolist(), t


VICTIM = b"victim"
GROW = b"grow"


def test_refresh_vs_serve_storm_mesh_engine(tmp_path):
    """Twin of tests/test_serving_race.py's mesh storm: readers serve
    lookup and boolean through a MeshQueryEngine of four CPU partitions
    while a writer loops put / refresh / put_removed / refresh / merge /
    refresh: once a refresh that hides or purges an id has returned, no
    filtered read shows it; no id a finished refresh published is lost;
    no reader raises."""
    from inverted_index_2_tpu_torch import MeshQueryEngine

    ii = port_pkg.InvertedIndex(str(tmp_path))
    base = [f"base{i:02d}".encode() for i in range(12)]
    for doc in range(1, 13):
        ii.put([base[doc % 12], GROW, VICTIM], doc)
    eng = MeshQueryEngine(ii, mesh=["cpu"] * 4, L=128)
    lock = threading.Lock()
    banned, grown = set(), set(range(1, 13))
    done = threading.Event()
    errors = []
    rounds = 3

    def writer():
        try:
            for r in range(rounds):
                vdoc, gdoc = 10_000 + r, 20_000 + r
                ii.put([VICTIM, b"extra%d" % r], vdoc)
                ii.put([GROW], gdoc)
                eng.refresh(ii)
                with lock:
                    grown.add(gdoc)
                ii.put_removed([vdoc])
                eng.refresh(ii)
                with lock:
                    banned.add(vdoc)
                while ii.merge(1, 1_000, 2) > 0:
                    pass
                eng.refresh(ii)
        except BaseException as e:
            errors.append(e)
        finally:
            done.set()

    def check(ban, grow, victim_rows, grow_rows):
        got_v = set() if victim_rows is None else set(victim_rows.tolist())
        assert not got_v & ban, f"resurrected: {sorted(got_v & ban)}"
        got_g = set() if grow_rows is None else set(grow_rows.tolist())
        assert not grow - got_g, f"lost: {sorted(grow - got_g)[:8]}"

    def serve_lookup():
        rows = eng.lookup([VICTIM, GROW], filter_removed=True)
        return rows[0], rows[1]

    def serve_boolean():
        return (eng.boolean([[VICTIM]], "or", filter_removed=True)[0],
                eng.boolean([[GROW]], "and", filter_removed=True)[0])

    def reader(serve, ready):
        try:
            while not done.is_set():
                with lock:
                    ban, grow = set(banned), set(grown)
                check(ban, grow, *serve())
                ready.set()
        except BaseException as e:
            errors.append(e)
            ready.set()

    ready = [threading.Event(), threading.Event()]
    threads = [threading.Thread(target=reader, args=(s, r))
               for s, r in zip((serve_lookup, serve_boolean), ready)]
    w = threading.Thread(target=writer)
    for t in threads:
        t.start()
    assert all(r.wait(timeout=120) for r in ready)  # both serve first
    w.start()
    for t in [w] + threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads + [w])
    if errors:
        raise errors[0]
    final = eng.lookup([VICTIM], filter_removed=True)[0]
    got = set() if final is None else set(final.tolist())
    assert not got & {10_000 + r for r in range(rounds)}
