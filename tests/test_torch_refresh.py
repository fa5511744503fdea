"""The port's refresh lifecycle on the CPU against the JAX engine: the port
writes an index, the JAX package opens the same directory, and both
engines refresh from it. Ported from the refresh cases of
tests/test_query_engine.py (prefix and range reads left out: ROADMAP queue
1 item 8) and the QueryEngine storm of tests/test_serving_race.py. Every
comparison is exact."""
import threading

import numpy as np
import pytest
import torch

import inverted_index_2_tpu as jax_pkg
from inverted_index_2_tpu.models import query_engine as jax_qe

import inverted_index_2_tpu_torch as port_pkg
from inverted_index_2_tpu_torch import QueryEngine
from inverted_index_2_tpu_torch.models.snapshot import snapshot_tables

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _device_route(monkeypatch):
    # both engines' device routes: these tests exist for the dual step
    monkeypatch.setenv("TPI_HOST_BOOL", "0")


def _rows_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        if x is None or y is None:
            assert x is None and y is None, i
        else:
            assert np.array_equal(x, y), (i, x, y)


class Pair:
    """The port's engine over a port-written index, and the JAX engine over
    the same directory, reopened by the JAX package at every refresh."""

    def __init__(self, path, L=128, apply_removed=False):
        self.dir = str(path)
        self.ii = port_pkg.InvertedIndex(self.dir)
        self.L = L
        self.apply_removed = apply_removed

    def start(self):
        self.port = QueryEngine.from_index(
            self.ii, L=self.L, apply_removed=self.apply_removed, device="cpu")
        self.jax = jax_qe.QueryEngine.from_index(
            jax_pkg.InvertedIndex(self.dir), L=self.L,
            apply_removed=self.apply_removed, q_bucket=8)
        return self.port

    def refresh(self):
        a = self.port.refresh(self.ii, apply_removed=self.apply_removed)
        b = self.jax.refresh(jax_pkg.InvertedIndex(self.dir),
                             apply_removed=self.apply_removed)
        assert a == b
        assert (self.port.delta is None) == (self.jax.delta is None)
        if self.port.delta is not None:
            assert self.port.delta.n_terms == self.jax.delta.n_terms
        return a

    def same(self, terms, queries):
        for fr in (False, True):
            _rows_equal(self.port.lookup(terms, filter_removed=fr),
                        self.jax.lookup(terms, filter_removed=fr))
            for op in ("and", "or"):
                _rows_equal(self.port.boolean(queries, op, filter_removed=fr),
                            self.jax.boolean(queries, op, filter_removed=fr))


def _lookup(eng, term, fr=False):
    got = eng.lookup([term], filter_removed=fr)[0]
    return None if got is None else got.tolist()


def test_incremental_refresh_delta(tmp_path):
    p = Pair(tmp_path)
    for v in range(1, 50):
        p.ii.put([b"alpha", b"beta", f"t{v:03d}".encode()], v)
    eng = p.start()
    main_before = eng.snap
    # additive: a term gains values, and a new term wider than main's
    p.ii.put([b"alpha", b"gamma-very-long-term"], 100)
    p.ii.put([b"beta"], 101)
    assert p.refresh() is True
    assert eng.snap is main_before
    assert eng.delta is not None and eng.delta.n_terms == 3
    assert eng.delta.width > eng.snap.width
    assert _lookup(eng, b"alpha") == list(range(1, 50)) + [100]
    assert _lookup(eng, b"gamma-very-long-term") == [100]
    res = eng.boolean([[b"alpha", b"beta"],
                       [b"alpha", b"gamma-very-long-term"]], "and")
    assert res[0].tolist() == list(range(1, 50)) and res[1].tolist() == [100]
    res = eng.boolean([[b"beta", b"gamma-very-long-term"]], "or")
    assert res[0].tolist() == list(range(1, 50)) + [100, 101]
    terms = [b"alpha", b"beta", b"gamma-very-long-term", b"t007", b"none"]
    p.same(terms, [[b"alpha", b"beta"], [b"gamma-very-long-term", b"beta"],
                   [b"t007", b"alpha", b"none"], [b"t009"]])
    full = QueryEngine.from_index(p.ii, L=128, device="cpu")
    _rows_equal(full.lookup(terms), eng.lookup(terms))
    # a compaction removes segments: a rebuild, not a delta
    while p.ii.merge(2, 1000, 2) > 0:
        pass
    assert p.refresh() is True
    assert eng.delta is None and eng.snap is not main_before
    assert _lookup(eng, b"alpha") == list(range(1, 50)) + [100]
    p.same(terms, [[b"alpha", b"beta"], [b"gamma-very-long-term"]])


def test_incremental_refresh_promotes_on_big_delta(tmp_path):
    p = Pair(tmp_path)
    for v in range(1, 20):
        p.ii.put([f"base{v:03d}".encode()], v)
    eng = p.start()
    main_before = eng.snap
    for v in range(1, 20):  # a delta as large as main: promote
        p.ii.put([f"newt{v:03d}".encode()], 100 + v)
    assert p.refresh() is True
    assert eng.delta is None and eng.snap is not main_before
    assert _lookup(eng, b"newt005") == [105]
    p.same([b"newt005", b"base003", b"x"], [[b"newt005", b"base003"]])


def _assert_tables_equal(a, b):
    for f in ("keys", "counts", "words", "flat", "tbs", "removed", "slots"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.width, a.max_count, a.max_probes) == (b.width, b.max_count,
                                                    b.max_probes)


def test_promotion_merges_snapshots_bit_identical(tmp_path):
    rng = np.random.default_rng(5)
    p = Pair(tmp_path)
    vocab = [f"w{i:04d}".encode() for i in range(40)]
    for doc in range(1, 200):
        p.ii.put([vocab[j] for j in rng.choice(len(vocab), size=3,
                                               replace=False)], doc)
    p.ii.put_removed([7, 13])
    eng = p.start()
    main_before = eng.snap
    # shared terms gain values and new longer terms appear, beyond
    # DELTA_FRACTION: the refresh promotes
    for doc in range(500, 520):
        p.ii.put([vocab[0], vocab[1], f"zz-long-new-term{doc}".encode()], doc)
    assert p.refresh() is True
    assert eng.delta is None and eng.snap is not main_before
    # the promoted tables equal a rebuild of the same index from disk
    _assert_tables_equal(eng.tables, snapshot_tables(p.ii))
    full = QueryEngine.from_index(p.ii, L=128, device="cpu")
    for f in ("keys", "counts", "blocks", "removed"):
        assert torch.equal(getattr(eng.snap, f), getattr(full.snap, f)), f
    terms = vocab[:8] + [b"zz-long-new-term505"]
    p.same(terms, [[vocab[0], vocab[1]], [vocab[2], b"zz-long-new-term505"]])


def test_promotion_apply_removed_bit_identical(tmp_path):
    p = Pair(tmp_path, apply_removed=True)
    for v in range(1, 30):
        p.ii.put([b"common", f"t{v:03d}".encode()], v)
    p.ii.put_removed([3, 4])
    eng = p.start()
    for v in range(100, 120):  # an oversized delta: promotion
        p.ii.put([b"common", f"n{v}".encode()], v)
    assert p.refresh() is True
    assert eng.delta is None
    _assert_tables_equal(eng.tables, snapshot_tables(p.ii,
                                                     apply_removed=True))
    got = _lookup(eng, b"common")
    assert 3 not in got and 4 not in got and 119 in got
    p.same([b"common", b"t003", b"n105"], [[b"common", b"n105"]])


def test_incremental_refresh_tombstones(tmp_path):
    p = Pair(tmp_path)
    # fill terms keep the one-term delta under DELTA_FRACTION of main
    p.ii.put([b"k1", b"k2"] + [f"fill{i}".encode() for i in range(8)], 1)
    p.ii.put([b"k1"], 2)
    eng = p.start()
    p.ii.put([b"k3"], 3)
    p.ii.put_removed([1])
    assert p.refresh() is True
    assert eng.delta is not None
    assert _lookup(eng, b"k1", fr=True) == [2]
    assert _lookup(eng, b"k2", fr=True) in (None, [])
    assert _lookup(eng, b"k3") == [3]
    # a tombstone-only change keeps main and refreshes the tombstones
    main = eng.snap
    p.ii.put_removed([2])
    assert p.refresh() is True
    assert eng.snap is main and eng.delta is not None
    assert _lookup(eng, b"k1", fr=True) in (None, [])
    p.same([b"k1", b"k2", b"k3"], [[b"k1", b"k2"], [b"k1", b"k3"]])


def test_refresh_noop_detection(tmp_path):
    p = Pair(tmp_path)
    p.ii.put([b"a"], 1)
    eng = p.start()
    assert p.refresh() is False  # from_index recorded the fingerprint
    p.ii.put([b"b"], 2)
    assert p.refresh() is True
    assert p.refresh() is False
    assert _lookup(eng, b"b") == [2]


def test_refresh_rederives_width(tmp_path):
    p = Pair(tmp_path)
    p.ii.put([b"ab"], 1)
    eng = p.start()
    p.ii.put([b"abcdefgh-long1"], 2)
    p.ii.put([b"abcdefgh-long2"], 3)
    assert p.refresh() is True
    assert _lookup(eng, b"abcdefgh-long1") == [2]
    assert _lookup(eng, b"abcdefgh-long2") == [3]
    assert eng.snap.width >= 4  # promoted: width from the new corpus
    p.same([b"ab", b"abcdefgh-long1", b"abcdefgh-long2", b"abcdefgh"],
           [[b"abcdefgh-long1", b"ab"]])


def test_delta_refresh_apply_removed_purges(tmp_path):
    p = Pair(tmp_path, apply_removed=True)
    p.ii.put([b"k1", b"k2"] + [f"fill{i:02d}".encode() for i in range(20)], 1)
    p.ii.put([b"k1"], 7)
    p.ii.put_removed([7])
    eng = p.start()
    assert _lookup(eng, b"k1") == [1]
    main_before = eng.snap
    p.ii.put([b"k1", b"k3"], 7)  # 7 comes back in a new segment
    assert p.refresh() is True
    assert eng.snap is main_before  # the delta path, purged to nothing
    assert eng.delta is None
    assert _lookup(eng, b"k1") == [1] and _lookup(eng, b"k3") is None
    p.ii.put([b"k1", b"k3"], 8)  # the delta keeps 8, never 7
    assert p.refresh() is True
    assert eng.snap is main_before and eng.delta is not None
    full = QueryEngine.from_index(p.ii, L=128, apply_removed=True,
                                  device="cpu")
    assert _lookup(eng, b"k1") == _lookup(full, b"k1") == [1, 8]
    assert _lookup(eng, b"k3") == _lookup(full, b"k3") == [8]
    assert eng.boolean([[b"k1", b"k3"]], "and")[0].tolist() == [8]
    p.same([b"k1", b"k2", b"k3"], [[b"k1", b"k3"], [b"k2", b"k3"]])


def test_boolean_staged_dual_stream(tmp_path):
    """With a delta live, boolean_staged and lookup_staged stream through
    the padded dual step: rows, columnar and prefix_p pages equal boolean()
    and the JAX engine, with ladder re-serves at L=128."""
    p = Pair(tmp_path)
    for v in range(1, 300):  # a long list: re-served at L=128
        p.ii.put([b"aa-long", b"bb"], v)
    for v in range(1, 40):
        p.ii.put([b"cc", b"dd", f"fill{v:02d}".encode()], v * 2)
    p.ii.put_removed(np.asarray([4, 10], dtype=np.uint32))
    eng = p.start()
    p.ii.put([b"aa-long", b"ee-new"], 999)
    p.ii.put([b"cc", b"ee-new"], 1000)
    assert p.refresh() is True and eng.delta is not None
    batches = [
        [[b"aa-long", b"bb"], [b"cc"], [b"aa-long", b"ee-new"]],
        [[b"cc", b"dd"], [b"ee-new"], [b"zz-missing", b"cc"]],
        [],
    ]
    reserved = 0
    for op in ("and", "or"):
        for fr in (False, True):
            staged = eng.boolean_staged(batches, op, filter_removed=fr,
                                        depth=1)
            reserved += eng.last_stream_stats["ladder_reserve"]
            col = eng.boolean_staged(batches, op, filter_removed=fr,
                                     columnar=True)
            pre = eng.boolean_staged(batches, op, filter_removed=fr,
                                     columnar=True, prefix_p=3)
            jcol = p.jax.boolean_staged(batches, op, filter_removed=fr,
                                        columnar=True)
            jpre = p.jax.boolean_staged(batches, op, filter_removed=fr,
                                        columnar=True, prefix_p=3)
            for bi, qs in enumerate(batches):
                plain = eng.boolean(qs, op, filter_removed=fr)
                _rows_equal(staged[bi], plain)
                vals, voffs = col[bi]
                pv, pvo, pc = pre[bi]
                assert len(voffs) == len(qs) + 1
                for qi in range(len(qs)):
                    assert np.array_equal(vals[voffs[qi]: voffs[qi + 1]],
                                          plain[qi])
                    assert pc[qi] == len(plain[qi])
                    assert np.array_equal(pv[pvo[qi]: pvo[qi + 1]],
                                          plain[qi][:3])
                for a, b in zip(col[bi], jcol[bi]):
                    assert np.array_equal(a, b)
                for a, b in zip(pre[bi], jpre[bi]):
                    assert np.array_equal(a, b)
    assert reserved > 0
    terms = [[b"aa-long", b"ee-new", b"zz-missing", b"cc"], [b"bb"]]
    # with retained tables lookup_staged serves on the host: the dual
    # stream's lookup runs on an engine over the same state without them
    bare = QueryEngine(eng.snap, L=eng.L, device="cpu")
    bare._publish(eng._state.replace(tables=None, delta_tables=None))
    for fr in (False, True):
        got = bare.lookup_staged(terms, filter_removed=fr, columnar=True)
        want = p.jax.lookup_staged(terms, filter_removed=fr, columnar=True)
        for g, w in zip(got, want):
            assert all(np.array_equal(a, b) for a, b in zip(g, w))
    p.same([b"aa-long", b"ee-new", b"cc", b"bb"],
           [[b"aa-long", b"bb"], [b"cc", b"ee-new"], [b"aa-long"]])


VICTIM = b"victim"
GROW = b"grow"


def test_refresh_vs_serve_storm(tmp_path):
    """Readers hammer lookup, boolean and boolean_staged while a writer
    loops put / put_removed / merge / refresh: once a refresh that hides or
    purges a value has returned, no filtered read shows it again, and every
    value a completed refresh published stays visible."""
    ii = port_pkg.InvertedIndex(str(tmp_path))
    base_terms = [f"base{i:02d}".encode() for i in range(12)]
    for doc in range(1, 13):
        ii.put([base_terms[doc % 12], GROW, VICTIM], doc)
    eng = QueryEngine.from_index(ii, L=128, device="cpu")
    lock = threading.Lock()
    banned, grown = set(), set(range(1, 13))
    done = threading.Event()
    errors = []
    rounds = 3

    def writer():
        try:
            for r in range(rounds):
                vdoc, gdoc = 10_000 + r, 20_000 + r
                # additive: the delta path (the victim doc must not carry
                # GROW, or its tombstone would hide GROW too)
                ii.put([VICTIM, b"extra%d" % r], vdoc)
                ii.put([GROW], gdoc)
                eng.refresh(ii)
                with lock:
                    grown.add(gdoc)
                ii.put_removed([vdoc])
                eng.refresh(ii)
                with lock:
                    banned.add(vdoc)
                # purge for real: merge to one segment, then a rebuild (the
                # tombstone array shrinks while the doc leaves the segments)
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
                eng.boolean([[GROW, GROW]], "and", filter_removed=True)[0])

    def serve_staged():
        out = eng.boolean_staged([[[VICTIM]], [[GROW]]], "or",
                                 filter_removed=True)
        return out[0][0], out[1][0]

    def reader(serve):
        try:
            while not done.is_set():
                with lock:
                    ban, grow = set(banned), set(grown)
                check(ban, grow, *serve())
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(s,))
               for s in (serve_lookup, serve_boolean, serve_staged)]
    w = threading.Thread(target=writer)
    for t in threads:
        t.start()
    w.start()
    w.join()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    final_v, final_g = (set(r.tolist()) for r in eng.lookup(
        [VICTIM, GROW], filter_removed=True))
    assert not final_v & {10_000 + r for r in range(rounds)}
    assert {20_000 + r for r in range(rounds)} <= final_g
