"""The port's MeshQueryEngine on the CPU against the JAX package's, on one
directory: the port's InvertedIndex writes it, the JAX package reopens it
(at every refresh too), and both engines serve it over D partitions (the
port's on devices=["cpu"] * D, JAX's on its virtual CPU devices). The six
lifecycles of tests/test_mesh_engine.py, each compared result for result,
plus a promotion past DELTA_FRACTION; the port's single-device QueryEngine
on the same index is held to the same answers. Every comparison is exact."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import inverted_index_2_tpu as jax_pkg
from inverted_index_2_tpu.models.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from inverted_index_2_tpu.parallel import MeshQueryEngine as JaxMesh
from inverted_index_2_tpu.parallel import mesh as jpm

import inverted_index_2_tpu_torch as port_pkg
from inverted_index_2_tpu_torch import MeshQueryEngine, QueryEngine
from inverted_index_2_tpu_torch.models.checkpoint import save_checkpoint

torch.set_num_threads(1)

EDGE = [0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]


@pytest.fixture(autouse=True)
def _device_route(monkeypatch):
    # the single-device engine's device route, as the mesh has no other
    monkeypatch.setenv("TPI_HOST_BOOL", "0")


@pytest.fixture(scope="module", autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _build_index(path, rng, n_docs=60, removed=(3, 7, 11, 20)):
    ii = port_pkg.InvertedIndex(str(path))
    vocab = [bytes([a, b]) + f"t{i}".encode() for i, (a, b) in enumerate(
        (int(x), int(y)) for x, y in rng.integers(32, 127, size=(90, 2)))]
    for doc in list(range(1, n_docs)) + EDGE:
        k = int(rng.integers(1, 6))
        ii.put([vocab[i] for i in rng.choice(len(vocab), size=k,
                                             replace=False)], doc)
    ii.put_removed(np.asarray(list(removed) + [0xFFFFFFFE],
                              dtype=np.uint32))
    return ii, vocab


def _rows_equal(a, b, ctx):
    assert len(a) == len(b), ctx
    for i, (x, y) in enumerate(zip(a, b)):
        if x is None or y is None:
            assert x is None and y is None, (ctx, i)
        else:
            assert np.array_equal(x, y), (ctx, i, x, y)


def _staged_equal(a, b, ctx):
    assert len(a) == len(b), ctx
    for bi, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, tuple):
            assert len(x) == len(y)
            for u, w in zip(x, y):
                assert np.array_equal(u, w), (ctx, bi)
        else:
            _rows_equal(x, y, (ctx, bi))


class Pair:
    """The port's mesh engine over a port-written index and the JAX mesh
    engine over the same directory, both at D partitions."""

    def __init__(self, ii, D=4, L=128):
        self.ii, self.D, self.L = ii, D, L
        self.port = MeshQueryEngine(ii, mesh=["cpu"] * D, L=L)
        self.jax = JaxMesh(self._jax_index(), mesh=jpm.default_mesh(D), L=L,
                           q_bucket=8)

    def _jax_index(self):
        return jax_pkg.InvertedIndex(self.ii.basedir)

    def refresh(self):
        a = self.port.refresh(self.ii)
        b = self.jax.refresh(self._jax_index())
        assert a == b
        assert (self.port.delta is None) == (self.jax.delta is None)
        return a

    def chip(self):
        return QueryEngine.from_index(self.ii, L=self.L, device="cpu")

    def same(self, terms, queries, chip=None, ops=("and", "or")):
        for fr in (False, True):
            got = self.port.lookup(terms, filter_removed=fr)
            _rows_equal(got, self.jax.lookup(terms, filter_removed=fr),
                        ("lookup", fr))
            if chip is not None:
                _rows_equal(got, chip.lookup(terms, filter_removed=fr),
                            ("chip lookup", fr))
            for op in ops:
                got = self.port.boolean(queries, op, filter_removed=fr)
                _rows_equal(got, self.jax.boolean(queries, op,
                                                  filter_removed=fr),
                            (op, fr))
                if chip is not None:
                    _rows_equal(got, chip.boolean(queries, op,
                                                  filter_removed=fr),
                                ("chip", op, fr))


def test_mesh_engine_bit_identity(tmp_path):
    rng = np.random.default_rng(11)
    ii, vocab = _build_index(tmp_path, rng)
    for D in (1, 4):
        p = Pair(ii, D=D)
        assert p.port.warmup(k_max=3) == p.jax.warmup(k_max=3)
        assert p.port.stats() == p.jax.stats()
        queries = [[vocab[0], vocab[1]], [vocab[2], vocab[3], vocab[4]],
                   [vocab[5], b"@@missing"], [vocab[6]], [vocab[7], vocab[7]]]
        p.same(vocab[:25] + [b"@@missing"], queries, chip=p.chip())
        prefixes = [v[:2] for v in vocab[:10]] + [b"\x00\x00nope", b""]
        got = p.port.prefix_search(prefixes)
        want = p.jax.prefix_search(prefixes)
        assert list(got) == list(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
        for lo, hi in ((None, None), (vocab[3], vocab[40])):
            a = [(t, v.tolist()) for t, v in p.port.read_range(lo, hi)]
            b = [(t, v.tolist()) for t, v in p.jax.read_range(lo, hi)]
            assert a == b


def test_mesh_engine_refresh_delta_and_promote(tmp_path):
    rng = np.random.default_rng(13)
    ii, vocab = _build_index(tmp_path, rng, n_docs=40, removed=(2,))
    p = Pair(ii)
    assert p.refresh() is False  # fingerprint no-op

    # additive change -> delta tier on partition 0, results track the index
    ii.put([vocab[0], b"zz-new-term", b"\x00"], 999)
    ii.put([vocab[0]], 0xFFFFFFFF - 1)
    assert p.refresh() is True and p.port.delta is not None
    st = p.port.stats()
    assert st == p.jax.stats()
    assert st["delta_terms"] == 3
    assert p.port.delta.n_real.tolist() == [3, 0, 0, 0]
    q = [[vocab[0], b"zz-new-term"], [vocab[0]], [b"\x00", vocab[1]]]
    p.same([vocab[0], b"zz-new-term", b"\x00", b"nope"], q, chip=p.chip())
    a = [(t, v.tolist()) for t, v in p.port.read_range(None, None)]
    assert a == [(t, v.tolist()) for t, v in p.jax.read_range(None, None)]

    # tombstone-only change refreshes the removed array, no rebuild
    ii.put_removed(np.asarray([999], dtype=np.uint32))
    assert p.refresh() is True
    assert 999 in p.port._removed.numpy().view(np.uint32).tolist()
    got = p.port.boolean([[vocab[0], b"zz-new-term"]], "and",
                         filter_removed=True)
    assert 999 not in got[0].tolist()
    p.same([vocab[0], b"zz-new-term"], q)

    # compaction (segments vanish) -> full rebuild, the delta folds in
    while ii.merge(2, 100, 2):
        pass
    assert p.refresh() is True and p.port.delta is None
    p.same([vocab[0], b"zz-new-term"], q, chip=p.chip())

    # a delta past DELTA_FRACTION of main promotes through a rebuild
    for v in range(2000, 2040):
        ii.put([f"grow{v}".encode(), vocab[1]], v)
    assert p.refresh() is True and p.port.delta is None
    assert p.jax.delta is None
    p.same([b"grow2001", vocab[1], b"grow1"], [[b"grow2001", vocab[1]]],
           chip=p.chip())


def test_mesh_engine_from_checkpoint(tmp_path):
    rng = np.random.default_rng(17)
    ii, vocab = _build_index(tmp_path / "idx", rng)
    path = str(tmp_path / "serve.ckpt")
    save_checkpoint(ii, path)
    jpath = str(tmp_path / "jax.ckpt")
    jax_save_checkpoint(jax_pkg.InvertedIndex(ii.basedir), jpath)

    fresh = MeshQueryEngine(ii, mesh=["cpu"] * 4, L=128)
    warm = MeshQueryEngine.from_checkpoint(path, index=ii,
                                           mesh=["cpu"] * 4, L=128)
    assert warm.delta is None  # the fingerprint matched: no refresh work
    jwarm = JaxMesh.from_checkpoint(jpath, mesh=jpm.default_mesh(4), L=128,
                                    q_bucket=8)
    # the JAX package's checkpoint, served by the port
    pwarm = MeshQueryEngine.from_checkpoint(jpath, mesh=["cpu"] * 4, L=128)
    terms = vocab[:20] + [b"@@missing"]
    queries = [[vocab[0], vocab[1]], [vocab[2], vocab[3], vocab[4]],
               [vocab[5], b"@@missing"]]
    for fr in (False, True):
        want = fresh.lookup(terms, filter_removed=fr)
        for e in (warm, jwarm, pwarm):
            _rows_equal(e.lookup(terms, filter_removed=fr), want,
                        ("ckpt lookup", fr))
    for op in ("and", "or"):
        want = fresh.boolean(queries, op, filter_removed=True)
        for e in (warm, jwarm, pwarm):
            _rows_equal(e.boolean(queries, op, filter_removed=True), want,
                        ("ckpt", op))
    rows = [(t, v.tolist()) for t, v in fresh.read_range(None, None)]
    assert [(t, v.tolist()) for t, v in warm.read_range(None, None)] == rows
    assert [(t, v.tolist()) for t, v in jwarm.read_range(None, None)] == rows

    # stale checkpoint: additive drift -> a delta tier at load
    ii.put([vocab[1], b"zz-late"], 500)
    warm2 = MeshQueryEngine.from_checkpoint(path, index=ii,
                                            mesh=["cpu"] * 4, L=128)
    assert warm2.delta is not None
    chip = QueryEngine.from_index(ii, L=128, device="cpu")
    _rows_equal(warm2.lookup([vocab[1], b"zz-late"]),
                chip.lookup([vocab[1], b"zz-late"]), "ckpt-delta")

    # apply_removed checkpoints are refused for mesh serving
    p2 = str(tmp_path / "purged.ckpt")
    save_checkpoint(ii, p2, apply_removed=True)
    with pytest.raises(ValueError):
        MeshQueryEngine.from_checkpoint(p2, mesh=["cpu"])

    # without an index: the checkpointed state serves as it is
    warm3 = MeshQueryEngine.from_checkpoint(path, mesh=["cpu"] * 4, L=128)
    _rows_equal(warm3.lookup(terms), fresh.lookup(terms), "ckpt-noindex")


def _batches(vocab, seed, n, per):
    rq = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append([[vocab[i] for i in rq.choice(40, size=int(
            rq.integers(1, 4)), replace=False)] for _ in range(per)])
    return out


def test_mesh_engine_boolean_staged(tmp_path):
    rng = np.random.default_rng(17)
    ii, vocab = _build_index(tmp_path, rng, n_docs=90)
    for v in range(100, 300):  # a long list forces the ladder (L=128)
        ii.put([vocab[0], vocab[1]], v)
    p = Pair(ii, D=3)
    batches = _batches(vocab, 23, 3, 6)
    batches[0].append([vocab[0], vocab[1]])  # > L: a deferred re-serve
    batches.append([])
    for op in ("and", "or"):
        for fr in (False, True):
            for col in (False, True):
                got = p.port.boolean_staged(batches, op, filter_removed=fr,
                                            columnar=col)
                _staged_equal(got, p.jax.boolean_staged(
                    batches, op, filter_removed=fr, columnar=col),
                    (op, fr, col))
            rows = p.port.boolean_staged(batches, op, filter_removed=fr)
            for bi, qs in enumerate(batches):
                _rows_equal(rows[bi], p.port.boolean(qs, op,
                                                     filter_removed=fr),
                            (op, fr, bi))


def test_mesh_engine_boolean_staged_pagination(tmp_path):
    rng = np.random.default_rng(31)
    ii, vocab = _build_index(tmp_path, rng, n_docs=90)
    for v in range(100, 300):
        ii.put([vocab[0], vocab[1]], v)
    p = Pair(ii)
    batches = _batches(vocab, 29, 2, 6)
    batches[0].append([vocab[0], vocab[1]])   # a re-serve row
    batches[1].append([b"zz-missing", vocab[2]])
    batches.append([])
    with pytest.raises(ValueError):
        p.port.boolean_staged(batches, "or", prefix_p=4)

    def check(tag):
        for op in ("and", "or"):
            for fr in (False, True):
                for P in (3, 16):
                    got = p.port.boolean_staged(batches, op,
                                                filter_removed=fr,
                                                columnar=True, prefix_p=P)
                    _staged_equal(got, p.jax.boolean_staged(
                        batches, op, filter_removed=fr, columnar=True,
                        prefix_p=P), (tag, op, fr, P))
                    for bi, qs in enumerate(batches):
                        plain = p.port.boolean(qs, op, filter_removed=fr)
                        vals, voffs, counts = got[bi]
                        assert counts.tolist() == [len(r) for r in plain]
                        for qi, row in enumerate(plain):
                            assert np.array_equal(
                                vals[voffs[qi]:voffs[qi + 1]], row[:P])

    check("main")
    # a delta window: pagination serves through the per-batch path
    ii.put([vocab[2], b"delta-new"], 999)
    assert p.refresh() is True and p.port.delta is not None
    batches[1].append([b"delta-new", vocab[2]])
    check("delta")


def test_mesh_engine_lookup_staged(tmp_path):
    rng = np.random.default_rng(41)
    ii, vocab = _build_index(tmp_path, rng, n_docs=80)
    p = Pair(ii, D=8)
    batches = [vocab[:7] + [b"zz-missing"], vocab[7:15], []]
    for fr in (False, True):
        for kw in ({}, {"columnar": True}, {"columnar": True,
                                            "prefix_p": 4}):
            got = p.port.lookup_staged(batches, filter_removed=fr, **kw)
            _staged_equal(got, p.jax.lookup_staged(
                batches, filter_removed=fr, **kw), (fr, kw))
        plain = [p.port.lookup(b, filter_removed=fr) for b in batches]
        rows = p.port.lookup_staged(batches, filter_removed=fr)
        for bi, b in enumerate(batches):
            for qi in range(len(b)):
                want = plain[bi][qi]
                want = np.zeros(0, np.uint32) if want is None else want
                assert np.array_equal(rows[bi][qi], want), (fr, bi, qi)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the error raised without a CUDA device")
def test_mesh_engine_default_mesh_needs_cuda(tmp_path):
    ii, _ = _build_index(tmp_path, np.random.default_rng(5), n_docs=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshQueryEngine(ii)
