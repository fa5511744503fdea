"""The port's serving checkpoints on the CPU (twins of
tests/test_checkpoint.py): a checkpoint round-trips the host tables and the
fingerprint; an engine warm-started from one serves what a fresh build
serves; a stale one reconciles through refresh() (unchanged: no-op,
additive drift: a delta, a merge: a rebuild); auto-resave tracks the main
tier; the warm window serves every entry point from the host tables while
the upload is held, and a changed index waits for the swap. Checkpoints
cross between the packages both ways, and an unchanged index is a no-op
in both.

The port writes the index; the JAX package opens the same directory."""
import os
import threading
import time

import numpy as np
import pytest
import torch

import inverted_index_2_tpu as jax_pkg
from inverted_index_2_tpu.models import checkpoint as jax_ckpt
from inverted_index_2_tpu.models import query_engine as jax_qe

import inverted_index_2_tpu_torch as port_pkg
from inverted_index_2_tpu_torch import QueryEngine
from inverted_index_2_tpu_torch.models import query_engine as port_qe
from inverted_index_2_tpu_torch.models.checkpoint import (
    _ARRAYS,
    load_checkpoint,
    load_fingerprint,
    save_checkpoint,
)
from inverted_index_2_tpu_torch.models.snapshot import (
    _index_fingerprint,
    snapshot_tables,
)

torch.set_num_threads(1)


def _within(seconds, fn):
    """fn() on a thread; fails the test if it has not returned in time."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:
            err.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(seconds)
    assert not th.is_alive(), f"no result within {seconds} s"
    if err:
        raise err[0]
    return out[0]


def build_index(path, rng, n_docs=60, n_terms=40):
    ii = port_pkg.InvertedIndex(str(path))
    vocab = ([f"term{i:03d}".encode() for i in range(n_terms)]
             + [b"a", b"", b"\xff\xff"])
    truth = {}
    for doc in range(1, n_docs + 1):
        k = int(rng.integers(1, 6))
        terms = [vocab[i] for i in rng.choice(len(vocab), size=k,
                                              replace=False)]
        ii.put(terms, doc)
        for t in terms:
            truth.setdefault(t, set()).add(doc)
    return ii, truth


def _results(eng, terms):
    return {"lk": eng.lookup(terms),
            "lkf": eng.lookup(terms, filter_removed=True),
            "rr": [(t, v.tolist()) for t, v in eng.read_range(None, None)],
            "rr2": [(t, v.tolist())
                    for t, v in eng.read_range(b"term005", b"term030")],
            "pf": {k: v.tolist() for k, v in
                   eng.prefix_search([b"term0", b"nope", b"\xff"]).items()}}


def _assert_same(a, b):
    assert a["rr"] == b["rr"] and a["rr2"] == b["rr2"] and a["pf"] == b["pf"]
    for key in ("lk", "lkf"):
        for x, y in zip(a[key], b[key]):
            assert (x is None and y is None) or np.array_equal(x, y), key


def _terms(truth):
    return sorted(truth) + [b"missing"]


def test_checkpoint_roundtrip_tables(tmp_path, rng):
    ii, _ = build_index(tmp_path / "idx", rng)
    path = str(tmp_path / "snap.ckpt")
    meta = save_checkpoint(ii, path)
    fresh = snapshot_tables(ii)
    t, meta2 = load_checkpoint(path)
    assert meta2["n_terms"] == fresh.n_terms == meta["n_terms"]
    for name in _ARRAYS:
        np.testing.assert_array_equal(getattr(t, name), getattr(fresh, name))
    for name in ("max_probes", "max_count", "width", "max_bw"):
        assert getattr(t, name) == getattr(fresh, name), name
    assert load_fingerprint(meta2) == _index_fingerprint(ii, False)
    assert not os.path.exists(path + ".tmp")


def test_from_checkpoint_serves_identically(tmp_path, rng):
    ii, truth = build_index(tmp_path / "idx", rng)
    ii.put_removed([3, 4])
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)
    fresh = QueryEngine.from_index(ii, L=256, device="cpu")
    warm = QueryEngine.from_checkpoint(path, L=256, device="cpu")
    _within(60, warm.device_wait)
    want = _results(fresh, _terms(truth))
    _assert_same(want, _results(warm, _terms(truth)))
    jax_eng = jax_qe.QueryEngine.from_index(
        jax_pkg.InvertedIndex(str(tmp_path / "idx")), L=256, q_bucket=8)
    _assert_same(want, _results(jax_eng, _terms(truth)))


def test_from_checkpoint_unchanged_index_is_noop(tmp_path, rng):
    ii, truth = build_index(tmp_path / "idx", rng)
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)
    warm = QueryEngine.from_checkpoint(path, index=ii, L=256, device="cpu")
    assert warm.delta is None
    assert warm._fingerprint == _index_fingerprint(ii, False)
    assert warm._busy_fn == ii.is_busy
    _within(60, warm.device_wait)
    fresh = QueryEngine.from_index(ii, L=256, device="cpu")
    _assert_same(_results(fresh, _terms(truth)),
                 _results(warm, _terms(truth)))


def test_stale_checkpoint_additive_drift_uses_delta(tmp_path, rng):
    ii, truth = build_index(tmp_path / "idx", rng)
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)
    ii.put([b"term000", b"brandnew"], 999)
    truth.setdefault(b"term000", set()).add(999)
    truth.setdefault(b"brandnew", set()).add(999)
    warm = QueryEngine.from_checkpoint(path, index=ii, L=256, device="cpu")
    assert warm.delta is not None and warm.device_ready()
    for t in (b"term000", b"brandnew"):
        assert warm.lookup([t])[0].tolist() == sorted(truth[t]), t
    fresh = QueryEngine.from_index(ii, L=256, device="cpu")
    _assert_same(_results(fresh, _terms(truth)),
                 _results(warm, _terms(truth)))


def test_stale_checkpoint_after_merge_full_rebuild(tmp_path, rng):
    ii, truth = build_index(tmp_path / "idx", rng)
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)
    ii.put_removed([1, 2])
    while ii.merge(2, 100, 2) > 0:
        pass
    warm = QueryEngine.from_checkpoint(path, index=ii, L=256, device="cpu")
    assert warm.delta is None
    assert warm._fingerprint == _index_fingerprint(ii, False)
    fresh = QueryEngine.from_index(ii, L=256, device="cpu")
    _assert_same(_results(fresh, _terms(truth)),
                 _results(warm, _terms(truth)))


def test_checkpoint_apply_removed(tmp_path, rng):
    ii, truth = build_index(tmp_path / "idx", rng, n_docs=30)
    ii.put_removed([5, 6])
    path = str(tmp_path / "snap.ckpt")
    assert save_checkpoint(ii, path, apply_removed=True)["apply_removed"]
    warm = QueryEngine.from_checkpoint(path, index=ii, L=256, device="cpu")
    assert warm.refresh(ii, apply_removed=True) is False
    for t, docs in truth.items():
        want = sorted(docs - {5, 6})
        got = warm.lookup([t])[0]
        assert (got is None and not want) or got.tolist() == want, t


def test_checkpoint_empty_index(tmp_path):
    ii = port_pkg.InvertedIndex(str(tmp_path / "idx"))
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)
    warm = QueryEngine.from_checkpoint(path, index=ii, L=256, device="cpu")
    assert warm.device_ready() and warm.snap.n_terms == 0
    assert warm.lookup([b"anything"]) == [None]
    assert list(warm.read_range()) == [] and warm.prefix_search([b"a"]) == {}


def test_corrupt_checkpoint_raises_value_error(tmp_path, rng):
    ii, _ = build_index(tmp_path / "idx", rng, n_docs=5)
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)
    foreign = str(tmp_path / "foreign.npz")
    np.savez(foreign, a=np.arange(3))
    with pytest.raises(ValueError):
        load_checkpoint(foreign)
    raw = open(path, "rb").read()
    bad = str(tmp_path / "trunc.ckpt")
    open(bad, "wb").write(raw[: len(raw) // 2])
    with pytest.raises(Exception):
        load_checkpoint(bad)


def test_auto_checkpoint_tracks_main_rebuilds(tmp_path, rng):
    ii, truth = build_index(tmp_path / "idx", rng)
    path = str(tmp_path / "auto.ckpt")
    eng = QueryEngine.from_index(ii, L=256, checkpoint_path=path,
                                 checkpoint_async=False, device="cpu")
    assert load_fingerprint(load_checkpoint(path)[1]) == eng._main_fp
    # a delta-only refresh leaves the file at the main tier's fingerprint
    ii.put([b"term000", b"tiny"], 901)
    assert eng.refresh(ii) is True and eng.delta is not None
    assert load_fingerprint(load_checkpoint(path)[1]) == eng._main_fp \
        != eng._fingerprint
    warm = QueryEngine.from_checkpoint(path, index=ii, L=256, device="cpu")
    assert warm.lookup([b"tiny"])[0].tolist() == [901]
    # a compaction rebuilds, and the file follows
    while ii.merge(2, 100, 2) > 0:
        pass
    assert eng.refresh(ii) is True and eng.delta is None
    fp = load_fingerprint(load_checkpoint(path)[1])
    assert fp == _index_fingerprint(ii, False)
    warm2 = QueryEngine.from_checkpoint(path, L=256, device="cpu")
    _within(60, warm2.device_wait)
    truth.setdefault(b"term000", set()).add(901)
    truth[b"tiny"] = {901}
    _assert_same(_results(QueryEngine.from_index(ii, L=256, device="cpu"),
                          _terms(truth)), _results(warm2, _terms(truth)))
    # asynchronous saves publish atomically
    eng2 = QueryEngine.from_index(ii, L=256, device="cpu",
                                  checkpoint_path=str(tmp_path / "a.ckpt"))
    _within(60, eng2.checkpoint_wait)
    assert load_fingerprint(load_checkpoint(str(tmp_path / "a.ckpt"))[1]) \
        == eng2._main_fp
    assert not os.path.exists(str(tmp_path / "a.ckpt.tmp"))


@pytest.fixture
def gate(monkeypatch):
    """Hold the warm start's background upload until gate.set()."""
    ev = threading.Event()
    orig = port_qe.upload_tables

    def gated(t, **kw):
        if threading.current_thread().name == "tpi-ckpt-upload":
            ev.wait(timeout=60)
        return orig(t, **kw)

    monkeypatch.setattr(port_qe, "upload_tables", gated)
    yield ev
    ev.set()


def test_warm_checkpoint_serves_during_upload_window(tmp_path, rng, gate,
                                                     monkeypatch):
    monkeypatch.setenv("TPI_HOST_BOOL", "0")  # pinned: the window wins
    ii, truth = build_index(tmp_path / "idx", rng)
    ii.put_removed([3, 4])
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)
    warm = QueryEngine.from_checkpoint(path, L=256, device="cpu")
    assert not warm.device_ready() and warm.snap.n_terms == 0
    fresh = QueryEngine.from_index(ii, L=256, device="cpu")
    terms = sorted(truth)
    qs = [terms[:3], terms[3:5], [b"zz-miss", terms[0]]]

    def collect(eng):
        out = _results(eng, terms + [b"zz-miss"])
        for op in ("and", "or"):
            out[op] = eng.boolean(qs, op)
            out[op + "s"] = eng.boolean_staged([qs], op, columnar=True)[0]
            out[op + "p"] = eng.boolean_staged([qs], op, columnar=True,
                                               prefix_p=2)[0]
        out["ls"] = eng.lookup_staged([terms], columnar=True, prefix_p=2)[0]
        return out

    def assert_equal(a, b):
        _assert_same(a, b)
        for key in ("and", "or"):
            for x, y in zip(a[key], b[key]):
                assert np.array_equal(x, y), key
        for key in ("ands", "ors", "andp", "orp", "ls"):
            for x, y in zip(a[key], b[key]):
                assert np.array_equal(x, y), key

    window = collect(warm)
    assert not warm.device_ready()  # still inside the window
    assert_equal(window, collect(fresh))
    gate.set()
    _within(60, warm.device_wait)
    assert warm.device_ready() and warm.snap.n_terms == len(truth)
    assert_equal(window, collect(warm))
    # an unchanged index reconciles as a no-op without waiting
    gate.clear()
    t0 = time.monotonic()
    warm2 = _within(30, lambda: QueryEngine.from_checkpoint(
        path, index=ii, L=256, device="cpu"))
    assert warm2.lookup([terms[0]])[0] is not None
    assert not warm2.device_ready() and time.monotonic() - t0 < 30
    gate.set()
    _within(60, warm2.device_wait)


def test_warm_checkpoint_drift_waits_for_swap(tmp_path, rng):
    ii, _ = build_index(tmp_path / "idx", rng)
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)
    ii.put([b"term000", b"drifted"], 999)
    warm = _within(60, lambda: QueryEngine.from_checkpoint(
        path, index=ii, L=256, device="cpu"))
    assert warm.device_ready()  # drift waited for the swap, then refreshed
    assert warm.delta is not None
    assert warm.lookup([b"drifted"])[0].tolist() == [999]


def test_warm_upload_error_raises_from_device_wait(tmp_path, rng,
                                                   monkeypatch):
    ii, truth = build_index(tmp_path / "idx", rng, n_docs=10)
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)
    orig = port_qe.upload_tables

    def failing(t, **kw):
        if threading.current_thread().name == "tpi-ckpt-upload":
            raise RuntimeError("injected upload failure")
        return orig(t, **kw)

    monkeypatch.setattr(port_qe, "upload_tables", failing)
    warm = QueryEngine.from_checkpoint(path, L=256, device="cpu")
    with pytest.raises(RuntimeError, match="injected upload failure"):
        _within(60, warm.device_wait)
    assert not warm.device_ready()
    # the failed upload never leaves the host route serving: every entry
    # point raises it
    t = sorted(truth)[0]
    for call in (lambda: warm.lookup([t]),
                 lambda: warm.boolean([[t, t]], "and"),
                 lambda: warm.boolean([[t, t]], "or"),
                 lambda: warm.lookup_staged([[t]]),
                 lambda: warm.boolean_staged([[[t, t]]], "and"),
                 lambda: warm.lookup_host([t]),
                 lambda: warm.boolean_host([[t, t]], "and"),
                 lambda: list(warm.read_range(None, None)),
                 lambda: warm.prefix_search([b"t"]),
                 lambda: warm.refresh(ii)):
        with pytest.raises(RuntimeError, match="injected upload failure"):
            call()
    # without keep_tables there is no window: the upload is synchronous
    cold = QueryEngine.from_checkpoint(path, L=256, keep_tables=False,
                                       device="cpu")
    assert cold.device_ready() and cold._upload_thread is None


def _spy_refresh(monkeypatch, cls):
    """Record what each refresh() of `cls` returns."""
    got, orig = [], cls.refresh

    def refresh(self, *a, **kw):
        got.append(orig(self, *a, **kw))
        return got[-1]

    monkeypatch.setattr(cls, "refresh", refresh)
    return got


def test_jax_checkpoint_served_by_the_port(tmp_path, rng, monkeypatch):
    ii, truth = build_index(tmp_path / "idx", rng)
    ii.put_removed([7])
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(jax_pkg.InvertedIndex(str(tmp_path / "idx")),
                             path)
    # a restart: the port reopens the directory the checkpoint was taken of
    reopened = port_pkg.InvertedIndex(str(tmp_path / "idx"))
    assert load_fingerprint(load_checkpoint(path)[1]) == \
        _index_fingerprint(reopened, False)
    calls = _spy_refresh(monkeypatch, QueryEngine)
    warm = QueryEngine.from_checkpoint(path, index=reopened, L=256,
                                       device="cpu")
    assert calls == [False]  # reconciling the unchanged index: a no-op
    assert warm.delta is None
    _within(60, warm.device_wait)
    jax_eng = jax_qe.QueryEngine.from_checkpoint(path, L=256, q_bucket=8,
                                                 warm_serve=False)
    _assert_same(_results(jax_eng, _terms(truth)),
                 _results(warm, _terms(truth)))


def test_port_checkpoint_served_by_jax(tmp_path, rng, monkeypatch):
    ii, truth = build_index(tmp_path / "idx", rng)
    ii.put_removed([8])
    path = str(tmp_path / "port.ckpt")
    # both packages reopen the directory, so both list its segments in the
    # same order, and their checkpoints hold the same fingerprint
    save_checkpoint(port_pkg.InvertedIndex(str(tmp_path / "idx")), path)
    jii = jax_pkg.InvertedIndex(str(tmp_path / "idx"))
    jax_ckpt.save_checkpoint(jii, path + ".jax")
    with np.load(path) as a, np.load(path + ".jax") as b:
        # the same entries, byte for byte (the archives differ only in the
        # zip members' time stamps)
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            assert np.array_equal(a[name], b[name]), name
    calls = _spy_refresh(monkeypatch, jax_qe.QueryEngine)
    jax_eng = jax_qe.QueryEngine.from_checkpoint(
        path, index=jii, L=256, q_bucket=8, warm_serve=False)
    assert calls == [False]  # reconciling the unchanged index: a no-op
    assert jax_eng.delta is None
    port = QueryEngine.from_index(ii, L=256, device="cpu")
    _assert_same(_results(port, _terms(truth)),
                 _results(jax_eng, _terms(truth)))


_EXIT_SCRIPT = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
import torch
from inverted_index_2_tpu_torch import InvertedIndex, QueryEngine
from inverted_index_2_tpu_torch.models import query_engine as qe
from inverted_index_2_tpu_torch.models.checkpoint import save_checkpoint

ii = InvertedIndex(sys.argv[2])
for v in range(1, 40):
    ii.put([b"t%02d" % (v % 7), b"u%02d" % (v % 5)], v)
path = sys.argv[2] + ".ckpt"
save_checkpoint(ii, path)
orig = qe.upload_tables


def slow(t, **kw):
    time.sleep(1.0)  # the interpreter reaches its exit meanwhile
    snap = orig(t, **kw)
    torch.cumsum(snap.blocks.reshape(-1).double(), 0)  # torch work at exit
    with open(sys.argv[3], "w") as f:
        f.write("uploaded")
    return snap


qe.upload_tables = slow
eng = QueryEngine.from_checkpoint(path, L=128, device="cpu")
print(eng.lookup_host([b"t01"])[0].tolist())
"""


def test_exit_waits_for_the_warm_upload(tmp_path):
    """A process that ends inside a warm start's upload window ends after
    the upload, with exit code 0: the upload thread is joined at exit, not
    cut off in torch code (which aborted the process now and then)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    marker = tmp_path / "done"
    res = subprocess.run(
        [sys.executable, "-c", _EXIT_SCRIPT, root, str(tmp_path / "idx"),
         str(marker)], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["[1,", "8,", "15,", "22,", "29,", "36]"]
    assert marker.read_text() == "uploaded"
