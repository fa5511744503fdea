"""The port's range and prefix reads and the rest of the engine surface on
the CPU, against the JAX engine on the same directory and against the
index's own host reads (the cases tests/test_torch_refresh.py left out):
prefix_range_step; read_range and prefix_search on the host route
(retained tables) and the device route (none), on a main tier and in a
delta window, over terms with bytes 0x80 and 0xFF, the empty term, a
posting 0xFFFFFFFF and lists past two ladder levels; warmup's count;
stats' keys; lookup_device; snapshot_index and build_snapshot_arrays.
Every comparison is exact.

The port writes the index; the JAX package opens the same directory."""
import numpy as np
import pytest
import torch

import inverted_index_2_tpu as jax_pkg
from inverted_index_2_tpu.models import query_engine as jax_qe
from inverted_index_2_tpu.models import steps as jax_steps

import inverted_index_2_tpu_torch as port_pkg
from inverted_index_2_tpu_torch import QueryEngine, to_slice
from inverted_index_2_tpu_torch.codec import keys as keys_mod
from inverted_index_2_tpu_torch.models import query_engine as port_qe
from inverted_index_2_tpu_torch.models import steps as port_steps
from inverted_index_2_tpu_torch.models.snapshot import (
    build_snapshot_arrays,
    snapshot_index,
    snapshot_tables,
)
from inverted_index_2_tpu_torch.utils.u32 import to_device, to_numpy_u32

torch.set_num_threads(1)

FF = 0xFFFFFFFF
VOCAB = ([f"r{i:03d}".encode() for i in range(50)]
         + [b"", b"\x80", b"\x80a", b"\x80\xff", b"\xff", b"\xff\xff\x01",
            b"z\x80", b"long-a", b"long-b"])
PREFIXES = [b"r0", b"r04", b"r", b"\x80", b"\x80\xff", b"\xff", b"\xff\xff",
            b"z", b"q", b"", b"r049", b"\x7f", b"\xff\x00", b"long",
            b"r" * 40]
RANGES = [(None, None), (b"r010", b"r040"), (b"\x80", None), (None, b"r003"),
          (b"s", b"t"), (b"\xff", b"\xff\xff\xff"), (b"", b""),
          (b"long-a", b"long-b")]


class Engines:
    """One port-written index; the port's engine with tables (host route)
    and without (device route), and the JAX engine of each kind over the
    same directory. With delta=True every engine is refreshed after more
    writes, so a delta tier is live."""

    def __init__(self, path, delta: bool):
        rng = np.random.default_rng(23)
        self.dir = str(path)
        ii = port_pkg.InvertedIndex(self.dir)
        for v in range(1, 300):
            ii.put([VOCAB[j] for j in rng.choice(50, 3, replace=False)]
                   + [VOCAB[50 + v % 7]], v)
        ii.put_many([([b"long-a", b"long-b"], 1_000 + v) for v in range(600)])
        ii.put([b"r001", b"\xff", b""], FF)
        ii.put_removed([5, 1_003, FF])
        self.ii = ii
        self.host = QueryEngine.from_index(ii, L=128, device="cpu")
        self.dev = QueryEngine.from_index(ii, L=128, keep_tables=False,
                                          device="cpu")
        jii = jax_pkg.InvertedIndex(self.dir)
        self.jax_host = jax_qe.QueryEngine.from_index(jii, L=128, q_bucket=8)
        self.jax_dev = jax_qe.QueryEngine.from_index(
            jii, L=128, q_bucket=8, keep_tables=False)
        if delta:
            ii.put([b"r002", b"\x80new", b"\xff"], 5_000)
            ii.put_many([([b"long-a", b"new-long"], 6_000 + v)
                         for v in range(200)])
            for eng in (self.host, self.dev):
                assert eng.refresh(ii) and eng.delta is not None
            jii = jax_pkg.InvertedIndex(self.dir)
            for eng in (self.jax_host, self.jax_dev):
                assert eng.refresh(jii) and eng.delta is not None
        self.jii = jii


@pytest.fixture(scope="module", params=["main", "delta"])
def engines(request, tmp_path_factory):
    return Engines(tmp_path_factory.mktemp(request.param),
                   request.param == "delta")


def _rows(stream):
    return [(t, v.tolist()) for t, v in stream]


def test_prefix_range_step_matches_jax(engines):
    s = engines.dev.snap
    lo_k, hi_k = keys_mod.prefix_bounds(PREFIXES, s.width)
    lo, hi = port_steps.prefix_range_step(s.keys, to_device(lo_k, "cpu"),
                                          to_device(hi_k, "cpu"))
    jlo, jhi = jax_steps.prefix_range_step(engines.jax_dev.snap.keys,
                                           lo_k, hi_k)
    assert lo.tolist() == np.asarray(jlo).tolist()
    assert hi.tolist() == np.asarray(jhi).tolist()
    # [lo, hi) holds exactly the key rows that start with the prefix
    blob, offs = keys_mod.unpack_keys(to_numpy_u32(s.keys))
    terms = [blob[offs[i]: offs[i + 1]].tobytes() for i in range(len(offs) - 1)]
    for p, a, b in zip(PREFIXES, lo.tolist(), hi.tolist()):
        assert [t for t in terms if t.startswith(p)] == terms[a:b], p


@pytest.mark.parametrize("route", ["host", "device"])
def test_read_range_matches_jax_and_index(engines, route, monkeypatch):
    eng = engines.host if route == "host" else engines.dev
    monkeypatch.setattr(eng, "_RANGE_CHUNK", 16)  # several chunks
    calls = []
    decode = port_qe.decode_postings
    monkeypatch.setattr(port_qe, "decode_postings",
                        lambda *a: calls.append(1) or decode(*a))
    for mn, mx in RANGES:
        got = _rows(eng.read_range(mn, mx))
        want = sorted(((tv.term, tv.values.tolist())
                       for tv in to_slice(engines.ii.read(mn, mx))),
                      key=lambda r: r[0])
        assert got == want, (mn, mx)
        jax_eng = engines.jax_host if route == "host" else engines.jax_dev
        assert got == _rows(jax_eng.read_range(mn, mx)), (mn, mx)
    # the device route decodes through K1's wrapper; the host route never
    assert bool(calls) == (route == "device")


@pytest.mark.parametrize("route", ["host", "device"])
def test_prefix_search_matches_jax_and_index(engines, route):
    eng = engines.host if route == "host" else engines.dev
    jax_eng = engines.jax_host if route == "host" else engines.jax_dev
    got = eng.prefix_search(PREFIXES)
    for want in (engines.ii.prefix_search(PREFIXES),
                 jax_eng.prefix_search(PREFIXES)):
        assert set(got) == set(want)
        for p in got:
            assert got[p].dtype == np.uint32
            assert np.array_equal(got[p], want[p]), p
    assert b"\xff" in got and FF in got[b"\xff"].tolist()
    assert eng.prefix_search([]) == {}


def test_warmup_counts_what_jax_counts(engines, monkeypatch):
    """warmup() runs a path where the JAX engine compiles a program: with
    the JAX fused AND off, the port's count is the JAX count plus K2's
    one-shot and staged paths, once without and once with tombstones."""
    monkeypatch.setenv("TPI_FUSED_AND", "0")
    k2 = 2 * (1 + int(engines.host._state.removed.shape[0] > 0))
    for ops in (("and", "or"), ("or",)):
        n = engines.host.warmup(k_max=4, ops=ops)
        j = engines.jax_dev.warmup(k_max=4, ops=ops)
        assert n == j + (k2 if "and" in ops else 0) and n >= 4, ops
    empty = QueryEngine(snapshot_index(port_pkg.InvertedIndex(
        str(engines.dir) + "-empty"), device="cpu"), L=128, device="cpu")
    assert empty.warmup() == 0


def test_stats_has_jax_keys(engines):
    for port_eng, jax_eng in ((engines.host, engines.jax_host),
                              (engines.dev, engines.jax_dev)):
        got, want = port_eng.stats(), jax_eng.stats()
        assert set(got) == set(want)
        for key in ("n_terms", "n_postings", "max_posting_len", "host_bytes",
                    "tables_bytes", "delta_terms", "ladder", "host_serving"):
            assert got[key] == want[key], key
        assert got["fused_and"] == (port_eng.delta is None)
        assert got["device_bytes"] > 0


def _same_rows(a, b, counts):
    """Equal (Q, L) postings in each row's first count lanes (the lanes
    past the count are padding, which the packages fill differently)."""
    assert a.shape == b.shape
    for i, c in enumerate(counts):
        assert np.array_equal(a[i, :c], b[i, :c]), i


def test_lookup_device_matches_jax(engines):
    s = engines.dev.snap
    terms = [b"r001", b"long-a", b"", b"\xff", b"missing", b"\x80\xff"]
    qk = keys_mod.pack_terms(terms, width=s.width)
    for fr in (False, True):
        found, vals, n, raw = engines.dev.lookup_device(
            to_device(qk, "cpu"), filter_removed=fr)
        jf, jv, jn, jraw = engines.jax_dev.lookup_device(qk,
                                                         filter_removed=fr)
        assert found.tolist() == np.asarray(jf).tolist()
        assert n.tolist() == np.asarray(jn).tolist()
        assert raw.tolist() == np.asarray(jraw).tolist()
        _same_rows(to_numpy_u32(vals), np.asarray(jv), n.tolist())
        assert raw[1] > 128  # a clipped row: lookup() re-serves it
    _, vals, n, _ = engines.dev.lookup_device(to_device(qk, "cpu"), L=1024)
    _, jv, jn, _ = engines.jax_dev.lookup_device(qk, L=1024)
    assert n.tolist() == np.asarray(jn).tolist() and n[1] > 128
    _same_rows(to_numpy_u32(vals), np.asarray(jv), n.tolist())


def test_snapshot_index_and_build_snapshot_arrays(engines):
    snap = snapshot_index(engines.ii, device="cpu")
    t = snapshot_tables(engines.ii)
    assert snap.n_terms == t.n_terms and snap.device.type == "cpu"
    assert torch.equal(snap.keys, to_device(t.keys, "cpu"))
    eng = QueryEngine(snap, L=128, device="cpu")
    host = {tv.term: tv.values for tv in to_slice(engines.ii.read(None, None))}
    terms = sorted(host)
    for term, got in zip(terms, eng.lookup(terms)):
        assert np.array_equal(got, host[term]), term
    blob = b"".join(terms)
    offs = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum([len(x) for x in terms], out=offs[1:])
    voffs = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum([len(host[x]) for x in terms], out=voffs[1:])
    built = build_snapshot_arrays(blob, offs,
                                  np.concatenate([host[x] for x in terms]),
                                  voffs, device="cpu")
    for name in ("keys", "blocks", "term_block_start", "counts"):
        assert torch.equal(getattr(built, name), getattr(snap, name)), name
