"""The port's partitioned serving steps (parallel/mesh.py) on the CPU
against the JAX package's mesh on its 8 virtual CPU devices: the port's
InvertedIndex writes one directory, the JAX package reopens it, and each
factory runs at D = 1, 3 and 8 partitions (the port's partitions all on
the CPU, devices=["cpu"] * D). Every comparison is exact, on valid
prefixes: K1 leaves the lanes past a row's count undefined. The corpus
holds 0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE and 0xFFFFFFFF as postings and
a list longer than L; at D = 8 some partitions hold no term."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import inverted_index_2_tpu as jax_pkg
from inverted_index_2_tpu.models import query_engine as jax_qe
from inverted_index_2_tpu.parallel import mesh as jpm

import inverted_index_2_tpu_torch as port_pkg
from inverted_index_2_tpu_torch.codec import keys as K
from inverted_index_2_tpu_torch.models.snapshot import (
    _empty_tables,
    build_host_tables,
)
from inverted_index_2_tpu_torch.parallel import collectives as coll
from inverted_index_2_tpu_torch.parallel import mesh as pm
from inverted_index_2_tpu_torch.utils.u32 import to_device, to_numpy_u32

torch.set_num_threads(1)

L = 128
EDGE = [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]
DS = (1, 3, 8)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    d = str(tmp_path_factory.mktemp("idx"))
    rng = np.random.default_rng(7)
    ii = port_pkg.InvertedIndex(d)
    vocab = [bytes([a, b]) + f"t{i}".encode() for i, (a, b) in enumerate(
        (int(x), int(y)) for x, y in rng.integers(32, 127, size=(60, 2)))]
    truth = {}

    def put(terms, doc):
        ii.put(terms, doc)
        for t in terms:
            truth.setdefault(t, set()).add(doc)

    for doc in list(range(1, 40)) + EDGE:
        k = int(rng.integers(1, 5))
        put([vocab[i] for i in rng.choice(len(vocab), size=k,
                                          replace=False)], doc)
    for doc in EDGE:  # one term holds every edge value
        put([vocab[1]], doc)
    for v in range(100, 300):  # > L: raw and need flag the clipped rows
        put([vocab[0], vocab[2]], v)
    return ii, jax_pkg.InvertedIndex(d), vocab, truth


@pytest.fixture(scope="module")
def snaps(corpus):
    ii, jii, _, _ = corpus
    return {D: (pm.build_sharded_snapshot(ii, ["cpu"] * D),
                jpm.build_sharded_snapshot(jii, jpm.default_mesh(D)))
            for D in DS}


def _np(x):
    return to_numpy_u32(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _rows_equal(a, ac, b, bc, ctx):
    """Equal counts, and equal rows within them."""
    ac, bc = _np(ac), _np(bc)
    np.testing.assert_array_equal(ac, bc, err_msg=str(ctx))
    a, b = _np(a), _np(b)
    for i, c in enumerate(ac):
        np.testing.assert_array_equal(a[i, :c], b[i, :c],
                                      err_msg=str((ctx, i)))


def _queries(vocab, rng, n, kmax):
    qs = []
    for _ in range(n):
        k = int(rng.integers(1, kmax + 1))
        qs.append([vocab[i] for i in rng.choice(len(vocab), size=k,
                                                replace=False)])
    qs.append([vocab[0], vocab[2]])           # both lists > L
    qs.append([vocab[1], b"zz-missing"])      # a required term found nowhere
    qs.append([vocab[1]])                     # the edge values alone
    return qs


def _pack(qs, width):
    Kk = max(len(q) for q in qs)
    qk = np.zeros((len(qs), Kk, width + 1), dtype=np.uint32)
    kv = np.zeros(len(qs), dtype=np.int32)
    for i, q in enumerate(qs):
        qk[i, : len(q)] = K.pack_terms(q, width=width)
        kv[i] = len(q)
    return qk, kv


@pytest.mark.parametrize("D", DS)
def test_sharded_lookup_matches_jax(corpus, snaps, D):
    _, _, vocab, truth = corpus
    ps, js = snaps[D]
    assert ps.width == js.width
    terms = vocab[:30] + [b"@@missing", b"q"]
    for nq in (len(terms), 17):
        qk = K.pack_terms(terms[:nq], width=ps.width)
        want = jpm.make_sharded_lookup(js, L)(
            js.keys, js.blocks, js.term_block_start, js.counts,
            jax.numpy.asarray(qk))
        for make in (pm.make_sharded_lookup, pm.make_sharded_lookup_scatter):
            found, vals, n, raw = make(ps, L)(qk)
            np.testing.assert_array_equal(found.numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(raw.numpy(), np.asarray(want[3]))
            _rows_equal(vals, n, want[1], want[2], (D, nq, make.__name__))
    for i, t in enumerate(terms[:nq]):
        if t in truth:
            assert raw[i] == len(truth[t])


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("op", ["and", "or"])
def test_sharded_boolean_matches_jax(corpus, snaps, D, op):
    _, _, vocab, _ = corpus
    ps, js = snaps[D]
    qs = _queries(vocab, np.random.default_rng(3 + D), 14, 3)
    qk, kv = _pack(qs, ps.width)
    jargs = (js.keys, js.blocks, js.term_block_start, js.counts,
             jax.numpy.asarray(qk), jax.numpy.asarray(kv))
    want = jpm.make_sharded_boolean(js, L, op)(*jargs)
    for make in (pm.make_sharded_boolean, pm.make_sharded_boolean_scatter):
        out, oc, need = make(ps, L, op)(qk, kv)
        np.testing.assert_array_equal(need.numpy(), np.asarray(want[2]))
        _rows_equal(out, oc, want[0], want[1], (D, op, make.__name__))


def _tables(pkg_build, terms, seed, edge=False):
    r = np.random.default_rng(seed)
    blob = b"".join(terms)
    offsets = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum([len(t) for t in terms], out=offsets[1:])
    lists = [np.unique(r.integers(0, 5000, size=int(r.integers(1, 150)),
                                  dtype=np.uint32)) for _ in terms]
    if edge:
        lists[0] = np.array(EDGE, dtype=np.uint32)
        lists[-1] = np.array(EDGE[2:], dtype=np.uint32)
    voffs = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    return pkg_build(np.frombuffer(blob, np.uint8), offsets,
                     np.concatenate(lists), voffs)


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("op", ["and", "or"])
def test_sharded_boolean_dual_matches_jax(D, op):
    """Main tier cut by partition_tables, the delta on partition 0 and
    empty partitions elsewhere, as the engine stacks them."""
    main_terms = sorted(f"m{i:03d}".encode() for i in range(40))
    delta_terms = sorted([f"d{i:03d}".encode() for i in range(12)]
                         + main_terms[:8])
    mains = [_tables(f, main_terms, 21, edge=True)
             for f in (build_host_tables, jax_qe.build_host_tables)]
    deltas = [_tables(f, delta_terms, 22, edge=True)
              for f in (build_host_tables, jax_qe.build_host_tables)]
    ps = pm.stack_tables(pm.partition_tables(mains[0], D), ["cpu"] * D)
    pd = pm.stack_tables([deltas[0]] + [_empty_tables(deltas[0].width)]
                         * (D - 1), ["cpu"] * D)
    mesh = jpm.default_mesh(D)
    js = jpm.stack_tables(jpm.partition_tables(mains[1], D), mesh)
    jd = jpm.stack_tables([deltas[1]] + [jax_qe._empty_tables(
        deltas[1].width)] * (D - 1), mesh)
    allt = main_terms + [t for t in delta_terms if t not in main_terms]
    rng = np.random.default_rng(D)
    qs = [[allt[i] for i in rng.choice(len(allt), size=2, replace=False)]
          for _ in range(13)] + [[main_terms[0], main_terms[-1]],
                                 [main_terms[0], b"nowhere"]]
    qk1, kv = _pack(qs, ps.width)
    qk2, _ = _pack(qs, pd.width)
    want = jpm.make_sharded_boolean_dual(js, jd, L, op)(
        jax.numpy.asarray(qk1), jax.numpy.asarray(qk2),
        jax.numpy.asarray(kv))
    for make in (pm.make_sharded_boolean_dual,
                 pm.make_sharded_boolean_dual_scatter):
        out, oc, need = make(ps, pd, L, op)(qk1, qk2, kv)
        np.testing.assert_array_equal(need.numpy(), np.asarray(want[2]))
        _rows_equal(out, oc, want[0], want[1], (D, op, make.__name__))


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("op", ["and", "or"])
def test_sharded_boolean_concat_matches_jax(corpus, snaps, D, op):
    _, _, vocab, truth = corpus
    ps, js = snaps[D]
    qs = _queries(vocab, np.random.default_rng(11 + D), 12, 4)
    qs.append([vocab[1], vocab[1]])  # a term twice
    qk, kv = _pack(qs, ps.width)
    want = jpm.make_sharded_boolean_concat(js, 4, op)(
        jax.numpy.asarray(qk), jax.numpy.asarray(kv))
    for make in (pm.make_sharded_boolean_concat,
                 pm.make_sharded_boolean_concat_scatter):
        out, oc = make(ps, 4, op)(qk, kv)
        _rows_equal(out, oc, want[0], want[1], (D, op, make.__name__))
    for i, q in enumerate(qs[:-1]):
        sets = [truth.get(t, set()) for t in q]
        ref = sorted(set.intersection(*sets) if op == "and"
                     else set.union(*sets))
        assert to_numpy_u32(out[i, : oc[i]]).tolist() == ref, q


@pytest.mark.parametrize("D", DS)
def test_sharded_prefix_ranges_and_decode_match_jax(corpus, snaps, D):
    _, _, vocab, _ = corpus
    ps, js = snaps[D]
    prefixes = [v[:1] for v in vocab[:8]] + [vocab[3], b"\x7f\x7f", b""]
    lo_k, hi_k = K.prefix_bounds(prefixes, ps.width)
    jlo, jhi = jpm._prefix_keys(prefixes, js.width)
    np.testing.assert_array_equal(lo_k, jlo)
    np.testing.assert_array_equal(hi_k, jhi)
    lo, hi = pm.make_sharded_prefix_ranges(ps)(lo_k, hi_k)
    want = jpm.make_sharded_prefix_ranges(js)(jax.numpy.asarray(jlo),
                                              jax.numpy.asarray(jhi))
    np.testing.assert_array_equal(lo, np.asarray(want[0]))
    np.testing.assert_array_equal(hi, np.asarray(want[1]))
    nmax = ps.host_counts.shape[1]
    idx = np.random.default_rng(D).integers(0, nmax, size=(D, 9),
                                            dtype=np.int32)
    vals, raw = pm.make_sharded_decode(ps, L)(idx)
    wv, wr = jpm.make_sharded_decode(js, L)(jax.numpy.asarray(idx))
    for d in range(D):
        np.testing.assert_array_equal(raw[d].numpy(), np.asarray(wr[d]))
        n = np.minimum(raw[d].numpy(), L)
        _rows_equal(vals[d], n, np.asarray(wv[d]), n, (D, d))


@pytest.mark.parametrize("D", DS)
def test_sharded_prefix_search_and_read_range_match_jax(corpus, snaps, D):
    ii, _, vocab, _ = corpus
    ps, js = snaps[D]
    prefixes = [v[:1] for v in vocab[:12]] + [b"zzzz-none", vocab[0][:2]]
    got = pm.sharded_prefix_search(ps, prefixes, L=L)
    want = jpm.sharded_prefix_search(js, prefixes, L=L)
    assert list(got) == list(want)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p])
    ref = ii.prefix_search(prefixes)
    assert sorted(got) == sorted(ref)
    srt = sorted(vocab)
    for lo, hi in ((None, None), (srt[3], srt[-5]), (srt[10], srt[10])):
        a = [(t, v.tolist()) for t, v in pm.sharded_read_range(ps, lo, hi,
                                                               L=L)]
        b = [(t, v.tolist()) for t, v in jpm.sharded_read_range(js, lo, hi,
                                                                L=L)]
        assert a == b, (lo, hi)


@pytest.mark.parametrize("D", DS)
def test_partitioning_matches_jax(corpus, snaps, D):
    ii, jii, _, _ = corpus
    for by in ("blocks", "terms"):
        assert pm.balanced_ranges(ii, D, by=by) == jpm.balanced_ranges(
            jii, D, by=by)
    ps, js = snaps[D]
    assert pm.partition_stats(ps) == jpm.partition_stats(js)
    assert ps.max_count == js.max_count and ps.max_probes == js.max_probes
    if D == 8:
        assert 0 in pm.partition_stats(ps)["n_terms_per_device"]


def test_partition_tables_match_jax(rng):
    terms = sorted(f"k{i:04d}".encode() for i in range(300))
    blob = np.frombuffer(b"".join(terms), np.uint8)
    offsets = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum([len(t) for t in terms], out=offsets[1:])
    lens = rng.geometric(1 / 50, size=len(terms)).astype(np.int64) + 1
    lens[::37] = 2000
    values = np.concatenate([
        np.sort(rng.choice(100_000, size=int(n), replace=False))
        .astype(np.uint32) for n in lens])
    voffs = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum(lens, out=voffs[1:])
    t = build_host_tables(blob, offsets, values, voffs)
    jt = jax_qe.build_host_tables(blob, offsets, values, voffs)
    for n_dev in (1, 4, 7):
        got = pm.partition_tables(t, n_dev)
        want = jpm.partition_tables(jt, n_dev)
        assert len(got) == len(want) == n_dev
        for a, b in zip(got, want):
            for f in ("keys", "words", "flat", "tbs", "counts", "removed",
                      "slots"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                              err_msg=f)
            assert (a.max_probes, a.max_count, a.width, a.max_bw) == (
                b.max_probes, b.max_count, b.width, b.max_bw)
        # stacked, every partition answers its terms and nothing else
        ps = pm.stack_tables(got, ["cpu"] * n_dev)
        found, vals, n, raw = pm.make_sharded_lookup(ps, 2048)(
            K.pack_terms(terms[::29] + [b"k9999"], width=ps.width))
        assert found.numpy().tolist() == [True] * 11 + [False]
        for j, i in enumerate(range(0, 300, 29)):
            np.testing.assert_array_equal(
                to_numpy_u32(vals[j, : n[j]]), values[voffs[i]:voffs[i + 1]])


def test_shard_ranges_cover_keyspace():
    for d in (1, 2, 8, 64):
        assert pm.shard_ranges(d) == jpm.shard_ranges(d)
        assert sorted(x for r in pm.shard_ranges(d) for x in r) == list(
            range(1024))


def test_default_mesh():
    assert pm.default_mesh(3, "cpu") == [torch.device("cpu")] * 3
    assert pm.default_mesh(device="cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pm.default_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            pm.default_mesh(2, "cuda")


def test_collectives():
    devs = [torch.device("cpu")] * 4
    xs = [to_device(np.arange(8, dtype=np.int32) * (d + 1), "cpu").reshape(
        4, 2) for d in range(4)]
    total = sum(x.numpy() for x in xs)
    for r in coll.psum(xs, devs):
        np.testing.assert_array_equal(r.numpy(), total)
    for d, r in enumerate(coll.psum_scatter(xs, devs)):
        np.testing.assert_array_equal(r.numpy(), total[d:d + 1])
    for r in coll.all_gather(xs, devs):
        np.testing.assert_array_equal(r.numpy(),
                                      np.stack([x.numpy() for x in xs]))
    for d, r in enumerate(coll.all_to_all(xs, devs, 0, 1)):
        np.testing.assert_array_equal(
            r.numpy(), np.concatenate([x.numpy()[d:d + 1] for x in xs], 1))
    rep = coll.replicate(xs[0], devs)
    assert all(r is rep[0] for r in rep)
