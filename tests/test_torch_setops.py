"""The port's sorted-set operations and padded boolean steps against the
JAX package on the CPU: intersect_many (K3's plain version, which the
wrapper takes for CPU tensors) against setops.intersect_many in both
regimes and against intersect_pallas in interpret mode; union_many and
member_mask; boolean_step and boolean_step_dual on two tiers built from the
same arrays by both packages. Integer set algebra has no rounding: every
comparison is exact, whole rows included (both sides pad with
0xFFFFFFFF)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from inverted_index_2_tpu.models import steps as jax_steps
from inverted_index_2_tpu.models.snapshot import upload_tables as jax_upload
from inverted_index_2_tpu.ops import setops as jax_setops
from inverted_index_2_tpu.ops.pallas_bool import intersect_pallas

from inverted_index_2_tpu_torch.codec import keys as keys_mod
from inverted_index_2_tpu_torch.models import steps
from inverted_index_2_tpu_torch.models.snapshot import (
    STRIDE_ALIGN,
    build_host_tables,
    upload_tables,
)
from inverted_index_2_tpu_torch.ops import cuda_bool, setops
from inverted_index_2_tpu_torch.utils.u32 import to_device, to_numpy_u32

torch.set_num_threads(1)

FF = 0xFFFFFFFF


def _lists(seed, Q, K, L):
    """(Q, K, L) lists as callers make them: sorted unique in u32 order
    within their counts, random garbage past them, some spanning the sign
    bit, some empty or full, k_valid 1..K with pad rows of k_valid 0 and
    count 0, and a genuine 0xFFFFFFFF as the last member of every
    non-empty list of every third query."""
    rng = np.random.default_rng(seed)
    off = rng.integers(0, 2**32 - 4 * L - 2, size=(Q, 1, 1))
    off[1::4] = 2**31 - 2 * L
    vals = off + np.cumsum(rng.integers(1, 4, size=(Q, K, L)), axis=2)
    counts = rng.integers(0, L + 1, size=(Q, K))
    counts[::5] = L
    counts[2::7, 1] = 0
    kv = rng.integers(1, K + 1, size=Q)
    kv[3::11] = 0
    counts[3::11] = 0
    qi, ji = np.nonzero((np.arange(Q) % 3 == 0)[:, None] & (counts > 0))
    vals[qi, ji, counts[qi, ji] - 1] = FF
    garbage = rng.integers(0, 2**32, size=(Q, K, L))
    vals = np.where(np.arange(L) < counts[..., None], vals, garbage)
    return vals.astype(np.uint32), counts.astype(np.int32), kv.astype(np.int32)


def _port(vals, counts, kv):
    return (to_device(vals, "cpu"), torch.from_numpy(counts),
            torch.from_numpy(kv))


def _and_oracle(vals, counts, kv):
    out = []
    for q in range(vals.shape[0]):
        r = None if kv[q] else np.zeros(0, np.uint32)
        for j in range(kv[q]):
            v = vals[q, j, : counts[q, j]]
            r = v if r is None else np.intersect1d(r, v)
        out.append(r)
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("L", [256, 1024])  # broadcast and sort regimes
def test_intersect_many_matches_jax(L, seed):
    vals, counts, kv = _lists(seed + L, 24, 6, L)
    got, gc = cuda_bool.intersect_many(*_port(vals, counts, kv))
    want, wc = jax_setops.intersect_many(jnp.asarray(vals),
                                         jnp.asarray(counts), jnp.asarray(kv))
    got = to_numpy_u32(got)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(gc.numpy(), np.asarray(wc))
    oracle = _and_oracle(vals, counts, kv)
    for q, w in enumerate(oracle):
        assert gc[q] == len(w) and np.array_equal(got[q, : len(w)], w), q
        assert (got[q, len(w):] == FF).all()
    assert sum(len(w) for w in oracle) > 0
    assert any(len(w) and w[-1] == FF for w in oracle)


@pytest.mark.parametrize("L", [256, 1024])
def test_intersect_many_matches_pallas(L):
    vals, counts, kv = _lists(L + 5, 16, 4, L)
    got, gc = cuda_bool.intersect_many(*_port(vals, counts, kv))
    want, wc = intersect_pallas(jnp.asarray(vals), jnp.asarray(counts),
                                jnp.asarray(kv), interpret=True)
    assert np.array_equal(to_numpy_u32(got), np.asarray(want))
    assert np.array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("L", [128, 512])
def test_union_many_matches_jax(L):
    vals, counts, kv = _lists(L + 9, 16, 4, L)
    got, gc = setops.union_many(*_port(vals, counts, kv))
    want, wc = jax_setops.union_many(jnp.asarray(vals), jnp.asarray(counts),
                                     jnp.asarray(kv))
    got = to_numpy_u32(got)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(gc.numpy(), np.asarray(wc))
    for q in range(16):
        w = np.unique(np.concatenate(
            [vals[q, j, : counts[q, j]] for j in range(kv[q])]
            or [np.zeros(0, np.uint32)]))
        assert np.array_equal(got[q, : gc[q]], w)


@pytest.mark.parametrize("P,L", [(256, 256), (512, 1024)])  # both regimes
def test_member_mask_matches_jax(P, L):
    vals, counts, _ = _lists(P + L, 16, 2, L)
    lists, probes = vals[:, 0], vals[:, 1, :P].copy()
    probes[:, ::7] = lists[:, : P: 7]  # members, garbage lanes included
    got = setops.member_mask(to_device(lists, "cpu"),
                             torch.from_numpy(counts[:, 0]),
                             to_device(probes, "cpu"))
    want = jax_setops.member_mask(jnp.asarray(lists),
                                  jnp.asarray(counts[:, 0]),
                                  jnp.asarray(probes))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


def _tables(seed, terms, n_max, universe):
    rng = np.random.default_rng(seed)
    lists = [np.unique(rng.integers(0, universe, size=int(rng.integers(
        1, n_max)))).astype(np.uint32) for _ in terms]
    lists[0] = np.append(lists[0], np.uint32(FF))
    lists[1] = np.append(lists[1], np.uint32(FF))
    offs = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum([len(t) for t in terms], out=offs[1:])
    voffs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    t = build_host_tables(b"".join(terms), offs, np.concatenate(lists), voffs)
    return dict(zip(terms, lists)), t


MAIN_TERMS = [f"t{i:05d}".encode() for i in range(24)]
# the delta: main terms that gain postings, and new terms wider than main's
DELTA_TERMS = sorted(MAIN_TERMS[:8] + [f"new-wider-term-{i:03d}".encode()
                                       for i in range(8)])


def _queries(seed, vocab, Q=40, K=5):
    rng = np.random.default_rng(seed)
    qs = [[vocab[i] for i in rng.choice(len(vocab), size=int(k),
                                        replace=False)]
          for k in rng.integers(1, K + 1, size=Q)]
    qs[0] = [vocab[0], vocab[1]]          # a genuine 0xFFFFFFFF in both
    qs[1] = [vocab[2], b"missing-term"]
    return qs


def _pack(queries, W):
    kv = np.array([len(q) for q in queries], dtype=np.int32)
    qk = np.zeros((len(queries), int(kv.max()), W + 1), dtype=np.uint32)
    for i, q in enumerate(queries):
        qk[i, : len(q)] = keys_mod.pack_terms(q, width=W)
    return qk, kv


def _snaps(t):
    return upload_tables(t, device="cpu"), jax_upload(t, STRIDE_ALIGN)


def _same(port_out, jax_out):
    for p, j in zip(port_out, jax_out):
        assert np.array_equal(p.numpy().view(np.uint32) if p.dtype ==
                              torch.int32 else p.numpy(), np.asarray(j))


@pytest.mark.parametrize("L", [256, 1024])
@pytest.mark.parametrize("op", ["and", "or"])
def test_boolean_step_matches_jax(op, L):
    truth, t = _tables(3, MAIN_TERMS, 1500, 4000)
    ps, js = _snaps(t)
    qk, kv = _pack(_queries(4, MAIN_TERMS), t.width)
    got = steps.boolean_step(ps.keys, ps.blocks, ps.term_block_start,
                             ps.counts, to_device(qk, "cpu"),
                             torch.from_numpy(kv), L, op, None,
                             ps.hash_slots, ps.max_probes)
    want = jax_steps.boolean_step(js.keys, js.blocks, js.term_block_start,
                                  js.counts, jnp.asarray(qk), jnp.asarray(kv),
                                  L, op, None, js.hash_slots, js.max_probes)
    _same(got, want)
    assert int((got[2] > L).sum()) > 0  # some lists clipped: need > L
    assert int(got[1].sum()) > 0


@pytest.mark.parametrize("L", [128, 384])  # dual AND broadcast / sort regime
@pytest.mark.parametrize("op", ["and", "or"])
def test_boolean_step_dual_matches_jax(op, L):
    main, tm = _tables(5, MAIN_TERMS, 600, 3000)
    delta, td = _tables(6, DELTA_TERMS, 300, 3000)
    assert td.width > tm.width
    removed = np.unique(np.concatenate([main[MAIN_TERMS[3]][::3],
                                        delta[DELTA_TERMS[0]][::2]]))
    (pm, jm), (pd, jd) = _snaps(tm), _snaps(td)
    vocab = sorted(set(MAIN_TERMS) | set(DELTA_TERMS))
    queries = _queries(7, vocab)
    qk, kv = _pack(queries, td.width)
    q1, q2 = steps._narrow_keys(qk, tm.width), qk
    got = steps.boolean_step_dual(
        pm.keys, pm.blocks, pm.term_block_start, pm.counts, pm.hash_slots,
        pd.keys, pd.blocks, pd.term_block_start, pd.counts, pd.hash_slots,
        to_device(q1, "cpu"), to_device(q2, "cpu"), torch.from_numpy(kv), L,
        op, to_device(removed, "cpu"), pm.max_probes, pd.max_probes)
    want = jax_steps.boolean_step_dual(
        jm.keys, jm.blocks, jm.term_block_start, jm.counts, jm.hash_slots,
        jd.keys, jd.blocks, jd.term_block_start, jd.counts, jd.hash_slots,
        jnp.asarray(q1), jnp.asarray(q2), jnp.asarray(kv), L, op,
        jnp.asarray(removed), jm.max_probes, jd.max_probes)
    _same(got, want)
    out, oc, need = (to_numpy_u32(got[0]), got[1].numpy(), got[2].numpy())
    for i, q in enumerate(queries):
        sets = [np.union1d(main.get(x, []), delta.get(x, []))
                .astype(np.uint32) for x in q]
        w = sets[0]
        for s in sets[1:]:
            w = np.intersect1d(w, s) if op == "and" else np.union1d(w, s)
        w = np.setdiff1d(w, removed)
        if need[i] <= L:
            assert np.array_equal(out[i, : oc[i]], w), (i, q)
    assert 0 < int((need > L).sum()) < len(queries)


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("L", [128, 512])  # broadcast and sort regimes
def test_intersect_many_ignores_the_order_of_present_lists(L, seed, package):
    """The AND's whole rows and counts do not depend on the order of slots
    0 .. k_valid-1, in either package and either regime. K3 on the card
    relies on it: it walks the shortest present list, whichever slot holds
    it, and probes the others shortest first."""
    vals, counts, kv = _lists(seed + 3 * L, 24, 6, L)
    kv = np.maximum(kv, 1).astype(np.int32)  # rows with a list present
    rng = np.random.default_rng(seed)
    perm = np.tile(np.arange(6), (24, 1))
    for q in range(24):
        perm[q, : kv[q]] = rng.permutation(kv[q])
    assert (perm != np.arange(6)).any(axis=1).sum() > 8
    pvals = np.take_along_axis(vals, perm[:, :, None], axis=1)
    pcounts = np.take_along_axis(counts, perm, axis=1)

    def run(v, c):
        if package == "port":
            o, oc = setops.intersect_many(*_port(v, c, kv))
            return to_numpy_u32(o), oc.numpy()
        o, oc = jax_setops.intersect_many(jnp.asarray(v), jnp.asarray(c),
                                          jnp.asarray(kv))
        return np.asarray(o), np.asarray(oc)

    out, oc = run(vals, counts)
    pout, poc = run(pvals, pcounts)
    assert np.array_equal(oc, poc) and np.array_equal(out, pout)
    assert int(oc.sum()) > 0 and int((oc == 0).sum()) > 0
