"""The concat-class path on the CPU, the port against the JAX package on
the same numpy-seeded inputs, bit-exact: boolean_concat_step (OR and AND,
prefix_p, wire dedup), the pagination buffer steps and the result wire
codec, then boolean(..., "or"), boolean_staged (OR, prefix_p, columnar,
tombstones, forced dedup, the singles beyond the largest class) and
lookup_staged. The JAX engine is pinned to its device route
(TPI_HOST_BOOL=0), so both serve through the concat classes."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from inverted_index_2_tpu import InvertedIndex as JaxIndex
from inverted_index_2_tpu.models import query_engine as jax_qe
from inverted_index_2_tpu.models import steps as jax_steps

from inverted_index_2_tpu_torch import InvertedIndex, QueryEngine
from inverted_index_2_tpu_torch.models import steps
from inverted_index_2_tpu_torch.models.snapshot import (
    STRIDE_ALIGN,
    _empty_tables,
    build_host_tables,
    upload_tables,
)
from inverted_index_2_tpu_torch.ops import concat_bool
from inverted_index_2_tpu_torch.utils.u32 import to_device, to_numpy_u32

torch.set_num_threads(1)

FF = 0xFFFFFFFF
L = 256


def _lists(seed):
    rng = np.random.default_rng(seed)
    lists = []
    for i, n in enumerate([400, 420, 380, 350, 500, 30, 410, 390, 1, 129,
                           700, 60]):
        gap = (3, 40, 70_000)[i % 3]        # u8, u16 and u32 result deltas
        lists.append(np.unique(np.cumsum(rng.integers(1, gap, size=n))
                               .astype(np.uint32)))
    lists += [np.array([5, 9, FF], np.uint32), np.array([9, FF], np.uint32),
              np.arange(2_000, 2_300, dtype=np.uint32)]   # width-0 blocks
    return lists


@pytest.fixture(scope="module")
def corpus():
    lists = _lists(0xC0FFEE)
    terms = [f"t{i:05d}".encode() for i in range(len(lists))]
    removed = np.unique(np.concatenate([lists[0][::4], lists[12][:1]])
                        ).astype(np.uint32)
    voffs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    offs = np.arange(len(lists) + 1, dtype=np.int64) * 6
    t = build_host_tables(b"".join(terms), offs, np.concatenate(lists),
                          voffs, removed)
    port = QueryEngine(upload_tables(t, device="cpu"), L=L, tables=t,
                       device="cpu")
    dev_port = QueryEngine(upload_tables(t, device="cpu"), L=L,
                           device="cpu")          # resolves on the device
    jax_eng = jax_qe.QueryEngine(
        jax_qe.upload_tables(t, stride_align=STRIDE_ALIGN), L=L, q_bucket=8)
    rng = np.random.default_rng(3)
    queries = [[terms[i] for i in rng.choice(len(terms), size=int(k),
                                             replace=False)]
               for k in rng.integers(1, 5, size=40)]
    queries += [[terms[12], terms[13]], [terms[3], b"missing"], [b"missing"],
                [terms[10], terms[11], terms[2], terms[4]]]
    return lists, terms, queries, removed, t, port, dev_port, jax_eng


@pytest.fixture
def jax_env(monkeypatch):
    monkeypatch.setenv("TPI_HOST_BOOL", "0")


def _oracle(lists, terms, q, op, removed=None):
    sets = [lists[terms.index(x)] if x in terms else None for q_ in [q]
            for x in q_]
    if op == "and":
        if any(s is None for s in sets):
            return np.zeros(0, np.uint32)
        out = sets[0]
        for s in sets[1:]:
            out = np.intersect1d(out, s)
    else:
        live = [s for s in sets if s is not None]
        out = (np.unique(np.concatenate(live)) if live
               else np.zeros(0, np.uint32))
    if removed is not None:
        out = np.setdiff1d(out, removed)
    return out.astype(np.uint32)


def _assert_rows(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is not None and np.array_equal(g, w), (i, g, w)


# -- the step functions -------------------------------------------------------


@pytest.mark.parametrize("op,prefix_p,wire_dedup", [
    ("or", 0, False), ("or", 0, True), ("or", 3, False), ("or", 32, False),
    ("and", 0, False)])
def test_concat_step_matches_jax(corpus, op, prefix_p, wire_dedup):
    lists, terms, queries, removed, t, port, dev_port, jax_eng = corpus
    snap = port.snap
    jsnap = jax_eng.snap
    rng = np.random.default_rng(len(op) + prefix_p)
    Q, K, SB = 16, 3, 32
    idx = rng.integers(0, len(lists), size=(Q, K)).astype(np.int32)
    kv = rng.integers(1, K + 1, size=Q).astype(np.int32)
    idx[0], kv[0] = [12, 13, 12], 3        # 0xFFFFFFFF in every list
    idx[1], kv[1] = [14, 9, 8], 3          # width-0 blocks
    found = np.ones((Q, K), dtype=bool)
    found[2, 1] = False                    # a missing term
    nb = -(-t.counts[idx] // 128) * (np.arange(K)[None, :] < kv[:, None])
    keep = nb.sum(axis=1) <= SB
    idx, kv, found = idx[keep], kv[keep], found[keep]
    jout, joc = jax_steps._JIT_CONCAT_BOOL(
        jsnap.blocks, jsnap.term_block_start, jsnap.counts, jnp.asarray(idx),
        jnp.asarray(found), jnp.asarray(kv), SB, op, prefix_p=prefix_p,
        wire_dedup=wire_dedup)
    out, oc = concat_bool.boolean_concat_step(
        snap.blocks, snap.term_block_start, snap.counts,
        torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(found),
        torch.from_numpy(kv), SB, op, prefix_p=prefix_p,
        wire_dedup=wire_dedup)
    assert np.array_equal(oc.numpy(), np.asarray(joc))
    assert np.array_equal(to_numpy_u32(out), np.asarray(jout))
    assert int(oc.max()) > 0


def test_concat_step_rejects_bad_contracts(corpus):
    snap = corpus[5].snap
    args = (snap.blocks, snap.term_block_start, snap.counts,
            torch.zeros((8, 2), dtype=torch.int64),
            torch.ones((8, 2), dtype=torch.bool),
            torch.ones(8, dtype=torch.int32), 8)
    for op, kw in (("and", {"wire_dedup": True}), ("and", {"prefix_p": 4}),
                   ("or", {"prefix_p": 4, "wire_dedup": True}),
                   ("xor", {})):
        with pytest.raises(ValueError):
            concat_bool.boolean_concat_step(*args, op, **kw)


def test_scatter_p_matches_jax():
    rng = np.random.default_rng(5)
    QB, P = 8, 4
    obuf = rng.integers(0, 100, size=(QB, P + 1)).astype(np.uint32)
    jbuf, tbuf = jnp.asarray(obuf), to_device(obuf, "cpu")
    # chunk 1 writes rows 0-6; chunk 2 (3 real rows) ends on the LAST row
    # and carries pad lanes: with a raw -1 those would clobber row QB-1
    for sel, width in (([0, 3, 1, 2, 4, 5, 6], 2), ([7, 6, 0, -1, -1], 9)):
        sel = np.asarray(sel, dtype=np.int32)
        n = int((sel >= 0).sum())
        o = np.sort(rng.integers(0, 2**32, size=(len(sel), width),
                                 dtype=np.uint64).astype(np.uint32), axis=1)
        oc = rng.integers(0, 50, size=len(sel)).astype(np.int32)
        jbuf = jax_steps._scatter_p_step(jbuf, jnp.asarray(sel),
                                         jnp.asarray(o), jnp.asarray(oc))
        tbuf = steps._scatter_p_step(
            tbuf, torch.from_numpy(sel[:n]), to_device(o[:n], "cpu"),
            torch.from_numpy(oc[:n]))
        assert np.array_equal(to_numpy_u32(tbuf), np.asarray(jbuf))


def test_pack_p_matches_jax():
    rng = np.random.default_rng(6)
    QB, P = 12, 8
    vals = np.sort(rng.integers(0, 2**14, size=(QB, P), dtype=np.uint32),
                   axis=1)
    vals[3] = np.arange(P, dtype=np.uint32) * (1 << 17)   # deltas >= 2^16
    vals[4, 5:] = FF                                     # past a short count
    cnt = rng.integers(0, 3 * P, size=QB).astype(np.uint32)
    cnt[:6] = [0, 1, P, P + 1, 5, 70_000]                # count hi word used
    obuf = np.concatenate([vals, cnt[:, None]], axis=1)
    want = np.asarray(jax_steps._pack_p_step(jnp.asarray(obuf)))
    got = steps._pack_p_step(to_device(obuf, "cpu")).numpy().view(np.uint16)
    assert np.array_equal(got, want)
    assert got[3, P + 2] >> 15 == 1 and got[2, P + 2] >> 15 == 0


@pytest.mark.parametrize("gap,bits", [(200, 8), (60_000, 16), (2**20, 0)])
def test_wire_codec_matches_jax(gap, bits):
    rng = np.random.default_rng(gap)
    o = np.cumsum(rng.integers(1, gap, size=(9, 40)), axis=1).astype(np.uint32)
    oc = rng.integers(0, 41, size=9).astype(np.int32)
    o[np.arange(40)[None, :] >= oc[:, None]] = FF        # fill past counts
    jmd = int(jax_steps._wire_meta_step(jnp.asarray(o), jnp.asarray(oc)))
    md = int(steps._wire_meta_step(to_device(o, "cpu"), torch.from_numpy(oc)))
    assert md == jmd
    assert bits == (8 if md < 256 else 16 if md < 1 << 16 else 0)
    if not bits:
        return
    jf, jd = jax_steps._wire_pack_step(jnp.asarray(o), bits)
    f, d = steps._wire_pack_step(to_device(o, "cpu"), bits)
    d = d.numpy() if bits == 8 else d.numpy().view(np.uint16)
    assert np.array_equal(to_numpy_u32(f), np.asarray(jf))
    assert d.dtype == np.asarray(jd).dtype and np.array_equal(d, np.asarray(jd))
    back = steps._wire_unpack(to_numpy_u32(f), d)
    for q in range(9):
        assert np.array_equal(back[q, : oc[q]], o[q, : oc[q]])
    row = np.array([1, 1, 2, 5, 5, 5, 9], np.uint32)
    assert steps._dedup_adjacent(row).tolist() == [1, 2, 5, 9]


# -- the engine ---------------------------------------------------------------


def test_boolean_or_matches_jax(corpus, jax_env):
    lists, terms, queries, removed, t, port, dev_port, jax_eng = corpus
    for fr in (False, True):
        want = [_oracle(lists, terms, q, "or", removed if fr else None)
                for q in queries]
        got = port.boolean(queries, "or", filter_removed=fr)
        _assert_rows(got, want)
        _assert_rows(dev_port.boolean(queries, "or", filter_removed=fr), want)
        _assert_rows(jax_eng.boolean(queries, "or", filter_removed=fr), got)


@pytest.mark.parametrize("op", ["or", "and"])
def test_boolean_staged_matches_jax(corpus, jax_env, monkeypatch, op):
    lists, terms, queries, removed, t, port, dev_port, jax_eng = corpus
    monkeypatch.setenv("TPI_STAGED_DEDUP", "force")
    # two small classes: the longest queries go singly, beyond them
    for eng in (port, dev_port, jax_eng):
        monkeypatch.setattr(eng, "_SB_CLASSES", (4, 8))
    assert max(-(-t.counts[[terms.index(x) for x in q if x in terms]]
                 // 128).sum() for q in queries) > 8
    rq = np.random.default_rng(7)
    batches = [[queries[i] for i in rq.integers(0, len(queries), size=n)]
               for n in (80, 72, 5)]
    for fr in (False, True):
        jrows = jax_eng.boolean_staged(batches, op, fr, depth=1)
        for eng in (port, dev_port):
            rows = eng.boolean_staged(batches, op, fr, depth=1)
            cols = eng.boolean_staged(batches, op, fr, columnar=True)
            pages = eng.boolean_staged(batches, op, fr, columnar=True,
                                       prefix_p=5)
            jpages = jax_eng.boolean_staged(batches, op, fr, columnar=True,
                                            prefix_p=5)
            for bi, qs in enumerate(batches):
                want = [_oracle(lists, terms, q, op, removed if fr else None)
                        for q in qs]
                _assert_rows(rows[bi], want)
                _assert_rows(jrows[bi], want)
                vals, voffs = cols[bi]
                _assert_rows([vals[voffs[i]:voffs[i + 1]]
                              for i in range(len(qs))], want)
                for a, b in zip(pages[bi], jpages[bi]):
                    assert np.array_equal(a, b)
                pv, pvo, pc = pages[bi]
                assert pc.tolist() == [len(w) for w in want]
                _assert_rows([pv[pvo[i]:pvo[i + 1]] for i in range(len(qs))],
                             [w[:5] for w in want])


def test_lookup_staged_matches_jax(corpus, jax_env):
    lists, terms, queries, removed, t, port, dev_port, jax_eng = corpus
    batches = [terms[:7] + [b"missing"], [b"nope", terms[12]] + terms[7:]]
    for eng in (port, dev_port):
        rows = eng.lookup_staged(batches)
        jrows = jax_eng.lookup_staged(batches)
        for bi, b in enumerate(batches):
            want = [lists[terms.index(x)] if x in terms
                    else np.zeros(0, np.uint32) for x in b]
            _assert_rows(rows[bi], want)                 # misses: count 0
            _assert_rows(jrows[bi], want)
        fr = eng.lookup_staged(batches, filter_removed=True, columnar=True,
                               prefix_p=3)
        jfr = jax_eng.lookup_staged(batches, filter_removed=True,
                                    columnar=True, prefix_p=3)
        for a, b in zip(fr, jfr):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)


def test_staged_prefix_pagination_full_bucket(tmp_path, jax_env):
    """nq an exact multiple of the JAX q_bucket, with a class chunk that
    JAX pads: the last query's page must survive (a -1 pad index would
    write the last row in torch as it did in JAX)."""
    docs = []
    vocab = [f"t{i:02d}".encode() for i in range(20)]
    for i, term in enumerate(vocab):
        docs += [([term], v) for v in range(1, 10 + i)]
    docs += [([b"sm"], v) for v in range(1, 49)]
    batch = [vocab[i: i + 9] for i in range(7)] + [[b"sm"]]
    ii = InvertedIndex(str(tmp_path / "port"))
    ii.put_many(docs)
    jii = JaxIndex(str(tmp_path / "jax"))
    jii.put_many(docs)
    # no tables: lookup_staged too takes the device route's concat classes
    port = QueryEngine.from_index(ii, L=8, keep_tables=False, device="cpu")
    jax_eng = jax_qe.QueryEngine.from_index(jii, L=8, q_bucket=8)
    for op in ("or", "and"):
        (pv, pvo, pc), = port.boolean_staged([batch], op, columnar=True,
                                             prefix_p=4)
        plain = port.boolean(batch, op)
        assert pc[7] == 48
        for qi in range(8):
            assert pc[qi] == len(plain[qi])
            assert np.array_equal(pv[pvo[qi]: pvo[qi + 1]], plain[qi][:4])
        for a, b in zip((pv, pvo, pc), jax_eng.boolean_staged(
                [batch], op, columnar=True, prefix_p=4)[0]):
            assert np.array_equal(a, b)
    (pv, pvo, pc), = port.lookup_staged([vocab[:7] + [b"sm"]], columnar=True,
                                        prefix_p=4)
    assert pc[7] == 48 and np.array_equal(pv[pvo[7]: pvo[8]],
                                          np.arange(1, 5, dtype=np.uint32))


def test_or_on_an_empty_index():
    port = QueryEngine(upload_tables(_empty_tables(2), device="cpu"), L=128,
                       device="cpu")
    assert [len(r) for r in port.boolean([[b"a", b"b"], [b"c"]], "or")] == [
        0, 0]
    vals, voffs, counts = port.boolean_staged(
        [[[b"a"], [b"b", b"c"]]], "or", columnar=True, prefix_p=3)[0]
    assert len(vals) == 0 and voffs.tolist() == [0, 0, 0]
    assert counts.tolist() == [0, 0]
    assert [len(r) for r in port.lookup_staged([[b"a", b"b"]])[0]] == [0, 0]
