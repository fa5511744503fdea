"""The concat-class step's kernels (ops/cuda_concat.py, csrc/concat_step.cu)
against the plain chain (ops/concat_bool.py::boolean_concat_step), bit for
bit: `out` with its fill, `oc`, the page form's (Q, P+1) buffer and the wire
form's sorted stream and lane counts.

The CPU tests hold the wrapper on CPU tensors to the chain (and count no
launch). The tests marked `gpu` need an NVIDIA card and nvcc and skip
elsewhere; this file imports no `jax`, so on a machine without it run
`python -m pytest --noconftest -m gpu tests/test_torch_concat_kernels.py`.
"""
import numpy as np
import pytest
import torch

from inverted_index_2_tpu_torch.models.snapshot import build_host_tables, upload_tables
from inverted_index_2_tpu_torch.models.steps import _scatter_p_step
from inverted_index_2_tpu_torch.ops import cuda_concat
from inverted_index_2_tpu_torch.ops.concat_bool import boolean_concat_step

FF = 0xFFFFFFFF
P = 32
# list lengths at block edges (128 k - 1, 128 k, 128 k + 1), each at a gap
# scale that gives it delta widths of 0, 8, 16 or 32 bits
EDGES = (1, 127, 128, 129, 255, 256, 257, 383, 384, 385)
SCALES = (1, 2, 100, 30_000, 1 << 24)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the concat kernels are CUDA C++ "
                    "built with nvcc and have no CPU mode")
    return torch.device("cuda")


def _list(rng, n, scale, ff=False):
    """n ascending unique u32 values (fewer where the gaps wrap past 2^32),
    overlapping other lists of the same scale; with ff the last is a
    genuine 0xFFFFFFFF."""
    gaps = rng.integers(1, 2 * scale + 1, size=n, dtype=np.int64)
    v = np.unique((int(rng.integers(0, 64)) + np.cumsum(gaps)) % FF)
    if ff:
        v[-1] = FF
    return v.astype(np.uint32)


def corpus(seed, long_lists=()):
    """(tables, blocks per term, the terms whose lists end in 0xFFFFFFFF,
    whether each term's list is dense): every edge length at every scale,
    medium lists, lists ending in a genuine 0xFFFFFFFF, and `long_lists`
    lengths at scale 2. Dense lists (scales 1 and 2) overlap, so their
    ANDs are not empty."""
    rng = np.random.default_rng(seed)
    lists, ff, dense = [], [], []
    for n in EDGES:
        for sc in SCALES:
            lists.append(_list(rng, n, sc))
            dense.append(sc <= 2)
    for n in rng.integers(1000, 30_000, size=12):
        sc = int(rng.choice([2, 100, 30_000]))
        lists.append(_list(rng, int(n), sc))
        dense.append(sc <= 2)
    for n in (1, 130, 700, 5000):
        ff.append(len(lists))
        lists.append(_list(rng, n, 2, ff=True))
        dense.append(True)
    for n in long_lists:
        lists.append(_list(rng, n, 2))
        dense.append(True)
    voffs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    blob = b"".join(f"t{i:05d}".encode() for i in range(len(lists)))
    offs = np.arange(len(lists) + 1, dtype=np.int64) * 6
    t = build_host_tables(blob, offs, np.concatenate(lists), voffs)
    nb = -(-np.array([len(v) for v in lists]) // 128)
    return t, nb, ff, np.array(dense)


def queries(seed, nb, ff, dense, Q, K, SB):
    """A resolved batch (idx (Q, K) int64, found, k_valid int32) whose every
    query's live blocks fit SB, and about half fill it: k_valid 0..K (some
    0, some 2 of a width K), absent required terms, every live list ending
    in 0xFFFFFFFF for some queries and only the first for others; most
    queries take dense lists only."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(nb), size=(Q, K))
    found = np.ones((Q, K), dtype=bool)
    kv = rng.integers(1, K + 1, size=Q)
    kv[::9] = 0
    kv[1::7] = min(2, K)
    kv[2::11] = 1 if nb[ff[1]] > SB // 2 else min(2, K)
    for q in range(Q):
        pool = dense if q % 4 else np.ones(len(nb), dtype=bool)
        forced = []
        if q % 11 == 2:            # a genuine 0xFFFFFFFF in every list
            forced = [ff[0], ff[1]][: kv[q]]
        elif q % 13 == 4:          # ... and in only the first
            forced = [ff[0]]
        left = SB
        for k in range(kv[q]):
            if k < len(forced):
                idx[q, k] = forced[k]
            else:
                want = max(1, left // (kv[q] - k))
                fit = np.nonzero(pool & (nb <= want))[0]
                big = fit[nb[fit] >= want // 4]
                pick = big if len(big) and rng.random() < 0.7 else fit
                idx[q, k] = rng.choice(pick)
            left -= nb[idx[q, k]]
        assert left >= 0
    found[5::10, 0] = False      # an absent required term
    found[6::10, K - 1] = False  # absent, and past k_valid for some
    return idx, found, kv.astype(np.int32)


def _to(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def plain(snap, idx, found, kv, rows, SB, op, form, obuf=None):
    """The chain over rows `rows` of the batch, in the wrapper's form."""
    r = rows.to(torch.int64)
    args = (snap.blocks, snap.term_block_start, snap.counts, idx[r],
            found[r], kv[r], SB, op)
    if form == "wire":
        return boolean_concat_step(*args, wire_dedup=True)
    if form == "page":
        o, oc = boolean_concat_step(*args, prefix_p=P)
        return _scatter_p_step(obuf, rows, o, oc)
    return boolean_concat_step(*args)


def step(snap, idx, found, kv, rows, SB, op, form, obuf=None):
    """The wrapper over the same rows, in the same form."""
    args = (snap.blocks, snap.term_block_start, snap.counts, idx, found, kv,
            rows, SB, op)
    if form == "wire":
        return cuda_concat.concat_step(*args, wire_dedup=True)
    if form == "page":
        assert cuda_concat.concat_step(*args, prefix_p=P, obuf=obuf) is None
        return obuf
    return cuda_concat.concat_step(*args)


FORMS = [("and", "full"), ("or", "full"), ("or", "page"), ("or", "wire")]


def _check(dev, snap, batch, rows, SB, op, form):
    idx, found, kv = _to(dev, *batch)
    rows = torch.from_numpy(rows.astype(np.int32)).to(dev)
    Q = idx.shape[0]
    garbage = torch.from_numpy(np.random.default_rng(SB).integers(
        -2**31, 2**31, size=(Q, P + 1), dtype=np.int64).astype(np.int32))
    got = step(snap, idx, found, kv, rows, SB, op, form,
               garbage.clone().to(dev))
    want = plain(snap, idx, found, kv, rows, SB, op, form,
                 garbage.clone().to(dev))
    if form == "page":
        assert torch.equal(got, want)
        return got[rows.to(torch.int64), P]
    (o, oc), (wo, woc) = got, want
    assert o.shape == wo.shape and oc.dtype == woc.dtype
    assert torch.equal(oc, woc)
    assert torch.equal(o, wo)  # the fill too
    return oc


@pytest.mark.parametrize("op,form", FORMS)
def test_wrapper_on_the_cpu_is_the_chain_and_launches_nothing(op, form):
    t, nb, ff, dense = corpus(1)
    snap = upload_tables(t, device="cpu")
    batch = queries(2, nb, ff, dense, 40, 6, 32)
    rows = np.random.default_rng(3).permutation(40)[:29]
    launches = (cuda_concat.concat_decode.launches,
                cuda_concat.concat_compact.launches)
    oc = _check("cpu", snap, batch, rows, 32, op, form)
    assert (cuda_concat.concat_decode.launches,
            cuda_concat.concat_compact.launches) == launches
    assert int((oc > 0).sum()) > 5


def test_wrapper_on_the_cpu_refuses_what_the_chain_refuses():
    t, nb, ff, dense = corpus(1)
    snap = upload_tables(t, device="cpu")
    idx, found, kv = _to("cpu", *queries(2, nb, ff, dense, 8, 3, 8))
    rows = torch.arange(8, dtype=torch.int32)
    args = (snap.blocks, snap.term_block_start, snap.counts, idx, found, kv,
            rows, 8)
    with pytest.raises(ValueError, match="wire_dedup"):
        cuda_concat.concat_step(*args, "and", wire_dedup=True)
    with pytest.raises(ValueError, match="OR-only"):
        cuda_concat.concat_step(*args, "and", prefix_p=4)
    with pytest.raises(ValueError, match="page form"):
        cuda_concat.concat_step(*args, "or", obuf=torch.zeros((8, 5)))
    # one contract on both devices: the page form needs its buffer
    with pytest.raises(ValueError, match="page form"):
        cuda_concat.concat_step(*args, "or", prefix_p=4)


# (SB, Q, n rows of the chunk, K): every class of models/staged.py; 256 rows
# of 2^12 lanes (SB 32) and 8 rows of 2^20 (SB 8192) for the compaction's
# tiles, one row of 2^22 (SB 32768)
CLASSES = [(8, 64, 40, 6), (32, 300, 256, 6), (64, 40, 24, 3),
           (128, 40, 24, 6), (512, 24, 16, 4), (2048, 16, 8, 6),
           (8192, 12, 8, 6), (32768, 4, 1, 6)]
LONG = (200_000, 500_000, 1_000_000, 2_000_000, 2_000_000)


@pytest.fixture(scope="module")
def card_corpus():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t, nb, ff, dense = corpus(7, LONG)
    return upload_tables(t, device="cuda"), nb, ff, dense


@pytest.mark.gpu
@pytest.mark.parametrize("op,form", FORMS)
@pytest.mark.parametrize("SB,Q,n,K", CLASSES)
def test_kernels_match_the_chain_in_every_class(cuda, card_corpus, SB, Q, n,
                                                K, op, form):
    snap, nb, ff, dense = card_corpus
    batch = queries(SB + K, nb, ff, dense, Q, K, SB)
    rows = np.random.default_rng(SB).permutation(Q)[:n]
    launches = (cuda_concat.concat_decode.launches,
                cuda_concat.concat_compact.launches)
    oc = _check(cuda, snap, batch, rows, SB, op, form)
    torch.cuda.synchronize()
    assert cuda_concat.concat_decode.launches == launches[0] + 1
    assert cuda_concat.concat_compact.launches == \
        launches[1] + 3 * (form != "wire")
    if op == "or":
        assert int((oc > 0).sum()) >= n // 2


@pytest.mark.gpu
@pytest.mark.parametrize("op,form", FORMS)
def test_kernels_match_the_chain_for_a_single_past_the_classes(
        cuda, card_corpus, op, form):
    snap, nb, _, _ = card_corpus
    T = len(nb)
    # the two 2M lists and the 1M list: 39,063 blocks, past 32,768
    idx = np.array([[T - 1, T - 2, T - 3, 0]])
    found = np.ones((1, 4), dtype=bool)
    kv = np.array([3], dtype=np.int32)
    SB = int(-(-nb[idx[0, :3]].sum() // 8) * 8)
    assert SB > 32768
    oc = _check(cuda, snap, (idx, found, kv), np.array([0]), SB, op, form)
    assert int(oc[0]) > 0


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda, card_corpus):
    snap, nb, ff, dense = card_corpus
    idx, found, kv = _to(cuda, *queries(1, nb, ff, dense, 8, 3, 8))
    args = (snap.blocks, snap.term_block_start, snap.counts, idx, found, kv)
    with pytest.raises(ValueError, match="rows"):
        cuda_concat.concat_decode(*args, torch.arange(8, device=cuda), 8)
    rows = torch.arange(8, dtype=torch.int32, device=cuda)
    flat, meta = cuda_concat.concat_decode(*args, rows, 8)
    with pytest.raises(ValueError, match="page form"):
        cuda_concat.concat_compact(flat, meta, "or", 3, prefix_p=4)
