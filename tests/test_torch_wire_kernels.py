"""The full-result wire codec's kernels (ops/cuda_wire.py, csrc/wire.cu)
against the plain steps (models/steps.py _wire_meta_step and
_wire_pack_step) and a numpy reading of the wire, bit for bit: the masked
max delta that picks the width, and the first value plus the deltas at 8
and 16 bits.

The cases on the CPU hold the wrappers on CPU tensors to numpy and to the
plain steps, and count no launch. The cases marked `gpu` need an NVIDIA
card and nvcc and skip elsewhere; this file imports no `jax`, so on a
machine without it run
`python -m pytest --noconftest -m gpu tests/test_torch_wire_kernels.py`.
"""
import numpy as np
import pytest
import torch

from inverted_index_2_tpu_torch import (
    InvertedIndex,
    MeshQueryEngine,
    QueryEngine,
)
from inverted_index_2_tpu_torch.models import staged
from inverted_index_2_tpu_torch.models.snapshot import (
    build_host_tables,
    upload_tables,
)
from inverted_index_2_tpu_torch.models.steps import (
    _wire_meta_step,
    _wire_pack_step,
    _wire_unpack,
)
from inverted_index_2_tpu_torch.ops.cuda_wire import wire_meta, wire_pack
from inverted_index_2_tpu_torch.parallel import mesh_engine

FF = 0xFFFFFFFF
# max deltas at the width edges: 8 bits up to 255, 16 up to 65,535, then
# raw u32 (2^31 and up must not read as negative)
EDGE_DELTAS = (1, 255, 256, 65_535, 65_536, 2**31 - 1, 2**31, FF)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wire kernels are CUDA C++ built "
                    "with nvcc and have no CPU mode")
    return torch.device("cuda")


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


@pytest.fixture
def dev(request):
    """The device of a case: "cpu", "cuda" (marked gpu) or "meta"."""
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wire kernels are CUDA C++ built "
                    "with nvcc and have no CPU mode")
    return torch.device(request.param)


def _launches():
    return wire_meta.launches, wire_pack.launches


def _counted(dev, before, meta, pack):
    """On the card each call launched once; on the CPU nothing launched."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
        assert _launches() == (before[0] + meta, before[1] + pack)
    else:
        assert _launches() == before


def matrix(rng, rows, S, fill="garbage"):
    """(o (n, S) uint32, oc (n,) int32): each row's values, then fill past
    its count: random words whose deltas would widen the wire if they were
    read, or 0xFFFFFFFF as the concat kernels write."""
    n = len(rows)
    if fill == "garbage":
        o = rng.integers(0, 2**32, size=(n, S), dtype=np.uint64)
        o = o.astype(np.uint32)
    else:
        o = np.full((n, S), FF, dtype=np.uint32)
    oc = np.zeros(n, dtype=np.int32)
    for r, v in enumerate(rows):
        o[r, : len(v)] = v
        oc[r] = len(v)
    return o, oc


def ascending(rng, n, gap, start=None):
    """n ascending u32 values with gaps in [1, gap], from `start` (else a
    random start that leaves room for them)."""
    g = rng.integers(1, gap + 1, size=n, dtype=np.int64)
    if start is None:
        start = int(rng.integers(0, max(1, 2**32 - n * gap)))
    v = start + np.cumsum(g) - g[:1]
    assert n == 0 or v[-1] <= FF
    return v.astype(np.uint32)


def jump_row(rng, n, delta):
    """Up to n ascending values with gaps of at most min(9, delta) but one
    of `delta`."""
    room, gap = FF - delta, min(9, delta)
    pre = ascending(rng, max(1, min(n // 2, room // 20)), gap, start=0)
    post = ascending(rng, min(n - len(pre), 1 + (room - int(pre[-1])) // 9),
                     gap, start=int(pre[-1]) + delta)
    return np.concatenate([pre, post])


def np_meta(o, oc):
    m = 0
    for r in range(o.shape[0]):
        k = int(min(oc[r], o.shape[1]))
        if k > 1:
            m = max(m, int(np.diff(o[r, :k].astype(np.int64)).max()))
    return m


def to_dev(dev, o, oc, oc_dtype=torch.int32):
    return (torch.from_numpy(o.view(np.int32)).to(dev),
            torch.from_numpy(oc).to(oc_dtype).to(dev))


def edge_rows(rng, S, delta):
    """Rows with counts 0, 1, 2 and the full width, smaller deltas, and one
    row whose largest kept delta is `delta`."""
    rows = [ascending(rng, 0, 1), ascending(rng, 1, 1),
            jump_row(rng, S // 3, delta), ascending(rng, 2, min(9, delta)),
            ascending(rng, S, min(3, delta), start=5)]
    for k in (3, S // 2, S - 1):
        rows.append(ascending(rng, k, min(200, delta)))
    return rows


@pytest.mark.parametrize("dev", DEVICES, indirect=True)
@pytest.mark.parametrize("oc_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("delta", EDGE_DELTAS)
def test_meta_reads_each_row_up_to_its_count(dev, oc_dtype, delta):
    rng = np.random.default_rng(delta % 1000)
    S = 3000  # two tiles of the kernel's 2,048 deltas
    o, oc = matrix(rng, edge_rows(rng, S, delta), S)
    # the fill past each count holds larger deltas than any kept one
    assert np_meta(o, np.full(len(oc), S)) > delta or delta == FF
    before = _launches()
    ot, oct_ = to_dev(dev, o, oc, oc_dtype)
    md = wire_meta(ot, oct_)
    _counted(dev, before, 1, 0)
    assert md.dtype == torch.int64 and md.shape == ()
    assert int(md) == np_meta(o, oc) == delta
    assert int(md) == int(_wire_meta_step(ot, oct_))


@pytest.mark.parametrize("dev", DEVICES, indirect=True)
def test_meta_of_rows_without_two_values_is_zero(dev):
    rng = np.random.default_rng(1)
    o, oc = matrix(rng, [ascending(rng, k, 5) for k in (0, 1, 1, 0)], 4100)
    before = _launches()
    assert int(wire_meta(*to_dev(dev, o, oc))) == 0
    _counted(dev, before, 1, 0)
    # one lane or no row: nothing to launch
    for shape in ((5, 1), (0, 64)):
        z = torch.zeros(shape, dtype=torch.int32, device=dev)
        md = wire_meta(z, torch.ones(shape[0], dtype=torch.int32, device=dev))
        assert md.dtype == torch.int64 and int(md) == 0
    _counted(dev, before, 1, 0)


@pytest.mark.parametrize("dev", DEVICES, indirect=True)
@pytest.mark.parametrize("bits", [8, 16])
def test_a_genuine_ffffffff_as_the_last_kept_value(dev, bits):
    rng = np.random.default_rng(bits)
    gap = 200 if bits == 8 else 60_000
    rows = []
    for n in (2, 130, 2049, 2050):
        g = rng.integers(1, gap + 1, size=n - 1, dtype=np.int64)
        rows.append((FF - np.append(np.cumsum(g[::-1])[::-1], 0))
                    .astype(np.uint32))
    o, oc = matrix(rng, rows, 2100, fill="ff")
    ot, oct_ = to_dev(dev, o, oc)
    md = int(wire_meta(ot, oct_))
    assert md == np_meta(o, oc) and md < 1 << bits
    f, dd = wire_pack(ot, bits, int(oc.max()))
    back = _wire_unpack(f.cpu().numpy().view(np.uint32),
                        dd.cpu().numpy().view(f"u{bits // 8}"))
    for r, v in enumerate(rows):
        assert np.array_equal(back[r, : len(v)], v)


@pytest.mark.parametrize("dev", DEVICES, indirect=True)
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("S,maxc", [(3000, 2), (3000, 1500), (3000, 3000),
                                    (4097, 4097), (64, 1)])
def test_pack_is_the_plain_pack_cut_to_maxc(dev, bits, S, maxc):
    rng = np.random.default_rng(S + maxc + bits)
    gap = (1 << bits) - 1
    rows = [ascending(rng, k, gap) for k in (maxc, max(0, maxc - 7), 1, 0)]
    o, oc = matrix(rng, rows, S)
    ot = to_dev(dev, o, oc)[0]
    before = _launches()
    f, dd = wire_pack(ot, bits, maxc)
    _counted(dev, before, 0, 1)
    assert f.shape == (4, 1) and f.dtype == torch.int32
    assert dd.shape == (4, maxc - 1) and dd.is_contiguous()
    assert dd.dtype == (torch.uint8 if bits == 8 else torch.int16)
    pf, pdd = _wire_pack_step(ot, bits)
    assert torch.equal(f, pf) and torch.equal(dd, pdd[:, : maxc - 1])
    want = (np.diff(o[:, :maxc].astype(np.int64), axis=1) % (1 << bits))
    got = dd.cpu().numpy().view(f"u{bits // 8}")
    assert np.array_equal(got, want)  # past a row's count too: it may wrap
    back = _wire_unpack(f.cpu().numpy().view(np.uint32), got)
    for r, v in enumerate(rows):
        assert np.array_equal(back[r, : len(v)], v)


@pytest.mark.parametrize("dev", DEVICES, indirect=True)
def test_rows_at_a_pitch(dev):
    rng = np.random.default_rng(5)
    rows = [ascending(rng, k, 250) for k in (2500, 17, 0, 2999)]
    o, oc = matrix(rng, rows, 3000)
    wide = np.concatenate([o, np.full((4, 96), 3, np.uint32)], axis=1)
    wt, oct_ = to_dev(dev, wide, oc)
    ot = wt[:, :3000]
    assert ot.stride(0) == 3096
    assert int(wire_meta(ot, oct_)) == np_meta(o, oc) < 256
    f, dd = wire_pack(ot, 8, 3000)
    pf, pdd = _wire_pack_step(ot, 8)
    assert torch.equal(f, pf) and torch.equal(dd, pdd)
    # lanes at a stride are refused, on both devices alike
    strided = wt.t().contiguous().t()[:, :3000]
    with pytest.raises(ValueError, match="stride"):
        wire_meta(strided, oct_)
    with pytest.raises(ValueError, match="stride"):
        wire_pack(strided, 8, 2)


@pytest.mark.parametrize("dev", DEVICES, indirect=True)
def test_wire_fetch_returns_every_rows_values(dev):
    """staged._wire_fetch at each width: u8, u16, raw u32 and a matrix
    whose rows hold one value at most."""
    rng = np.random.default_rng(6)
    mats = []
    for gap in (100, 30_000, 2**24):
        mats.append(matrix(rng, [ascending(rng, k, gap)
                                 for k in (40, 1, 0, 200)], 300))
    mats.append(matrix(rng, [ascending(rng, 1, 1), []], 300))
    outs, ocs, mds = [], [], []
    before = _launches()
    for o, oc in mats:
        ot, oct_ = to_dev(dev, o, oc)
        outs.append(ot)
        ocs.append(oc)
        mds.append(wire_meta(ot, oct_).cpu().numpy())
    hosts = staged._wire_fetch(outs, ocs, mds)
    _counted(dev, before, 4, 2)
    for (o, oc), h in zip(mats, hosts):
        assert h.dtype == np.uint32
        for r in range(len(oc)):
            assert np.array_equal(h[r, : oc[r]], o[r, : oc[r]])


@pytest.mark.parametrize("dev", DEVICES + ["meta"], indirect=True)
def test_arguments_the_wrappers_do_not_take_raise(dev):
    o = torch.zeros((4, 64), dtype=torch.int32, device=dev)
    oc = torch.ones(4, dtype=torch.int32, device=dev)
    before = _launches()
    if dev.type == "meta":
        with pytest.raises(ValueError, match="no wire meta kernel"):
            wire_meta(o, oc)
        with pytest.raises(ValueError, match="no wire pack kernel"):
            wire_pack(o, 8, 2)
        return
    for bad in (o.to(torch.int64), o[0], o.to(torch.uint8)):
        with pytest.raises(ValueError, match="o: want int32"):
            wire_meta(bad, oc)
        with pytest.raises(ValueError, match="o: want int32"):
            wire_pack(bad, 8, 2)
    for bad in (oc[:3], oc.to(torch.float32), oc[None, :], oc.to("meta")):
        with pytest.raises(ValueError, match="oc: want"):
            wire_meta(o, bad)
    for bits in (4, 12, 32):
        with pytest.raises(ValueError, match="bits"):
            wire_pack(o, bits, 2)
    for maxc in (0, -1, 65):
        with pytest.raises(ValueError, match="maxc"):
            wire_pack(o, 8, maxc)
    _counted(dev, before, 0, 0)


# -- on the card: the chunks the streams and the mesh hand the codec -------


def _corpus(seed, n_terms=160):
    """Lists at every block width (gaps up to 1, 100, 30,000 and 2^24), some
    long, one ending in a genuine 0xFFFFFFFF; tables and the lists."""
    rng = np.random.default_rng(seed)
    lists = []
    for i in range(n_terms):
        scale = (1, 100, 30_000, 2**24)[i % 4]
        n = int(rng.choice([1, 127, 129, int(rng.integers(1, 5000)),
                            int(rng.integers(20_000, 60_000))]))
        g = rng.integers(1, 2 * scale + 1, size=n, dtype=np.int64)
        lists.append(np.unique((int(rng.integers(0, 2**20)) + np.cumsum(g))
                               % FF).astype(np.uint32))
    lists.append(np.array([0, 7, FF], dtype=np.uint32))
    voffs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    blob = b"".join(f"t{i:05d}".encode() for i in range(len(lists)))
    offs = np.arange(len(lists) + 1, dtype=np.int64) * 6
    return build_host_tables(blob, offs, np.concatenate(lists), voffs)


class Spy:
    """Records every (o, oc) the wrapper sees in `module.wire_meta` and
    every (o, bits, maxc) in staged.wire_pack, and passes each through."""

    def __init__(self, monkeypatch, module):
        self.meta, self.pack = [], []

        def meta(o, oc):
            self.meta.append((o, oc))
            return wire_meta(o, oc)

        def pack(o, bits, maxc):
            self.pack.append((o, bits, maxc))
            return wire_pack(o, bits, maxc)

        monkeypatch.setattr(module, "wire_meta", meta)
        monkeypatch.setattr(staged, "wire_pack", pack)

    def verify(self, before, label):
        """Every captured call again through the kernels and the plain
        steps on the card, bit-equal; one launch a call."""
        torch.cuda.synchronize()
        assert _launches() == (before[0] + len(self.meta),
                               before[1] + len(self.pack)), label
        for o, oc in self.meta:
            assert int(wire_meta(o, oc)) == int(_wire_meta_step(o, oc)), label
        for o, bits, maxc in self.pack:
            f, dd = wire_pack(o, bits, maxc)
            pf, pdd = _wire_pack_step(o, bits)
            assert torch.equal(f, pf), label
            assert torch.equal(dd, pdd[:, : maxc - 1]), label
        torch.cuda.synchronize()
        n = len(self.meta), len(self.pack)
        self.meta, self.pack = [], []
        return n


@pytest.mark.gpu
def test_engine_chunks_are_bit_equal_and_counted(cuda, monkeypatch):
    monkeypatch.setenv("TPI_HOST_BOOL", "0")
    t = _corpus(11)
    terms = [f"t{i:05d}".encode() for i in range(t.counts.shape[0])]
    gpu = QueryEngine(upload_tables(t, device=cuda), L=256, device=cuda)
    cpu = QueryEngine(upload_tables(t, device="cpu"), L=256, device="cpu")
    rng = np.random.default_rng(12)
    queries = [[terms[i] for i in rng.choice(len(terms), size=int(k))]
               for k in rng.integers(2, 5, size=200)]
    queries += [[terms[-1], terms[-1]], [terms[-1], b"missing"]]
    # ORs of the lists with gaps up to 1 and 100 only: their chunks ship
    # at 8 or 16 bits, where a list of gaps up to 2^24 ships raw u32
    dense = [terms[i] for i in range(len(terms) - 1) if i % 4 < 2]
    dense_queries = [[dense[i] for i in rng.choice(len(dense), size=int(k))]
                     for k in rng.integers(2, 5, size=100)]
    # the CPU engine's answers first: its calls go through the spy too
    st, cst = gpu._serving_state(), cpu._serving_state()
    qk, kv = gpu._pack_boolean(st, queries)
    want_and = cpu._boolean_concat(cst, queries, qk, kv, "and", None)[0]
    batches = [queries[:100], dense_queries]
    want_or = cpu.boolean_staged(batches, "or", columnar=True)
    spy = Spy(monkeypatch, staged)
    # the AND follow-ups' route: the concat AND over the whole batch
    before = _launches()
    got = gpu._boolean_concat(st, queries, qk, kv, "and", None)[0]
    meta, pack = spy.verify(before, "the concat AND")
    assert meta > 1 and pack > 0
    assert all(np.array_equal(a, w) for a, w in zip(got, want_and))
    # the full-result OR stream: wire dedup, K4's sorted stream and n_valid
    before = _launches()
    got = gpu.boolean_staged(batches, "or", columnar=True)
    meta, pack = spy.verify(before, "the OR stream")
    assert meta > 1 and pack > 0
    for (a, ao), (w, wo) in zip(got, want_or):
        assert np.array_equal(a, w) and np.array_equal(ao, wo)
    # pages: the page form writes its buffer and never calls the codec
    before = _launches()
    gpu.boolean_staged([queries], "or", columnar=True, prefix_p=8)
    assert spy.verify(before, "the OR page stream") == (0, 0)


@pytest.mark.gpu
def test_mesh_chunks_are_bit_equal_and_counted(cuda, monkeypatch, tmp_path):
    monkeypatch.setenv("TPI_HOST_BOOL", "0")
    rng = np.random.default_rng(3)
    ii = InvertedIndex(str(tmp_path))
    vocab = [bytes([int(a), int(b)]) + f"t{i}".encode()
             for i, (a, b) in enumerate(rng.integers(32, 127, size=(60, 2)))]
    # dense ids, so the mesh's chunks ship packed (the edge rows of the
    # synthetic cases above take the raw u32 choice)
    for doc in range(1, 400):
        k = int(rng.integers(1, 6))
        ii.put([vocab[i] for i in rng.choice(len(vocab), size=k,
                                             replace=False)], doc)
    for v in range(1000, 1300):
        ii.put([vocab[0], vocab[1]], v)
    gpu = MeshQueryEngine(ii, mesh=[cuda, cuda], L=128)
    cpu = MeshQueryEngine(ii, mesh=["cpu", "cpu"], L=128)
    queries = [[vocab[i] for i in rng.choice(len(vocab), size=int(k),
                                             replace=False)]
               for k in rng.integers(1, 4, size=50)]
    queries += [[vocab[0], vocab[1]], [vocab[0]]]
    # the CPU engine's answers first: its calls go through the spy too
    want = {op: cpu.boolean(queries, op) for op in ("and", "or")}
    want_lookup = cpu.lookup(vocab)
    spy = Spy(monkeypatch, mesh_engine)
    for op in ("and", "or"):
        before = _launches()
        got = gpu.boolean(queries, op)
        meta, pack = spy.verify(before, f"mesh {op}")
        assert meta >= 2 and pack >= 1  # the pass and a re-serve
        for a, w in zip(got, want[op]):
            assert np.array_equal(a, w)
    before = _launches()
    got = gpu.lookup(vocab)
    assert spy.verify(before, "mesh lookup")[0] >= 2
    for a, w in zip(got, want_lookup):
        assert np.array_equal(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("n,S,share", [
    (8, 1 << 20, 0.02),     # a class-8192 AND chunk
    (8, 1 << 20, 1.0),      # ... every lane kept (the OR stream's n_valid)
    (1, 1 << 24, 0.05),     # a single of 2^24 lanes
    (256, 4096, 0.3),       # a short class
    (2048, 128, 0.9)])      # mesh rows at L = 128
def test_kernels_at_chunk_shapes(cuda, n, S, share):
    g = torch.Generator(device=cuda)
    g.manual_seed(n + S)
    gaps = torch.randint(1, 256, (n, S), generator=g, device=cuda,
                         dtype=torch.int64)
    vals = torch.cumsum(gaps, dim=1) + torch.randint(
        0, 1 << 20, (n, 1), generator=g, device=cuda, dtype=torch.int64)
    oc = torch.randint(0, max(2, int(S * share)) + 1, (n,), generator=g,
                       device=cuda, dtype=torch.int64)
    oc[0] = int(S * share)
    lanes = torch.arange(S, device=cuda)[None, :]
    o = torch.where(lanes < oc[:, None], vals, FF)
    o = torch.where(o > FF, FF, o)
    o = (o - (o >= 2**31).to(torch.int64) * 2**32).to(torch.int32)
    for c in (oc, oc.to(torch.int32)):
        before = _launches()
        md = wire_meta(o, c)
        assert int(md) == int(_wire_meta_step(o, c))
        maxc = int(c.max())
        f, dd = wire_pack(o, 8, maxc)
        pf, pdd = _wire_pack_step(o, 8)
        assert torch.equal(f, pf) and torch.equal(dd, pdd[:, : maxc - 1])
        f, dd = wire_pack(o, 16, maxc)
        pf, pdd = _wire_pack_step(o, 16)
        assert torch.equal(f, pf) and torch.equal(dd, pdd[:, : maxc - 1])
        _counted(cuda, before, 1, 2)
