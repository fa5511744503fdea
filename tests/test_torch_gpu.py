"""Kernels K1 (decode, with and without a found mask), K2 (fused AND), K3
(sorted-set AND) and K4 (row sort from any row, from ascending runs, the
two-run merge, the compaction of kept lanes) on the card against their
plain torch versions, and the engine on
CUDA against the engine on the CPU and a numpy oracle (AND, OR,
pagination, staged lookup, and all of them with a delta tier live; range
and prefix reads; the hybrid AND stream; a warm checkpoint start whose
arena uploads on a side stream); the mesh engine with two partitions on
one card against the same on the CPU, and on two cards when there are two;
the device merge against the host merge. The device routes are pinned
(TPI_HOST_BOOL=0) unless a test asks for the host.

Marked `gpu`: they need an NVIDIA card and nvcc and skip elsewhere. This
file imports no `jax`, so on a machine without it run it with
`python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`."""
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from inverted_index_2_tpu_torch import InvertedIndex, QueryEngine
from inverted_index_2_tpu_torch.models import query_engine as port_qe
from inverted_index_2_tpu_torch.models.checkpoint import save_tables
from inverted_index_2_tpu_torch.models.snapshot import build_host_tables, upload_tables
from inverted_index_2_tpu_torch.ops import (
    compaction,
    cuda_bool,
    cuda_decode,
    cuda_fused,
    cuda_sort,
    setops,
)
from inverted_index_2_tpu_torch.ops.decode import gather_postings_arena
from inverted_index_2_tpu_torch.utils.u32 import from_i64
from inverted_index_2_tpu_torch.ops.cuda_fused import (
    MAX_LEVEL,
    fused_and,
    fused_and_torch,
    reorder_smallest_base,
)

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _device_route(monkeypatch):
    # auto may pick the host route on the card: these tests exist for the
    # device paths
    monkeypatch.setenv("TPI_HOST_BOOL", "0")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1/K2 are CUDA C++ built with nvcc "
                    "and have no CPU mode")
    return torch.device("cuda")


def _corpus(seed, n_terms=300, extra=()):
    rng = np.random.default_rng(seed)
    lists = []
    for i in range(n_terms):
        scale = (1, 100, 30_000, 2**24)[i % 4]   # block widths 0/8/16/32
        n = int(rng.choice([1, 127, 128, 129, int(rng.integers(1, 5000))]))
        g = rng.integers(1, 2 * scale + 1, size=n, dtype=np.int64)
        start = int(rng.integers(0, 2**32 - 1))  # lists cross 2^32 and wrap
        lists.append(np.unique(((start + np.cumsum(g)) % 2**32)
                               .astype(np.uint32)))
    lists.append(np.array([0, 7, 2**32 - 1], dtype=np.uint32))
    lists.extend(extra)
    voffs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    blob = b"".join(f"t{i:05d}".encode() for i in range(len(lists)))
    offs = np.arange(len(lists) + 1, dtype=np.int64) * 6
    return lists, build_host_tables(blob, offs, np.concatenate(lists), voffs)


def _valid_equal(a, b, counts, L):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    for q, c in enumerate(np.minimum(counts.cpu().numpy(), L)):
        if not np.array_equal(a[q, :c], b[q, :c]):
            return False
    return True


@pytest.mark.parametrize("L,seed", [(128, 1), (2048, 1), (512, 2)])
def test_decode_kernel_matches_plain(cuda, L, seed):
    lists, t = _corpus(seed)
    snap = upload_tables(t, device=cuda)
    cpu = upload_tables(t, device="cpu")
    idx = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, len(lists), size=1000).astype(np.int32))
    before = cuda_decode.decode_postings.launches
    kv, kc = cuda_decode.decode_postings(
        snap.blocks, snap.term_block_start, snap.counts, idx.to(cuda), L)
    torch.cuda.synchronize()
    assert cuda_decode.decode_postings.launches == before + 1
    pv, pc = gather_postings_arena(cpu.blocks, cpu.term_block_start,
                                   cpu.counts, idx, L)
    assert torch.equal(kc.cpu(), pc)
    assert _valid_equal(kv, pv, pc, L)


def _edge_lists():
    """Lists for K2's block tests. `wide`: 384 values whose blocks need 8,
    16 and 8 bits. `dense`: 300 consecutive values, so blocks of bit width
    0. `touch`: values equal to a block's anchor (wide[128]), to a block's
    last value (wide[255], dense[127]) and to neither."""
    wide = np.cumsum(np.concatenate([np.full(128, 3), np.full(128, 700),
                                     np.full(128, 5)])).astype(np.uint32)
    dense = (np.arange(300) + 70_000).astype(np.uint32)
    touch = np.unique(np.array(
        [wide[0], wide[127], wide[128], wide[129] + 1, wide[255], wide[256],
         wide[383], dense[0], dense[127], dense[128], dense[299], 90_000],
        dtype=np.uint32))
    return [wide, dense, touch, np.union1d(wide, dense).astype(np.uint32)]


@pytest.mark.parametrize("mode", ["masked", "compact", "width8"])
@pytest.mark.parametrize("L,K,seed", [(256, 8, 3), (2048, 8, 4),
                                       (MAX_LEVEL, 8, 5), (512, 16, 6),
                                       (2048, 2, 7), (256, 1, 8)])
def test_fused_kernel_matches_plain(cuda, L, K, seed, mode):
    lists, t = _corpus(seed, extra=_edge_lists())
    snap = upload_tables(t, device=cuda)
    rng = np.random.default_rng(seed)
    Q = 512
    idx = rng.integers(0, len(lists), size=(Q, K))
    kv = rng.integers(1, K + 1, size=Q).astype(np.int32)
    if K >= 2:
        # the block tests: `touch` against the lists it touches, both ways
        n = len(lists)
        wide, dense, touch, both = n - 4, n - 3, n - 2, n - 1
        pairs = [(touch, wide), (touch, dense), (touch, both),
                 (wide, touch), (dense, both), (both, touch)]
        for r, pair in enumerate(pairs):
            idx[r, :2], kv[r] = pair, 2
    kv[6::9] = K                       # every slot live ...
    kmask = np.arange(K)[None, :] < kv[:, None]
    rows = np.where(kmask, t.tbs[idx], 0).astype(np.int32)
    cnts = np.where(kmask, t.counts[idx], 0).astype(np.int32)
    cnts[10::17, min(1, K - 1)] = 0  # missing terms
    rows, cnts, _ = reorder_smallest_base(
        torch.from_numpy(rows), torch.from_numpy(cnts), torch.from_numpy(kv))
    kv[6::9] = K + 3                   # ... and a k_valid above K walks K
    args = (rows.to(cuda), cnts.to(cuda), torch.from_numpy(kv).to(cuda), L)
    pout, poc = fused_and_torch(snap.blocks, *args)
    before = cuda_fused.fused_and.launches
    if mode == "masked":
        out, oc = fused_and(snap.blocks, *args, compact=False)
    elif mode == "compact":
        out, oc = fused_and(snap.blocks, *args)
        pout = compaction.compact_rows_torch(pout, pout != -1)
    else:
        out, oc = fused_and(snap.blocks, *args, width=8)
        pout = cuda_fused.compact_small(pout, 8)
    torch.cuda.synchronize()
    assert cuda_fused.fused_and.launches == before + 1
    assert out.shape == pout.shape
    assert torch.equal(oc, poc) and torch.equal(out, pout)
    assert int((oc > 0).sum()) > 0
    if K >= 2:  # the base is the shorter list's first L values
        for r, pair in enumerate(pairs):
            small, big = sorted((lists[i] for i in pair), key=len)
            assert oc[r] == len(np.intersect1d(small[:L], big)) > 0


def test_engine_cuda_matches_cpu(cuda, monkeypatch):
    lists, t = _corpus(5, n_terms=120)
    terms = [f"t{i:05d}".encode() for i in range(len(lists))]
    gpu = QueryEngine(upload_tables(t, device=cuda), L=256, device=cuda)
    cpu = QueryEngine(upload_tables(t, device="cpu"), L=256, device="cpu")
    rng = np.random.default_rng(6)
    queries = [[terms[i] for i in rng.choice(len(terms), size=int(k))]
               for k in rng.integers(1, 6, size=300)]
    queries.append([terms[0], b"missing"])
    k1, k2 = cuda_decode.decode_postings.launches, cuda_fused.fused_and.launches
    for a, b in zip(gpu.boolean(queries, "and"), cpu.boolean(queries, "and")):
        assert np.array_equal(a, b)
    for a, b in zip(gpu.lookup(terms + [b"missing"]),
                    cpu.lookup(terms + [b"missing"])):
        assert (a is None and b is None) or np.array_equal(a, b)
    assert cuda_fused.fused_and.launches > k2
    assert cuda_decode.decode_postings.launches > k1
    # the stream with forced dedup, and bases above a lowered level cap
    # served by the concat AND (torch ops on the card)
    monkeypatch.setenv("TPI_STAGED_DEDUP", "force")
    monkeypatch.setattr(port_qe, "MAX_LEVEL", 512)
    stream = [queries[:150] * 2, queries[150:]]
    for (gv, go), (cv, co) in zip(
            gpu.boolean_staged(stream, "and", columnar=True),
            cpu.boolean_staged(stream, "and", columnar=True)):
        assert np.array_equal(go, co) and np.array_equal(gv, cv)
    assert gpu.last_stream_stats["concat"] > 0
    assert gpu.last_stream_stats["served_rows"] < 2 * len(queries)


def _sort_input(rng, Q, M):
    x = rng.integers(0, 2**32, size=(Q, M), dtype=np.uint64).astype(np.uint32)
    x[0] = 0xFFFFFFFF                      # a row full of the fill value
    x[1] = 0x80000000                      # a row at the sign bit
    x[2, ::3] = 0xFFFFFFFF
    x[2, 1::3] = 0x80000000
    x[3] = rng.integers(0, 4, size=M)      # long runs of equal values
    return torch.from_numpy(x.view(np.int32))


@pytest.mark.parametrize("Q,M", [(16384, 1024), (4096, 4096), (2048, 8192),
                                 (1024, 16384), (256, 65536), (64, 262144),
                                 (40, 160), (24, 5000), (8, 128)])
def test_sort_kernel_matches_plain(cuda, Q, M):
    x = _sort_input(np.random.default_rng(Q + M), Q, M).to(cuda)
    before = cuda_sort.sort_rows.launches
    got = cuda_sort.sort_rows(x)
    torch.cuda.synchronize()
    assert cuda_sort.sort_rows.launches == before + 1
    assert got.shape == (Q, M)
    assert torch.equal(got, cuda_sort.sort_rows_torch(x))


def runs_input(rng, Q, m, r):
    """Rows of m lanes whose every r consecutive lanes ascend in u32 order:
    sorted random values (across the sign bit), each run ending in a tail
    of 0xFFFFFFFF of random length (none, some, or the whole run)."""
    n_runs = -(-m // r)
    x = rng.integers(0, 2**32, size=(Q, n_runs, r), dtype=np.uint64)
    x = np.sort(x.astype(np.uint32), axis=2)
    tail = rng.integers(0, r + 1, size=(Q, n_runs, 1))
    tail[rng.random((Q, n_runs, 1)) < 0.3] = 0
    x[np.arange(r)[None, None, :] >= r - tail] = 0xFFFFFFFF
    return torch.from_numpy(
        np.ascontiguousarray(x.reshape(Q, n_runs * r)[:, :m]).view(np.int32))


@pytest.mark.parametrize("Q,m,r", [
    (4096, 4096, 2048),      # the pair union at L = 2048
    (77, 27136, 13568),      # ... at the top ladder level: no power of two
    (33, 700, 400),          # two runs, the second short
    (512, 32768, 4096),      # the dual OR: K runs of 2L
    (2048, 8192, 128),       # a concat class: 128-lane blocks
    (256, 65536, 128), (16, 262144, 128),
    (24, 5000, 128), (40, 160, 128),
    (64, 100000, 20000),     # runs longer than a tile, no power of two
    (32, 3000, 1536),        # 3 * 512: sorted from runs of 512
    (32, 3000, 24),          # no usable power of two: the whole network
    (8, 500, 500), (8, 500, 600),   # one run: already sorted
])
def test_sort_from_runs_matches_plain(cuda, Q, m, r):
    x = runs_input(np.random.default_rng(Q + m + r), Q, m, r).to(cuda)
    cuda_sort.check_runs(x, r)
    before = dict(cuda_sort.sort_rows.entries)
    got = cuda_sort.sort_rows(x, run=r)
    torch.cuda.synchronize()
    assert got.shape == (Q, m)
    assert torch.equal(got, cuda_sort.sort_rows_torch(x, run=r))
    entry = None if r >= m else "two_run" if m <= 2 * r else "runs"
    for name, n in cuda_sort.sort_rows.entries.items():
        assert n == before[name] + (name == entry)


def compact_input(rng, Q, m):
    """Sorted rows with random keep masks; row 0 all 0xFFFFFFFF (kept and
    not), row 1 keeps a genuine 0xFFFFFFFF last member, row 2 keeps all,
    row 3 keeps none."""
    vals = np.sort(rng.integers(0, 2**32, size=(Q, m), dtype=np.uint64)
                   .astype(np.uint32), axis=1)
    keep = rng.random((Q, m)) < rng.random((Q, 1))
    vals[0] = 0xFFFFFFFF
    vals[1, -1] = 0xFFFFFFFF
    keep[1, -1] = True
    keep[2] = True
    keep[3] = False
    return torch.from_numpy(vals.view(np.int32)), torch.from_numpy(keep)


@pytest.mark.parametrize("Q,m", [(4096, 4096), (2048, 8192), (256, 65536),
                                 (16, 262144), (8192, 160), (24, 5000),
                                 (8, 1), (8, 257)])
def test_compact_kernel_matches_plain(cuda, Q, m):
    vals, keep = compact_input(np.random.default_rng(Q + m), Q, m)
    vals, keep = vals.to(cuda), keep.to(cuda)
    before = cuda_sort.sort_rows.entries["compact"]
    got = compaction.compact_rows(vals, keep)
    torch.cuda.synchronize()
    assert cuda_sort.sort_rows.entries["compact"] == before + 1
    assert torch.equal(got, compaction.compact_rows_torch(vals, keep))
    assert torch.equal((got != -1).sum(dim=1)[2:],
                       (keep & (vals != -1)).sum(dim=1)[2:])


def test_compact_kernel_takes_a_row_pitch_and_refuses_other_strides(cuda):
    vals, keep = compact_input(np.random.default_rng(5), 64, 1000)
    vals, keep = vals.to(cuda), keep.to(cuda)
    got = compaction.compact_rows(vals[:, :160], keep[:, :160])
    want = compaction.compact_rows_torch(vals[:, :160].contiguous(),
                                         keep[:, :160].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # a list of a (Q, K, L) matrix: pitch K * L
    v3 = vals[:, :960].reshape(64, 3, 320)
    k3 = keep[:, :960].reshape(64, 3, 320)
    assert torch.equal(compaction.compact_rows(v3[:, 1, :], k3[:, 1, :]),
                       compaction.compact_rows_torch(v3[:, 1, :], k3[:, 1, :]))
    with pytest.raises(ValueError):
        compaction.compact_rows(vals[:, ::2], keep[:, ::2])


@pytest.mark.parametrize("L", [256, 2048])
def test_decode_kernel_found_mask(cuda, L):
    lists, t = _corpus(12)
    snap = upload_tables(t, device=cuda)
    rng = np.random.default_rng(13)
    idx = torch.from_numpy(rng.integers(0, len(lists), size=3000)
                           .astype(np.int32)).to(cuda)
    found = torch.from_numpy(rng.random(3000) < 0.3).to(cuda)
    idx = torch.where(found, idx, 0).to(torch.int32)  # a miss resolves to 0
    pv, pc = gather_postings_arena(snap.blocks, snap.term_block_start,
                                   snap.counts, idx, L, found)
    # K1 writes into whatever torch.empty hands out: make that a pattern, so
    # an untouched row still holds it
    pattern = torch.full((3000, L), 0x5A5A5A5A, dtype=torch.int32,
                         device=cuda)
    ptr = pattern.data_ptr()
    del pattern
    kv, kc = cuda_decode.decode_postings(
        snap.blocks, snap.term_block_start, snap.counts, idx, L, found)
    torch.cuda.synchronize()
    assert torch.equal(kc, pc)
    assert bool((kc[~found] == 0).all()) and int(kc[found].min()) > 0
    assert _valid_equal(kv, pv, pc, L)
    if kv.data_ptr() == ptr:  # the allocator reused the block
        assert bool((kv[~found] == 0x5A5A5A5A).all())


@pytest.mark.parametrize("L", [128, 512])
def test_engine_cuda_and_of_no_terms_in_a_delta_window(cuda, tmp_path, L):
    """k_valid = 0 with a non-empty base (the index holds the empty term):
    the card answers as the CPU engine does in both regimes of the plain
    AND (L = 128 keeps the base, L = 512 gives nothing)."""
    ii = InvertedIndex(str(tmp_path))
    for v in range(1, 30):
        # filler terms keep the one-document delta below DELTA_FRACTION
        ii.put([b"", b"a", b"t01"]
               + [f"f{v:02d}-{j}".encode() for j in range(3)], v)
    got = {}
    for dev in ("cpu", "cuda"):
        eng = QueryEngine.from_index(ii, L=L, device=dev)
        got[dev] = eng
    ii.put([b"a", b"x"], 100)
    k3 = cuda_bool.intersect_many.launches
    rows = {}
    for dev, eng in got.items():
        assert eng.refresh(ii) and eng.delta is not None
        rows[dev] = eng.boolean([[], [b"a"], [b"a", b"x"]], "and")
    assert cuda_bool.intersect_many.launches > k3
    for a, b in zip(rows["cuda"], rows["cpu"]):
        assert np.array_equal(a, b)
    want = np.arange(1, 30) if L == 128 else np.zeros(0)
    assert np.array_equal(rows["cuda"][0], want)
    assert np.array_equal(rows["cuda"][1], np.append(np.arange(1, 30), 100))


def _or_oracle(lists, terms, q, op):
    sets = [lists[terms.index(t)] for t in q if t in terms]
    if op == "and":
        if len(sets) < len(q):
            return np.zeros(0, np.uint32)
        out = sets[0]
        for v in sets[1:]:
            out = np.intersect1d(out, v)
        return out
    return (np.unique(np.concatenate(sets)).astype(np.uint32) if sets
            else np.zeros(0, np.uint32))


def test_engine_cuda_or_and_pages_match_oracle(cuda, monkeypatch):
    lists, t = _corpus(8, n_terms=120)
    terms = [f"t{i:05d}".encode() for i in range(len(lists))]
    gpu = QueryEngine(upload_tables(t, device=cuda), L=256, tables=t,
                      device=cuda)
    bare = QueryEngine(upload_tables(t, device=cuda), L=256, device=cuda)
    rng = np.random.default_rng(9)
    queries = [[terms[i] for i in rng.choice(len(terms), size=int(k))]
               for k in rng.integers(1, 6, size=300)]
    queries += [[terms[-1], b"missing"], [b"missing"]]
    monkeypatch.setenv("TPI_STAGED_DEDUP", "force")
    k4 = cuda_sort.sort_rows.launches
    for eng in (gpu, bare):
        eng._SB_CLASSES = (8, 32)  # long queries go singly
        want = [_or_oracle(lists, terms, q, "or") for q in queries]
        for a, w in zip(eng.boolean(queries, "or"), want):
            assert np.array_equal(a, w)
        vals, voffs = eng.boolean_staged([queries[:150] * 2, queries[150:]],
                                         "or", columnar=True)[0]
        for i, w in enumerate(want[:150] * 2):
            assert np.array_equal(vals[voffs[i]:voffs[i + 1]], w)
        for op in ("or", "and"):
            pv, pvo, pc = eng.boolean_staged([queries], op, columnar=True,
                                             prefix_p=8)[0]
            for i, q in enumerate(queries):
                w = _or_oracle(lists, terms, q, op)
                assert pc[i] == len(w)
                assert np.array_equal(pv[pvo[i]:pvo[i + 1]], w[:8])
        rows = eng.lookup_staged([terms + [b"missing"]])[0]
        for i, w in enumerate(lists + [np.zeros(0, np.uint32)]):
            assert np.array_equal(rows[i], w)
    assert cuda_sort.sort_rows.launches > k4


def intersect_input(dev, seed, Q, K, W):
    """K3's inputs as callers make them: (Q, K, W) lists sorted unique in
    u32 order within their counts and random garbage past them, some
    spanning the sign bit, some empty or full, k_valid 1..K with pad rows
    of k_valid 0 and count 0, and a genuine 0xFFFFFFFF as the last member
    of every present list of every third query."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int64)

    off = ints(0, 2**32 - 4 * W - 2, (Q, 1, 1))
    off[1::4] = 2**31 - 2 * W
    vals = off + torch.cumsum(ints(1, 4, (Q, K, W)), dim=2)
    counts = ints(0, W + 1, (Q, K))
    counts[::5] = W
    counts[2::7, min(1, K - 1)] = 0
    kv = ints(1, K + 1, (Q,))
    kv[3::11] = 0
    counts[3::11] = 0
    ff = torch.zeros((Q, 1), dtype=torch.bool, device=dev)
    ff[::3] = True
    last = (counts - 1).clamp(min=0)[..., None]
    vals.scatter_(2, last, torch.where(ff[..., None] & (counts > 0)[..., None],
                                       2**32 - 1, vals.gather(2, last)))
    lanes = torch.arange(W, device=dev)[None, None, :]
    vals = torch.where(lanes < counts[..., None], vals,
                       ints(0, 2**32, (Q, K, W)))
    return (from_i64(vals), counts.to(torch.int32).contiguous(),
            kv.to(torch.int32))


def _check_intersect(lists, counts, kv):
    Q, K, W = lists.shape
    before = cuda_bool.intersect_many.launches
    out, oc = cuda_bool.intersect_many(lists, counts, kv)
    torch.cuda.synchronize()
    assert cuda_bool.intersect_many.launches == before + 1
    pout, poc = setops.intersect_many(lists, counts, kv)
    torch.cuda.synchronize()
    assert out.shape == (Q, W)
    assert torch.equal(oc, poc) and torch.equal(out, pout)
    return out, oc


@pytest.mark.parametrize("Q,K,W", [
    (8192, 8, 4096), (256, 8, 16384), (16, 4, 131072), (64, 8, 256),
    (154, 8, 27136),   # the top ladder level: no power of two
    (64, 4, 5001),     # rows that are not 16-byte aligned: copied by words
    (300, 1, 3000), (32, 32, 2048)])
def test_intersect_kernel_matches_plain(cuda, Q, K, W):
    lists, counts, kv = intersect_input(cuda, Q * K + W, Q, K, W)
    out, oc = _check_intersect(lists, counts, kv)
    assert int((oc > 0).sum()) > Q // 8
    assert int((out == -1).sum(dim=1).lt(W).sum()) > 0


@pytest.mark.parametrize("W", [12288, 27136, 512])
def test_intersect_kernel_branches(cuda, W):
    """Every branch of K3 (chip_smoke.k3_branch_input names them), in both
    regimes of the plain version (W = 512: a k_valid = 0 row keeps its
    base)."""
    vals, counts, kv, names = chip_smoke.k3_branch_input(W, seed=W)
    lists = torch.from_numpy(vals.view(np.int32)).to(cuda)
    out, oc = _check_intersect(lists, torch.from_numpy(counts).to(cuda),
                               torch.from_numpy(kv).to(cuda))
    want = chip_smoke.k3_branch_counts(vals, counts, kv)
    assert oc.cpu().numpy().tolist() == want.tolist(), names


def test_engine_cuda_with_delta_matches_cpu(cuda):
    lists, t = _corpus(10, n_terms=120)
    terms = [f"t{i:05d}".encode() for i in range(len(lists))]
    rng = np.random.default_rng(11)
    # the delta: half of it main terms that gain postings (some duplicates
    # of main values), half new longer terms
    dterms, dlists = [], []
    for i in range(40):
        new = i % 2 == 1
        dterms.append(f"new-term-{i:04d}".encode() if new else terms[i])
        base = lists[i]
        extra = rng.integers(0, 2**32, size=int(rng.integers(1, 600)),
                             dtype=np.uint64).astype(np.uint32)
        dup = base[:: max(1, len(base) // 5)] if not new else base[:0]
        dlists.append(np.unique(np.concatenate([extra, dup])))
    order = sorted(range(len(dterms)), key=lambda i: dterms[i])
    dterms = [dterms[i] for i in order]
    dlists = [dlists[i] for i in order]
    doffs = np.zeros(len(dterms) + 1, dtype=np.int64)
    np.cumsum([len(x) for x in dterms], out=doffs[1:])
    dvoffs = np.zeros(len(dlists) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in dlists], out=dvoffs[1:])
    dt = build_host_tables(b"".join(dterms), doffs, np.concatenate(dlists),
                           dvoffs)
    removed = np.unique(np.concatenate([lists[3][::3], dlists[0][::4]]))
    engines = []
    for dev in (cuda, torch.device("cpu")):
        eng = QueryEngine(upload_tables(t, device=dev), L=256, tables=t,
                          device=dev)
        eng._publish(eng._state.replace(
            delta=upload_tables(dt, device=dev), delta_tables=dt,
            removed=torch.from_numpy(removed.view(np.int32)).to(dev)))
        engines.append(eng)
    gpu, cpu = engines
    union = {}
    for term, v in zip(terms, lists):
        union[term] = v
    for term, v in zip(dterms, dlists):
        union[term] = np.union1d(union.get(term, v[:0]), v)
    vocab = sorted(union)
    queries = [[vocab[i] for i in rng.choice(len(vocab), size=int(k))]
               for k in rng.integers(1, 6, size=300)]
    queries += [[vocab[0], b"missing"], [b"missing"]]
    k1, k3 = cuda_decode.decode_postings.launches, cuda_bool.intersect_many.launches
    for fr in (False, True):
        for op in ("and", "or"):
            g_rows = gpu.boolean(queries, op, filter_removed=fr)
            c_rows = cpu.boolean(queries, op, filter_removed=fr)
            for q, a, b in zip(queries, g_rows, c_rows):
                assert np.array_equal(a, b)
                sets = [union.get(x) for x in q]
                if op == "and":
                    w = (sets[0] if all(s is not None for s in sets)
                         else np.zeros(0, np.uint32))
                    for s in sets[1:]:
                        w = np.intersect1d(w, s) if s is not None else w
                else:
                    w = np.unique(np.concatenate(
                        [s for s in sets if s is not None] or [w[:0]]))
                if fr:
                    w = np.setdiff1d(w, removed)
                assert np.array_equal(a, w)
            gp = gpu.boolean_staged([queries[:150], queries[150:]], op, fr,
                                    columnar=True, prefix_p=8)
            cp = cpu.boolean_staged([queries[:150], queries[150:]], op, fr,
                                    columnar=True, prefix_p=8)
            for x, y in zip(gp, cp):
                assert all(np.array_equal(a, b) for a, b in zip(x, y))
    for a, b in zip(gpu.lookup(vocab + [b"missing"]),
                    cpu.lookup(vocab + [b"missing"])):
        assert (a is None and b is None) or np.array_equal(a, b)
    assert cuda_bool.intersect_many.launches > k3
    assert cuda_decode.decode_postings.launches > k1


def _byte_terms_tables(seed):
    """Tables whose terms hold bytes 0x80 and 0xFF, a posting 0xFFFFFFFF
    and the empty term, with lists past two ladder levels at L=128."""
    rng = np.random.default_rng(seed)
    terms = sorted({b"", b"\x80", b"\x80\x80a", b"\x80\xff", b"\xff",
                    b"\xff\xff\xff", b"a\xff", b"z\x80"}
                   | {f"p{i:03d}".encode() for i in range(150)})
    lists = [np.unique(rng.integers(0, 2**32, size=int(rng.choice(
        [1, 50, 300, 2000])), dtype=np.uint64).astype(np.uint32))
        for _ in terms]
    lists[1] = np.append(lists[1][lists[1] < 2**32 - 1], 2**32 - 1
                         ).astype(np.uint32)
    offs = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum([len(x) for x in terms], out=offs[1:])
    voffs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    return build_host_tables(b"".join(terms), offs, np.concatenate(lists),
                             voffs)


def test_engine_cuda_range_and_prefix_match_host(cuda):
    """read_range and prefix_search on the device route (no tables: the
    ranges by binary search of the device keys, the postings through K1)
    equal the host route's reads of the retained tables."""
    t = _byte_terms_tables(21)
    gpu = QueryEngine(upload_tables(t, device=cuda), L=128, device=cuda)
    host = QueryEngine(upload_tables(t, device="cpu"), L=128, tables=t,
                       device="cpu")
    gpu._RANGE_CHUNK = 64  # several chunks
    k1 = cuda_decode.decode_postings.launches
    for mn, mx in [(None, None), (b"p010", b"p120"), (b"\x80", b"\xff"),
                   (b"\xff", None), (b"q", b"r")]:
        a, b = list(gpu.read_range(mn, mx)), list(host.read_range(mn, mx))
        assert [x[0] for x in a] == [x[0] for x in b]
        assert all(np.array_equal(x[1], y[1]) for x, y in zip(a, b))
    prefixes = [b"", b"p", b"p01", b"\x80", b"\x80\xff", b"\xff", b"\xff\xff",
                b"a", b"z", b"\x7f", b"p149", b"q", b"\xff\xff\xff\xff"]
    a, b = gpu.prefix_search(prefixes), host.prefix_search(prefixes)
    assert set(a) == set(b) and b"\xff" in a
    assert all(np.array_equal(a[p], b[p]) for p in a)
    assert cuda_decode.decode_postings.launches > k1


def test_engine_cuda_hybrid_stream_matches_device(cuda, monkeypatch):
    """The hybrid AND stream (TPI_HYBRID=1, the link pinned below the AND
    threshold): K2 serves batches from the head, the host from the tail,
    and the result equals the device-only stream, with and without the
    tombstone filter."""
    lists, t = _corpus(31, n_terms=200)
    terms = [f"t{i:05d}".encode() for i in range(len(lists))]
    removed = np.unique(np.concatenate([v[::5] for v in lists[:40]]))
    t.removed = removed.astype(np.uint32)
    eng = QueryEngine(upload_tables(t, device=cuda), L=256, tables=t,
                      device=cuda)
    rng = np.random.default_rng(32)
    batches = [[[terms[i] for i in rng.choice(len(terms), size=int(k),
                                              replace=False)]
                for k in rng.integers(2, 6, size=64)] for _ in range(12)]
    for fr in (False, True):
        want = eng.boolean_staged(batches, "and", fr, columnar=True)
        monkeypatch.delenv("TPI_HOST_BOOL")
        monkeypatch.setenv("TPI_HYBRID", "1")
        monkeypatch.setattr(port_qe, "_LINK_MBPS", None)
        monkeypatch.setenv("TPI_LINK_MBPS",
                           str(QueryEngine._HOST_ROUTE_LINK_MBPS / 2))
        assert eng._hybrid_staged("and")
        k2 = cuda_fused.fused_and.launches
        got = eng.boolean_staged(batches, "and", fr, columnar=True)
        stats = eng.last_stream_stats
        monkeypatch.setenv("TPI_HOST_BOOL", "0")
        assert stats["host_batches"] > 0 and stats["device_batches"] > 0
        assert cuda_fused.fused_and.launches > k2
        assert stats["queries"] == 64 * len(batches)
        for (gv, go), (wv, wo) in zip(got, want):
            assert np.array_equal(go, wo) and np.array_equal(gv, wv)


def test_warm_checkpoint_swaps_in_a_side_stream_upload(cuda, tmp_path,
                                                       monkeypatch):
    """from_checkpoint on the card serves from the host tables while the
    arena uploads on a side stream (held here by a gate), then publishes
    the uploaded snapshot: lookups and AND equal before and after the swap
    and the device engine's, and after it K1 and K2 serve them."""
    lists, t = _corpus(41, n_terms=150)
    terms = [f"t{i:05d}".encode() for i in range(len(lists))]
    path = str(tmp_path / "c.ckpt")
    save_tables(t, path)
    gate = threading.Event()
    orig = port_qe.upload_on_side_stream
    streams = []

    def gated(tables, device, serve_stream):
        gate.wait(timeout=60)
        streams.append(serve_stream)
        return orig(tables, device, serve_stream)

    monkeypatch.setattr(port_qe, "upload_on_side_stream", gated)
    ref = QueryEngine(upload_tables(t, device=cuda), L=256, device=cuda)
    warm = QueryEngine.from_checkpoint(path, L=256, device=cuda)
    assert not warm.device_ready() and warm.snap.n_terms == 0
    queries = [[terms[i], terms[j]] for i, j in zip(range(0, 60, 2),
                                                     range(1, 61, 2))]
    want_lk = ref.lookup(terms + [b"missing"])
    want_and = ref.boolean(queries, "and")

    def same(eng):
        for a, b in zip(eng.lookup(terms + [b"missing"]), want_lk):
            assert (a is None and b is None) or np.array_equal(a, b)
        for a, b in zip(eng.boolean(queries, "and"), want_and):
            assert np.array_equal(a, b)

    k1 = cuda_decode.decode_postings.launches
    same(warm)
    assert not warm.device_ready()
    assert cuda_decode.decode_postings.launches == k1  # all on the host
    gate.set()
    warm.device_wait()
    assert warm.device_ready() and warm.snap.n_terms == len(terms)
    assert warm.snap.blocks.device.type == "cuda"
    assert streams == [torch.cuda.current_stream(cuda)]
    assert warm.upload_seconds is not None
    k2 = cuda_fused.fused_and.launches
    same(warm)
    assert cuda_decode.decode_postings.launches > k1
    assert cuda_fused.fused_and.launches > k2



# -- the mesh (parallel/) and the device merge (ops/merge.py) ---------------


def _mesh_index(path, seed=3):
    """A port index whose terms spread over many shards (so partitions
    split them), with edge postings, a list past L=128 and tombstones."""
    rng = np.random.default_rng(seed)
    ii = InvertedIndex(str(path))
    vocab = [bytes([a, b]) + f"t{i}".encode() for i, (a, b) in enumerate(
        (int(x), int(y)) for x, y in rng.integers(32, 127, size=(80, 2)))]
    edge = [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]
    for doc in list(range(1, 70)) + edge:
        k = int(rng.integers(1, 6))
        ii.put([vocab[i] for i in rng.choice(len(vocab), size=k,
                                             replace=False)], doc)
    for v in range(100, 400):
        ii.put([vocab[0], vocab[1]], v)
    ii.put_removed(np.array([3, 7, 0x80000000], dtype=np.uint32))
    return ii, vocab


def _mesh_same(a, b, vocab, ctx):
    """Two mesh engines answer every entry point alike."""
    rng = np.random.default_rng(9)
    terms = vocab + [b"@@missing", b"zz"]
    queries = [[vocab[i] for i in rng.choice(len(vocab), size=int(k),
                                             replace=False)]
               for k in rng.integers(1, 5, size=60)]
    queries += [[vocab[0], vocab[1]], [vocab[2], b"@@missing"]]
    for fr in (False, True):
        for x, y in zip(a.lookup(terms, fr), b.lookup(terms, fr)):
            assert (x is None and y is None) or np.array_equal(x, y), ctx
        for op in ("and", "or"):
            for x, y in zip(a.boolean(queries, op, fr),
                            b.boolean(queries, op, fr)):
                assert np.array_equal(x, y), (ctx, op, fr)
            for kw in ({"columnar": True}, {"columnar": True,
                                            "prefix_p": 8}):
                for x, y in zip(a.boolean_staged([queries[:30], queries[30:]],
                                                 op, fr, **kw),
                                b.boolean_staged([queries[:30], queries[30:]],
                                                 op, fr, **kw)):
                    assert all(np.array_equal(u, w) for u, w in zip(x, y))
    for x, y in zip(a.lookup_staged([terms], columnar=True),
                    b.lookup_staged([terms], columnar=True)):
        assert all(np.array_equal(u, w) for u, w in zip(x, y))
    pre = [v[:1] for v in vocab[:20]] + [b"@@"]
    pa, pb = a.prefix_search(pre), b.prefix_search(pre)
    assert list(pa) == list(pb)
    assert all(np.array_equal(pa[p], pb[p]) for p in pa)
    assert ([(t, v.tolist()) for t, v in a.read_range(None, None)]
            == [(t, v.tolist()) for t, v in b.read_range(None, None)])


def test_mesh_two_partitions_on_one_card_match_cpu(cuda, tmp_path):
    """Two partitions on one card against the same two on the CPU. Most
    queries miss on one partition, whose K1 row stays unwritten: the owner
    select before the sum keeps that out of the answer."""
    from inverted_index_2_tpu_torch import MeshQueryEngine
    from inverted_index_2_tpu_torch.codec.keys import pack_terms
    from inverted_index_2_tpu_torch.parallel import mesh as pm

    ii, vocab = _mesh_index(tmp_path)
    gpu = MeshQueryEngine(ii, mesh=[cuda, cuda], L=128)
    cpu = MeshQueryEngine(ii, mesh=["cpu", "cpu"], L=128)
    assert min(gpu.stats()["partition"]["n_terms_per_device"]) > 0
    qk = pack_terms(vocab + [b"@@missing"], width=gpu.snap.width)
    for make in (pm.make_sharded_lookup, pm.make_sharded_lookup_scatter):
        g = make(gpu.snap, 128)(qk)
        c = make(cpu.snap, 128)(qk)
        for x, y in zip((g[0], g[2], g[3]), (c[0], c[2], c[3])):
            assert torch.equal(x.cpu(), y)
        assert _valid_equal(g[1], c[1], c[2], 128)
    counts = {k: k.launches for k in (cuda_decode.decode_postings,
                                      cuda_bool.intersect_many,
                                      cuda_sort.sort_rows)}
    _mesh_same(gpu, cpu, vocab, "main")
    torch.cuda.synchronize()
    for k, n in counts.items():
        assert k.launches > n, k.__name__
    # a delta window: the dual step on partition 0, empty partition 1
    ii.put([vocab[0], b"new-term"], 5000)
    ii.put([vocab[3]], 0xFFFFFFFF)
    assert gpu.refresh(ii) and cpu.refresh(ii)
    assert gpu.delta is not None and cpu.delta is not None
    _mesh_same(gpu, cpu, vocab + [b"new-term"], "delta")


def test_device_merge_cuda_matches_host(cuda, tmp_path):
    from inverted_index_2_tpu_torch import Shard
    from inverted_index_2_tpu_torch.ops.merge import merge_views_device
    from inverted_index_2_tpu_torch.shard import merge_views

    sh = Shard(str(tmp_path / "s"))
    rng = np.random.default_rng(4)
    vocab = [f"t{i:03d}".encode() for i in range(200)] + [b"", b"\xff\xff"]
    vals = list(range(1, 400)) + [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                                  0xFFFFFFFF]
    for doc in vals:
        sh.put([vocab[i] for i in rng.choice(len(vocab), size=8,
                                             replace=False)], doc)
    views = [s.view for s in sh.segments.snapshot()]
    for removed in (None, np.zeros(0, np.uint32),
                    np.array([5, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)):
        got = merge_views_device(views, removed, device=cuda)
        want = merge_views(views, removed)
        assert got[0] == want[0]
        for x, y in zip(got[1:], want[1:]):
            assert np.array_equal(x, y)


def test_mesh_two_cards_match_one(tmp_path):
    """Partitions on two cards (peer copies between them) against the same
    partitions on one."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the partitions of this case sit "
                    "on different cards")
    from inverted_index_2_tpu_torch import MeshQueryEngine

    ii, vocab = _mesh_index(tmp_path)
    two = MeshQueryEngine(ii, mesh=["cuda:0", "cuda:1", "cuda:0", "cuda:1"],
                          L=128)
    one = MeshQueryEngine(ii, mesh=["cuda:0"] * 4, L=128)
    _mesh_same(two, one, vocab, "two cards")
