"""Kernel K4's plain versions against the JAX package on the CPU:
sort_rows_torch against sort_rows_pallas in Pallas interpret mode, the tile
network's 0xFFFFFFFF padding to 128 * 2^k, sort_rows with a run hint against
jnp.sort and sort_rows_pallas, compact_rows against the JAX compact_rows,
the CPU path's precondition checks, and the plan of kernel entries that
sort_rows makes from (width, hint), emulated in numpy. Bit-exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from inverted_index_2_tpu.ops import compaction as jax_compaction
from inverted_index_2_tpu.ops.pallas_sort import sort_rows_pallas

from inverted_index_2_tpu_torch.ops import compaction, cuda_sort
from inverted_index_2_tpu_torch.utils.u32 import to_device, to_numpy_u32

torch.set_num_threads(1)

FF = 0xFFFFFFFF
SIGN = 0x80000000


def _rows(seed, Q, M):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, size=(Q, M), dtype=np.uint64).astype(np.uint32)
    x[0] = FF                               # a row of the fill value
    x[1, ::2] = SIGN                        # the sign bit, as int32 the minimum
    x[2, ::3] = FF                          # genuine 0xFFFFFFFF members
    x[2, 1::3] = SIGN
    x[3] = rng.integers(0, 3, size=M)       # long runs of equal values
    x[4, :2] = [SIGN - 1, SIGN][:M]         # both sides of the sign flip
    return x


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_sort_rows_plain_matches_pallas(S):
    x = _rows(S, 8, 128 * S)
    want = np.asarray(sort_rows_pallas(jnp.asarray(x), interpret=True))
    got = to_numpy_u32(cuda_sort.sort_rows_torch(to_device(x, "cpu")))
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.sort(x, axis=1))
    # on a CPU tensor the wrapper is the plain version
    assert np.array_equal(to_numpy_u32(cuda_sort.sort_rows(
        to_device(x, "cpu"))), want)


@pytest.mark.parametrize("m", [1, 100, 160, 300])
def test_padding_to_the_kernel_width_is_exact(m):
    """The kernel sorts rows padded with 0xFFFFFFFF to padded_width(m) and
    returns the first m columns: the same as sorting the row itself."""
    M = cuda_sort.padded_width(m)
    assert M >= m and M % 128 == 0 and (M // 128) & (M // 128 - 1) == 0
    x = _rows(m, 8, m)
    pad = np.full((8, M), FF, dtype=np.uint32)
    pad[:, :m] = x
    via_pallas = np.asarray(sort_rows_pallas(jnp.asarray(pad),
                                             interpret=True))[:, :m]
    got = to_numpy_u32(cuda_sort.sort_rows(to_device(x, "cpu")))
    assert np.array_equal(got, via_pallas)


def test_padded_width():
    assert [cuda_sort.padded_width(m) for m in (1, 128, 129, 160, 5000)] == [
        128, 128, 256, 256, 8192]


def test_compact_rows_matches_jax():
    rng = np.random.default_rng(3)
    vals = np.sort(rng.integers(0, 2**32, size=(16, 384), dtype=np.uint64)
                   .astype(np.uint32), axis=1)
    vals[0, -1] = FF
    keep = rng.random((16, 384)) < 0.4
    keep[0, -1] = True                      # a kept genuine 0xFFFFFFFF
    want = np.asarray(jax_compaction.compact_rows(jnp.asarray(vals),
                                                  jnp.asarray(keep)))
    got = to_numpy_u32(compaction.compact_rows(to_device(vals, "cpu"),
                                               torch.from_numpy(keep)))
    assert np.array_equal(got, want)


def _runs(seed, Q, m, r):
    """Rows whose every r consecutive lanes ascend, each run with a tail of
    0xFFFFFFFF of random length."""
    rng = np.random.default_rng(seed)
    n = -(-m // r)
    x = np.sort(rng.integers(0, 2**32, size=(Q, n, r), dtype=np.uint64)
                .astype(np.uint32), axis=2)
    tail = rng.integers(0, r + 1, size=(Q, n, 1))
    x[np.arange(r)[None, None, :] >= r - tail] = FF
    x[0, 0, -1] = FF                        # a genuine last member
    return np.ascontiguousarray(x.reshape(Q, n * r)[:, :m])


@pytest.mark.parametrize("m,r", [(256, 128), (1024, 128), (512, 256),
                                 (384, 192),   # two runs, no power of two
                                 (300, 200),   # two runs, the second short
                                 (640, 128), (128, 128)])
def test_sort_rows_with_run_hint_matches_jax(m, r):
    x = _runs(m + r, 8, m, r)
    want = np.asarray(jnp.sort(jnp.asarray(x), axis=1))
    got = to_numpy_u32(cuda_sort.sort_rows(to_device(x, "cpu"), run=r))
    assert np.array_equal(got, want)
    if m % 128 == 0 and (m // 128) & (m // 128 - 1) == 0:
        assert np.array_equal(got, np.asarray(
            sort_rows_pallas(jnp.asarray(x), interpret=True)))


def test_sort_rows_raises_on_a_broken_hint():
    x = _runs(1, 4, 512, 128)
    cuda_sort.sort_rows(to_device(x, "cpu"), run=128)
    x[2, 128:256] = 10 + 2 * np.arange(128)
    x[2, 131] = 3                           # descends inside run 1
    with pytest.raises(ValueError, match="row 2 descends at lane 131"):
        cuda_sort.sort_rows(to_device(x, "cpu"), run=128)
    # the same row is fine with no hint, and sorts as ever
    got = to_numpy_u32(cuda_sort.sort_rows(to_device(x, "cpu")))
    assert np.array_equal(got, np.sort(x, axis=1))
    # u32 order: 0x80000000 after 0x7FFFFFFF ascends
    y = np.array([[SIGN - 1, SIGN, FF, 0]], dtype=np.uint32)
    cuda_sort.sort_rows(to_device(y, "cpu"), run=3)
    with pytest.raises(ValueError):
        cuda_sort.sort_rows(to_device(y, "cpu"), run=4)


def test_compact_rows_raises_on_descending_kept_lanes():
    vals = np.array([[5, 7, 6, 9], [SIGN, 1, 2, FF]], dtype=np.uint32)
    keep = np.array([[1, 1, 0, 1], [0, 1, 1, 1]], dtype=bool)
    got = to_numpy_u32(compaction.compact_rows(to_device(vals, "cpu"),
                                               torch.from_numpy(keep)))
    assert np.array_equal(got, [[5, 7, 9, FF], [1, 2, FF, FF]])
    keep[0, 2] = True                       # 6 kept after 7
    with pytest.raises(ValueError, match="row 0 keeps lane 2"):
        compaction.compact_rows(to_device(vals, "cpu"),
                                torch.from_numpy(keep))
    keep[0, 2] = False
    keep[1, 0] = True                       # 0x80000000 kept before 1
    with pytest.raises(ValueError, match="row 1"):
        compaction.compact_rows(to_device(vals, "cpu"),
                                torch.from_numpy(keep))


def test_compact_rows_on_column_slices_matches_jax():
    """The pagination call compacts the first W columns of a wider sorted
    matrix."""
    rng = np.random.default_rng(4)
    vals = np.sort(rng.integers(0, 2**32, size=(8, 640), dtype=np.uint64)
                   .astype(np.uint32), axis=1)
    keep = rng.random((8, 640)) < 0.5
    want = np.asarray(jax_compaction.compact_rows(
        jnp.asarray(vals[:, :160]), jnp.asarray(keep[:, :160])))
    got = to_numpy_u32(compaction.compact_rows(
        to_device(vals, "cpu")[:, :160], torch.from_numpy(keep)[:, :160]))
    assert np.array_equal(got, want)


def _emulate(x, steps):
    """The kernel entries' contracts in numpy: each step asserts what the
    entry requires of its input and gives what it promises."""
    m = x.shape[1]
    for step in steps:
        if step[0] == "tiles":
            _, tile, g = step
            assert tile & (tile - 1) == 0 and 128 <= tile <= cuda_sort.TILE
            assert g == 1 or (g & (g - 1) == 0 and 16 <= g < tile)
            for c0 in range(0, m, g):
                assert (np.diff(x[:, c0:c0 + g].astype(np.int64)) >= 0).all()
            x = np.concatenate([np.sort(x[:, c0:c0 + tile], axis=1)
                                for c0 in range(0, m, tile)], axis=1)
        else:
            w = step[1]
            for c0 in range(0, m, w):
                assert (np.diff(x[:, c0:c0 + w].astype(np.int64)) >= 0).all()
            x = np.concatenate([np.sort(x[:, c0:c0 + 2 * w], axis=1)
                                for c0 in range(0, m, 2 * w)], axis=1)
    return x


@pytest.mark.parametrize("m,r", [
    (4096, 2048), (27136, 13568), (700, 400), (32768, 4096), (8192, 128),
    (65536, 128), (40000, 128), (160, 128), (100000, 20000), (3000, 1536),
    (3000, 24), (500, 500), (8192, 1), (40000, 1), (100, 1), (50000, 16384),
    (8192, 2048), (9000, 1024)])
def test_sort_plan_sorts_every_row(m, r):
    steps = cuda_sort.sort_plan(m, r)
    x = _runs(m + r, 2, m, r)
    assert np.array_equal(_emulate(x, steps), np.sort(x, axis=1))
    merges = [s for s in steps if s[0] == "merge"]
    if r >= m:
        assert steps == []
    elif m <= 2 * r:
        assert steps == [("merge", r)]      # the pair union: one level
    else:
        assert len(steps) - len(merges) <= 1
        assert len(merges) == max(0, int(np.ceil(np.log2(
            m / (r if r >= cuda_sort.MERGE_FROM else
                 min(cuda_sort.padded_width(m), cuda_sort.TILE))))))
