"""Kernel K4's plain version and the compaction sort against the JAX
package on the CPU: sort_rows_torch against sort_rows_pallas in Pallas
interpret mode, the wrapper's 0xFFFFFFFF padding to 128 * 2^k, and
compact_rows. Bit-exact."""
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
