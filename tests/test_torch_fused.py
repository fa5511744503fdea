"""Port vs JAX: the plain version of kernel K2 (fused decode + AND) and
reorder_smallest_base against fused_and_pallas in interpret mode, on the
CPU. Exact: the masked (Q, L) rows and the keep counts are bit-identical."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from inverted_index_2_tpu.models.snapshot import upload_tables as jax_upload
from inverted_index_2_tpu.ops.pallas_fused import (
    fused_and_pallas,
    reorder_smallest_base as jax_reorder,
)

from inverted_index_2_tpu_torch.models.convert import snapshot_from_jax_arrays
from inverted_index_2_tpu_torch.models.snapshot import build_host_tables
from inverted_index_2_tpu_torch.ops.cuda_fused import fused_and, reorder_smallest_base
from inverted_index_2_tpu_torch.utils.u32 import to_numpy_u32

torch.set_num_threads(1)

FF = np.uint32(0xFFFFFFFF)


def _tables(lists):
    voffs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    blob = b"".join(f"t{i:05d}".encode() for i in range(len(lists)))
    offs = np.arange(len(lists) + 1, dtype=np.int64) * 6
    return build_host_tables(blob, offs, np.concatenate(lists), voffs)


def _clustered_lists(rng):
    """Range-clustered lists (probe walks skip blocks and exit early),
    lists longer than L and a pair sharing a genuine 0xFFFFFFFF member."""
    lists = []
    for s, c in [(40, 100), (2600, 5_000_000), (1300, 9_000),
                 (3100, 2_000_000_000), (700, 60_000), (2049, 1_000_000),
                 (90, 1_500_000_000), (1025, 300_000), (300, 0)]:
        w = max(4 * s, 16)
        lists.append(np.unique(rng.integers(c, c + w, size=s, dtype=np.uint32)))
    common = np.sort(rng.choice(5_000, size=150, replace=False)).astype(np.uint32)
    lists.append(np.concatenate([common, [FF]]).astype(np.uint32))
    lists.append(np.concatenate([common[::2], [FF]]).astype(np.uint32))
    return lists


@pytest.mark.parametrize("L", [256, 512])
def test_plain_fused_and_matches_pallas(rng, L):
    lists = _clustered_lists(rng)
    jsnap = jax_upload(_tables(lists), stride_align=128)
    snap = snapshot_from_jax_arrays(jsnap, device="cpu")
    Q, K = 16, 4
    idx = rng.integers(0, len(lists), size=(Q, K)).astype(np.int32)
    kv = rng.integers(1, K + 1, size=Q).astype(np.int32)
    idx[0, :3], kv[0] = [len(lists) - 2, len(lists) - 1, len(lists) - 2], 3
    idx[1, :2], kv[1] = [0, 3], 2  # lists in disjoint value ranges
    tbs, hc = np.asarray(jsnap.term_block_start), jsnap.host_counts
    kmask = np.arange(K)[None, :] < kv[:, None]
    rows = np.where(kmask, tbs[idx], 0).astype(np.int32)
    cnts = np.where(kmask, hc[idx], 0).astype(np.int32)
    cnts[2, 1] = rows[2, 1] = 0  # a missing term in a probe slot
    kv[2] = max(kv[2], 2)

    jr, jc, jneed = jax.jit(jax_reorder)(
        jnp.asarray(rows), jnp.asarray(cnts), jnp.asarray(kv))
    r2, c2, need = reorder_smallest_base(
        torch.from_numpy(rows), torch.from_numpy(cnts), torch.from_numpy(kv))
    assert np.array_equal(r2.numpy(), np.asarray(jr))
    assert np.array_equal(c2.numpy(), np.asarray(jc))
    assert np.array_equal(need.numpy(), np.asarray(jneed))

    if L == 512:
        # the kernel contract holds for any slot order: here slot 0 is not
        # the smallest list and query 2's empty list is a probe
        r2, c2 = torch.from_numpy(rows), torch.from_numpy(cnts)
        jr, jc = jnp.asarray(rows), jnp.asarray(cnts)
    jout, joc = fused_and_pallas(jsnap.blocks, jr, jc, jnp.asarray(kv), L,
                                 compact=False, interpret=True)
    out, oc = fused_and(snap.blocks, r2, c2, torch.from_numpy(kv), L,
                        compact=False)
    assert np.array_equal(oc.numpy(), np.asarray(joc))
    assert np.array_equal(to_numpy_u32(out), np.asarray(jout))
    assert oc[0] == 76 and to_numpy_u32(out)[0].tolist().count(FF) == L - 75
    assert oc[2] == 0 and oc[1] == 0

    sout, soc = fused_and(snap.blocks, r2, c2, torch.from_numpy(kv), L)
    assert np.array_equal(to_numpy_u32(sout),
                          np.sort(np.asarray(jout), axis=1))
    assert np.array_equal(soc.numpy(), oc.numpy())
