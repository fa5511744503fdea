"""Port vs JAX on the CPU: the concat AND (the class for bases above K2's
level cap), the tombstone filter, and the small-P compaction of the fused
output. Exact; compared on valid prefixes."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from inverted_index_2_tpu.models import steps as jax_steps
from inverted_index_2_tpu.models.snapshot import upload_tables as jax_upload

from inverted_index_2_tpu_torch.models.snapshot import build_host_tables, upload_tables
from inverted_index_2_tpu_torch.ops import concat_bool, cuda_fused, setops
from inverted_index_2_tpu_torch.utils.u32 import to_device, to_numpy_u32

torch.set_num_threads(1)

FF = 0xFFFFFFFF


def _valid_rows(v, c):
    return [v[q, : c[q]].tolist() for q in range(len(c))]


def test_filter_removed_matches_jax(rng):
    Q, L = 12, 256
    vals = np.sort(rng.integers(0, 3_000, size=(Q, L), dtype=np.uint32), axis=1)
    vals[0, -1] = FF
    counts = rng.integers(0, L + 1, size=Q).astype(np.int32)
    counts[0] = L
    for removed in (np.zeros(0, np.uint32),
                    np.unique(np.concatenate([vals[:, ::5].ravel(), [FF]]))
                    .astype(np.uint32)):
        jv, jc = jax_steps._JIT_FILTER(
            jnp.asarray(vals), jnp.asarray(counts), jnp.asarray(removed))
        tv, tc = setops.filter_removed(
            to_device(vals, "cpu"), torch.from_numpy(counts),
            to_device(removed, "cpu"))
        assert np.array_equal(tc.numpy(), np.asarray(jc))
        assert _valid_rows(to_numpy_u32(tv), tc.numpy()) == _valid_rows(
            np.asarray(jv), np.asarray(jc))


def test_compact_small_matches_jax(rng):
    Q, L, P = 16, 256, 8
    flat = np.full((Q, L), FF, dtype=np.uint32)
    for q in range(Q):
        n = int(rng.integers(0, 20))
        pos = np.sort(rng.choice(L, size=n, replace=False))
        flat[q, pos] = np.sort(rng.choice(10**9, size=n, replace=False))
    flat[1, 3] = FF  # a genuine member, same bits as the mask
    got = to_numpy_u32(cuda_fused.compact_small(to_device(flat, "cpu"), P))
    assert np.array_equal(got, np.asarray(
        jax_steps._compact_small(jnp.asarray(flat), P)))


@pytest.mark.parametrize("SB", [8, 32])
def test_concat_and_matches_jax(rng, SB):
    common = np.sort(rng.choice(50_000, size=40, replace=False))
    lists = [np.unique(np.concatenate(
        [common, rng.integers(0, 50_000, size=int(s))])).astype(np.uint32)
        for s in (30, 100, 200, 400, 700)]
    lists += [np.array([5, 9, FF], np.uint32), np.array([9, FF], np.uint32)]
    voffs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    blob = b"".join(f"t{i:05d}".encode() for i in range(len(lists)))
    offs = np.arange(len(lists) + 1, dtype=np.int64) * 6
    t = build_host_tables(blob, offs, np.concatenate(lists), voffs)
    snap = upload_tables(t, device="cpu")
    jsnap = jax_upload(t, stride_align=1)
    Q, K = 16, 3
    idx = rng.integers(0, 5, size=(Q, K)).astype(np.int32)
    kv = rng.integers(1, K + 1, size=Q).astype(np.int32)
    found = np.ones((Q, K), dtype=bool)
    idx[0], kv[0] = [5, 6, 5], 3    # genuine 0xFFFFFFFF in every list
    idx[1, :2], kv[1] = [0, 1], 2
    found[1, 1] = False             # an absent required term
    blocks_needed = (-(-t.counts[idx] // 128)
                     * (np.arange(K)[None, :] < kv[:, None])).sum(axis=1)
    keep = blocks_needed <= SB
    assert keep[:2].all()
    idx, kv, found = idx[keep], kv[keep], found[keep]
    jout, joc = jax_steps._JIT_CONCAT_BOOL(
        jsnap.blocks, jsnap.term_block_start, jsnap.counts, jnp.asarray(idx),
        jnp.asarray(found), jnp.asarray(kv), SB, "and")
    out, oc = concat_bool.boolean_concat_step(
        snap.blocks, snap.term_block_start, snap.counts,
        torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(found),
        torch.from_numpy(kv), SB, "and")
    assert np.array_equal(oc.numpy(), np.asarray(joc))
    assert _valid_rows(to_numpy_u32(out), oc.numpy()) == _valid_rows(
        np.asarray(jout), np.asarray(joc))
    assert oc[0] == 2 and oc[1] == 0
