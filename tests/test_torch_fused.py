"""Port vs JAX: the plain version of kernel K2 (fused decode + AND) and
reorder_smallest_base against fused_and_pallas in interpret mode, on the
CPU; the compact and width-P outputs of fused_and and boolean_fused_step
against the JAX step. Exact: rows and counts are bit-identical."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from inverted_index_2_tpu.models import steps as jax_steps
from inverted_index_2_tpu.models.snapshot import upload_tables as jax_upload
from inverted_index_2_tpu.ops.pallas_fused import (
    fused_and_pallas,
    reorder_smallest_base as jax_reorder,
)

from inverted_index_2_tpu_torch.codec import keys as keys_mod
from inverted_index_2_tpu_torch.models import steps
from inverted_index_2_tpu_torch.models.convert import snapshot_from_jax_arrays
from inverted_index_2_tpu_torch.models.snapshot import build_host_tables
from inverted_index_2_tpu_torch.ops.cuda_fused import fused_and, reorder_smallest_base
from inverted_index_2_tpu_torch.utils.u32 import to_device, to_numpy_u32

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


def _fused_queries(lists, tables, Q=24, K=4, seed=3):
    """Packed AND queries over `lists`: random terms, plus the pair that
    shares a genuine 0xFFFFFFFF member, a query whose smallest list is over
    L = 256, and one with a missing term."""
    rng = np.random.default_rng(seed)
    terms = [f"t{i:05d}".encode() for i in range(len(lists))]
    n = len(lists)
    qs = [[terms[i] for i in rng.choice(n, size=int(k), replace=False)]
          for k in rng.integers(1, K + 1, size=Q)]
    qs[0] = [terms[n - 2], terms[n - 1]]       # both end in 0xFFFFFFFF
    qs[1] = [terms[1], terms[5]]               # 2600 and 2049 values: base > L
    qs[2] = [terms[2], b"missing"]
    qs[3] = [terms[n - 1], terms[n - 2], terms[n - 1]]
    kv = np.array([len(q) for q in qs], dtype=np.int32)
    qk = np.zeros((Q, K, tables.width + 1), dtype=np.uint32)
    for i, q in enumerate(qs):
        qk[i, : len(q)] = keys_mod.pack_terms(q, width=tables.width)
    return qk, kv


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("small_p", [0, 8])
def test_fused_step_compact_outputs_match_jax(rng, small_p, filtered):
    """boolean_fused_step on the CPU (K2's plain version, then the plain
    compactions that the kernel's compact and width-P outputs replace on the
    card) against the JAX step through fused_and_pallas in interpret mode:
    whole rows, counts and need, exact."""
    lists = _clustered_lists(rng)
    tables = _tables(lists)
    jsnap = jax_upload(tables, stride_align=128)
    snap = snapshot_from_jax_arrays(jsnap, device="cpu")
    L = 256
    qk, kv = _fused_queries(lists, tables)
    removed = (np.sort(np.concatenate([lists[-1][::7], lists[4][::5]]))
               .astype(np.uint32) if filtered else None)
    want = jax_steps.boolean_fused_step(
        jsnap.keys, jsnap.blocks, jsnap.term_block_start, jsnap.counts,
        jnp.asarray(qk), jnp.asarray(kv), L,
        None if removed is None else jnp.asarray(removed), jsnap.hash_slots,
        jsnap.max_probes, interpret=True, small_p=small_p)
    got = steps.boolean_fused_step(
        snap.keys, snap.blocks, snap.term_block_start, snap.counts,
        to_device(qk, "cpu"), torch.from_numpy(kv), L,
        None if removed is None else to_device(removed, "cpu"),
        snap.hash_slots, snap.max_probes, small_p)
    assert len(got) == len(want) == (4 if small_p else 3)
    assert got[0].shape == (len(kv), small_p or L)
    assert np.array_equal(to_numpy_u32(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    oc, need = got[1].numpy(), got[2].numpy()
    assert need[1] > L and need[2] == 0 and oc[2] == 0
    row0 = to_numpy_u32(got[0])[0]
    if not filtered:  # the genuine 0xFFFFFFFF is the last counted member
        assert (got[3] if small_p else got[1])[0] == 76
        if small_p == 0:
            assert row0[75] == FF and row0[74] != FF
    assert int((oc > 0).sum()) >= 3


@pytest.mark.parametrize("width", [0, 1, 8, 256])
def test_fused_and_width_matches_jax_small_compaction(rng, width):
    """fused_and's compact (width 0) and width-P outputs on the CPU against
    the JAX kernel's masked rows compacted the JAX way: the row sort, or
    the P masked minima of _compact_small."""
    lists = _clustered_lists(rng)
    jsnap = jax_upload(_tables(lists), stride_align=128)
    snap = snapshot_from_jax_arrays(jsnap, device="cpu")
    L, Q, K = 256, 16, 4
    idx = rng.integers(0, len(lists), size=(Q, K)).astype(np.int32)
    kv = rng.integers(1, K + 1, size=Q).astype(np.int32)
    idx[0, :2], kv[0] = [len(lists) - 2, len(lists) - 1], 2
    tbs, hc = np.asarray(jsnap.term_block_start), jsnap.host_counts
    kmask = np.arange(K)[None, :] < kv[:, None]
    rows = np.where(kmask, tbs[idx], 0).astype(np.int32)
    cnts = np.where(kmask, hc[idx], 0).astype(np.int32)
    r2, c2, _ = reorder_smallest_base(
        torch.from_numpy(rows), torch.from_numpy(cnts), torch.from_numpy(kv))
    jout, joc = fused_and_pallas(
        jsnap.blocks, jnp.asarray(r2.numpy()), jnp.asarray(c2.numpy()),
        jnp.asarray(kv), L, compact=False, interpret=True)
    out, oc = fused_and(snap.blocks, r2, c2, torch.from_numpy(kv), L,
                        width=width)
    want = (jax_steps._compact_small(jout, width) if width
            else jnp.sort(jout, axis=1))
    assert np.array_equal(to_numpy_u32(out), np.asarray(want))
    assert np.array_equal(oc.numpy(), np.asarray(joc))
    assert oc[0] == 76  # the true count, whatever the width
    with pytest.raises(ValueError):
        fused_and(snap.blocks, r2, c2, torch.from_numpy(kv), L, width=L + 1)


def _k2_work_oracle(lists, idx, kv, L):
    """chip_smoke.k2_work by numpy on the lists themselves: block b of a
    list is v[128 b: 128 b + 128], its range [v[128 b], v[128 (b + 1)])."""
    n = dict.fromkeys(("base", "all", "span", "hit", "span_run", "hit_run"), 0)
    for q in range(len(kv)):
        base = lists[idx[q, 0]][:L].astype(np.int64)
        n["base"] += -(-len(base) // 128)
        probes = [lists[i].astype(np.int64) for i in idx[q, 1: kv[q]]]
        n["all"] += sum(-(-len(p) // 128) for p in probes)
        alive = base
        for p in sorted(probes, key=len):  # stable: ties keep the slot order
            a0 = p[::128]
            a1 = np.append(a0[1:], 1 << 40)
            for name, vals in (("", base), ("_run", alive)):
                if len(vals) == 0:
                    continue
                n["span" + name] += int(((a0 <= vals[-1])
                                         & (a1 > vals[0])).sum())
                n["hit" + name] += int((np.searchsorted(vals, a1)
                                        > np.searchsorted(vals, a0)).sum())
            alive = np.intersect1d(alive, p)
    return n


@pytest.mark.parametrize("L", [256, 2048])
@pytest.mark.parametrize("seed", [0, 1])
def test_k2_bound_counts_follow_the_running_and(seed, L):
    """The block counts under K2's bound in chip_smoke.py (k2_work) against
    a numpy count on the lists: probes shortest first, each held against the
    base values that the earlier probes left alive, so a probe after an
    empty running result counts nothing. Chunked and whole give the same."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    lists = _clustered_lists(rng)
    # overlapping lists, so that running results stay alive over several probes
    pool = np.unique(rng.integers(0, 40_000, size=6000, dtype=np.uint32))
    lists += [np.sort(rng.choice(pool, size=s, replace=False))
              for s in (150, 900, 2500, 4000, 3000, 1200)]
    jsnap = jax_upload(_tables(lists), stride_align=128)
    snap = snapshot_from_jax_arrays(jsnap, device="cpu")
    Q, K = 32, 5
    idx = rng.integers(0, len(lists), size=(Q, K))
    idx[: Q // 2] = rng.integers(len(lists) - 6, len(lists), size=(Q // 2, K))
    kv = rng.integers(1, K + 1, size=Q).astype(np.int32)
    kv[0], kv[1] = K, 0
    tbs, hc = np.asarray(jsnap.term_block_start), jsnap.host_counts
    rows = torch.from_numpy(tbs[idx].astype(np.int32))
    cnts = torch.from_numpy(hc[idx].astype(np.int32))
    want = _k2_work_oracle(lists, idx, kv, L)
    got = chip_smoke.k2_work(torch, snap, rows, cnts, torch.from_numpy(kv), L)
    assert got == want
    assert got == chip_smoke.k2_work(torch, snap, rows, cnts,
                                     torch.from_numpy(kv), L, budget=1)
    assert 0 < got["hit_run"] < got["hit"] < got["all"]
    assert got["span_run"] < got["span"]
