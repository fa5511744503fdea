"""Port vs JAX: term hashing, dictionary resolve, and the posting decode
(the plain version of kernel K1) on the CPU. Integer data: exact equality,
compared on valid prefixes only (lanes past a count are undefined)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from inverted_index_2_tpu.codec import hashing, keys as keys_mod
from inverted_index_2_tpu.models.snapshot import upload_tables as jax_upload
from inverted_index_2_tpu.models import steps as jax_steps
from inverted_index_2_tpu.ops.pallas_decode import decode_postings_pallas

from inverted_index_2_tpu_torch.codec.hashing import hash_rows_torch
from inverted_index_2_tpu_torch.models.convert import snapshot_from_jax_arrays
from inverted_index_2_tpu_torch.models.snapshot import build_host_tables
from inverted_index_2_tpu_torch.ops import dict_search
from inverted_index_2_tpu_torch.ops.cuda_decode import decode_postings
from inverted_index_2_tpu_torch.ops.decode import gather_postings_arena
from inverted_index_2_tpu_torch.utils.u32 import to_device, to_numpy_u32

torch.set_num_threads(1)


def _tables(lists):
    voffs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    blob = b"".join(f"t{i:05d}".encode() for i in range(len(lists)))
    offs = np.arange(len(lists) + 1, dtype=np.int64) * 6
    return build_host_tables(blob, offs, np.concatenate(lists), voffs)


def _width_lists(rng):
    """Lists covering block widths {0, 8, 16, 32}, lengths 1/127/128/129,
    a width-0 final block, and values up to 0xFFFFFFFF."""
    lists = []
    for scale in (1, 120, 60_000, 2**24):  # gap scales -> b = 0/8/16/32
        for n in (1, 127, 128, 129, 300):
            g = (rng.integers(1, 2 * scale + 1, size=n, dtype=np.int64)
                 if scale > 1 else np.ones(n, dtype=np.int64))
            lists.append(np.unique((np.cumsum(g) % 2**32).astype(np.uint32)))
    # wide first block, then a final block of consecutive values (b = 0)
    head = np.cumsum(rng.integers(1, 2**20, size=128, dtype=np.int64))
    lists.append(np.concatenate([head, head[-1] + 1 + np.arange(5)])
                 .astype(np.uint32))
    # values at the top of the u32 range, the last one 0xFFFFFFFF
    lists.append(np.array([0, 2**31, 2**32 - 3, 2**32 - 1], dtype=np.uint32))
    lists.append((2**32 - 1 - np.arange(200)[::-1] * 7).astype(np.uint32))
    return lists


def test_hash_rows_torch_matches_numpy(rng):
    keys = rng.integers(0, 2**32, size=(257, 5), dtype=np.uint32)
    keys[0] = 0
    keys[1] = 0xFFFFFFFF
    got = to_numpy_u32(hash_rows_torch(to_device(keys, "cpu")))
    assert np.array_equal(got, hashing.hash_rows_np(keys))


def test_resolve_hits_and_misses(rng):
    terms = sorted({bytes(rng.integers(97, 123, size=int(n), dtype=np.uint8))
                    for n in rng.integers(1, 14, size=300)})
    keys = keys_mod.pack_terms(terms)
    slots, max_probes = hashing.build_table_with_probes(keys)
    missing = [b"zz-missing", b"", b"a" * 13]
    q = keys_mod.pack_terms(terms[::7] + missing, width=keys.shape[1] - 1)
    want = hashing.probe_rows_np(slots, max_probes, keys, q)
    kt, qt = to_device(keys, "cpu"), to_device(q, "cpu")
    idx, found = dict_search.hash_lookup_rows(
        kt, to_device(np.asarray(slots, np.int32), "cpu"), qt, max_probes)
    bidx, bfound = dict_search.lookup_rows(kt, qt)
    for got_idx, got_found in ((idx, found), (bidx, bfound)):
        assert np.array_equal(got_found.numpy(), want >= 0)
        assert np.array_equal(got_idx.numpy()[want >= 0], want[want >= 0])
    assert not found.numpy()[-len(missing):].any()


@pytest.mark.parametrize("L", [128, 384])
def test_plain_decode_matches_jax(rng, L):
    lists = _width_lists(rng)
    t = _tables(lists)
    jsnap = jax_upload(t, stride_align=128)  # the Pallas kernel's arena
    snap = snapshot_from_jax_arrays(jsnap, device="cpu")
    Q = 8 * -(-len(lists) // 8)
    term_idx = np.resize(np.arange(len(lists), dtype=np.int32), Q)
    pv, pc = decode_postings_pallas(
        jsnap.blocks, jsnap.term_block_start, jsnap.counts,
        jnp.asarray(term_idx), L, interpret=True)
    jv, jc = jax_steps._JIT_DECODE(
        jsnap.blocks, jsnap.term_block_start, jsnap.counts,
        jnp.asarray(term_idx), L)
    tv, tc = decode_postings(snap.blocks, snap.term_block_start, snap.counts,
                             torch.from_numpy(term_idx), L)
    tv, tc = to_numpy_u32(tv), tc.numpy()
    assert np.array_equal(tc, np.asarray(jc))
    assert np.array_equal(tc, np.asarray(pc))
    for q, ti in enumerate(term_idx):
        c = min(int(tc[q]), L)
        assert np.array_equal(tv[q, :c], np.asarray(jv)[q, :c]), q
        assert np.array_equal(tv[q, :c], np.asarray(pv)[q, :c]), q
        assert np.array_equal(tv[q, :c], lists[ti][:c]), q


@pytest.mark.parametrize("L", [128, 384])
def test_plain_decode_with_found_matches_jax(rng, L):
    """found= on the plain decode and on the wrapper's CPU path against the
    JAX gather_postings_arena masked the same way: a row with found = False
    reports a raw count of 0 and has no valid lane. Tolerance 0."""
    lists = _width_lists(rng)
    t = _tables(lists)
    jsnap = jax_upload(t, stride_align=128)
    snap = snapshot_from_jax_arrays(jsnap, device="cpu")
    Q = 64
    found = rng.random(Q) < 0.5
    # a miss resolves to index 0, as hash_lookup_rows leaves it
    term_idx = np.where(found, rng.integers(0, len(lists), size=Q),
                        0).astype(np.int32)
    jv, jc = jax_steps._JIT_DECODE(
        jsnap.blocks, jsnap.term_block_start, jsnap.counts,
        jnp.asarray(term_idx), L)
    jc = np.where(found, np.asarray(jc), 0)
    args = (snap.blocks, snap.term_block_start, snap.counts,
            torch.from_numpy(term_idx), L, torch.from_numpy(found))
    for fn in (gather_postings_arena, decode_postings):
        tv, tc = fn(*args)
        tv, tc = to_numpy_u32(tv), tc.numpy()
        assert tc.dtype == np.int32 and np.array_equal(tc, jc)
        assert (tc[~found] == 0).all() and (tc[found] > 0).all()
        for q in range(Q):
            c = min(int(tc[q]), L)
            assert np.array_equal(tv[q, :c], np.asarray(jv)[q, :c]), q
