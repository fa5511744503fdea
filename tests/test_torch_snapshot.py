"""Port vs JAX: host tables, the uploaded snapshot (block arena, keys,
counts, hash slots) and the JAX-snapshot converter, on the CPU."""
import numpy as np
import pytest
import torch

from inverted_index_2_tpu import InvertedIndex
from inverted_index_2_tpu.models import snapshot as jax_snapshot

from inverted_index_2_tpu_torch.models import snapshot as port
from inverted_index_2_tpu_torch.models.convert import snapshot_from_jax_arrays
from inverted_index_2_tpu_torch.utils.u32 import to_numpy_u32

torch.set_num_threads(1)

_TABLE_FIELDS = ("keys", "words", "flat", "tbs", "counts", "removed", "slots",
                 "max_probes", "max_count", "width", "max_bw")


def _merged(rng, n_terms=40):
    lists = [np.unique(rng.integers(0, 2**32, size=int(s), dtype=np.uint32))
             for s in rng.integers(1, 700, size=n_terms)]
    lists[3] = np.arange(10, 300, dtype=np.uint32)  # width-0 blocks
    voffs = np.zeros(n_terms + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    terms = sorted({f"term-{i:03d}-{'x' * int(i % 9)}".encode()
                    for i in range(n_terms)})
    offs = np.zeros(n_terms + 1, dtype=np.int64)
    np.cumsum([len(t) for t in terms], out=offs[1:])
    removed = lists[5][::3]
    return b"".join(terms), offs, np.concatenate(lists), voffs, removed


def _assert_tables_equal(a, b):
    for f in _TABLE_FIELDS:
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f


def _assert_snapshot_matches(snap, jsnap, n_rows):
    assert np.array_equal(to_numpy_u32(snap.keys), np.asarray(jsnap.keys))
    jblocks = np.asarray(jsnap.blocks)
    assert np.array_equal(to_numpy_u32(snap.blocks), jblocks[:n_rows])
    assert not jblocks[n_rows:].any()  # JAX's trailing slack rows are zero
    for f in ("term_block_start", "counts", "hash_slots"):
        assert np.array_equal(getattr(snap, f).numpy(),
                              np.asarray(getattr(jsnap, f))), f
    assert np.array_equal(to_numpy_u32(snap.removed), np.asarray(jsnap.removed))
    for f in ("width", "max_probes", "max_count"):
        assert getattr(snap, f) == getattr(jsnap, f), f
    assert np.array_equal(snap.host_counts, jsnap.host_counts)


def test_upload_matches_jax(rng):
    merged = _merged(rng)
    t = port.build_host_tables(*merged)
    _assert_tables_equal(t, jax_snapshot.build_host_tables(*merged))
    snap = port.upload_tables(t, device="cpu")
    jsnap = jax_snapshot.upload_tables(t, stride_align=port.STRIDE_ALIGN)
    assert snap.blocks.shape[1] == port.arena_stride(t)
    assert snap.blocks.shape[1] % port.STRIDE_ALIGN == 0
    assert snap.blocks.shape[0] == len(t.flat) + port.SLACK_ROWS
    _assert_snapshot_matches(snap, jsnap, len(t.flat))


@pytest.mark.parametrize("stride_align", [1, 128])
def test_snapshot_from_jax_arrays(rng, stride_align):
    t = port.build_host_tables(*_merged(rng))
    jsnap = jax_snapshot.upload_tables(t, stride_align=stride_align)
    snap = snapshot_from_jax_arrays(jsnap, device="cpu")
    assert snap.blocks.shape == tuple(jsnap.blocks.shape)
    _assert_snapshot_matches(snap, jsnap, jsnap.blocks.shape[0])


@pytest.mark.parametrize("apply_removed", [False, True])
def test_snapshot_tables_match_jax(tmp_path, rng, apply_removed):
    ii = InvertedIndex(str(tmp_path))
    vocab = [f"w{i:03d}".encode() for i in range(60)] + [b"ab", b"zebra"]
    for v in range(1, 400):
        ii.put([vocab[j] for j in rng.choice(len(vocab), size=4,
                                             replace=False)], v)
    ii.put_removed([5, 77, 200])
    while ii.merge(1, 100, 2) > 0:
        pass
    ii.put([b"late"], 1000)
    t = port.snapshot_tables(ii, apply_removed=apply_removed)
    _assert_tables_equal(
        t, jax_snapshot.snapshot_tables(ii, apply_removed=apply_removed))
    assert t.n_terms == len(vocab) + 1
    empty = port.upload_tables(port._empty_tables(2), device="cpu")
    assert empty.n_terms == 0 and empty.device == torch.device("cpu")
