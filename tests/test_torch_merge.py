"""The port's device merge (ops/merge.py) on the CPU, against the port's
host merge (shard.merge_views) and the JAX package's device merge on the
same segment files: the port's Shard writes them, the JAX package's Shard
reopens the directory. The twin of tests/test_device_merge.py, plus cases
with 0xFFFFFFFF and 0x80000000 as postings and as tombstones, with no
tombstones at all, and the seven outputs of merge_device_step against JAX's.
Every comparison is exact."""
import os

import numpy as np
import pytest
import torch

import inverted_index_2_tpu as jax_pkg
from inverted_index_2_tpu.ops import merge as jax_merge

import inverted_index_2_tpu_torch as port_pkg
import inverted_index_2_tpu_torch.shard as port_shard
from inverted_index_2_tpu_torch.ops import merge as port_merge
from inverted_index_2_tpu_torch.shard import merge_views
from inverted_index_2_tpu_torch.utils.u32 import to_device, to_numpy_u32

torch.set_num_threads(1)

EDGE = [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]


def _shard(tmp_path, rng, n_docs=25, values=None):
    """A port Shard of one direct segment a document; returns (port views,
    JAX views of the same files)."""
    d = os.path.join(str(tmp_path), "s")
    sh = port_pkg.Shard(d)
    vocab = [f"t{i:02d}".encode() for i in range(30)] + [b"", b"a",
                                                        b"\xff\xffx"]
    values = list(range(1, n_docs + 1)) if values is None else values
    for doc in values:
        k = int(rng.integers(1, 7))
        sh.put([vocab[i] for i in rng.choice(len(vocab), size=k,
                                             replace=False)], doc)
    port_views = [s.view for s in sh.segments.snapshot()]
    jax_views = [s.view for s in jax_pkg.Shard(d).segments.snapshot()]
    return port_views, jax_views


def _norm(res):
    if res is None:
        return None
    blob, offsets, values, voffs = res
    return (bytes(blob), np.asarray(offsets).tolist(),
            np.asarray(values, dtype=np.uint32).tolist(),
            np.asarray(voffs).tolist())


def _three(port_views, jax_views, removed):
    dev = port_merge.merge_views_device(port_views, removed, device="cpu")
    host = merge_views(port_views, removed)
    ref = jax_merge.merge_views_device(jax_views, removed)
    assert _norm(dev) == _norm(host)
    assert _norm(dev) == _norm(ref)
    return dev


def test_device_merge_matches_host(tmp_path, rng):
    pv, jv = _shard(tmp_path, rng)
    assert _three(pv, jv, None) is not None


def test_device_merge_with_tombstones(tmp_path, rng):
    pv, jv = _shard(tmp_path, rng)
    _three(pv, jv, np.array([1, 5, 9, 13, 200], dtype=np.uint32))


def test_device_merge_everything_purged(tmp_path, rng):
    pv, jv = _shard(tmp_path, rng, n_docs=5)
    removed = np.arange(1, 6, dtype=np.uint32)
    assert _three(pv, jv, removed) is None


def test_device_merge_empty_removed(tmp_path, rng):
    pv, jv = _shard(tmp_path, rng)
    assert _norm(_three(pv, jv, np.zeros(0, np.uint32))) == _norm(
        merge_views(pv, None))


@pytest.mark.parametrize("removed", [[], [0x80000000], [0xFFFFFFFF],
                                     [0, 0x80000000, 0xFFFFFFFF]])
def test_device_merge_u32_edges(tmp_path, rng, removed):
    # each edge value twice (two documents), among ordinary ones: compared
    # as int32 bits 0x80000000 and above would sort first
    vals = EDGE + EDGE + list(range(1000, 1020))
    pv, jv = _shard(tmp_path, rng, values=vals)
    out = _three(pv, jv, np.array(removed, dtype=np.uint32))
    got = set(np.asarray(out[2]).tolist())
    assert got == (set(vals) - set(removed))
    blob, offsets, values, voffs = out
    for t in range(len(voffs) - 1):
        row = np.asarray(values[voffs[t]:voffs[t + 1]], dtype=np.uint32)
        assert np.all(row[1:] > row[:-1])  # ascending in u32 order, unique


def test_merge_device_step_outputs_match_jax(rng):
    """The seven outputs of the step on one input, against JAX's step with
    no padding: the survivors, their groups, the counts and the grouping
    of the key rows."""
    N, W = 40, 3
    keys = rng.integers(0, 4, size=(N, W + 1), dtype=np.uint32)
    keys[::5, 0] = 0xFFFFFFFF
    keys[1::7, 1] = 0x80000000
    keys[:, -1] = rng.integers(1, 12, size=N, dtype=np.uint32)
    tov = rng.integers(0, N, size=300).astype(np.int32)
    vals = rng.choice(np.array(EDGE + list(range(50)), dtype=np.uint32),
                      size=300)
    removed = np.array([3, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)
    got = port_merge.merge_device_step(
        to_device(keys, "cpu"), to_device(tov, "cpu"), to_device(vals, "cpu"),
        to_device(removed, "cpu"))
    want = jax_merge.merge_device_step(keys, tov, vals, removed)
    perm, head, gpos, kept, ov, og, gc = got
    k = int(kept)
    assert k == int(want[3])
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(head.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(to_numpy_u32(ov), np.asarray(want[4]))
    np.testing.assert_array_equal(og.numpy(), np.asarray(want[5]))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(want[6]))


def _build(pkg, d):
    sh = pkg.Shard(d)
    r = np.random.default_rng(3)
    for doc in list(range(1, 30)) + [0x80000000, 0xFFFFFFFF]:
        terms = [bytes(r.integers(97, 105, size=4, dtype=np.uint8))
                 for _ in range(4)]
        sh.put(terms, doc)
    sh.remove(np.array([5, 6, 0x80000000], dtype=np.uint32))
    while sh.merge(2, 100) > 0:
        pass
    return sh


def _segment_bytes(d):
    names = sorted(n for n in os.listdir(d) if n.endswith(("_dict", "_vals")))
    return sorted(open(os.path.join(d, n), "rb").read() for n in names)


def test_shard_merge_device_dispatch(tmp_path, monkeypatch):
    """Threshold 0 and merge device "cpu": Shard.merge goes through
    ops/merge.py and writes the files a host merge writes, and reads back
    the same."""
    host_sh = _build(port_pkg, os.path.join(str(tmp_path), "host"))
    calls = []
    real = port_merge.merge_views_device

    def spy(views, removed=None, *, device="cuda"):
        calls.append(str(device))
        return real(views, removed, device=device)

    monkeypatch.setattr(port_merge, "merge_views_device", spy)
    monkeypatch.setattr(port_shard, "DEVICE_MERGE_MIN_VALUES", 0)
    monkeypatch.setattr(port_shard, "MERGE_DEVICE", "cpu")
    dev_sh = _build(port_pkg, os.path.join(str(tmp_path), "dev"))
    assert calls and set(calls) == {"cpu"}
    assert _segment_bytes(host_sh.basedir) == _segment_bytes(dev_sh.basedir)
    h = [(tv.term, tv.values.tolist())
         for tv in port_pkg.to_slice(host_sh.read(None, None))]
    d = [(tv.term, tv.values.tolist())
         for tv in port_pkg.to_slice(dev_sh.read(None, None))]
    assert h == d
    j = [(tv.term, tv.values.tolist()) for tv in jax_pkg.to_slice(
        jax_pkg.Shard(dev_sh.basedir).read(None, None))]
    assert j == h


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the error raised without a CUDA device")
def test_device_merge_without_cuda_raises(tmp_path, monkeypatch, rng):
    pv, _ = _shard(tmp_path, rng)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_merge.merge_views_device(pv, None)
    # above the threshold Shard.merge asks for the card and raises too,
    # leaving its inputs in place
    monkeypatch.setattr(port_shard, "DEVICE_MERGE_MIN_VALUES", 0)
    sh = port_pkg.Shard(os.path.join(str(tmp_path), "t"))
    for doc in range(1, 5):
        sh.put([b"x%d" % doc, b"y"], doc)
    n = len(sh.segments)
    with pytest.raises(RuntimeError, match="CUDA"):
        sh.merge(2, 100)
    assert len(sh.segments) == n
    monkeypatch.setattr(port_shard, "DEVICE_MERGE_MIN_VALUES", 1 << 40)
    assert sh.merge(2, 100) == n
