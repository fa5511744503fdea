"""The port's host layers (its own copy of the LSM index, segments,
tombstones and codecs) against the JAX package's, on the CPU: one seeded
workload through both InvertedIndex classes writes byte-identical segment
files and reads back the same results, each package opens and reads the
directory the other wrote, and the posting codec agrees on the corpora of
experiments/fuzz_native.py."""
import os

import numpy as np
import pytest

import inverted_index_2_tpu as jax_pkg
from inverted_index_2_tpu.codec import packing as jax_packing

import inverted_index_2_tpu_torch as port_pkg
from inverted_index_2_tpu_torch.codec import native as port_native
from inverted_index_2_tpu_torch.codec import packing as port_packing

PREFIXES = [b"ab", b"ac0", b"m", b"zz01", b"q", b""]


def _workload(pkg, basedir, seed):
    rng = np.random.default_rng(seed)
    vocab = ([f"{p}{i:03d}".encode() for p in ("ab", "ac", "m", "zz")
              for i in range(20)] + [b"ab", b"a\x00b", b"\xff\xfe"])
    ii = pkg.InvertedIndex(basedir)
    for v in range(1, 121):
        k = int(rng.integers(1, 6))
        ii.put([vocab[j] for j in rng.choice(len(vocab), size=k,
                                             replace=False)], v * 7)
        if v % 30 == 0:
            ii.put_removed(rng.choice(np.arange(1, v + 1) * 7, size=6,
                                      replace=False).tolist())
    while ii.merge(1, 100, 2) > 0:
        pass
    ii.put([b"late", b"ab"], 10_001)
    ii.put_removed([14, 10_001])
    return ii


def _read(pkg, ii):
    out = []
    for lo, hi in ((None, None), (b"ab", b"ac010"), (b"m", None)):
        out.append([(tv.term, tv.values.tolist())
                    for tv in pkg.to_slice(ii.read(lo, hi))])
    found = ii.prefix_search(PREFIXES)
    out.append(sorted((p, v.tolist()) for p, v in found.items()))
    return out


def _segment_files(basedir):
    """{shard: [segment file bytes in key order]} (file names carry the
    write time, so they differ between two runs)."""
    out = {}
    for shard in sorted(os.listdir(basedir)):
        d = os.path.join(basedir, shard)
        names = sorted(n for n in os.listdir(d)
                       if n.endswith(("_dict", "_vals")))
        out[shard] = [(n.split("_")[1], open(os.path.join(d, n), "rb").read())
                      for n in names]
    return out


def _removed(pkg, basedir):
    out = {}
    for shard in sorted(os.listdir(basedir)):
        path = os.path.join(basedir, shard, "removed.list")
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[shard] = sorted(pkg.unserialize_removed_list(f.read())
                                    .values().tolist())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_workload_same_files_and_reads(tmp_path, seed):
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    port = _workload(port_pkg, pdir, seed)
    jax_ii = _workload(jax_pkg, jdir, seed)
    got = _read(port_pkg, port)
    assert got == _read(jax_pkg, jax_ii)
    assert any(len(v) for _, v in got[0]) and got[3]
    files = _segment_files(pdir)
    assert files == _segment_files(jdir)
    assert sum(len(v) for v in files.values()) > 0
    assert _removed(port_pkg, pdir) == _removed(jax_pkg, jdir)
    # each package opens the directory the other wrote
    assert _read(port_pkg, port_pkg.InvertedIndex(jdir)) == got
    assert _read(jax_pkg, jax_pkg.InvertedIndex(pdir)) == got


def _fuzz_lists(rng, n_lists):
    """experiments/fuzz_native.py's shapes: heavy overlap, consecutive runs
    (bit-width-0 blocks, also as the final block) and sparse lists, up to
    5k values."""
    lists = []
    for _ in range(n_lists):
        n = int(rng.integers(0, 5000 if rng.random() < 0.3 else 300))
        r = rng.random()
        if r < 0.25:
            base = rng.integers(0, max(2 * n, 50), size=n)
        elif r < 0.45:
            start = int(rng.integers(0, 1000))
            base = np.arange(start, start + n)
        else:
            base = rng.integers(0, 100_000, size=n)
        lists.append(np.unique(base).astype(np.uint32))
    # a dense block followed by a width-0 final block of 1 and of 2 values
    lists += [np.concatenate([np.arange(0, 128), [1_000]]).astype(np.uint32),
              np.arange(7, 7 + 257, dtype=np.uint32),
              np.arange(7, 7 + 258, dtype=np.uint32),
              np.array([0, 0xFFFFFFFF], np.uint32)]
    return lists


@pytest.mark.parametrize("byte_align", [0, 2])
def test_packing_matches_jax_on_fuzz_corpora(byte_align):
    rng = np.random.default_rng(0)
    lists = _fuzz_lists(rng, 60)
    values = np.concatenate(lists)
    voffs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    words, outs = port_packing.encode_bulk(values, voffs, byte_align=byte_align)
    jwords, jouts = jax_packing.encode_bulk(values, voffs,
                                            byte_align=byte_align)
    assert np.array_equal(words, jwords) and np.array_equal(outs, jouts)
    # the numpy codec against the native one, and both decodes round-trip
    nwords, nouts = port_packing._encode_bulk_np(values, voffs,
                                                 byte_align=byte_align)
    assert np.array_equal(nwords, words) and np.array_equal(nouts, outs)
    for dec in (port_packing.decode_bulk, port_packing._decode_bulk_np,
                jax_packing.decode_bulk):
        got = dec(words, outs)
        vals, vo = got[0], got[-1]
        for i, want in enumerate(lists):
            assert np.array_equal(vals[vo[i]:vo[i + 1]], want), (dec, i)
    assert port_native.available() == jax_pkg.codec.native.available()
