"""The port's bitmask codec (codec/bitmask.py) against the JAX package's
(twin of tests/test_bitmask.py): the same batches encode to the same bytes
in both, decode back, and stream."""
import numpy as np

from inverted_index_2_tpu.codec.bitmask import Bitmask as JaxBitmask

from inverted_index_2_tpu_torch.codec import packing
from inverted_index_2_tpu_torch.codec.bitmask import Bitmask


def test_round_trip_and_dictionary_growth(rng):
    bm, jbm = Bitmask(), JaxBitmask()
    batches = [
        np.unique(rng.integers(0, 10_000, size=int(s), dtype=np.uint32))
        for s in rng.integers(1, 200, size=20)
    ]
    encoded = [bm.put(b) for b in batches]
    assert encoded == [jbm.put(b) for b in batches]  # byte for byte
    for enc, want in zip(encoded, batches):
        got, consumed = bm.get(enc)
        assert consumed == len(enc)
        assert sorted(got.tolist()) == sorted(want.tolist())
        jgot, jconsumed = jbm.get(enc)
        assert jconsumed == consumed and np.array_equal(got, jgot)
    assert np.array_equal(bm.all_values(), jbm.all_values())


def test_stream_decode():
    bm = Bitmask()
    batches = [np.array([1, 2, 3], dtype=np.uint32),
               np.array([2, 3, 4, 99], dtype=np.uint32),
               np.array([], dtype=np.uint32),
               np.array([0, 0xFFFFFFFF], dtype=np.uint32)]
    stream = b"".join(bm.put(b) for b in batches)
    off = 0
    for want in batches:
        got, consumed = bm.get(stream, off)
        off += consumed
        assert sorted(got.tolist()) == sorted(want.tolist())
    assert off == len(stream)


def test_shared_values_amortize(rng):
    shared = np.unique(rng.integers(0, 2**32, size=500, dtype=np.uint32))
    bm = Bitmask()
    n_terms = 50
    bitmask_bytes = sum(len(bm.put(shared)) for _ in range(n_terms))
    bitmask_bytes += 4 * len(bm.all_values())  # the dictionary itself
    intcomp_bytes = n_terms * len(packing.encode_postings(shared)) * 4
    assert bitmask_bytes < intcomp_bytes


def test_all_values_insertion_order():
    bm = Bitmask()
    bm.put(np.array([7, 3], dtype=np.uint32))
    bm.put(np.array([3, 9], dtype=np.uint32))
    assert bm.all_values().tolist() == [7, 3, 9]
