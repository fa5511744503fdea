"""The benchmark's device pieces on the card: run on a machine with one,
`python -m pytest --noconftest -q -m gpu benchmark/tests/test_bench_gpu.py`
(the conftest here adds only paths; without a card every test skips)."""
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [p for p in (BENCH, os.path.dirname(BENCH))
                if p not in sys.path]

import codec_bytes  # noqa: E402
import corpus  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def test_codec_words_on_the_card_equal_the_cpu(card):
    rng = np.random.default_rng(0)
    lists = [np.unique(rng.integers(0, 1 << 26, size=int(n)))
             for n in rng.integers(0, 3000, size=200)]
    vals = torch.tensor(np.concatenate(lists), dtype=torch.int64)
    cnt = torch.tensor([len(l) for l in lists], dtype=torch.int64)
    want = codec_bytes.encoded_words(vals, cnt)
    got = codec_bytes.encoded_words(vals.to(card), cnt.to(card)).cpu()
    assert torch.equal(got, want)


def test_the_card_makes_the_same_corpus_from_the_same_seed(card):
    cfg = dict(documents=2_000_000, vocabulary=300_000, terms_per_doc=40,
               zipf_s=1.0, stopword_ranks=33)
    a = corpus.generate(cfg, 2**33 + 1, card)
    b = corpus.generate(cfg, 2**33 + 1, card)
    assert np.array_equal(a.values, b.values)
    assert np.array_equal(a.blob, b.blob)
    assert len(a.values) == int(corpus.df_model(2_000_000, 40, 300_000,
                                                1.0)[33:].sum())
    lst = a.lst(int(np.argmax(a.df))).astype(np.int64)
    assert (np.diff(lst) > 0).all() and lst[-1] < a.D
