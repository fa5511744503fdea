"""The corpus generator and the frozen codec arithmetic."""
import numpy as np
import pytest
import torch

import codec_bytes
import corpus
from conftest import TINY_CFG


@pytest.mark.parametrize("D,T,V,s", [(8841823, 40, 2_000_000, 1.0),
                                     (10_000_000, 110, 5_000_000, 1.0),
                                     (40000, 40, 4000, 1.0),
                                     (50000, 20, 9000, 1.2)])
def test_df_model_sums_to_the_postings_it_states(D, T, V, s):
    m = corpus.df_model(D, T, V, s)
    assert len(m) == V
    assert m.max() <= D and m.min() >= 1
    assert (np.diff(m) <= 0).all()
    # rounding each rank moves the sum by at most half a posting a rank
    assert abs(int(m.sum()) - D * T) <= V / 2 + D


def test_the_published_deployments_sizes():
    m = corpus.df_model(8841823, 40, 2_000_000, 1.0)
    assert int(m[33:].sum()) == 271_970_108
    w = corpus.df_model(10_000_000, 110, 5_000_000, 1.0)
    assert int(w.sum()) == 1_100_007_607


def test_same_seed_same_corpus_other_seed_other(tiny_corpus):
    a = tiny_corpus
    b = corpus.generate(TINY_CFG, 2**31 + 11, "cpu")
    c = corpus.generate(TINY_CFG, 2**31 + 12, "cpu")
    for f in ("blob", "offsets", "values", "voffs", "rank", "enc_bytes"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert not np.array_equal(a.values[:1000], c.values[:1000])
    assert not np.array_equal(a.blob, c.blob)


def test_terms_sorted_distinct_lower_case(tiny_corpus):
    c = tiny_corpus
    terms = [c.blob[c.offsets[i]:c.offsets[i + 1]].tobytes()
             for i in range(c.n_terms)]
    assert terms == sorted(terms)
    assert len(set(terms)) == len(terms)
    assert all(5 <= len(t) <= 16 and t.isalpha() and t.islower()
               for t in terms)


def test_lists_follow_the_df_model_without_stopwords(tiny_corpus):
    c = tiny_corpus
    sw = TINY_CFG["stopword_ranks"]
    model = corpus.df_model(TINY_CFG["documents"], TINY_CFG["terms_per_doc"],
                            TINY_CFG["vocabulary"], TINY_CFG["zipf_s"])
    assert (c.pos_of_rank[: sw + 1] == -1).all()
    assert sorted(c.rank) == list(range(sw + 1, TINY_CFG["vocabulary"] + 1))
    assert np.array_equal(c.df, model[c.rank - 1])
    assert len(c.values) == int(model[sw:].sum())
    for p in range(c.n_terms):
        lst = c.lst(p).astype(np.int64)
        assert len(lst) == c.df[p]
        assert (np.diff(lst) > 0).all()
        assert lst[0] >= 0 and lst[-1] < c.D


def test_a_list_as_long_as_the_corpus_holds_every_document():
    cfg = dict(TINY_CFG, stopword_ranks=0)
    c = corpus.generate(cfg, 5, "cpu")
    p = int(c.pos_of_rank[1])
    assert c.df[p] == c.D
    assert np.array_equal(c.lst(p), np.arange(c.D, dtype=np.uint32))


def _words(*lists):
    vals = torch.tensor([v for l in lists for v in l], dtype=torch.int64)
    cnt = torch.tensor([len(l) for l in lists], dtype=torch.int64)
    return codec_bytes.encoded_words(vals, cnt).tolist()


def test_codec_words_by_hand():
    # [] : the count word alone; [7] : count, header, anchor, no gaps
    assert _words([], [7]) == [1, 3]
    # gaps of 0 pack at 0 bits; a gap of 299 at 16 bits (one word)
    assert _words([0, 1, 2], [0, 300]) == [3, 4]
    # three gaps of 255 and 256: 16 bits each, 48 bits -> 2 words
    assert _words([0, 256, 513, 770]) == [1 + 2 + 2]
    # gap of 2**16: 32 bits; 129 ids of step 2 are two blocks, the second
    # a lone anchor: 1 + (2 + ceil(127 * 8 / 32)) + 2
    assert _words([0, 1 + (1 << 16)]) == [4]
    assert _words(list(range(0, 258, 2))) == [1 + (2 + 32) + 2]


def test_codec_words_match_the_arena_codec_lengths(tiny_corpus):
    """A second witness: the port's encoder at the arena's byte widths
    writes as many words as the frozen arithmetic counts."""
    from inverted_index_2_tpu_torch.codec import packing

    c = tiny_corpus
    words, outs = packing.encode_bulk(c.values, c.voffs, byte_align=2)
    ends = np.append(np.asarray(outs[1:], np.int64), len(words))
    assert np.array_equal(4 * (ends - np.asarray(outs, np.int64)),
                          c.enc_bytes)
