"""The corpus of a configuration, made from the seed on the device.

A configuration file (benchmark/configs/<name>.json) states a deployment: D
documents, `terms_per_doc` distinct terms in each, a vocabulary of V terms
whose document frequencies follow Zipf's law with exponent s, capped at D,
and the most frequent `stopword_ranks` ranks left out of the index. From it:

* `df_model` gives the document frequency of every rank: df(r) =
  clip(rint(C / r**s), 1, D), C solved so that the frequencies of all V
  ranks sum to D * terms_per_doc (stopwords included: they are words of the
  documents, only not indexed).
* `generate` makes the index's terms and posting lists with one CUDA
  `torch.Generator` (or a CPU one, for the tests) seeded with the run's
  seed, in a few large calls, and copies them to the host once. Each indexed
  term is a distinct five-letter stem (26**5 = 11,881,376 stems) followed by
  0-11 more lower-case letters, so terms are 5-16 bytes; the terms are in
  byte order, and a seeded permutation gives each its rank. A term of df k
  gets k distinct ids of [0, D): k uniform draws over [0, D - k + 1),
  sorted, the j-th raised by j, which is a uniform k-subset up to ties.

The program's tables and the plain reference both take the same host copy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from codec_bytes import encoded_words

STEM = 5                   # letters of each term's distinct stem
MAX_SUFFIX = 11            # letters after the stem: terms of 5-16 bytes
TERM_BYTES = STEM + MAX_SUFFIX
CHUNK = 1 << 26            # postings made in one device call


def df_model(D: int, terms_per_doc: float, V: int, s: float) -> np.ndarray:
    """Document frequency of ranks 1..V (int64, index r - 1)."""
    r = np.arange(1, V + 1, dtype=np.float64)
    w = r ** -s
    h = np.concatenate([[0.0], np.cumsum(w)])
    target = float(D) * terms_per_doc
    if target > float(D) * V:
        raise ValueError("terms_per_doc exceeds the vocabulary")

    def total(C: float) -> float:
        # ranks with C / r**s >= D are capped at D
        m = min(V, int((C / D) ** (1.0 / s)))
        return D * m + C * (h[V] - h[m])

    lo, hi = 1e-9, float(D) * V
    for _ in range(200):
        mid = (lo * hi) ** 0.5
        if total(mid) < target:
            lo = mid
        else:
            hi = mid
    C = (lo * hi) ** 0.5
    return np.clip(np.rint(C * w), 1, D).astype(np.int64)


@dataclass
class Corpus:
    """One generated index, in byte order of its terms (position p)."""

    D: int
    blob: np.ndarray          # (sum of term lengths,) uint8
    offsets: np.ndarray       # (n + 1,) int64 term byte offsets
    term_mat: np.ndarray      # (n, TERM_BYTES) uint8, zero past the length
    term_len: np.ndarray      # (n,) int64
    values: np.ndarray        # (postings,) uint32, each list ascending
    voffs: np.ndarray         # (n + 1,) int64
    df: np.ndarray            # (n,) int64 list length of position p
    rank: np.ndarray          # (n,) int64 Zipf rank of position p (1-based)
    pos_of_rank: np.ndarray   # (V + 1,) int64 position of rank r, -1 if
                              # not indexed (stopwords, index 0)
    enc_bytes: np.ndarray     # (n,) int64 codec bytes of each list
    df_by_rank: np.ndarray    # (V,) int64 the model
    device: torch.device      # where it was made

    @property
    def n_terms(self) -> int:
        return len(self.df)

    def lst(self, p: int) -> np.ndarray:
        return self.values[self.voffs[p]:self.voffs[p + 1]]


def _lists_on_device(k: torch.Tensor, D: int, g: torch.Generator):
    """Ascending distinct ids for terms of df k (int64 tensor), one list
    after another: k uniform draws over [0, D - k + 1) a term, sorted (one
    integer sort of (term, draw) keys), the j-th raised by j. Integer
    sorting keeps the result the same on every run of a seed."""
    dev = k.device
    total = int(k.sum())
    term_of = torch.repeat_interleave(torch.arange(k.numel(), device=dev), k,
                                      output_size=total)
    room = (D - k + 1)[term_of]
    u = torch.rand(total, dtype=torch.float64, device=dev, generator=g)
    u = torch.minimum((u * room).to(torch.int64), room - 1)
    del room
    base = term_of * D
    keys = torch.sort(base + u).values
    del u
    j = torch.arange(total, device=dev) - (torch.cumsum(k, 0) - k)[term_of]
    return keys - base + j


def generate(cfg: dict, seed: int, device, mark=None) -> Corpus:
    """The corpus of configuration `cfg` for `seed`, made on `device`;
    mark(name), if given, is called after the terms and after the lists."""
    mark = mark or (lambda name: None)
    D = int(cfg["documents"])
    V = int(cfg["vocabulary"])
    sw = int(cfg.get("stopword_ranks", 0))
    model = df_model(D, float(cfg["terms_per_doc"]), V, float(cfg["zipf_s"]))
    n = V - sw
    if n > 26 ** STEM:
        raise ValueError(f"{n} terms exceed the {26 ** STEM} stems")
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))

    stems = torch.randperm(26 ** STEM, generator=g, device=dev)[:n]
    stems = torch.sort(stems).values
    slen = torch.randint(0, MAX_SUFFIX + 1, (n,), generator=g, device=dev)
    sfx = torch.randint(0, 26, (n, MAX_SUFFIX), generator=g, device=dev,
                        dtype=torch.int16)
    perm = torch.randperm(n, generator=g, device=dev)

    stems_h = stems.cpu().numpy()
    term_len = STEM + slen.cpu().numpy().astype(np.int64)
    digits = (stems_h[:, None] // 26 ** np.arange(STEM - 1, -1, -1)) % 26
    term_mat = np.empty((n, TERM_BYTES), np.uint8)
    term_mat[:, :STEM] = 97 + digits
    term_mat[:, STEM:] = 97 + sfx.cpu().numpy()
    inside = np.arange(TERM_BYTES)[None, :] < term_len[:, None]
    term_mat[~inside] = 0
    blob = term_mat[inside]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(term_len, out=offsets[1:])

    mark("terms")
    rank = sw + 1 + perm.cpu().numpy().astype(np.int64)
    pos_of_rank = np.full(V + 1, -1, np.int64)
    pos_of_rank[rank] = np.arange(n)
    df = model[rank - 1]
    voffs = np.zeros(n + 1, np.int64)
    np.cumsum(df, out=voffs[1:])

    values = np.empty(int(voffs[-1]), np.uint32)
    enc_words = np.empty(n, np.int64)
    cum = np.cumsum(df + 1)
    cuts = np.searchsorted(cum, np.arange(CHUNK, int(cum[-1]), CHUNK),
                           side="right")
    bounds = np.unique(np.concatenate([[0], cuts, [n]]))
    df_dev = torch.from_numpy(df).to(dev)
    values_t = torch.from_numpy(values.view(np.int32))
    for a, b in zip(bounds[:-1], bounds[1:]):
        k = df_dev[a:b]
        v = _lists_on_device(k, D, g)
        enc_words[a:b] = encoded_words(v, k).cpu().numpy()
        values_t[voffs[a]:voffs[b]].copy_(v.to(torch.int32))
        del v
    mark("lists")
    return Corpus(D=D, blob=blob, offsets=offsets, term_mat=term_mat,
                  term_len=term_len, values=values, voffs=voffs, df=df,
                  rank=rank, pos_of_rank=pos_of_rank,
                  enc_bytes=4 * enc_words, df_by_rank=model, device=dev)
