"""Shared pieces of the benchmark's tests: the benchmark's folder on the
path, and cells at a size the CPU holds in seconds (the port on the CPU runs
its kernels' plain versions)."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, REPO) if p not in sys.path]

# a corpus whose lists reach every class of both streams at the default pad
TINY_CFG = dict(documents=40000, vocabulary=4000, terms_per_doc=40,
                zipf_s=1.0, stopword_ranks=5)
TINY_MIX = dict(batch_q=256, batches_per_call=2, warmup_calls=1, pool=3000)
TINY_BINS = {"High": [0.05, 1.0], "Med": [0.01, 0.05], "Low": [0.001, 0.01]}
CELLS = ("msmarco-passage.and-distinct", "wikimedium10m.and-2term",
         "msmarco-passage.or-page32")


def tiny_mix(decl, workload):
    import harness

    _, _, mix = harness.load_cell(decl, workload)
    mix = dict(mix, **TINY_MIX)
    if mix["term_draw"] == "bins":
        mix["bins"] = TINY_BINS
    return mix


@pytest.fixture(scope="session")
def decl():
    import harness

    return harness.load_declaration(REPO)


@pytest.fixture(scope="session")
def tiny_corpus():
    import corpus

    return corpus.generate(TINY_CFG, 2**31 + 11, "cpu")
