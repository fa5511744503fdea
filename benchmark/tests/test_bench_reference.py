"""The plain reference against brute-force set operations, and the control
(every list cut at the pad) that must not pass for it."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

import reference
from conftest import BENCH


def _lists(rng, n, D):
    return [np.sort(rng.choice(D, size=int(rng.integers(0, D // 2)),
                               replace=False)).astype(np.uint32)
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_and_and_page_equal_brute_force(seed):
    rng = np.random.default_rng(seed)
    D = int(rng.integers(1, 400))
    lists = _lists(rng, int(rng.integers(1, 6)), D)
    sets = [set(l.tolist()) for l in lists]
    want_and = sorted(set.intersection(*sets))
    assert reference.intersect(lists).tolist() == want_and
    union = sorted(set.union(*sets))
    seen = np.zeros(D, bool)
    for p in (1, 8, 32, 1000):
        ids, n = reference.union_page(lists, p, seen)
        assert ids.tolist() == union[:p] and n == len(union)
        assert not seen.any()


def test_reference_reads_the_corpus_lists(tiny_corpus):
    c = tiny_corpus
    ref = reference.Reference(c.values, c.voffs, c.D)
    a, b = int(np.argmax(c.df)), int(np.argmin(c.df))
    assert np.array_equal(ref.and_([a, b]),
                          np.intersect1d(c.lst(a), c.lst(b)))
    ids, n = ref.page([a, b], 32)
    u = np.union1d(c.lst(a), c.lst(b))
    assert n == len(u) and np.array_equal(ids, u[:32])


def test_the_truncated_control_differs_on_long_lists(tiny_corpus):
    c = tiny_corpus
    exact = reference.Reference(c.values, c.voffs, c.D)
    cut = reference.Reference(c.values, c.voffs, c.D, truncate=1024)
    longs = np.argsort(-c.df)[:2]
    assert c.df[longs].min() > 1024
    assert not np.array_equal(exact.and_(longs), cut.and_(longs))
    assert exact.page(longs, 32)[1] != cut.page(longs, 32)[1]
    shorts = np.argsort(c.df)[:3]
    assert np.array_equal(exact.and_(shorts), cut.and_(shorts))


def _imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


FORBIDDEN = {"jax", "jaxlib", "inverted_index_2_tpu",
             "inverted_index_2_tpu_torch"}


def test_reference_imports_nothing_of_either_package():
    path = os.path.join(BENCH, "reference.py")
    assert not (_imports(path) & FORBIDDEN)
    code = ("import sys; sys.path.insert(0, %r); import reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(eval(out))
    assert not (loaded & FORBIDDEN), loaded & FORBIDDEN


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for root, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                names = _imports(os.path.join(root, f))
                assert not (names & {"jax", "jaxlib", "flax",
                                     "inverted_index_2_tpu"}), f


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    import harness

    monkeypatch.setitem(sys.modules, "inverted_index_2_tpu_torch.x",
                        sys.modules[__name__])
    assert "inverted_index_2_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "inverted_index_2_tpu.ops",
                        sys.modules[__name__])
    assert "inverted_index_2_tpu" in harness.forbidden_modules()
