"""The port's entry points on the CPU: entry()'s step against the JAX
package's boolean_step on the same inputs, bit for bit (the JAX side is
rebuilt from inverted_index_2_tpu's own functions: __graft_entry__ rewrites
the JAX config when imported), dryrun_multichip at 1, 3 and 8 partitions,
the module's command line, and the two examples, whose result lines equal
the JAX examples' lines."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp
from inverted_index_2_tpu.codec import keys as jax_keys
from inverted_index_2_tpu.models import query_engine as jax_qe

from inverted_index_2_tpu_torch import entry as port_entry
from inverted_index_2_tpu_torch.utils.u32 import to_device, to_numpy_u32

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _jax_snapshot():
    """__graft_entry__._synthetic_snapshot_arrays through the JAX package:
    512 terms, Poisson mean 32, seed 0, width 3."""
    rng = np.random.default_rng(0)
    terms = sorted({f"term{i:06d}".encode() for i in range(512)})
    lists = [
        np.unique(rng.integers(0, 1_000_000,
                               size=max(1, int(rng.poisson(32))),
                               dtype=np.uint32))
        for _ in terms
    ]
    blob = b"".join(terms)
    offsets = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum([len(t) for t in terms], out=offsets[1:])
    voffs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    snap = jax_qe.build_snapshot_arrays(blob, offsets, np.concatenate(lists),
                                        voffs, None, 3)
    return snap, terms


def _jax_entry_queries(terms, width):
    """__graft_entry__.entry's queries: 64 of 4 distinct terms, seed 1."""
    rng = np.random.default_rng(1)
    qk = np.zeros((64, 4, width + 1), dtype=np.uint32)
    for i in range(64):
        chosen = [terms[j] for j in rng.choice(len(terms), size=4,
                                               replace=False)]
        qk[i] = jax_keys.pack_terms(chosen, width=width)
    return qk, np.full(64, 4, dtype=np.int32)


def _overlapping_queries(terms, width):
    """Queries whose AND is not empty: term i repeated, 1-4 slots live."""
    qk = np.zeros((64, 4, width + 1), dtype=np.uint32)
    for i in range(64):
        qk[i] = jax_keys.pack_terms([terms[i]] * 4, width=width)
    return qk, (np.arange(64) % 4 + 1).astype(np.int32)


@pytest.fixture(scope="module")
def both():
    fn, args = port_entry.entry(device="cpu")
    snap, terms = _jax_snapshot()
    return fn, args, snap, terms


@pytest.mark.parametrize("queries", ["entry", "overlapping"])
def test_entry_step_matches_jax_boolean_step(both, queries):
    fn, args, snap, terms = both
    qk, kv = _jax_entry_queries(terms, snap.width)
    # the port packs the same queries from the same seed
    assert np.array_equal(to_numpy_u32(args[4]), qk)
    assert np.array_equal(args[5].numpy(), kv)
    assert np.array_equal(to_numpy_u32(args[0]), np.asarray(snap.keys))
    if queries == "overlapping":
        qk, kv = _overlapping_queries(terms, snap.width)
        args = args[:4] + (to_device(qk, "cpu"), to_device(kv, "cpu"))
    out, oc, need = fn(*args)
    j_out, j_oc, j_need = jax_qe.boolean_step(
        snap.keys, snap.blocks, snap.term_block_start, snap.counts,
        jnp.asarray(qk), jnp.asarray(kv), L=256, op="and", removed=None,
        slots=snap.hash_slots, max_probes=snap.max_probes)
    j_out, j_oc, j_need = (np.asarray(x) for x in (j_out, j_oc, j_need))
    assert np.array_equal(oc.numpy(), j_oc)
    assert np.array_equal(need.numpy(), j_need)
    o = to_numpy_u32(out)
    for i in range(len(qk)):
        assert np.array_equal(o[i, :j_oc[i]], j_out[i, :j_oc[i]]), i
    if queries == "overlapping":
        assert (j_oc > 0).all()


@pytest.mark.parametrize("n", [1, 3, 8])
def test_dryrun_multichip_on_cpu(n):
    res = port_entry.dryrun_multichip(n, device="cpu")
    assert {"lookup", "and", "and concat", "and scatter", "or", "prefix",
            "range", "engine pages", "engine dual and"} <= set(res)
    # every AND form has rows, some of them not empty
    assert len(res["and"]) == 16 and sum(map(len, res["and"])) > 0


@pytest.mark.parametrize("form", ["or", "and"])
def test_dryrun_multichip_fails_on_a_wrong_set_op(form, monkeypatch):
    """A set op that drops each non-empty row's last value (a wrong union
    or AND) fails the dry run against its numpy answers."""
    from inverted_index_2_tpu_torch.parallel import mesh as pm

    real = pm._set_op

    def short(lists, ncnt, kv, op):
        out, oc = real(lists, ncnt, kv, op)
        return out, (oc - (oc > 0).to(oc.dtype) if op == form else oc)

    monkeypatch.setattr(pm, "_set_op", short)
    with pytest.raises(AssertionError, match="numpy answer"):
        port_entry.dryrun_multichip(3, device="cpu")


def test_dryrun_results_compare_across_runs():
    a = port_entry.dryrun_multichip(3, device="cpu")
    b = port_entry.dryrun_multichip(3, device="cpu")
    assert port_entry.same_results(a, b)
    b["or"][0] = b["or"][0][:-1]
    assert not port_entry.same_results(a, b)


def test_entry_command_line_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "inverted_index_2_tpu_torch.entry",
         "--device", "cpu", "--n", "3"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines() == ["entry ok: (64, 256) (64,)",
                                       "dryrun ok"]


def test_entry_without_cuda_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_entry.main([]) == 1
    cap = capsys.readouterr()
    assert cap.out == ""
    assert len(cap.err.strip().splitlines()) == 1


def _run(script, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          *args], capture_output=True, text=True, cwd=ROOT,
                         timeout=600, env=env)
    assert res.returncode == 0, res.stderr
    return res.stdout.splitlines()


# result lines that differ between the packages by design: the engine's
# stats carry the device arena's bytes (the port's rows are 16-byte
# aligned, JAX's 128-word) and whether the AND takes the fused kernel
# (JAX's does only on a TPU)
_DIFFER = {"serving_mesh": ("stats: ",)}


@pytest.mark.parametrize("name", ["quickstart", "serving_mesh"])
def test_example_prints_the_jax_examples_lines(name):
    port = _run(f"{name}_torch.py", "--device", "cpu")
    ref = _run(f"{name}.py")
    assert len(port) == len(ref)
    skip = _DIFFER.get(name, ())
    for a, b in zip(port, ref):
        if a.startswith(skip) and b.startswith(skip):
            continue
        assert a == b
