"""A run of each cell driven on the CPU at a tiny size (the look for a card
skipped): its result line, the faults it must catch, the control that must
fail, and the declaration it reads."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import control
import harness
from conftest import BENCH, CELLS, REPO, TINY_CFG, tiny_mix


def _run(decl, workload, seed=2**31 + 77, seconds=0.5):
    return harness.run(workload, seed, seconds, False, "cpu", decl=decl,
                       cfg=TINY_CFG, mix=tiny_mix(decl, workload),
                       log=lambda *a: None)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct_and_prints_the_contract_keys(decl,
                                                             workload):
    res = _run(decl, workload)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"qps", "p95_call_ms", "device_peak_gb",
                                   "setup_s"}
    for m in decl["end_to_end"]:
        assert res["metrics"][m["name"]]["unit"] == m["unit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(res["device"])
    checks = res["checks"]
    assert checks["wrong_answers"] == {"value": 0, "limit": 0}
    assert checks["unanswered"] == {"value": 0, "limit": 0}
    assert checks["answers_compared"]["value"] > 50
    json.dumps(res)


def _alter_k2(monkeypatch):
    from inverted_index_2_tpu_torch.models.query_engine import QueryEngine

    orig = QueryEngine._fused_run_staged

    def bad(self, *a, **k):
        small, *rest = orig(self, *a, **k)
        return (small + 1, *rest)

    monkeypatch.setattr(QueryEngine, "_fused_run_staged", bad)


def _alter_page(monkeypatch):
    from inverted_index_2_tpu_torch.models import staged

    orig = staged._scatter_p_step
    monkeypatch.setattr(staged, "_scatter_p_step",
                        lambda obuf, sel, o, oc: orig(obuf, sel, o, oc + 1))


def _drop_half(monkeypatch):
    """Serve the first half of every batch; the rest get empty answers."""
    from inverted_index_2_tpu_torch.models.query_engine import QueryEngine

    orig = QueryEngine.boolean_staged

    def half(self, batches, op="and", filter_removed=False, depth=3,
             columnar=False, prefix_p=0, _st=None):
        cut = []
        for blob, toffs, qoffs in batches:
            h = (len(qoffs) - 1) // 2
            cut.append((blob, toffs[: qoffs[h] + 1], qoffs[: h + 1]))
        out = orig(self, cut, op, filter_removed, depth, columnar, prefix_p)
        full = []
        for (_, _, qoffs), r in zip(batches, out):
            pad = len(qoffs) - len(r[1])
            offs = np.concatenate([r[1], np.full(pad, r[1][-1])])
            if prefix_p:
                full.append((r[0], offs, np.concatenate(
                    [r[2], np.zeros(pad, r[2].dtype)])))
            else:
                full.append((r[0], offs))
        return full

    monkeypatch.setattr(QueryEngine, "boolean_staged", half)


FAULTS = {"answer_altered": {"and": _alter_k2, "or": _alter_page},
          "half_the_batch_left_out": {"and": _drop_half, "or": _drop_half}}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(decl, monkeypatch, workload,
                                            fault):
    op = "or" if "or-" in workload else "and"
    FAULTS[fault][op](monkeypatch)
    res = _run(decl, workload)
    assert res["correct"] is False
    assert res["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(decl, workload):
    seeds = (2**31 + 1, 2**31 + 2, 2**31 + 3)
    for seed in seeds:
        r = control.control_reading(workload, seed, 1024, "cpu", calls=6,
                                    decl=decl, cfg=TINY_CFG,
                                    mix=tiny_mix(decl, workload))
        assert r["compared"] > 50
        assert r["wrong_answers"] > 0


def test_without_a_card_the_command_fails_and_prints_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the look for it succeeds")
    env = dict(os.environ, TPI_HOST_BOOL="all")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", CELLS[0], "--seed", str(2**33),
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, env=env)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA is not available" in p.stderr


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_the_declaration_keeps_the_contract(decl):
    assert set(decl) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert decl["paths"] == ["benchmark"]
    assert 1 <= decl["run_seconds"] <= 51
    e2e = {m["name"]: m for m in decl["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in decl["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    names = {w["name"] for w in decl["workloads"]}
    for m in decl["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= names
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    for m in decl["end_to_end"] + decl["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in decl["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = harness.load_json(os.path.join(REPO, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200
    for w in decl["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        assert any(w["name"] in m["workloads"] for m in decl["per_layer"])
