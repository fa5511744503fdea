"""One run of one cell of BENCHMARK.json: set-up, the measured window, the
check of its answers, and the result line's contents. run.py is the command
around it; control.py and the tests drive parts of it.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file found by its name:

    benchmark/configs/<config>.json     the deployment (corpus.py reads it)
    benchmark/traffic/<mix>.json        the mix; its "generator" names the
                                        module benchmark/traffic/<gen>.py
    benchmark/metrics/<metric>.py       read(ctx) -> number or None

The generator module serves and judges its own kind of traffic, so a new
kind is a new module and the harness only times and records:

    build(mix, corpus, seed) -> stream   .warm and .calls (lists of calls,
                                         made in set-up), .queries_per_call
    serve(eng, stream, call)             -> (results, counters or None)
    written(stream, results)             ids written per query of a call
    least_bytes(stream, corpus, rows, ids)  the roofline's bytes (work.py)
    classes(stream, corpus, rows)        the check's classes of rows
    answer_of(stream, results, row)      the program's answer, or None
    expected(stream, ref, row)           the reference's answer
    same(stream, got, want)              the verdict on one answer
    engine(corpus, device)               optional: the engine to serve;
                                         default_engine below otherwise

The window is a closed loop of one client: it serves the prepared calls in
turn (again from the first when it outlasts them) and does nothing but call
and record.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import check as check_mod  # noqa: E402
import corpus as corpus_mod  # noqa: E402
import devtrace  # noqa: E402
import work  # noqa: E402
from reference import Reference  # noqa: E402

# top-level module names no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "inverted_index_2_tpu")
# calls whose results are kept for the check: this many drawn from the
# seed among the first KEEP_FROM calls of the window, and the last call
KEPT_CALLS = 6
KEEP_FROM = 100
# a traced run's window: its trace of host and card events grows with every
# launch, and reading it back costs about three times the window
TRACED_SECONDS = 15.0


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_declaration(root: str = REPO) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def find_cell(decl: dict, workload: str):
    """(the workload entry, its configuration entry)."""
    for cell in decl["workloads"]:
        if cell["name"] == workload:
            cfg = next(c for c in decl["configs"] if c["name"] == cell["config"])
            return cell, cfg
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def load_cell(decl: dict, workload: str, root: str = REPO):
    """(cell, configuration file contents, mix file contents)."""
    cell, cfg_entry = find_cell(decl, workload)
    cfg = load_json(os.path.join(root, cfg_entry["file"]))
    mix = load_json(os.path.join(BENCH, "traffic", cell["traffic"] + ".json"))
    return cell, cfg, mix


def traffic(mix: dict):
    """The generator module the mix names."""
    name = "traffic_" + mix["generator"]
    if name not in sys.modules:
        load_module(os.path.join(BENCH, "traffic", mix["generator"] + ".py"),
                    name)
    return sys.modules[name]


def make_stream(mix: dict, corpus, seed: int):
    return traffic(mix).build(mix, corpus, seed)


def default_engine(corpus, device, mark=lambda name: None):
    """The engine as `from_index` leaves it: host tables built from the
    corpus's lists, uploaded, and retained by a QueryEngine (the default L,
    the router on auto). mark("tables") is called once they are built."""
    from inverted_index_2_tpu_torch import QueryEngine
    from inverted_index_2_tpu_torch.models.snapshot import (
        build_host_tables,
        upload_tables,
    )

    tables = build_host_tables(corpus.blob, corpus.offsets, corpus.values,
                               corpus.voffs)
    mark("tables")
    return QueryEngine(upload_tables(tables, device=device), tables=tables,
                       device=device)


def forbidden_modules() -> List[str]:
    """FORBIDDEN names among the loaded modules' top-level names (the part
    before the first dot, compared whole)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def drawn_calls(seed: int) -> set:
    """Window calls whose results the check holds, besides the last one:
    KEPT_CALLS drawn from the seed among the first KEEP_FROM."""
    rng = np.random.default_rng([int(seed), 3])
    return {int(w) for w in rng.choice(KEEP_FROM, size=KEPT_CALLS,
                                       replace=False)}


def rows_of_calls(stream, calls) -> np.ndarray:
    """Window rows of prepared calls `calls`."""
    qpc = stream.queries_per_call
    return np.concatenate([np.arange(c * qpc, (c + 1) * qpc) for c in calls])


@dataclass
class Window:
    times: List[float] = field(default_factory=list)     # seconds a call
    stats: List[Optional[dict]] = field(default_factory=list)
    written: List[np.ndarray] = field(default_factory=list)  # ids a query
    kept: Dict[int, list] = field(default_factory=dict)  # prepared index
    seconds: float = 0.0
    trace: Optional[devtrace.Trace] = None


@dataclass
class Ctx:
    """What a per-layer metric reader gets."""

    stats: List[Optional[dict]]
    trace: Optional[devtrace.Trace]
    queries: int
    least_bytes: int
    peak_bytes_per_s: float = work.PEAK_BYTES_PER_S


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e!r}"


def window(gen, eng, stream, seconds: float, seed: int,
           traced: bool) -> Window:
    """The measured window: calls until `seconds` have passed, the last one
    finished; results of the kept calls held for the check."""
    n = len(stream.calls)
    want = drawn_calls(seed)
    w = Window()
    if traced:
        seconds = min(seconds, TRACED_SECONDS)
    span = devtrace.call_span if traced else contextlib.nullcontext
    prof = devtrace.profiler() if traced else None
    with prof if prof is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        deadline = t0 + seconds
        res, te = None, t0
        while te < deadline:
            call = stream.calls[len(w.times) % n]
            ts = time.perf_counter()
            with span():
                res, stats = gen.serve(eng, stream, call)
            te = time.perf_counter()
            w.times.append(te - ts)
            w.stats.append(stats)
            w.written.append(gen.written(stream, res))
            if len(w.times) - 1 in want:
                w.kept[(len(w.times) - 1) % n] = res
        w.kept[(len(w.times) - 1) % n] = res
        w.seconds = te - t0
    if prof is not None:
        w.trace = devtrace.read(prof)
    return w


def run(workload: str, seed: int, seconds: float, traced: bool, device,
        decl: Optional[dict] = None, cfg: Optional[dict] = None,
        mix: Optional[dict] = None, t_start: Optional[float] = None,
        log=None) -> dict:
    """One run of one cell; returns the result line's object."""
    import torch

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    decl = decl if decl is not None else load_declaration()
    cell, cfg_file, mix_file = load_cell(decl, workload)
    cfg = cfg if cfg is not None else cfg_file
    mix = mix if mix is not None else mix_file
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    marks = {}

    def mark(name):
        marks[name] = time.perf_counter()

    mark("imports")
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=dev)
    mark("cuda")
    corp = corpus_mod.generate(cfg, seed, dev, mark)
    mark("corpus")
    gen = traffic(mix)
    stream = gen.build(mix, corp, seed)
    mark("stream")
    gen_peak = 0
    if on_card:
        torch.cuda.synchronize(dev)
        gen_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    if hasattr(gen, "engine"):
        eng = gen.engine(corp, dev)
    else:
        eng = default_engine(corp, dev, mark)
    _sync(torch, dev)
    mark("engine")
    for call in stream.warm:
        gen.serve(eng, stream, call)
    _sync(torch, dev)
    mark("warm")
    setup_s = time.perf_counter() - t_start
    log(f"[bench] {workload} seed {seed}: set-up {setup_s:.3f} s (imports "
        f"{marks['imports'] - t_start:.3f}, card "
        f"{marks['cuda'] - marks['imports']:.3f}, terms "
        f"{marks['terms'] - marks['cuda']:.3f}, lists "
        f"{marks['lists'] - marks['terms']:.3f}, stream "
        f"{marks['stream'] - marks['corpus']:.3f}, tables "
        f"{marks.get('tables', marks['stream']) - marks['stream']:.3f}, "
        f"upload {marks['engine'] - marks.get('tables', marks['stream']):.3f}"
        f", warm-up "
        f"{marks['warm'] - marks['engine']:.3f}); {corp.n_terms} terms, "
        f"{len(corp.values)} postings, {len(stream.calls)} calls of "
        f"{stream.queries_per_call} queries")

    win = window(gen, eng, stream, seconds, seed, traced)
    _sync(torch, dev)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    n_calls = len(win.times)
    n = len(stream.calls)
    if n_calls > n:
        log(f"[bench] the window outlasted its {n} calls and served them "
            f"again ({n_calls} calls)")
    del eng
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the check, once the program's state is freed
    t_chk = time.perf_counter()
    kept = sorted(win.kept)
    rows = rows_of_calls(stream, kept)
    picks = check_mod.draw_sample(gen.classes(stream, corp, rows),
                                  mix["check"]["per_class"], seed)
    ref = Reference(corp.values, corp.voffs, corp.D)
    qpc = stream.queries_per_call
    verdict = check_mod.compare(
        picks, lambda row: gen.answer_of(stream, win.kept[row // qpc], row),
        lambda row: gen.expected(stream, ref, row),
        lambda got, want: gen.same(stream, got, want))
    n_wrong, n_missing = len(verdict["wrong"]), len(verdict["missing"])
    correct = verdict["compared"] > 0 and n_wrong == 0 and n_missing == 0
    log(f"[bench] compared {verdict['compared']} answers of calls {kept} "
        f"in {time.perf_counter() - t_chk:.3f} s, by class "
        f"{verdict['by_class']}; wrong rows {verdict['wrong'][:8]}, "
        f"unanswered rows {verdict['missing'][:8]}")

    queries = n_calls * stream.queries_per_call
    times = np.array(win.times)
    log(f"[bench] window {win.seconds:.3f} s, {n_calls} calls, call s "
        f"min {times.min():.4f} median {np.median(times):.4f} max "
        f"{times.max():.4f}; device peak {peak} B (generator {gen_peak} B)")
    result = {"correct": bool(correct), "attempted": int(queries),
              "failed": n_wrong + n_missing}
    if not traced:
        metrics = {
            "qps": (queries / win.seconds, "queries/s"),
            "p95_call_ms": (float(np.percentile(times, 95)) * 1e3, "ms"),
            "device_peak_gb": (peak / 1e9, "GB"),
            "setup_s": (setup_s, "s"),
        }
        wanted = [m["name"] for m in decl["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    else:
        answered = rows_of_calls(stream, [w % n for w in range(n_calls)])
        ctx = Ctx(stats=win.stats, trace=win.trace, queries=queries,
                  least_bytes=gen.least_bytes(stream, corp, answered,
                                              np.concatenate(win.written)))
        metrics = {}
        for m in decl["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            reader = load_module(os.path.join(BENCH, "metrics",
                                              m["name"] + ".py"),
                                 "metric_" + m["name"])
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = (float(v), m["unit"])
        wanted = list(metrics)
    result["metrics"] = {k: {"value": metrics[k][0], "unit": metrics[k][1]}
                         for k in wanted if k in metrics}
    device_info = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": 1,
        "memory_peak_bytes": int(max(peak, gen_peak)),
    }
    if traced:
        device_info["busy_s"] = win.trace.busy_s
        device_info["window_s"] = win.trace.window_s
    result["device"] = device_info
    if traced:
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in win.trace.device_ops],
            "idle_gaps": [[k, v] for k, v in win.trace.idle_gaps]}
        log(f"[bench] trace: window {win.trace.window_s:.6f} s, busy "
            f"{win.trace.busy_s:.6f} s, kernels {win.trace.kernel_s:.6f} s "
            f"in {win.trace.launches} launches")
    checks = {"wrong_answers": (n_wrong, 0), "unanswered": (n_missing, 0),
              "answers_compared": (verdict["compared"], 1)}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    if on_card:
        log(f"[bench] card: {card_line()}")
    log(f"check wrong_answers {n_wrong} limit 0 (at most)")
    log(f"check unanswered {n_missing} limit 0 (at most)")
    log(f"check answers_compared {verdict['compared']} limit 1 (at least)")
    return result
