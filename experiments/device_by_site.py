#!/usr/bin/env python3
"""A cell's device time by the place that launched it: one traced run of
the benchmark (as `benchmark/run.py --trace 1` makes it) whose kernels,
copies and memsets are each put under the innermost `tpi.*` span and the
innermost torch operation (`aten::...`) around the host call that launched
them, matched through the profiler's correlation ids. The torch elementwise
kernels carry no caller in their names; this says which stage launched them
(the concat stream's dispatch, where the wire meta runs, or the harvest,
where the pack runs).

    python3 experiments/device_by_site.py --workload <cell> --seed <n> \
        [--seconds 15] [--top 30]

Prints the run's lines on standard error, then `[site] <seconds> s
<launches> x <span> | <torch op> | <kernel>` for the largest sites of the
window, and last the run's result object with "device_by_site" added: a
list of [span, torch op, kernel, seconds, launches], largest first. Where
the profiler's events carry no correlation id that ties a kernel to its
launch (torch 2.11 on the H100 did not), span and op read "-" and only the
kernels' own totals remain. The card only: it exits 2 without CUDA.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
sys.path[:0] = [p for p in (BENCH, REPO) if p not in sys.path]

import devtrace  # noqa: E402

NONE = "-"


def _thread(e):
    f = getattr(e, "start_thread_id", None)
    return f() if f else 0


def _correlation(e):
    for attr in ("correlation_id", "linked_correlation_id"):
        f = getattr(e, attr, None)
        if f is not None and f():
            return f()
    return 0


def _innermost(iv, queries):
    """iv: one thread's host intervals (t0, t1, name), which nest; queries:
    (t, key). Returns {key: the name of the innermost interval around t}."""
    iv = sorted(iv, key=lambda x: (x[0], -x[1]))
    stack, j, out = [], 0, {}
    for t, key in sorted(queries):
        while j < len(iv) and iv[j][0] <= t:
            while stack and stack[-1][1] < iv[j][0]:
                stack.pop()
            stack.append(iv[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = stack[-1][2] if stack else NONE
    return out


def by_site(events):
    """events: (kind, name, t0, t1, thread, correlation) tuples of one
    window's trace, kind as devtrace._kind names it. Returns {(span, torch
    op, kernel): [seconds, launches]} over the device work."""
    spans, ops, launch = {}, {}, {}
    for kind, name, t0, t1, th, corr in events:
        if kind in ("cpu_op", "user_annotation") and name.startswith("tpi."):
            spans.setdefault(th, []).append((t0, t1, name))
        elif kind == "cpu_op":
            ops.setdefault(th, []).append((t0, t1, name))
        elif kind in ("cuda_runtime", "cuda_driver") and corr:
            launch[corr] = (th, t0)
    where = {}
    for th in set(th for th, _ in launch.values()):
        q = [(t, c) for c, (lth, t) in launch.items() if lth == th]
        sp = _innermost(spans.get(th, []), q)
        op = _innermost(ops.get(th, []), q)
        for _, c in q:
            where[c] = (sp[c], op[c])
    out = {}
    for kind, name, t0, t1, th, corr in events:
        if kind not in devtrace.DEVICE_WORK:
            continue
        key = where.get(corr, (NONE, NONE)) + (devtrace._short(name, 64),)
        got = out.setdefault(key, [0.0, 0])
        got[0] += (t1 - t0) / 1e9
        got[1] += 1
    return out


def _events(prof):
    """The traced window's events as by_site takes them."""
    evs = []
    for e in prof.profiler.kineto_results.events():
        t0, t1 = devtrace._span_ns(e)
        evs.append((devtrace._kind(e), e.name(), t0, t1, _thread(e),
                    _correlation(e)))
    calls = [(t0, t1) for k, n, t0, t1, _, _ in evs
             if k == "user_annotation" and n == devtrace.CALL]
    w0, w1 = min(c[0] for c in calls), max(c[1] for c in calls)
    return [e for e in evs if e[3] > w0 and e[2] < w1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)
    for k in [k for k in os.environ if k.startswith("TPI_")]:
        del os.environ[k]
    import harness
    import torch

    if not torch.cuda.is_available():
        print("[site] CUDA is not available: no card to measure",
              file=sys.stderr)
        return 2
    found = {}
    read = devtrace.read

    def read_and_split(prof):
        found["sites"] = by_site(_events(prof))
        return read(prof)

    devtrace.read = read_and_split
    try:
        with contextlib.redirect_stdout(sys.stderr):
            result = harness.run(args.workload, args.seed, args.seconds,
                                 True, "cuda")
    finally:
        devtrace.read = read
    sites = sorted(([*k, v[0], v[1]] for k, v in found["sites"].items()),
                   key=lambda r: -r[3])
    for span, op, kern, s, n in sites[: args.top]:
        print(f"[site] {s:.6f} s {n} x {span} | {op} | {kern}",
              file=sys.stderr)
    result["device_by_site"] = sites
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
