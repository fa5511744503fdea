#!/usr/bin/env python3
"""The card's idle time, and the host's blocking CUDA calls, named by the
program's spans. A stopgap beside run.py --trace 1 until devtrace.read
fills the split itself (ROADMAP.md, queue 4); no declared metric reads it.

The program marks its stages with `tpi.*` spans
(inverted_index_2_tpu_torch/utils/tracing.py), which the profiler records as
host events, on the clock of the card's kernels. idle_by_span(prof)
takes every idle interval of the traced window (the window, the device work
and its union as devtrace.read takes them) and splits it by the innermost
`tpi.*` span over each part of it, so that the card's idle time carries the
name of the host stage that left it idle; what no span covers goes under
NO_SPAN. sync_by_span(prof) splits the same way the host's time inside the
CUDA runtime calls in which it waits for the card (SYNC_CALLS; a copy from
or to pageable memory waits for every kernel queued before it), so that a
wait that no `tpi.wait` or `tpi.upload` span names shows under the span it
hides in.

    python3 benchmark/idle_spans.py --workload <cell> --seed <n> \
        [--seconds <s>]

makes one traced run of the cell, as run.py --trace 1 does, and prints after
its lines on standard error `[bench] idle by span: ...` and `[bench] host
sync by span: ...`, in percent of the traced window; the last line of
standard output is the run's result object with "idle_by_span" and
"sync_by_span" (seconds by span name) added.
"""
from __future__ import annotations

import argparse
import contextlib
import heapq
import json
import os
import sys
from typing import Dict

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import devtrace  # noqa: E402

SPAN_PREFIX = "tpi."
NO_SPAN = "outside tpi spans"


def _innermost(spans, w0: int, w1: int):
    """[w0, w1) cut where the innermost span changes: (bounds, the label of
    each piece, -1 outside every span, and the labels' names). The
    innermost of the spans over a point is the one that started last (of
    two that started together, the one that ends first)."""
    names = sorted({n for _, _, n in spans})
    code = {n: i for i, n in enumerate(names)}
    pts = []
    for t0, t1, n in spans:
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 > t0:
            pts.append((t0, 1, t1, code[n]))
            pts.append((t1, 0, t0, code[n]))
    pts.sort()                      # at one instant, ends before starts
    bounds, labels = [w0], []
    heap, ended, cur = [], {}, -1
    for t, start, other, c in pts:
        if t > bounds[-1]:
            bounds.append(t)
            labels.append(cur)
        if start:
            heapq.heappush(heap, (-t, other, c))
        else:
            key = (-other, t, c)
            ended[key] = ended.get(key, 0) + 1
            while heap and ended.get(heap[0], 0):
                ended[heap[0]] -= 1
                heapq.heappop(heap)
        cur = heap[0][2] if heap else -1
    if w1 > bounds[-1]:
        bounds.append(w1)
        labels.append(cur)
    return np.array(bounds, np.int64), np.array(labels, np.int64), names


def split(spans, gs, ge, w0: int, w1: int) -> Dict[str, float]:
    """Seconds of the idle gaps [gs, ge) (ns, sorted, disjoint, inside
    [w0, w1)) by the innermost of `spans` ((start_ns, end_ns, name)) over
    them; NO_SPAN for the rest."""
    gs = np.asarray(gs, np.int64)
    ge = np.asarray(ge, np.int64)
    bounds, labels, names = _innermost(spans, w0, w1)
    pre = np.concatenate([[0], np.cumsum(ge - gs)])
    # idle time before each bound: the gaps that start before it, less
    # the part of the last of them that lies after it
    k = np.searchsorted(gs, bounds, side="right")
    after = np.where(k > 0,
                     np.maximum(0, ge[np.maximum(k - 1, 0)] - bounds), 0)
    cum = pre[k] - after
    per = cum[1:] - cum[:-1]
    named = labels >= 0
    by = np.bincount(labels[named], weights=per[named],
                     minlength=len(names))
    out = {n: float(v) / 1e9 for n, v in zip(names, by) if v > 0}
    out[NO_SPAN] = float(pre[-1] - by.sum()) / 1e9
    return out


# the CUDA runtime calls in which the host waits for the card (a copy from
# or to pageable memory is cudaMemcpyAsync and then cudaStreamSynchronize)
SYNC_CALLS = frozenset(("cudaStreamSynchronize", "cudaEventSynchronize",
                        "cudaDeviceSynchronize", "cudaMemcpy"))


def _collect(prof):
    """The window's calls, device work, `tpi.*` spans and blocking runtime
    calls of a finished profiler session, as (start_ns, end_ns[, name])."""
    calls, dev, spans, syncs = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        act = devtrace._kind(e)
        t0, t1 = devtrace._span_ns(e)
        name = e.name()
        if name.startswith(SPAN_PREFIX):
            # the program's records are host events (cpu_op); a user
            # annotation of that name counts too, and its copy on the
            # card's timeline, which an older torch calls a kernel, is no
            # device work
            if act in ("user_annotation", "cpu_op"):
                spans.append((t0, t1, name))
        elif act == "user_annotation" and name == devtrace.CALL:
            calls.append((t0, t1))
        elif act in devtrace.DEVICE_WORK:
            dev.append((t0, t1))
        elif name in SYNC_CALLS:
            syncs.append((t0, t1))
    return calls, dev, spans, syncs


def _union_in(iv, w0: int, w1: int):
    """The union of intervals iv clipped to [w0, w1): sorted, disjoint
    (starts, ends)."""
    iv = [d for d in iv if d[1] > w0 and d[0] < w1]
    if not iv:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ds = np.clip(np.array([d[0] for d in iv], np.int64), w0, w1)
    de = np.clip(np.array([d[1] for d in iv], np.int64), w0, w1)
    return devtrace._union(ds, de)


def idle_by_span(prof, found=None) -> Dict[str, float]:
    """Idle seconds of a finished profiler session's window by span name
    and NO_SPAN; {} when the trace holds no `tpi.*` span."""
    calls, dev, spans, _ = found or _collect(prof)
    if not spans or not calls:
        return {}
    w0 = min(c[0] for c in calls)
    w1 = max(c[1] for c in calls)
    us, ue = _union_in(dev, w0, w1)
    gs = np.concatenate([[w0], ue])
    ge = np.concatenate([us, [w1]])
    keep = ge > gs
    return split(spans, gs[keep], ge[keep], w0, w1)


def sync_by_span(prof, found=None) -> Dict[str, float]:
    """Seconds of the window the host spent in SYNC_CALLS, by the innermost
    span over them and NO_SPAN; {} when the trace holds no `tpi.*` span."""
    calls, _, spans, syncs = found or _collect(prof)
    if not spans or not calls:
        return {}
    w0 = min(c[0] for c in calls)
    w1 = max(c[1] for c in calls)
    ss, se = _union_in(syncs, w0, w1)
    return split(spans, ss, se, w0, w1)


def line(by: Dict[str, float], window_s: float,
         what: str = "idle") -> str:
    """The stderr line of a split, in percent of the window."""
    return f"[bench] {what} by span: " + ", ".join(
        f"{k} {100.0 * v / window_s:.2f}%"
        for k, v in sorted(by.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    for k in [k for k in os.environ if k.startswith("TPI_")]:
        del os.environ[k]
    sys.path[:0] = [p for p in (BENCH, REPO) if p not in sys.path]
    import harness
    import torch

    if not torch.cuda.is_available():
        print("[bench] CUDA is not available: no card to measure",
              file=sys.stderr)
        return 2
    found = {}
    read = devtrace.read

    def read_and_split(prof):
        got = _collect(prof)
        found["idle_by_span"] = idle_by_span(prof, got)
        found["sync_by_span"] = sync_by_span(prof, got)
        return read(prof)

    devtrace.read = read_and_split
    try:
        with contextlib.redirect_stdout(sys.stderr):
            result = harness.run(args.workload, args.seed, args.seconds,
                                 True, "cuda")
    finally:
        devtrace.read = read
    window_s = result["device"]["window_s"]
    print(line(found["idle_by_span"], window_s), file=sys.stderr)
    print(line(found["sync_by_span"], window_s, "host sync"),
          file=sys.stderr)
    result.update(found)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
