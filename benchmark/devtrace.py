"""The traced run's reading of the device: torch.profiler (CUPTI) over the
measured window, reduced to what the per-layer metrics and the breakdown
need. The benchmark marks each call with a `bench.call` annotation; the
traced window runs from the first call's start to the last call's end.

Device work is every kernel, copy and memset on the card. Busy time is the
length of their union inside the window; an idle gap is labelled with the
innermost host operation the profiler saw running at its middle.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

CALL = "bench.call"
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
LABELLED_GAPS = 2000       # the longest gaps that get a host label
NO_OP = "host outside torch ops (numpy, Python)"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: float                       # summed kernel durations
    launches: int                         # kernels in the window
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def profiler():
    """A profiler of host operations and the card, to enter around the
    window."""
    import torch

    # the session is one cycle; torch's note on cycles does not apply
    warnings.filterwarnings("ignore", message="Profiler clears events")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def call_span():
    """The annotation around one call of the traced window."""
    import torch

    return torch.profiler.record_function(CALL)


def _short(name: str, n: int = 96) -> str:
    name = " ".join(name.split())
    return name if len(name) <= n else name[: n - 3] + "..."


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of [starts, ends), sorted."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.nonzero(new)[0]
    last = np.append(idx[1:] - 1, len(s) - 1)
    return s[idx], run_end[last]


def _kind(e) -> str:
    """The event's kind as newer torch names it (activity_type): by the
    device and the name where the event has no such field."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if name == CALL:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "user_annotation" if name == CALL else "cpu_op"


def _span_ns(e):
    if hasattr(e, "start_ns"):
        t0 = e.start_ns()
        return t0, t0 + e.duration_ns()
    t0 = int(e.start_us() * 1000)
    return t0, t0 + int(e.duration_us() * 1000)


def read(prof) -> Trace:
    """Reduce a finished profiler session. Raises when no device work was
    recorded, rather than reporting an idle card."""
    evs = prof.profiler.kineto_results.events()
    calls, dev, host = [], [], []
    for e in evs:
        act = _kind(e)
        t0, t1 = _span_ns(e)
        if act == "user_annotation" and e.name() == CALL:
            calls.append((t0, t1))
        elif act in DEVICE_WORK:
            dev.append((t0, t1, act == "kernel", e.name()))
        elif act in ("cpu_op", "cuda_runtime", "cuda_driver"):
            host.append((t0, t1, e.name()))
    if not calls:
        raise RuntimeError("the trace holds no bench.call annotation")
    w0 = min(c[0] for c in calls)
    w1 = max(c[1] for c in calls)
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    if not dev:
        raise RuntimeError("the profiler recorded no device work in the "
                           "window: the card's trace is missing")
    ds = np.clip(np.array([d[0] for d in dev], np.int64), w0, w1)
    de = np.clip(np.array([d[1] for d in dev], np.int64), w0, w1)
    us, ue = _union(ds, de)
    busy = int((ue - us).sum())
    kern = [d for d in dev if d[2]]
    by_name: Dict[str, int] = {}
    for d in kern:
        by_name[d[3]] = by_name.get(d[3], 0) + (d[1] - d[0])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # idle gaps inside the window, the longest labelled by the host
    gs = np.concatenate([[w0], ue])
    ge = np.concatenate([us, [w1]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    order = np.argsort(gs - ge, kind="stable")[:LABELLED_GAPS]
    hs = np.array([h[0] for h in host], np.int64)
    he = np.array([h[1] for h in host], np.int64)
    idle: Dict[str, int] = {}
    for g in order:
        mid = (gs[g] + ge[g]) // 2
        inside = np.nonzero((hs <= mid) & (he >= mid))[0] if len(hs) else []
        label = (host[inside[np.argmax(hs[inside])]][2] if len(inside)
                 else NO_OP)
        idle[label] = idle.get(label, 0) + int(ge[g] - gs[g])
    rest = int((ge - gs).sum()) - sum(idle.values())
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[: 9 if rest else 10]
    if rest:
        gaps.append(("shorter gaps, not labelled", rest))
    return Trace(
        window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
        kernel_s=sum(d[1] - d[0] for d in kern) / 1e9, launches=len(kern),
        device_ops=[(_short(n), v / 1e9) for n, v in top],
        idle_gaps=[(_short(n), v / 1e9) for n, v in gaps])
