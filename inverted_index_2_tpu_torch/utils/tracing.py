"""Spans of the serving streams (models/staged.py).

Tracing is on while a torch.profiler session records, or after
enable(True). Off, span() returns one shared null context: no clock is read
and no profiler record is built. On, a span inside a call (the root span
ROOT, `tpi.stream`, around one boolean_staged or lookup_staged call)

  * enters a profiler record named `name` when a profiler records, so the
    span lies in the profiler's trace, on the host's timeline and the
    clock of the card's kernels. The record is torch's RecordFunction in
    function scope (an event of kind cpu_op), not a user annotation
    (torch.profiler.record_function): the profiler copies a user
    annotation onto the card's timeline over the kernels launched inside
    it, and an event list without activity types (torch 2.11) cannot tell
    that copy from a kernel;
  * keeps (name, parent, start, end) on a per-thread stack, read with
    perf_counter_ns.

A span outside every call (a stage that boolean() shares with the streams)
records nothing. When the root ends, the call's spans reduce to
{name: [count, inclusive_ns, self_ns]} in the root's `spans`, where a
span's self time is its duration less the part its child spans cover; the
stream puts them in its engine's last_stream_stats["spans"]:

    from inverted_index_2_tpu_torch.utils import tracing
    tracing.enable(True)
    eng.boolean_staged(batches, "and", columnar=True)
    print(eng.last_stream_stats["spans"])

Names are `tpi.<stage>`; a name never nests inside itself, so a name's
inclusive time counts no interval twice.
"""
from __future__ import annotations

import threading
from contextlib import nullcontext
from time import perf_counter_ns
from typing import Dict, List, Optional

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast as record_function

ROOT = "tpi.stream"

_OFF = nullcontext()
_enabled = False
_local = threading.local()


def enable(on: bool = True) -> None:
    """Record spans without a profiler (on) or only while one records
    (off, the default)."""
    global _enabled
    _enabled = bool(on)


def span(name: str):
    """A context manager around one stage; the shared null context while
    tracing is off or outside a call. Entered, it gives the _Span (None
    when it records nothing)."""
    if not (_enabled or getattr(_autograd_profiler, "_is_profiler_enabled",
                                False)):
        return _OFF
    t = _thread()
    if not t.stack and name != ROOT:
        return _OFF
    return _Span(name, t)


def _thread():
    t = _local
    if not hasattr(t, "stack"):
        t.stack = []          # indexes into t.spans of the open spans
        t.spans = []          # [name, parent index, start_ns, end_ns]
    return t


class _Span:
    __slots__ = ("name", "_t", "_rf", "_i", "spans")

    def __init__(self, name: str, t):
        self.name = name
        self._t = t
        self._rf = None
        self.spans: Optional[Dict[str, List[int]]] = None

    def __enter__(self):
        if getattr(_autograd_profiler, "_is_profiler_enabled", False):
            self._rf = record_function(self.name)
            self._rf.__enter__()
        t = self._t
        self._i = len(t.spans)
        t.spans.append([self.name, t.stack[-1] if t.stack else -1,
                        perf_counter_ns(), 0])
        t.stack.append(self._i)
        return self

    def __exit__(self, *exc):
        t = self._t
        t.spans[self._i][3] = perf_counter_ns()
        t.stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if not t.stack:
            self.spans = reduce(t.spans)
            t.spans = []
        return False


def reduce(spans) -> Dict[str, List[int]]:
    """{name: [count, inclusive_ns, self_ns]} of one call's spans
    ([name, parent index, start_ns, end_ns], parents before children)."""
    covered = [0] * len(spans)
    for name, parent, t0, t1 in spans:
        if parent >= 0:
            covered[parent] += t1 - t0
    out: Dict[str, List[int]] = {}
    for (name, _, t0, t1), kids in zip(spans, covered):
        row = out.setdefault(name, [0, 0, 0])
        row[0] += 1
        row[1] += t1 - t0
        row[2] += t1 - t0 - kids
    return out
