"""The program's spans in the benchmark, on hand-made inputs: the idle and
host-sync splits of idle_spans.py, the trace reduction left as it was
beside the spans, and the readers of the span shares and the stream
counters."""
import os
import types

import pytest

import devtrace
import harness
import idle_spans
from conftest import BENCH

MS = 1_000_000


class _Ev:
    def __init__(self, kind, name, t0, t1, cuda=False):
        self._k, self._n, self._t0, self._t1, self._c = kind, name, t0, t1, cuda

    def activity_type(self):
        return self._k

    def name(self):
        return self._n

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._t1 - self._t0

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"


class _OldEv(_Ev):
    """An event of an older torch: no activity_type, microseconds."""

    def __getattribute__(self, n):
        if n in ("activity_type", "start_ns"):
            raise AttributeError(n)
        return object.__getattribute__(self, n)

    def start_us(self):
        return self._t0 / 1000

    def duration_us(self):
        return (self._t1 - self._t0) / 1000


def _prof(evs):
    kr = types.SimpleNamespace(events=lambda: evs)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=kr))


# the window 0-100 ms; the card works 10-20 and 50-60, so it idles 0-10,
# 20-50 and 60-100
WORK = [("user_annotation", "bench.call", 0, 100, False),
        ("kernel", "K2", 10, 20, True),
        ("gpu_memcpy", "Memcpy DtoH", 50, 60, True),
        ("cpu_op", "aten::copy_", 20, 60, False)]
# the program's spans: a pack that starts with the call and straddles the
# first gap's end, a harvest with a wait inside across the copy, and an
# assembly inside the last gap
SPANS = [("tpi.stream", 5, 95), ("tpi.pack", 5, 15), ("tpi.harvest", 30, 70),
         ("tpi.wait", 40, 55), ("tpi.assemble", 80, 90)]
WANT = {idle_spans.NO_SPAN: 10, "tpi.pack": 5, "tpi.stream": 25,
        "tpi.harvest": 20, "tpi.wait": 10, "tpi.assemble": 10}


def _events(cls, spans=True, mirrors=False, kind="cpu_op"):
    evs = [cls(k, n, t0 * MS, t1 * MS, c) for k, n, t0, t1, c in WORK]
    if spans:
        evs += [cls(kind, n, t0 * MS, t1 * MS) for n, t0, t1 in SPANS]
    if mirrors:
        # the card's copy of an annotation over the kernels it covers
        evs += [cls("gpu_user_annotation", n, t0 * MS, t1 * MS, True)
                for n, t0, t1 in SPANS[2:3]]
    return evs


@pytest.mark.parametrize("kind", ["cpu_op", "user_annotation"])
@pytest.mark.parametrize("cls", [_Ev, _OldEv])
def test_idle_split_by_the_innermost_span(cls, kind):
    by = idle_spans.idle_by_span(_prof(_events(cls, mirrors=True,
                                               kind=kind)))
    assert set(by) == set(WANT)
    for name, ms in WANT.items():
        assert by[name] == pytest.approx(ms / 1e3, abs=1e-12), name
    assert sum(by.values()) == pytest.approx(0.080)


def test_every_gap_is_split_not_only_the_longest():
    # 3,000 gaps of 1 ms, one span over the second half of them
    evs = [_Ev("user_annotation", "bench.call", 0, 6000 * MS)]
    evs += [_Ev("kernel", "k", (2 * i + 1) * MS, (2 * i + 2) * MS, True)
            for i in range(3000)]
    evs += [_Ev("user_annotation", "tpi.stream", 3000 * MS, 6000 * MS)]
    by = idle_spans.idle_by_span(_prof(evs))
    assert by["tpi.stream"] == pytest.approx(1.5)
    assert by[idle_spans.NO_SPAN] == pytest.approx(1.5)


def test_split_on_hand_made_gaps():
    spans = [(0, 10, "tpi.a"), (2, 4, "tpi.b"), (4, 10, "tpi.c"),
             (12, 14, "tpi.a")]
    by = idle_spans.split(spans, [1, 5, 11], [3, 8, 20], 0, 20)
    assert by == {"tpi.a": pytest.approx(3e-9), "tpi.b": pytest.approx(1e-9),
                  "tpi.c": pytest.approx(3e-9),
                  idle_spans.NO_SPAN: pytest.approx(7e-9)}


def test_no_span_no_split():
    assert idle_spans.idle_by_span(_prof(_events(_Ev, spans=False))) == {}
    assert idle_spans.sync_by_span(_prof(_events(_Ev, spans=False))) == {}


# the host's blocking runtime calls: one inside the wait, one hidden in the
# harvest's own time, two overlapping ones outside every span, and calls
# that do not block (a launch, an asynchronous copy), which do not count
SYNCS = [("cudaStreamSynchronize", 42, 50), ("cudaEventSynchronize", 60, 64),
         ("cudaStreamSynchronize", 96, 98), ("cudaDeviceSynchronize", 97, 99),
         ("cudaLaunchKernel", 6, 9), ("cudaMemcpyAsync", 31, 33)]


@pytest.mark.parametrize("cls", [_Ev, _OldEv])
def test_host_sync_split_by_the_innermost_span(cls):
    evs = _events(cls) + [cls("cuda_runtime", n, t0 * MS, t1 * MS)
                          for n, t0, t1 in SYNCS]
    by = idle_spans.sync_by_span(_prof(evs))
    assert by == {"tpi.wait": pytest.approx(0.008),
                  "tpi.harvest": pytest.approx(0.004),
                  idle_spans.NO_SPAN: pytest.approx(0.003)}
    # the idle split does not change beside them
    assert idle_spans.idle_by_span(_prof(evs)) == \
        pytest.approx({k: v / 1e3 for k, v in WANT.items()})


@pytest.mark.parametrize("cls", [_Ev, _OldEv])
def test_the_trace_reduction_is_unchanged_beside_the_spans(cls):
    plain = devtrace.read(_prof(_events(cls, spans=False)))
    assert plain.busy_s == pytest.approx(0.020)
    assert plain.launches == 1
    labels = dict(plain.idle_gaps)
    assert labels["aten::copy_"] == pytest.approx(0.030)
    assert labels[devtrace.NO_OP] == pytest.approx(0.050)
    traced = devtrace.read(_prof(_events(cls)))
    # the spans are host events: they never count as device work, and a
    # gap's label, the innermost host event at its middle, may be a span
    for f in ("window_s", "busy_s", "kernel_s", "launches", "device_ops"):
        assert getattr(traced, f) == getattr(plain, f), f
    assert sum(v for _, v in traced.idle_gaps) == \
        pytest.approx(sum(v for _, v in plain.idle_gaps))
    assert dict(traced.idle_gaps) == {"tpi.stream": pytest.approx(0.010),
                                      "tpi.harvest": pytest.approx(0.030),
                                      "tpi.assemble": pytest.approx(0.040)}


def test_the_split_line_reads_in_percent_of_the_window():
    assert idle_spans.line({"tpi.wait": 0.5, idle_spans.NO_SPAN: 0.25},
                           2.0) == \
        "[bench] idle by span: tpi.wait 25.00%, outside tpi spans 12.50%"
    assert idle_spans.line({"tpi.wait": 0.5}, 2.0, "host sync") == \
        "[bench] host sync by span: tpi.wait 25.00%"


def _reader(name):
    return harness.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                               "metric_" + name)


SPAN_METRICS = ("pack_pct", "launch_pct", "wait_pct", "assemble_pct",
                "followup_time_pct", "upload_pct")
COUNTER_METRICS = ("concat_singles_per_kq", "host_route_pct")


def _stats(spans=True):
    a = {"queries": 100, "concat_singles": 2, "host_queries": 0,
         "route": "device"}
    b = {"queries": 300, "concat_singles": 6, "host_queries": 100,
         "route": "hybrid"}
    if spans:
        a["spans"] = {"tpi.stream": [1, 1000, 100], "tpi.pack": [2, 50, 50],
                      "tpi.dedup": [2, 30, 30], "tpi.dispatch": [3, 300, 160],
                      "tpi.upload": [6, 40, 40], "tpi.wait": [4, 150, 150],
                      "tpi.followups": [1, 400, 20],
                      "tpi.harvest": [2, 120, 70],
                      "tpi.assemble": [1, 80, 80]}
        b["spans"] = {"tpi.stream": [1, 3000, 300], "tpi.pack": [2, 150, 150],
                      "tpi.resolve": [2, 120, 100],
                      "tpi.dispatch": [2, 900, 700],
                      "tpi.wait": [3, 250, 250],
                      "tpi.harvest": [2, 400, 300],
                      "tpi.assemble": [2, 100, 100]}
    return [a, None, b]


def test_span_and_counter_readers_by_hand():
    ctx = harness.Ctx(stats=_stats(), trace=None, queries=400, least_bytes=0)
    got = {m: _reader(m).read(ctx) for m in SPAN_METRICS + COUNTER_METRICS}
    assert got["pack_pct"] == pytest.approx(100 * (50 + 30 + 150 + 100)
                                            / 4000)
    assert got["launch_pct"] == pytest.approx(100 * 860 / 4000)
    assert got["wait_pct"] == pytest.approx(100 * 440 / 4000)
    assert got["upload_pct"] == pytest.approx(100 * 40 / 4000)
    assert got["assemble_pct"] == pytest.approx(100 * (70 + 80 + 300 + 100)
                                                / 4000)
    assert got["followup_time_pct"] == pytest.approx(100 * 400 / 4000)
    assert got["concat_singles_per_kq"] == pytest.approx(1000 * 8 / 400)
    assert got["host_route_pct"] == pytest.approx(100 * 100 / 400)


def test_readers_give_none_without_spans_or_counters():
    bare = harness.Ctx(stats=_stats(spans=False), trace=None, queries=400,
                       least_bytes=0)
    for m in SPAN_METRICS:
        assert _reader(m).read(bare) is None
    # the stats of a program without the counters (AND keys alone)
    old = [{"queries": 100, "served_rows": 100, "small_p_overflow": 0,
            "ladder_reserve": 0, "concat": 0}, None]
    none = harness.Ctx(stats=old, trace=None, queries=100, least_bytes=0)
    for m in SPAN_METRICS + COUNTER_METRICS:
        assert _reader(m).read(none) is None
    empty = harness.Ctx(stats=[None], trace=None, queries=0, least_bytes=0)
    for m in SPAN_METRICS + COUNTER_METRICS:
        assert _reader(m).read(empty) is None
