"""The roofline's byte count, the trace reduction and the metric readers,
on hand-made inputs."""
import os
import types

import numpy as np
import pytest

import devtrace
import harness
import work
from conftest import BENCH


def _stream(op, qpos, qid):
    qpos = np.array(qpos, np.int64)
    return types.SimpleNamespace(op=op, qpos=qpos, qid=np.array(qid),
                                 kv=(qpos >= 0).sum(axis=1))


# a corpus of four lists: lengths 3, 200, 200, 1 with codec bytes by hand
CORPUS = types.SimpleNamespace(df=np.array([3, 200, 200, 1]),
                               enc_bytes=np.array([20, 400, 300, 12]))


def test_and_counts_the_shortest_list_once_per_distinct_query():
    st = _stream("and", [[1, 0, -1], [1, 2, -1], [1, 0, -1], [3, 1, 2]],
                 [7, 8, 7, 9])
    rows = np.array([0, 1, 2, 3, 0])
    ids = np.array([2, 50, 2, 1, 2])
    # query 7: list 0 (20 B) + 2 ids; query 8: lists 1 and 2 are as long,
    # the fewer bytes (300) + 50 ids; query 9: list 3 (12 B) + 1 id
    assert work.least_bytes(st, CORPUS, rows, ids) == \
        20 + 8 + 300 + 200 + 12 + 4


def test_or_page_counts_every_list():
    st = _stream("or", [[0, 1, 3], [2, -1, -1]], [0, 1])
    assert work.least_bytes(st, CORPUS, np.array([0, 1, 1]),
                            np.array([32, 32, 32])) == \
        20 + 400 + 12 + 128 + 300 + 128


def test_union_merges_overlaps():
    s, e = devtrace._union(np.array([5, 0, 2, 20]), np.array([8, 3, 4, 25]))
    assert s.tolist() == [0, 5, 20] and e.tolist() == [4, 8, 25]


class _Ev:
    def __init__(self, kind, name, t0, t1, cuda):
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


def _events(cls):
    ms = 1_000_000
    return [
        cls("user_annotation", "bench.call", 0, 40 * ms, False),
        cls("user_annotation", "bench.call", 50 * ms, 100 * ms, False),
        cls("kernel", "K2", 5 * ms, 15 * ms, True),
        cls("kernel", "K4", 10 * ms, 20 * ms, True),
        cls("gpu_memcpy", "Memcpy DtoH", 60 * ms, 70 * ms, True),
        cls("kernel", "K2", 120 * ms, 130 * ms, True),      # after the window
        cls("cpu_op", "aten::copy_", 20 * ms, 60 * ms, False),
        cls("cpu_op", "aten::inner", 30 * ms, 35 * ms, False),
    ]


@pytest.mark.parametrize("cls", [_Ev, _OldEv])
def test_trace_reduction_by_hand(cls):
    tr = devtrace.read(_prof(_events(cls)))
    assert tr.window_s == pytest.approx(0.1)
    assert tr.busy_s == pytest.approx(0.025)         # 5-20 and 60-70 ms
    assert tr.kernel_s == pytest.approx(0.020)
    assert tr.launches == 2
    assert tr.device_ops[0][0] == "K2" or tr.device_ops[0][0] == "K4"
    labels = dict(tr.idle_gaps)
    # gaps 0-5 (no op), 20-60 (middle 40 ms: aten::copy_), 70-100
    assert labels["aten::copy_"] == pytest.approx(0.040)
    assert labels[devtrace.NO_OP] == pytest.approx(0.035)


def test_a_trace_without_device_work_fails():
    evs = [e for e in _events(_Ev) if e._k != "kernel"
           and e._k != "gpu_memcpy"]
    with pytest.raises(RuntimeError, match="no device work"):
        devtrace.read(_prof(evs))


def _reader(name):
    return harness.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                               "metric_" + name)


def test_readers_by_hand():
    tr = devtrace.Trace(window_s=2.0, busy_s=0.5, kernel_s=0.4, launches=300)
    stats = [{"queries": 100, "served_rows": 60, "small_p_overflow": 5,
              "ladder_reserve": 3, "concat": 2}, None,
             {"queries": 100, "served_rows": 40, "small_p_overflow": 0,
              "ladder_reserve": 0, "concat": 0}]
    ctx = harness.Ctx(stats=stats, trace=tr, queries=200,
                      least_bytes=int(0.1 * 3.35e12))
    assert _reader("and_followup_pct").read(ctx) == pytest.approx(5.0)
    assert _reader("kernels_roofline_pct").read(ctx) == pytest.approx(25.0)
    assert _reader("device_launches_per_kq").read(ctx) == \
        pytest.approx(1500.0)
    assert _reader("device_idle_pct").read(ctx) == pytest.approx(75.0)
    none = harness.Ctx(stats=[None], trace=None, queries=0, least_bytes=0)
    for name in ("and_followup_pct", "kernels_roofline_pct",
                 "device_launches_per_kq", "device_idle_pct"):
        assert _reader(name).read(none) is None
