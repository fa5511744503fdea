"""The port's span recorder (utils/tracing.py) and the staged streams'
counters, on the CPU: nothing recorded while tracing is off or outside a
call, the spans' nesting and self times under a CPU torch.profiler, the
concat singles and steps, and last_stream_stats on every route (device AND
and page streams, the host route, the hybrid stream, lookup_staged, the
delta window, an empty index)."""
import numpy as np
import pytest
import torch

from inverted_index_2_tpu_torch import InvertedIndex, QueryEngine
from inverted_index_2_tpu_torch.models import query_engine as port_qe
from inverted_index_2_tpu_torch.models import staged
from inverted_index_2_tpu_torch.models.snapshot import (
    _empty_tables,
    build_host_tables,
    upload_tables,
)
from inverted_index_2_tpu_torch.models.staged import STREAM_COUNTERS
from inverted_index_2_tpu_torch.utils import tracing

torch.set_num_threads(1)

L = 256
SIZES = [3000, 2600, 2200, 1800, 900, 600, 300, 200, 40, 12]
KEYS = set(STREAM_COUNTERS) | {"route"}

# the innermost span each span may lie in (the table in PERF.md section 3)
PARENTS = {
    "tpi.pack": {"tpi.stream"},
    "tpi.dedup": {"tpi.stream"},
    "tpi.resolve": {"tpi.stream", "tpi.followups"},
    "tpi.dispatch": {"tpi.stream", "tpi.followups"},
    "tpi.harvest": {"tpi.stream", "tpi.followups"},
    "tpi.followups": {"tpi.stream"},
    "tpi.assemble": {"tpi.stream", "tpi.harvest"},
    "tpi.wait": {"tpi.stream", "tpi.harvest", "tpi.dispatch",
                 "tpi.resolve", "tpi.assemble"},
    # never inside a wait, so wait_pct may sum the two
    "tpi.upload": {"tpi.dispatch", "tpi.resolve"},
}


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0x7ACE)
    lists = [np.unique(rng.integers(0, 20_000, size=s, dtype=np.uint32))
             for s in SIZES]
    terms = [f"t{i:05d}".encode() for i in range(len(lists))]
    voffs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    offs = np.arange(len(lists) + 1, dtype=np.int64) * 6
    tables = build_host_tables(b"".join(terms), offs, np.concatenate(lists),
                               voffs)
    return lists, terms, tables


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("TPI_HOST_BOOL", "0")
    monkeypatch.delenv("TPI_HYBRID", raising=False)
    yield
    tracing.enable(False)


def _engine(tables, keep=False):
    return QueryEngine(upload_tables(tables, device="cpu"), L=L,
                       tables=tables if keep else None, device="cpu")


def _and_batches(terms):
    t = terms
    qs = [[t[4], t[0]],          # base 900: a ladder re-serve
          [t[0], t[1]],          # base 2600: past the level cap, concat AND
          [t[6], t[7]],          # base 200: K2 at the pad
          [t[8], t[9]], [t[6]], [t[2], t[3], t[1]], [t[9], b"absent"]]
    return [qs * 3, qs[::-1] * 2]


def _or_batches(terms):
    t = terms
    qs = [[t[0], t[1]], [t[8], t[9]], [t[7]], [t[5], t[6], t[9]],
          [b"absent"]]
    return [qs * 2, qs[::-1]]


def _oracle(lists, terms, q, op):
    sets = [lists[terms.index(x)] if x in terms else np.zeros(0, np.uint32)
            for x in q]
    out = sets[0]
    for v in sets[1:]:
        out = np.intersect1d(out, v) if op == "and" else np.union1d(out, v)
    return out.astype(np.uint32)


def _serve(eng, kind, terms):
    if kind == "and":
        return eng.boolean_staged(_and_batches(terms), "and", columnar=True,
                                  depth=1)
    return eng.boolean_staged(_or_batches(terms), "or", columnar=True,
                              depth=1, prefix_p=4)


def _check(res, kind, lists, terms):
    batches = _and_batches(terms) if kind == "and" else _or_batches(terms)
    for r, qs in zip(res, batches):
        vals, voffs = r[0], r[1]
        for i, q in enumerate(qs):
            want = _oracle(lists, terms, q, kind if kind == "and" else "or")
            got = vals[voffs[i]: voffs[i + 1]]
            if kind == "and":
                assert np.array_equal(got, want), (q, got, want)
            else:
                assert np.array_equal(got, want[:4]) and r[2][i] == len(want)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert np.array_equal(u, v)


@pytest.fixture
def followups(monkeypatch):
    """Ladder re-serves up to 1024 ids; longer bases to the concat AND."""
    monkeypatch.setattr(port_qe, "MAX_LEVEL", 1024)


@pytest.fixture
def steps_run(monkeypatch):
    """The concat steps the streams launch, counted as they run."""
    calls = [0]
    real = staged.concat_step

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(staged, "concat_step", counted)
    return calls


@pytest.mark.parametrize("kind", ["and", "page"])
def test_off_builds_no_annotation_and_reads_no_clock(corpus, followups,
                                                     monkeypatch, kind):
    lists, terms, tables = corpus
    eng = _engine(tables)

    def boom(*a, **k):
        raise AssertionError("tracing is off")

    monkeypatch.setattr(tracing, "record_function", boom)
    monkeypatch.setattr(tracing, "perf_counter_ns", boom)
    with tracing.span("tpi.stream") as off:
        assert off is None
    res = _serve(eng, kind, terms)
    _check(res, kind, lists, terms)
    assert set(eng.last_stream_stats) == KEYS


def _tpi_events(prof):
    evs = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("tpi."):
            t0 = e.start_ns()
            evs.append((t0, t0 + e.duration_ns(), e.name()))
    return evs


def _innermost_parent(evs, i):
    t0, t1, _ = evs[i]
    best = None
    for j, (s0, s1, name) in enumerate(evs):
        if j != i and s0 <= t0 and t1 <= s1 and (s1 - s0) >= (t1 - t0):
            if best is None or (s0, -s1) > (evs[best][0], -evs[best][1]):
                best = j
    return None if best is None else evs[best][2]


@pytest.mark.parametrize("kind", ["and", "page"])
def test_spans_nest_as_tabled_and_self_times_sum_to_the_call(
        corpus, followups, kind):
    lists, terms, tables = corpus
    eng = _engine(tables)
    plain = _serve(eng, kind, terms)
    assert "spans" not in eng.last_stream_stats
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = _serve(eng, kind, terms)
    _same(plain, traced)
    _check(traced, kind, lists, terms)
    evs = _tpi_events(prof)
    names = {e[2] for e in evs}
    want = {"tpi.stream", "tpi.pack", "tpi.dedup", "tpi.dispatch",
            "tpi.upload", "tpi.harvest", "tpi.assemble"}
    want |= ({"tpi.followups", "tpi.resolve", "tpi.wait"} if kind == "and"
             else {"tpi.resolve"})
    assert want <= names
    assert sum(e[2] == "tpi.stream" for e in evs) == 1
    for i, (_, _, name) in enumerate(evs):
        parent = _innermost_parent(evs, i)
        if name == "tpi.stream":
            assert parent is None
        else:
            assert parent in PARENTS[name], (name, parent)
    spans = eng.last_stream_stats["spans"]
    assert set(spans) == names
    for name, (n, _, _) in spans.items():
        assert n == sum(e[2] == name for e in evs)
    root = spans["tpi.stream"][1]
    assert abs(sum(r[2] for r in spans.values()) - root) <= 0.01 * root
    for n, incl, own in spans.values():
        assert 0 <= own <= incl


def test_enable_records_calls_without_a_profiler(corpus, followups):
    lists, terms, tables = corpus
    eng = _engine(tables)
    tracing.enable(True)
    res = _serve(eng, "and", terms)
    _check(res, "and", lists, terms)
    spans = eng.last_stream_stats["spans"]
    assert spans["tpi.stream"][0] == 1
    assert {"tpi.followups", "tpi.upload", "tpi.wait"} <= set(spans)
    _serve(eng, "page", terms)
    assert "tpi.followups" not in eng.last_stream_stats["spans"]
    tracing.enable(False)
    _serve(eng, "and", terms)
    assert "spans" not in eng.last_stream_stats


def test_spans_outside_a_call_record_nothing(corpus, followups):
    """boolean() shares the follow-ups and the uploads with the streams
    but opens no call: its spans are not recorded, and a call after it
    holds only its own."""
    lists, terms, tables = corpus
    eng = _engine(tables)
    qs = _and_batches(terms)[0]
    tracing.enable(True)
    with tracing.span("tpi.wait") as stray:
        assert stray is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = eng.boolean(qs, "and")
    assert not _tpi_events(prof)
    for q, v in zip(qs, got):
        assert np.array_equal(v, _oracle(lists, terms, q, "and"))
    assert not tracing._thread().stack and not tracing._thread().spans
    _serve(eng, "and", terms)
    assert eng.last_stream_stats["spans"]["tpi.stream"][0] == 1


def test_reduce_takes_each_span_less_its_children():
    spans = [["tpi.stream", -1, 0, 100], ["tpi.harvest", 0, 10, 50],
             ["tpi.wait", 1, 20, 30], ["tpi.wait", 1, 35, 40],
             ["tpi.assemble", 0, 60, 90]]
    assert tracing.reduce(spans) == {
        "tpi.stream": [1, 100, 30], "tpi.harvest": [1, 40, 25],
        "tpi.wait": [2, 15, 15], "tpi.assemble": [1, 30, 30]}


def _blocks(lists, terms, q):
    return sum(-(-len(lists[terms.index(x)]) // 128) for x in q
               if x in terms)


@pytest.mark.parametrize("kind", ["and", "page"])
def test_concat_singles_past_the_largest_class(corpus, followups,
                                               monkeypatch, steps_run, kind):
    lists, terms, tables = corpus
    eng = _engine(tables)
    monkeypatch.setattr(eng, "_SB_CLASSES", (8,))
    res = _serve(eng, kind, terms)
    _check(res, kind, lists, terms)
    st = eng.last_stream_stats
    # every class chunk and single is one concat step
    assert st["concat_chunks"] == steps_run[0] > 0
    if kind == "and":
        # the concat AND's queries: bases past the level cap
        over = [q for b in _and_batches(terms) for q in b
                if all(x in terms for x in q)
                and min(len(lists[terms.index(x)]) for x in q) > 1024]
        assert st["concat"] == len(over) > 0
    else:
        over = [q for b in _or_batches(terms) for q in b]
    singles = sum(_blocks(lists, terms, q) > 8 for q in over)
    assert singles > 0
    assert st["concat_singles"] == singles
    assert st["concat_chunks"] >= singles
    eng._SB_CLASSES = type(eng)._SB_CLASSES
    _serve(eng, kind, terms)
    assert eng.last_stream_stats["concat_singles"] == 0


def test_page_stream_sets_the_and_streams_keys(corpus):
    lists, terms, tables = corpus
    eng = _engine(tables)
    _serve(eng, "and", terms)
    and_keys = set(eng.last_stream_stats)
    res = _serve(eng, "page", terms)
    _check(res, "page", lists, terms)
    st = eng.last_stream_stats
    assert set(st) == and_keys == KEYS
    n = sum(len(b) for b in _or_batches(terms))
    assert st["queries"] == n and st["device_batches"] == 2
    assert st["route"] == "device" and st["host_queries"] == 0
    assert st["small_p_overflow"] == st["ladder_reserve"] == \
        st["concat"] == 0


def test_host_route_sets_route_and_host_queries(corpus, monkeypatch):
    lists, terms, tables = corpus
    eng = _engine(tables, keep=True)
    _serve(eng, "and", terms)
    assert eng.last_stream_stats["route"] == "device"
    monkeypatch.setenv("TPI_HOST_BOOL", "and")
    batches = _and_batches(terms)
    res = eng.boolean_staged(batches, "and", columnar=True)
    _check(res, "and", lists, terms)
    st = eng.last_stream_stats
    n = sum(len(b) for b in batches)
    assert set(st) == KEYS
    assert st["route"] == "host"
    assert st["queries"] == st["host_queries"] == n
    assert st["host_batches"] == 2 and st["device_batches"] == 0
    assert st["served_rows"] == st["concat_singles"] == 0
    assert st["concat_chunks"] == 0
    # lookup_staged serves on the host too with retained tables
    eng.lookup_staged([terms[:3], terms[3:]], columnar=True)
    st = eng.last_stream_stats
    assert st["route"] == "host" and st["host_queries"] == len(terms)


def _route_engine(route, corpus, tmp_path):
    """An engine whose next call takes `route`, and that call."""
    lists, terms, tables = corpus
    if route == "empty":
        eng = QueryEngine(upload_tables(_empty_tables(2), device="cpu"), L=L,
                          device="cpu")
        return eng, lambda: eng.boolean_staged([[[b"a"], [b"b", b"c"]]],
                                               "or", columnar=True)
    if route == "dual":
        ii = InvertedIndex(str(tmp_path))
        for v in range(1, 400):  # a main tier many times the delta
            ii.put([terms[v % 3], terms[3 + v % 2], f"u{v:04d}".encode()], v)
        eng = QueryEngine.from_index(ii, L=128, device="cpu")
        ii.put([terms[0], terms[5]], 1000)
        assert eng.refresh(ii) and eng.delta is not None
        return eng, lambda: eng.boolean_staged(
            [[[terms[0], terms[3]], [terms[1]]]], "or", columnar=True)
    eng = _engine(tables, keep=route == "host")
    if route == "lookup":
        return eng, lambda: eng.lookup_staged([terms[:4], terms[4:]],
                                              columnar=True)
    if route == "or":
        return eng, lambda: eng.boolean_staged(_or_batches(terms), "or",
                                               columnar=True)
    kind = "page" if route == "page" else "and"
    return eng, lambda: _serve(eng, kind, terms)


@pytest.mark.parametrize("route,launched", [
    ("and", True), ("or", True), ("page", True), ("lookup", True),
    ("host", False), ("dual", False), ("empty", False)])
def test_concat_chunks_on_every_route(corpus, followups, monkeypatch,
                                      steps_run, tmp_path, route, launched):
    if route == "host":
        monkeypatch.setenv("TPI_HOST_BOOL", "all")
    eng, call = _route_engine(route, corpus, tmp_path)
    call()
    st = eng.last_stream_stats
    assert set(st) == KEYS
    assert st["concat_chunks"] == steps_run[0]
    assert (st["concat_chunks"] > 0) == launched


def test_lookup_staged_on_the_device_is_one_call(corpus):
    lists, terms, tables = corpus
    eng = _engine(tables)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        (vals, voffs), = eng.lookup_staged([terms], columnar=True)
    for i, t in enumerate(terms):
        assert np.array_equal(vals[voffs[i]: voffs[i + 1]], lists[i])
    st = eng.last_stream_stats
    assert st["route"] == "device" and st["queries"] == len(terms)
    assert st["spans"]["tpi.stream"][0] == 1


def test_hybrid_stream_reports_its_host_queries(corpus, monkeypatch):
    lists, terms, tables = corpus
    eng = _engine(tables, keep=True)
    monkeypatch.delenv("TPI_HOST_BOOL")
    monkeypatch.setenv("TPI_HYBRID", "1")
    monkeypatch.setattr(port_qe, "_LINK_MBPS",
                        QueryEngine._HOST_ROUTE_LINK_MBPS / 2)
    batches = _and_batches(terms) * 2
    res = eng.boolean_staged(batches, "and", columnar=True)
    for r, qs in zip(res, batches):
        for i, q in enumerate(qs):
            assert np.array_equal(r[0][r[1][i]: r[1][i + 1]],
                                  _oracle(lists, terms, q, "and"))
    st = eng.last_stream_stats
    assert st["route"] == "hybrid"
    assert st["queries"] == sum(len(b) for b in batches)
    assert 0 <= st["host_queries"] <= st["queries"]
    assert st["host_queries"] == 0 or st["host_batches"] > 0
