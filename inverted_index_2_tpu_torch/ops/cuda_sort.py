"""Kernel K4: ascending row sort of u32 bits (csrc/sort_rows.cu), with its
plain torch version.

Replaces inverted_index_2_tpu/ops/pallas_sort.py::sort_rows_pallas, a drop-in
for the jnp.sort along rows that the concat classes and the set operations
run. No caller hands it an unsorted row, so `sort_rows` takes a hint,
`run=r`: every r consecutive lanes of a row already ascend in u32 order.
`sort_plan` turns (width, hint) into the kernel's entries:

  * two runs (M <= 2r, the pair union of the dual step): ONE merge-path
    level, any r;
  * r >= MERGE_FROM (the dual OR's K runs of 2L): merge-path levels from
    runs of r, any r. A pair of such runs fills a CTA's output tile, and a
    level costs about what 9 compare-exchange steps of the network cost;
  * otherwise the tiles of up to TILE lanes are sorted in shared memory by a
    bitonic network that starts at stage 2g, g the largest power of two
    that divides r (g = 128 for every concat-class row; g < 16 is the whole
    network, the general sort), and rows past one tile are then merged
    level by level, one read and one write of the matrix each.

The compaction of kept lanes, the third entry, is ops/compaction.py. Bound
on the card by device-memory bytes (see the kernel's header).

`sort_rows` takes the plain version only for tensors on the CPU, where it
also verifies the hint and raises ValueError on a row that breaks it (the
CPU path serves the tests, so they prove the hint at every call site); for
CUDA tensors it launches K4 or raises. `sort_rows.launches` counts every K4
call (compactions too), `sort_rows.entries` the calls by entry.
"""
from __future__ import annotations

import torch

from . import _build
from .cuda_decode import _check_int32
from ..utils.u32 import flip, sort_u32

LANES = 128
TILE = 16384     # lanes one CTA sorts in shared memory (kTile)
MERGE_FROM = 2048  # runs this long are merged, not sorted (kMergeTile / 2)
_MIN_RUN = 16    # shortest run the tile network can start from (kRun)


def padded_width(m: int) -> int:
    """The tile network's width for m values: the next 128 * 2^k >= m."""
    w = LANES
    while w < m:
        w *= 2
    return w


def sort_plan(m: int, run: int = 1):
    """The kernel entries that sort a row of m lanes whose every `run`
    consecutive lanes ascend, in order: ("tiles", tile, g) sorts every tile
    of `tile` lanes, given ascending runs of g lanes; ("merge", w) merges
    every pair of ascending runs of w lanes. Empty for a sorted row."""
    if run < 1:
        raise ValueError(f"run={run}: want >= 1")
    if run >= m:
        return []
    if m <= 2 * run:
        return [("merge", run)]
    steps = []
    if run >= MERGE_FROM:
        w = run
    else:
        g = run & -run
        w = min(padded_width(m), TILE)
        steps.append(("tiles", w, g if _MIN_RUN <= g < w else 1))
    while w < m:
        steps.append(("merge", w))
        w *= 2
    return steps


def check_runs(x: torch.Tensor, run: int) -> None:
    """Raise ValueError unless every `run` consecutive lanes of each row of
    x (u32 bits) ascend in u32 order."""
    if run <= 1 or x.shape[1] < 2:
        return
    f = flip(x)
    inside = torch.arange(1, x.shape[1], device=x.device) % run != 0
    bad = (f[:, 1:] < f[:, :-1]) & inside[None, :]
    if bool(bad.any()):
        q, c = (int(v) for v in bad.nonzero()[0])
        raise ValueError(f"sort_rows(run={run}): row {q} descends at lane "
                         f"{c + 1}, inside a run")


def sort_rows_torch(x: torch.Tensor, run: int = 1) -> torch.Tensor:
    """Plain version of K4: each row of x (Q, M) int32 holding u32 bits,
    sorted ascending in u32 order. The hint is not needed and not read."""
    return sort_u32(x, dim=1)


def count_entry(entry: str) -> None:
    sort_rows.launches += 1
    sort_rows.entries[entry] += 1


def sort_rows(x: torch.Tensor, run: int = 1) -> torch.Tensor:
    """Each row of x (Q, M) int32 holding u32 bits, sorted ascending in u32
    order; any M. `run=r` states that every r consecutive lanes of a row
    ascend in u32 order (the last run may be short); r = 1 states nothing.
    On the card the hint decides the work (sort_plan) and a false hint gives
    a wrong answer; on the CPU it is verified."""
    dev = x.device
    if dev.type == "cpu":
        check_runs(x, run)
        return sort_rows_torch(x, run)
    if dev.type != "cuda":
        raise ValueError(f"no K4 kernel for device {dev}")
    x = x.contiguous()
    _check_int32("x", x, 2, dev)
    Q, m = x.shape
    if m >= 1 << 30:
        raise ValueError(f"rows of {m} lanes: K4 takes fewer than 2^30")
    steps = sort_plan(m, run)
    if Q == 0 or not steps:
        return x.clone()
    lib = _build.library()
    # ping-pong so that the last step writes `out`; the first step reads x
    bufs = [torch.empty((Q, m), dtype=torch.int32, device=dev)
            for _ in range(min(2, len(steps)))]
    src = x
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i, step in enumerate(steps):
            dst = bufs[(len(steps) - 1 - i) % 2]
            if step[0] == "tiles":
                err = lib.tpi_sort_tiles(src.data_ptr(), m, dst.data_ptr(), m,
                                         Q, m, step[1], step[2], stream)
            else:
                err = lib.tpi_merge_runs(src.data_ptr(), m, dst.data_ptr(), m,
                                         Q, m, step[1], stream)
            _build.check(err, f"K4 {step}")
            src = dst
    count_entry("two_run" if m <= 2 * run else "runs" if run > 1
                else "general")
    return src


sort_rows.launches = 0  # K4 calls in this process, every entry
# ... by entry: the general sort, a sort from runs, the two-run merge, and
# the compaction of kept lanes (ops/compaction.py)
sort_rows.entries = {"general": 0, "runs": 0, "two_run": 0, "compact": 0}
