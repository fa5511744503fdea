#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (inverted_index_2_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--terms N] [--seed S] [--baseline-csrc DIR]

Phases; any failure raises and the script exits non-zero:
  1. the card: CUDA must be available; prints nvidia-smi's name and power
     limit;
  2. build: nvcc builds the kernels of inverted_index_2_tpu_torch/csrc
     (kernel K1, posting decode; K2, fused decode + AND; K3, sorted-set AND;
     K4, row sort, merge and compaction), one nvcc per source in parallel;
  3. each kernel against its plain torch version on the card, bit-identical:
     K1 and K2 at the AND slice's shapes (Q=8192 queries of up to 8 terms,
     L=2048, and the ladder level 8192), K2 in its three outputs (masked,
     compact, the first P members), K1 also at the dual step's shape
     (65536 term slots, L=2048) with the delta tier's real found mask (rows
     with found = False stay untouched); K3 on the lists the delta window's
     dual AND runs on (checked once phase 5 has made the delta): the pass over
     one uniform batch (Q=8192, K=8, width 2L=4096) and the first ladder
     re-serve dispatch at each level of the uniform stream (width 2 x
     level), on a synthetic input that takes every branch of the kernel
     (k3_branch_input), and on rows with k_valid = 0 in both regimes of its
     plain version; with --baseline-csrc, K2 and K3 of that earlier version
     are built too and timed on the same inputs; K4's three
     entries: the general sort at the concat classes' chunk shapes
     (16384, 1024) .. (256, 65536), at (64, 262144) and at one odd width,
     with rows of 0xFFFFFFFF and 0x80000000; the sort from ascending runs
     at the same shapes with run=128, at (8192, 32768) run=4096, and the
     two-run merge at (65536, 4096) run=2048 and (1232, 27136) run=13568;
     the compaction of kept lanes at all of these shapes; and all three on
     real dispatches, captured with their hints (the first pair-union
     matrix and compaction input of the dual stream at L and at each
     ladder level, the first concat-class chunk of the OR and OR-page
     streams), each also held against its precondition; the full-result
     wire codec's kernels (ops/cuda_wire.py: the masked max delta and the
     delta pack) on the chunks captured from the AND follow-ups' route,
     the OR stream and (phase 6) a mesh OR pass, and none called by the
     page stream; each timed with
     CUDA events beside its plain version, torch.sort for K4, and its bound
     (for K3, the lists its inputs need, shortest first: a query's AND
     stops at its first empty running result; for K2, the probe blocks a
     member can lie in and the anchors in the base's range, with the
     two earlier counts printed beside it: every probe row, and the probe
     blocks that hold a value of the whole base; the bound takes the probes
     shortest first and holds each against the values still alive);
  4. a small engine check: an InvertedIndex (the port's) built with put /
     put_removed / merge, served by QueryEngine.from_index(...) on the card,
     against a numpy oracle: lookup, AND, OR (with tombstones), prefix_p
     pages for AND and OR, lookup_staged, ladder re-serves, small-P overflow
     and queries beyond the largest concat class; then refresh() through an
     additive delta, a tombstone-only refresh, a promotion and a compaction
     rebuild, every state against the oracle of the index's host reads;
     then checkpoints: a round trip of the tables and fingerprint, and
     from_checkpoint against the index unchanged, after an additive put (a
     delta) and after a merge (a rebuild), with lookup, read_range and
     prefix_search on the host route and the device route in every state;
  5. the main paths at a realistic size: the config-3 deployment of
     BASELINE.md (Boolean queries of 2-8 terms, mean posting length 1k), cut
     from 10M to --terms terms: boolean_staged AND (columnar, depth 4) over
     8 uniform batches of 8192 queries and a Zipf stream, one batch of 8192
     lookups, full-result OR over 2 uniform batches and 2 Zipf batches, OR
     pages (prefix_p=32, depth 4) over the 8 uniform batches, and
     lookup_staged over 4 batches of the queries' first terms; three timed
     passes each, sampled results against the oracle, each path's kernel
     launches, then one profiled pass of each stream (device busy share);
     these streams run on the device routes (TPI_HOST_BOOL=0, and
     lookup_staged on an engine without the host tables). Then the host
     route at the same size (TPI_HOST_BOOL=all): the AND streams, the
     full-result OR over 2 uniform batches and lookup_staged, against the
     oracle, with their QPS beside the device route's and no kernel
     launched; the link probe and the route auto picks per op; the hybrid
     AND stream (TPI_HYBRID=1), bit-identical to the device's, with both
     sides serving; prefix_search of 256 prefixes and read_range over two
     windows on the device route (K1) against the host route and the
     oracle; a warm start from a checkpoint of the tables (serving before
     and after the side-stream upload is published); warmup() and stats().
     Then the delta window: a delta of 20,000 terms (10% of main) published
     as refresh() publishes it, and the dual step's streams over the union
     vocabulary: AND over 4 uniform and 4 Zipf batches, OR pages over the 4
     uniform ones, full-result OR over one, and 8192 lookups, sampled
     results against the per-term union of both tiers, K1, K3 and K4
     launched on the dual AND path, and one profiled pass of the dual AND
     and dual OR-page streams. K4's calls are counted by entry on every
     path (no path may sort without a hint), K2's by output (no path may
     take the masked rows); every profile prints K4's,
     K1's, K2's and K3's device time by kernel, and the AND profiles fail
     if a topk kernel or a K4 compaction ran;
  6. the mesh engine (parallel/) at the same size: MeshQueryEngine started
     from a checkpoint of the phase-5 tables at D = 1 and D = 4 partitions
     on the one card; lookup of 8192 terms, boolean_staged AND and OR over
     2 uniform batches (one query of the two longest lists, so the ladder
     re-serves), OR pages, lookup_staged, prefix_search and read_range on
     phase 5's inputs, each equal to the single-card QueryEngine bit for
     bit and sampled against the oracle; refresh() through an additive
     put (a delta tier on partition 0) and one dual AND batch, equal to the
     single-card dual stream and the oracle; at D = 4, K1 (partition 0's
     found mask), K3 (a query tile) and K4 (an OR tile's sort and
     compaction) against their plain versions at the partition shapes, and
     one profiled AND pass (K1 and K3, no K4 and no library sort) and OR
     pass (K1 and K4, no library sort); QPS and max_memory_allocated;
  7. the device merge (ops/merge.py) at one shard of the config-3
     deployment: 9,800 terms of mean length 1,000 written from numpy arrays
     as 8 overlapping segments, 1% of the doc ids tombstoned;
     merge_views_device on the card bit-identical to merge_views, both
     timed; Shard.merge at the default threshold takes the device branch
     and writes the segment files a host merge writes;
  8. the repository's entry points on the card: entry()'s step (K1, K3)
     against the same call on the CPU, where the kernels' plain versions
     run, on its own queries and on queries whose AND is not empty;
     dryrun_multichip(4), four partitions on the one card, its results
     held against numpy answers and against the same run on four CPU
     partitions; the two examples
     (examples/quickstart_torch.py, examples/serving_mesh_torch.py); and
     bench_torch.py --quick, whose last line must hold every headline key
     with a positive value and whose phases must launch the kernels they
     stand for (its sidecar's per-phase counts);
  9. the write-while-serving lifecycle at the phase-5 size
     (phase_lifecycle): the corpus written as the segment files of an
     InvertedIndex (two overlapping segments a shard), served by
     QueryEngine.from_index with a checkpoint_path and by a MeshQueryEngine
     of 4 partitions of the card started from that checkpoint; reader
     threads serve AND, OR pages, lookup_staged and read_range on the
     device routes, and AND through the mesh, holding the storm's
     invariants (no id whose tombstone refresh returned comes back, no id
     whose put and refresh returned is lost), while a writer puts
     (put_many), removes (put_removed) and merges, and refresh() takes
     each of its kinds, timed: an additive delta, tombstones only, a
     promotion past DELTA_FRACTION and a rebuild after the merge; after
     each refresh, readers paused, sampled queries of every form on both
     routes equal a numpy oracle of the index's host reads and the mesh
     equals the single engine; K1-K4 must each launch; prints the
     readers' QPS with the writer idle and in the storm, their slowest
     call, and max_memory_allocated across the promotion and the rebuild.
The last line is {"ok": true, "device": {...}}; before it come one JSON
line with each kernel's launches (over the paths of phases 5, 6, 8 and 9;
a ".mesh" row counts phase 6's paths alone), error, time against its plain
version and the library call, and bound, and nvidia-smi's name and power
limit of the card. A kernel's "ms" is one rule for every row (kernel_ms): CUDA
events around each call alone, made with the L2 emptied and the host's
enqueue hidden, so that it holds against a bound over the memory rate;
every row must not beat its bound. The phase-3 lines print beside it the
gap between back-to-back calls. Plain and library times are gaps between
CUDA events over back-to-back calls.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

import bench_torch
from bench_torch import (and_oracle, env, or_oracle, uniform_stream,
                         zipf_stream)

L_MAIN = 2048
BATCH = 8192
N_BATCHES = 8
N_DUAL_BATCHES = 4
PAGE_P = 32
DELTA_TERMS = 20_000  # 10% of the 200,000-term main, under DELTA_FRACTION

# the bound of a kernel: the larger of its bytes over the HBM rate and its
# operations over the card's peak rate for their type (H100 SXM, NVIDIA's
# data sheet: 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores, the
# table's rate for ALU work, taken for the integer compares and shifts)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# a read this large evicts the H100's 50 MB L2, and a spin this long
# (about 0.5 ms at its 1.98 GHz) outlasts the host's enqueue of a wrapper
# (kernel_ms)
L2_FLUSH_BYTES = 256 << 20
SPIN_CYCLES = 1_000_000

# K4 at the concat classes' chunk shapes (one 2^24-element chunk per class
# up to SB = 128, then SB = 512), a long row past shared memory, and the
# pagination window W = P * K = 160 padded to 256
SORT_SHAPES = ((16384, 1024), (4096, 4096), (2048, 8192), (1024, 16384),
               (256, 65536), (64, 262144), (8192, 160))
SORT_REPORTED = (2048, 8192)  # the modal class of config-3 OR (SB = 64)


# K4's kernels as the profiler names them
K4_KERNELS = ("sort_tiles_kernel", "merge_runs_kernel", "compact_rows_kernel")
# ... and K2's and K3's, and K1's
AND_KERNELS = ("fused_and_kernel", "intersect_kernel")
K1_KERNELS = ("decode_postings_kernel",)


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def gen_corpus(n_terms: int, mean_len: int, seed: int):
    """The bench's config-3 generator (bench_torch.gen_corpus) with the
    terms as a (n, 12) uint8 matrix."""
    blob, offsets, values, voffs = bench_torch.gen_corpus(n_terms, mean_len,
                                                          seed)
    return (np.frombuffer(blob, np.uint8).reshape(-1, bench_torch.TERM_BYTES),
            offsets, values, voffs)


def gen_delta(terms_mat, values, voffs, n_delta: int, seed: int):
    """The delta tier of phase 5: n_delta terms, half of them main terms
    that gain postings and half new 12-byte terms (first byte a digit, so
    never a main term); geometric list lengths with mean 100; doc ids above
    main's largest value, and a tenth of a grown term's postings duplicates
    of its main values. Returns (delta terms (n, 12) uint8 sorted, their
    universe ids (main term i is i, new term k is len(main) + k), values,
    voffs, the new terms (m, 12))."""
    rng = np.random.default_rng(seed)
    n_main = len(terms_mat)
    half = n_delta // 2
    grow = np.sort(rng.choice(n_main, size=half, replace=False))
    raw = rng.integers(97, 123, size=(2 * (n_delta - half), 12),
                       dtype=np.uint8)
    raw[:, 0] = rng.integers(48, 58, size=len(raw), dtype=np.uint8)
    new = np.unique(raw, axis=0)
    new = new[np.sort(rng.choice(len(new), size=n_delta - half,
                                 replace=False))]
    ids = np.concatenate([grow, n_main + np.arange(len(new))])
    mat = np.concatenate([terms_mat[grow], new])
    order = np.lexsort(mat.T[::-1])
    mat, ids = mat[order], ids[order]
    lens = np.maximum(1, rng.geometric(1.0 / 100, size=n_delta))
    top = int(values.max()) + 1
    lists = []
    for i, n in zip(ids, lens):
        fresh = top + np.cumsum(rng.integers(1, 80_000, size=n))
        if i < n_main and n >= 10:
            own = values[voffs[i]:voffs[i + 1]]
            fresh = np.concatenate([fresh[: n - n // 10],
                                    rng.choice(own, size=n // 10)])
        lists.append(np.unique(fresh).astype(np.uint32))
    dvoffs = np.zeros(n_delta + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=dvoffs[1:])
    return mat, ids, np.concatenate(lists), dvoffs, new


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_ms(torch, fn, reps: int):
    """A kernel wrapper's time: (ms, ms back to back), per call over `reps`
    calls. The first is the `ms` of every row of the kernels line, timed as
    a bound over the memory rate assumes: CUDA events around each call
    alone, the call made after a read of L2_FLUSH_BYTES has evicted the L2
    (its inputs come from memory, and no dirty line of an earlier call is
    left to write back) and behind a spin of the stream (SPIN_CYCLES) that
    hides the host's time to enqueue it. The second is the mean gap between
    back-to-back calls (time_ms), whose inputs may sit in the L2 and which,
    for a short kernel, is the host's time to enqueue the call."""
    between = time_ms(torch, fn, reps)
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    marks = []
    for _ in range(reps):
        flush.amax()
        torch.cuda._sleep(SPIN_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        marks.append((e0, e1))
    torch.cuda.synchronize()
    del flush
    return sum(a.elapsed_time(b) for a, b in marks) / reps, between


def bound(nbytes: float, ops: float):
    """(bound ms, "bytes" or "operations")."""
    b, o = nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
    return (max(b, o) * 1e3, "bytes" if b >= o else "operations")


class Baseline:
    """K2 and K3 of an earlier version of the package, built from its csrc
    directory (--baseline-csrc) into a library of their own, to be timed on
    the same inputs in the same process. That version's entry points are
    tpi_fused_and(blocks, stride, rows, counts, k_valid, Q, K, L, out,
    out_count, stream), which writes the masked rows, and
    tpi_intersect(lists, counts, k_valid, Q, K, L, keep_base, out,
    out_counts, stream)."""

    def __init__(self, csrc: str):
        import ctypes
        from pathlib import Path

        from inverted_index_2_tpu_torch.ops import _build

        src = Path(csrc)
        so = _build.BUILD_DIR / "libtpi_baseline.so"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        res = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(src / "fused_and.cu"), str(src / "intersect.cu")],
            capture_output=True, text=True)
        check(res.returncode == 0, f"baseline build failed:\n{res.stderr}")
        print(f"[phase 2] baseline K2 and K3 of {src} built in "
              f"{time.perf_counter() - t0:.4f} s")
        vp, i = ctypes.c_void_p, ctypes.c_int
        self.lib = ctypes.CDLL(str(so))
        self.lib.tpi_fused_and.argtypes = [vp, i, vp, vp, vp, i, i, i, vp, vp,
                                           vp]
        self.lib.tpi_intersect.argtypes = [vp, vp, vp, i, i, i, i, vp, vp, vp]

    def fused_and(self, torch, blocks, rows, counts, kv, L):
        Q, K = rows.shape
        out = torch.empty((Q, L), dtype=torch.int32, device=blocks.device)
        oc = torch.empty(Q, dtype=torch.int32, device=blocks.device)
        err = self.lib.tpi_fused_and(
            blocks.data_ptr(), blocks.shape[1], rows.data_ptr(),
            counts.data_ptr(), kv.data_ptr(), Q, K, L, out.data_ptr(),
            oc.data_ptr(), torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"baseline tpi_fused_and: CUDA error {err}")
        return out, oc

    def intersect(self, torch, lists, counts, kv, keep_base):
        Q, K, L = lists.shape
        out = torch.empty((Q, L), dtype=torch.int32, device=lists.device)
        oc = torch.empty(Q, dtype=torch.int32, device=lists.device)
        err = self.lib.tpi_intersect(
            lists.data_ptr(), counts.data_ptr(), kv.data_ptr(), Q, K, L,
            keep_base, out.data_ptr(), oc.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"baseline tpi_intersect: CUDA error {err}")
        return out, oc


def _blocks(counts, cap=None):
    nb = -(-counts.astype(np.int64) // 128)
    return nb if cap is None else np.minimum(nb, cap)


def _check_k1(torch, s, ti, L, found):
    """K1 on snapshot `s` for term indexes `ti` at width L, with or without
    a found mask, against its plain version: counts equal, values
    bit-identical on valid prefixes, and rows with found = False left as
    they were (the output block is filled with a pattern first). Timed
    beside the plain version and its bound. Returns (err, ms, plain ms,
    None, bound ms, bound_by)."""
    from inverted_index_2_tpu_torch.ops import cuda_decode
    from inverted_index_2_tpu_torch.ops.decode import gather_postings_arena
    from inverted_index_2_tpu_torch.utils.u32 import to_i64

    dev = ti.device
    Q = ti.shape[0]
    stride = int(s.blocks.shape[1])
    args = (s.blocks, s.term_block_start, s.counts, ti, L)
    untouched = ""
    kv_ = ptr = None
    for _ in range(1 if found is None else 4):
        # K1's output is a fresh torch.empty: fill a block of that size with
        # a pattern and free it, so the allocator hands the same block out
        if found is not None:
            del kv_
            pat = torch.full((Q, L), 0x5A5A5A5A, dtype=torch.int32,
                             device=dev)
            ptr = pat.data_ptr()
            del pat
        kv_, kc = cuda_decode.decode_postings(*args, found)
        torch.cuda.synchronize()
        if kv_.data_ptr() == ptr:
            break
    if found is not None:
        check(kv_.data_ptr() == ptr, "K1: the output did not reuse the "
              "pattern block, so untouched rows cannot be shown")
        check(bool((kv_[~found] == 0x5A5A5A5A).all()),
              f"K1 Q={Q} L={L}: a row with found = False was written")
        check(bool((kc[~found] == 0).all()),
              f"K1 Q={Q} L={L}: a row with found = False has a count")
        untouched = (f", {int((~found).sum())} rows with found = False "
                     f"untouched")
    pv, pc = gather_postings_arena(*args, found)
    torch.cuda.synchronize()
    check(torch.equal(kc, pc), f"K1 Q={Q} L={L}: counts differ")
    valid = (torch.arange(L, device=dev)[None, :]
             < pc.clamp(max=L).long()[:, None])
    diff = (to_i64(kv_) - to_i64(pv)).abs()[valid]
    err = int(diff.max()) if diff.numel() else 0
    check(err == 0, f"K1 Q={Q} L={L}: values differ (max abs {err})")
    n_valid = int(valid.sum())
    del kv_, pv, valid, diff
    k_ms, e_ms = kernel_ms(
        torch, lambda: cuda_decode.decode_postings(*args, found), 20)
    p_ms = time_ms(torch, lambda: gather_postings_arena(*args, found), 3)
    # bytes: each block row a found term needs read once, its 128 values
    # written once; per term its index read, its count written, and for a
    # found term its count and block start read (a found flag is a byte)
    nb = _blocks(pc.cpu().numpy(), L // 128)
    n_found = Q if found is None else int(found.sum())
    b_ms, b_by = bound(nb.sum() * (stride * 4 + 512) + 8 * Q + 8 * n_found
                       + (0 if found is None else Q), 2 * 128 * nb.sum())
    print(f"[phase 3] K1 decode Q={Q} L={L}"
          f"{'' if found is None else ' with found'}: bit-identical "
          f"({n_valid} values, {int(nb.sum())} blocks){untouched}, kernel "
          f"{k_ms:.4f} ms ({e_ms:.4f} back to back), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return (err, k_ms, p_ms, None, b_ms, b_by)


def phase_decode_dual(torch, eng, st, batch):
    """Phase 3, K1 at the dual step's shape: every term slot of one uniform
    dual batch (BATCH x 8 slots, L_MAIN) decoded in the delta tier with the
    tier's real found mask, as _decode_tier does."""
    from inverted_index_2_tpu_torch.models.steps import _narrow_keys
    from inverted_index_2_tpu_torch.ops.dict_search import resolve
    from inverted_index_2_tpu_torch.utils.u32 import to_device

    d = st.delta
    qk, _ = eng._pack_boolean(st, batch)
    Q, K = qk.shape[:2]
    qflat = to_device(_narrow_keys(qk, d.width), d.device).reshape(Q * K, -1)
    idx, found = resolve(d.keys, qflat, d.hash_slots, d.max_probes)
    check(0 < int(found.sum()) < Q * K, "K1 dual: the delta tier finds all "
          "or none of the batch's terms")
    return _check_k1(torch, d, idx.to(torch.int32), L_MAIN, found)


def k2_work(torch, s, rows, cnts, kvt, L, budget=1 << 22):
    """What K2's inputs ask of any implementation, counted in arena rows.
    Values of block b of a list lie in [anchor_b, anchor_b+1), so a probe
    block whose range holds no base value cannot hold a member. The probes
    are taken shortest first and each is held against the base values that
    are still alive, as K3's bound takes its lists: a probe is reached only
    while the running AND is non-empty. Returns a dict of counts:
      base      the base's blocks;
      all       every probe block;
      span, hit   probe blocks whose anchor lies in the range of the whole
                base, and those whose own range holds a value of the whole
                base (the count before the running AND was followed);
      span_run, hit_run   the same against the values alive when the probe
                is reached: what the bound counts.
    Queries go in chunks of `budget` probe values."""
    from inverted_index_2_tpu_torch.ops.decode import BLOCK, decode_lists

    dev = rows.device
    Q, K = rows.shape
    kv = kvt.long().clamp(0, K)
    c = cnts.long().clamp(min=0)
    slots = torch.arange(K, device=dev)[None, :]
    live = slots < kv[:, None]
    live[:, 0] = False
    n = {"base": int(((c[:, 0].clamp(max=L) + BLOCK - 1) // BLOCK).sum()),
         "all": int(torch.where(live, (c + BLOCK - 1) // BLOCK, 0).sum()),
         "span": 0, "hit": 0, "span_run": 0, "hit_run": 0}
    if K == 1 or Q == 0:
        return n
    BIG = 1 << 33  # above every u32
    anchors = s.blocks[:, 1].long() & 0xFFFFFFFF
    # present probes shortest first (a stable order), absent ones last
    order = torch.argsort(torch.where(live, c, BIG)[:, 1:], dim=1,
                          stable=True) + 1
    step = max(1, budget // max(L, int(c[:, 1:].max())))
    for q0 in range(0, Q, step):
        sl = slice(q0, q0 + step)
        nbv = c[sl, 0].clamp(max=L)
        base = decode_lists(s.blocks, rows[sl, 0], c[sl, 0], L)
        valid = torch.arange(L, device=dev)[None, :] < nbv[:, None]
        base = torch.where(valid, base, BIG)   # ascending, BIG past the count
        alive = valid.clone()
        bmin = base[:, 0]
        bmax = torch.where(valid, base, -1).max(dim=1).values
        zero = torch.zeros((base.shape[0], 1), dtype=torch.long, device=dev)
        cum_all = torch.cat([zero, torch.cumsum(valid, 1)], dim=1)
        for r in range(K - 1):
            j = order[sl, r: r + 1]
            act = live[sl].gather(1, j)[:, 0]
            nj = torch.where(act, c[sl].gather(1, j)[:, 0], 0)
            longest = int(nj.max())
            if longest == 0:  # every present probe of this round is empty
                alive &= ~act[:, None]
                continue
            nb = (nj + BLOCK - 1) // BLOCK
            B = -(-longest // BLOCK)
            b = torch.arange(B, device=dev)[None, :]
            rowj = rows[sl].gather(1, j).long()
            a0 = anchors[(rowj + b).clamp(max=anchors.shape[0] - 1)]
            a0 = torch.where(b < nb[:, None], a0, BIG)
            last = b + 1 >= nb[:, None]
            a1 = torch.where(last, BIG, torch.cat(
                [a0[:, 1:], torch.full_like(a0[:, :1], BIG)], dim=1))
            lo = torch.searchsorted(base, a0)
            hi = torch.searchsorted(base, a1)
            block = (b < nb[:, None])
            whole = block & (nbv > 0)[:, None]
            n["span"] += int((whole & (a0 <= bmax[:, None])
                              & (last | (a1 > bmin[:, None]))).sum())
            n["hit"] += int((whole & (cum_all.gather(1, hi)
                                      > cum_all.gather(1, lo))).sum())
            smin = torch.where(alive, base, BIG).min(dim=1).values
            smax = torch.where(alive, base, -1).max(dim=1).values
            cum = torch.cat([zero, torch.cumsum(alive, 1)], dim=1)
            reached = block & alive.any(dim=1)[:, None]
            n["span_run"] += int((reached & (a0 <= smax[:, None])
                                  & (last | (a1 > smin[:, None]))).sum())
            n["hit_run"] += int((reached & (cum.gather(1, hi)
                                            > cum.gather(1, lo))).sum())
            M = B * BLOCK
            pv = decode_lists(s.blocks, rowj[:, 0], nj, M)
            pv = torch.where(torch.arange(M, device=dev)[None, :]
                             < nj[:, None], pv, BIG + 1)
            pos = torch.searchsorted(pv, base).clamp(max=M - 1)
            alive &= (pv.gather(1, pos) == base) | ~act[:, None]
    return n


def phase_fused(torch, eng, uniform, baseline):
    """Phase 3, K2: its masked, compact and width-P outputs on the first
    uniform batch at L_MAIN and on the batch's longest bases at 4 L_MAIN,
    each bit-identical to its plain version and timed beside it; with a
    baseline, that version's kernel on the same inputs. Three bounds are
    printed: the count of earlier versions of this script (every probe row
    read once), the count that holds every probe against the whole base,
    and the one the times are held against (k2_work: probes shortest first,
    only the rows that a value still alive can lie in, and the anchors in
    those values' range). Returns the kernels-line rows."""
    from inverted_index_2_tpu_torch.utils.u32 import to_i64

    from inverted_index_2_tpu_torch.models.steps import fused_rows
    from inverted_index_2_tpu_torch.ops import compaction, cuda_fused
    from inverted_index_2_tpu_torch.utils.u32 import to_device

    s = eng.snap
    dev = eng.device
    stride = int(s.blocks.shape[1])
    P = eng._STAGED_SMALL_P
    qk, kv = eng._pack_boolean(eng._state, uniform[0])
    kvt = to_device(kv, dev)
    rows, cnts, need = fused_rows(s.keys, s.term_block_start, s.counts,
                                  to_device(qk, dev), kvt, s.hash_slots,
                                  s.max_probes)
    top = torch.argsort(need, descending=True)[:256]
    res = {}
    for L, args in ((L_MAIN, (rows, cnts, kvt)),
                    (4 * L_MAIN, (rows[top].contiguous(),
                                  cnts[top].contiguous(),
                                  kvt[top].contiguous()))):
        Q, K = args[0].shape
        po, pc = cuda_fused.fused_and_torch(s.blocks, *args, L)
        plain = {"masked": lambda: cuda_fused.fused_and_torch(
                     s.blocks, *args, L),
                 "compact": lambda: compaction.compact_rows_torch(
                     cuda_fused.fused_and_torch(s.blocks, *args, L)[0],
                     po != -1),
                 "width": lambda: cuda_fused.compact_small(
                     cuda_fused.fused_and_torch(s.blocks, *args, L)[0], P)}
        want = {"masked": po,
                "compact": compaction.compact_rows_torch(po, po != -1),
                "width": cuda_fused.compact_small(po, P)}
        kern = {"masked": lambda: cuda_fused.fused_and(
                    s.blocks, *args, L, compact=False),
                "compact": lambda: cuda_fused.fused_and(s.blocks, *args, L),
                "width": lambda: cuda_fused.fused_and(
                    s.blocks, *args, L, width=P)}
        n = k2_work(torch, s, *args, L)
        c = args[1].long().clamp(min=0)
        live = (torch.arange(1, K, device=dev)[None, :]
                < args[2].long()[:, None])
        # operations: one binary search of log2(L) steps per value of a
        # probe block that is read (before: per probe value)
        head = Q * 4 + Q * K * 8
        old_ms, old_by = bound((n["base"] + n["all"]) * stride * 4
                               + Q * L * 4 + head,
                               int((c[:, 1:] * live).sum()) * math.log2(L))
        whole_ms, whole_by = bound(
            (n["base"] + n["hit"]) * stride * 4 + n["span"] * 4 + Q * L * 4
            + head, n["hit"] * 128 * math.log2(L))
        base_parent = None
        if baseline is not None:
            bo, bc = baseline.fused_and(torch, s.blocks, *args, L)
            torch.cuda.synchronize()
            check(torch.equal(bo, po) and torch.equal(bc, pc),
                  f"K2 L={L}: the baseline's masked rows differ")
            base_parent = kernel_ms(torch, lambda: baseline.fused_and(
                torch, s.blocks, *args, L), 20)
        for entry, width in (("masked", L), ("compact", L), ("width", P)):
            ko, kc = kern[entry]()
            torch.cuda.synchronize()
            check(torch.equal(kc, pc), f"K2 {entry} L={L}: keep counts differ")
            check(ko.shape == want[entry].shape,
                  f"K2 {entry} L={L}: the output's shape is {ko.shape}")
            err = int((to_i64(ko) - to_i64(want[entry])).abs().max())
            check(err == 0 and torch.equal(ko, want[entry]),
                  f"K2 {entry} L={L}: rows differ from the plain version "
                  f"(max abs {err})")
            k_ms, e_ms = kernel_ms(torch, kern[entry], 20)
            p_ms = time_ms(torch, plain[entry], 2)
            b_ms, b_by = bound(
                (n["base"] + n["hit_run"]) * stride * 4 + n["span_run"] * 4
                + Q * width * 4 + head, n["hit_run"] * 128 * math.log2(L))
            check(b_ms <= k_ms, f"K2 {entry} L={L}: the kernel beat its "
                  f"bound ({k_ms} < {b_ms} ms)")
            extra = ""
            if entry == "masked":
                extra = (f"; bound as counted before {old_ms:.4f} ms "
                         f"({old_by}: all {n['all']} probe blocks); with "
                         f"every probe held against the whole base "
                         f"{whole_ms:.4f} ms ({whole_by}: anchors in range "
                         f"{n['span']}, rows {n['hit']})")
                if base_parent is not None:
                    extra += (f"; baseline kernel {base_parent[0]:.4f} ms "
                              f"({base_parent[1]:.4f} back to back)")
            if entry == "width":
                # what the width-P output replaces on the staged path
                t_ms = time_ms(torch, lambda: cuda_fused.compact_small(
                    kern["masked"]()[0], P), 10)
                extra = (f"; masked kernel + topk (the path before) "
                         f"{t_ms:.4f} ms by events")
            print(f"[phase 3] K2 fused AND {entry} Q={Q} K={K} L={L}"
                  f"{f' P={P}' if entry == 'width' else ''}: bit-identical "
                  f"({int(kc.sum())} kept, {int((c[:, 0] > L).sum())} bases "
                  f"> L; blocks: base {n['base']}, probes shortest first "
                  f"against the values still alive: anchors in range "
                  f"{n['span_run']}, rows a member can lie in "
                  f"{n['hit_run']}), kernel "
                  f"{k_ms:.4f} ms ({e_ms:.4f} back to back), plain {p_ms:.4f} "
                  f"ms, bound {b_ms:.4f} ms ({b_by}), "
                  f"{k_ms / b_ms:.2f}x{extra}")
            if L == L_MAIN:
                name = {"masked": "fused_and.masked", "compact":
                        "fused_and.compact", "width": "fused_and"}[entry]
                res[name] = (err, k_ms, p_ms, None, b_ms, b_by)
        del po, want
        torch.cuda.empty_cache()
    return res


def phase_kernels(torch, eng, terms_mat, uniform, baseline=None):
    """Phase 3: K1, K2 and K4 against their plain versions on the card.
    Returns per kernel (max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by)."""
    from inverted_index_2_tpu_torch.codec import keys as keys_mod
    from inverted_index_2_tpu_torch.models.steps import fused_rows
    from inverted_index_2_tpu_torch.ops import cuda_fused
    from inverted_index_2_tpu_torch.ops.dict_search import resolve
    from inverted_index_2_tpu_torch.utils.u32 import to_device, to_i64

    s = eng.snap
    dev = eng.device
    stride = int(s.blocks.shape[1])
    res = {}

    # K1 at the lookup shape, then at the ladder level 4L for the longest
    rng = np.random.default_rng(5)
    pick = rng.choice(len(terms_mat), size=BATCH, replace=False)
    qk = keys_mod.pack_blob(terms_mat[pick].reshape(-1),
                            np.arange(BATCH + 1, dtype=np.int64) * 12, s.width)
    idx, found = resolve(s.keys, to_device(qk, dev), s.hash_slots,
                         s.max_probes)
    check(bool(found.all()), "K1 input: a corpus term did not resolve")
    idx = idx.to(torch.int32)
    longest = torch.argsort(s.counts[idx.long()], descending=True)[:1024]
    res["decode_postings"] = _check_k1(torch, s, idx, L_MAIN, None)
    _check_k1(torch, s, idx[longest].contiguous(), 4 * L_MAIN, None)

    res.update(phase_fused(torch, eng, uniform, baseline))
    res.update(phase_sort(torch, dev))
    return res


def _lib_sort(torch, x, want, label):
    """The library call beside K4: one torch.sort of the same rows in u32
    order (on a uint32 view, or on the sign-flipped int32 bits where this
    build has no uint32 sort). Returns (callable, its form)."""
    from inverted_index_2_tpu_torch.utils.u32 import flip

    try:
        xu = x.view(torch.uint32)
        lib = torch.sort(xu, dim=1).values
        check(torch.equal(lib.view(torch.int32), want),
              f"torch.sort {label} on uint32 disagrees")
        return (lambda: torch.sort(xu, dim=1)), "uint32"
    except (RuntimeError, TypeError, NotImplementedError):
        xf = flip(x)
        return (lambda: torch.sort(xf, dim=1)), "flipped"


def runs_input(torch, gen, Q, M, r, dev):
    """(Q, M) u32 bits whose every r consecutive lanes ascend: sorted random
    values, each run ending in a tail of 0xFFFFFFFF of random length (none
    for a third of the runs, up to the whole run)."""
    from inverted_index_2_tpu_torch.utils.u32 import sort_u32

    n = -(-M // r)
    x = sort_u32(torch.randint(-2**31, 2**31, (Q, n, r), dtype=torch.int32,
                               device=dev, generator=gen), dim=2)
    tail = torch.randint(0, r + 1, (Q, n, 1), device=dev, generator=gen)
    tail[torch.rand((Q, n, 1), device=dev, generator=gen) < 0.33] = 0
    x = torch.where(torch.arange(r, device=dev)[None, None, :] >= r - tail,
                    -1, x)
    return x.reshape(Q, n * r)[:, :M].contiguous()


def _check_sort(torch, x, run, label, reps=10):
    """K4's sort of x with the hint `run` against the plain version, the
    hint itself verified, timed beside the plain version and torch.sort.
    Returns (0, ms, plain ms, library ms, bound ms, bound_by)."""
    from inverted_index_2_tpu_torch.ops import cuda_sort

    Q, M = x.shape
    cuda_sort.check_runs(x, run)
    got = cuda_sort.sort_rows(x, run=run)
    want = cuda_sort.sort_rows_torch(x, run=run)
    torch.cuda.synchronize()
    check(got.shape == want.shape and torch.equal(got, want),
          f"K4 sort {label}: rows differ from the plain version")
    lib_call, lib_form = _lib_sort(torch, x, want, label)
    del got, want
    k_ms, e_ms = kernel_ms(torch, lambda: cuda_sort.sort_rows(x, run=run),
                            reps)
    p_ms = time_ms(torch, lambda: cuda_sort.sort_rows_torch(x, run=run), 3)
    l_ms = time_ms(torch, lib_call, 3)
    # bytes: the matrix read once and written once; operations: one compare
    # per value and halving of the distance to a sorted row
    plan = cuda_sort.sort_plan(M, run)
    g = max(1, min(run, M))
    b_ms, b_by = bound(2 * Q * M * 4,
                       Q * M * max(1.0, math.log2(M) - math.log2(g)))
    print(f"[phase 3] K4 sort_rows ({Q}, {M}) run={run} {label}: "
          f"bit-identical, hint holds, plan {plan}, kernel {k_ms:.4f} ms "
          f"({e_ms:.4f} back to back), "
          f"plain {p_ms:.4f} ms, torch.sort ({lib_form}) {l_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})")
    return (0, k_ms, p_ms, l_ms, b_ms, b_by)


def _check_compact(torch, vals, keep, label, reps=10):
    """K4's compaction against the plain version (the masked sort), the
    precondition verified, timed beside the plain version and the masked
    torch.sort. Returns (0, ms, plain ms, library ms, bound ms, bound_by)."""
    from inverted_index_2_tpu_torch.ops import compaction

    Q, M = vals.shape
    compaction.check_kept_ascend(vals, keep)
    got = compaction.compact_rows(vals, keep)
    want = compaction.compact_rows_torch(vals, keep)
    torch.cuda.synchronize()
    check(got.shape == want.shape and torch.equal(got, want),
          f"K4 compact_rows {label}: rows differ from the plain version")
    masked = torch.where(keep, vals, -1)
    lib_call, lib_form = _lib_sort(torch, masked, want, label)
    del got, want
    k_ms, e_ms = kernel_ms(
        torch, lambda: compaction.compact_rows(vals, keep), reps)
    p_ms = time_ms(torch, lambda: compaction.compact_rows_torch(vals, keep),
                   3)
    l_ms = time_ms(torch, lib_call, 3)
    del masked
    # bytes: a value and a keep byte read and a value written per lane;
    # operations: one scan step and one select per lane
    b_ms, b_by = bound(Q * M * (4 + 1 + 4), 2 * Q * M)
    print(f"[phase 3] K4 compact_rows ({Q}, {M}) {label}: bit-identical, "
          f"kept lanes ascend, kernel {k_ms:.4f} ms ({e_ms:.4f} back to back), "
          f"plain {p_ms:.4f} ms, "
          f"torch.sort of the masked rows ({lib_form}) {l_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    return (0, k_ms, p_ms, l_ms, b_ms, b_by)


def phase_sort(torch, dev):
    """Phase 3, K4, every entry bit-identical to its plain version:
      * the general sort (run=1) at every shape in SORT_SHAPES, on random
        rows with rows of 0xFFFFFFFF and 0x80000000;
      * the sort from runs at every SORT_SHAPES shape with run=128 (the
        concat classes), at (8192, 32768) run=4096 (the dual OR), and the
        two-run merge at (65536, 4096) run=2048 and (1232, 27136)
        run=13568 (the pair union at L and at the top ladder level), on
        sorted runs with 0xFFFFFFFF tails of random length;
      * the compaction at every SORT_SHAPES shape and (65536, 4096), on
        sorted rows with random keep masks, a row of 0xFFFFFFFF, a kept
        genuine 0xFFFFFFFF member, an all-kept and a none-kept row.
    Each timed beside the plain version, torch.sort and its bound. Returns
    the reported numbers by kernels-line name."""
    from inverted_index_2_tpu_torch.ops import cuda_sort
    from inverted_index_2_tpu_torch.utils.u32 import sort_u32

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    res = {}
    for Q, M in SORT_SHAPES:
        x = torch.randint(-2**31, 2**31, (Q, M), dtype=torch.int32,
                          device=dev, generator=gen)
        x[0] = -1                            # a row of 0xFFFFFFFF
        x[1] = -2**31                        # a row of 0x80000000
        x[2, ::3] = -1
        x[2, 1::3] = -2**31
        x[3] = torch.randint(0, 3, (M,), dtype=torch.int32, device=dev,
                             generator=gen)
        _check_sort(torch, x, 1, "general")
        got = cuda_sort.sort_rows(x)
        check(bool((got[0] == -1).all()) and bool((got[1] == -2**31).all()),
              f"K4 ({Q}, {M}): a constant row changed")
        del x, got
        x = runs_input(torch, gen, Q, M, 128, dev)
        r = _check_sort(torch, x, 128, "blocks")
        if (Q, M) == SORT_REPORTED:
            res["sort_rows"] = r
        # the compaction: sorted rows, each with its own keep density
        vals = sort_u32(x, dim=1)
        del x
        keep = (torch.rand((Q, M), device=dev, generator=gen)
                < torch.rand((Q, 1), device=dev, generator=gen))
        _edge_rows(vals, keep)
        _check_compact(torch, vals, keep, "sorted rows")
        del vals, keep
        torch.cuda.empty_cache()
    for Q, M, r_, label in ((8192, 8 * 2 * L_MAIN, 2 * L_MAIN, "dual OR"),
                            (1232, 2 * 13568, 13568, "pair union, top level"),
                            (BATCH * 8, 2 * L_MAIN, L_MAIN, "pair union")):
        x = runs_input(torch, gen, Q, M, r_, dev)
        r = _check_sort(torch, x, r_, label)
        if label == "pair union":
            res["sort_rows.two_run"] = r
            vals = sort_u32(x, dim=1)
            del x
            keep = torch.cat([torch.ones((Q, 1), dtype=torch.bool, device=dev),
                              vals[:, 1:] != vals[:, :-1]], dim=1)
            keep &= torch.rand((Q, M), device=dev, generator=gen) < 0.9
            _edge_rows(vals, keep)
            res["compact_rows"] = _check_compact(torch, vals, keep,
                                                 "pair union")
            del vals, keep
        else:
            del x
        torch.cuda.empty_cache()
    return res


def _edge_rows(vals, keep):
    """The compaction's edge rows, in place: row 0 all 0xFFFFFFFF, row 1
    keeps a genuine 0xFFFFFFFF as its last member, row 2 keeps every lane,
    row 3 keeps none."""
    vals[0] = -1
    vals[1, -1] = -1
    keep[1, -1] = True
    keep[2] = True
    keep[3] = False


def _dual_inputs(torch, st, qk, kv, lv):
    """K3's inputs on the dual step's path: the union of each term's first
    lv postings in both tiers of state `st`, (Q, K, 2 lv), with counts,
    k_valid and each query's summed need."""
    from inverted_index_2_tpu_torch.models.steps import (
        _max_live, _narrow_keys, dual_lists)
    from inverted_index_2_tpu_torch.utils.u32 import to_device

    s, d = st.snap, st.delta
    dev = s.device
    lists, ncnt, raw = dual_lists(
        s.keys, s.blocks, s.term_block_start, s.counts, s.hash_slots,
        d.keys, d.blocks, d.term_block_start, d.counts, d.hash_slots,
        to_device(_narrow_keys(qk, s.width), dev),
        to_device(_narrow_keys(qk, d.width), dev), lv, s.max_probes,
        d.max_probes)
    kvt = to_device(kv, dev)
    return lists, ncnt, kvt, _max_live(raw, kvt)


def k3_branch_input(W: int, seed: int):
    """A synthetic K3 input that takes every branch of csrc/intersect.cu,
    as numpy: (lists (Q, 4, W) uint32 sorted unique within counts and
    random beyond, counts (Q, 4) int32, k_valid (Q,) int32, the rows'
    names). Sizes are cut to W; the windows past a ring slot need
    W >= 12288."""
    rng = np.random.default_rng(seed)
    K, FF = 4, 0xFFFFFFFF

    def dense(n, start, step):
        return (start + step * np.arange(min(n, W), dtype=np.int64))

    def mix(keep, n, hi):
        """`keep` and random values below `hi`, n values in all."""
        extra = rng.integers(0, hi, size=2 * n)
        extra = np.setdiff1d(extra, keep)[: max(0, min(n, W) - len(keep))]
        return np.union1d(keep, extra)

    rows = []
    a = dense(W, 1000, 3)
    tiny = a[[7, len(a) // 4, len(a) // 2, 3 * len(a) // 4, len(a) - 9]]
    rows.append(("a base shorter than a warp against windows past a ring "
                 "slot, the base not in slot 0",
                 [a, tiny, np.union1d(a[::2], tiny)], 3))
    base = dense(3000, 50, 11)
    rows.append(("a base of several tiles, staged windows",
                 [mix(base[::2], 4000, 40_000), base,
                  mix(base[::3], 3500, 40_000)], 3))
    rows.append(("a probe wholly outside the base's range",
                 [dense(500, 10, 7), dense(800, 10**7, 3)], 2))
    rows.append(("k_valid 0", [dense(300, 5, 2), dense(200, 5, 2)], 0))
    rows.append(("k_valid 1", [dense(2500, 9, 5), dense(100, 9, 5)], 1))
    rows.append(("a present list of count 0",
                 [dense(400, 0, 3), np.zeros(0, np.int64), dense(300, 0, 3)],
                 3))
    common = np.append(dense(60, 2**31 - 30, 1), FF)
    rows.append(("a genuine 0xFFFFFFFF in every list, values across the "
                 "sign bit",
                 [mix(common, 300 + 40 * j, 2**32 - 1) for j in range(K)], K))
    rows.append(("a full tile against a window past a ring slot",
                 [dense(W, 0, 1), dense(2000, 0, 16)], 2))
    short = dense(10, 100, 97)
    rows.append(("a window far longer than a short base",
                 [mix(short, 1500, 1700), short], 2))
    full = dense(W, 3, 2)
    rows.append(("identical full lists: every lane kept", [full] * K, K))

    Q = len(rows)
    vals = rng.integers(0, 2**32, size=(Q, K, W), dtype=np.uint64)
    counts = np.zeros((Q, K), dtype=np.int32)
    kv = np.zeros(Q, dtype=np.int32)
    for q, (_, ls, k) in enumerate(rows):
        kv[q] = k
        for j, v in enumerate(ls):
            counts[q, j] = len(v)
            vals[q, j, : len(v)] = v
    return (vals.astype(np.uint32), counts, kv, [r[0] for r in rows])


def k3_branch_counts(vals, counts, kv):
    """The AND's counts for k3_branch_input, by numpy; a k_valid = 0 row
    keeps list 0's prefix in the plain version's broadcast regime only."""
    W = vals.shape[2]
    out = []
    for q in range(len(kv)):
        if kv[q] == 0:
            out.append(int(counts[q, 0]) if W * W <= 512 * 512 else 0)
            continue
        r = vals[q, 0, : counts[q, 0]]
        for j in range(1, kv[q]):
            r = np.intersect1d(r, vals[q, j, : counts[q, j]])
        out.append(len(r))
    return np.array(out)


def k3_windows(torch, lists, ncnt, kvt):
    """K3's plan for these inputs, emulated in torch: the base is the
    shortest present list, in tiles of TILE values; of each probe list a tile
    looks at the window [first value >= tile_min, first value > tile_max).
    A window past a ring slot (less the alignment slack), or more than
    DIRECT_RATIO times the tile's base, is searched where it lies, except a
    tile's first probe (the shortest) of up to WHOLE_FIRST values, which is
    copied whole; the sizes are the kernel's, from ops/cuda_bool.
    Returns (the lists permuted shortest first with their counts, the
    number of (tile, probe) windows that are staged, searched in place
    because they pass a ring slot, searched in place because they are far
    longer than the tile's base, and the last two among each tile's first
    probe, which no early exit can skip)."""
    from inverted_index_2_tpu_torch.ops.cuda_bool import (
        DIRECT_RATIO, SLOT, TILE, WHOLE_FIRST)
    from inverted_index_2_tpu_torch.utils.u32 import flip

    Q, K, W = lists.shape
    dev = lists.device
    c = ncnt.long().clamp(0, W)
    kv = kvt.long().clamp(0, K)
    present = torch.arange(K, device=dev)[None, :] < kv[:, None]
    order = torch.argsort(torch.where(present, c, W + 1), dim=1, stable=True)
    ordered = lists.gather(1, order[:, :, None].expand(-1, -1, W))
    oc = c.gather(1, order)
    n0 = torch.where(kv > 0, oc[:, 0], 0)
    n_t = max(1, -(-int(n0.max()) // TILE))
    first = (torch.arange(n_t, device=dev) * TILE)[None, :].expand(Q, -1)
    lastp = torch.minimum(first + TILE, n0[:, None]) - 1
    fk = torch.where(torch.arange(W, device=dev) < oc[:, :, None],
                     flip(ordered), 2**31 - 1)
    tmin = fk[:, 0].gather(1, first.clamp(max=W - 1))
    tmax = fk[:, 0].gather(1, lastp.clamp(min=0))
    seq = fk.reshape(Q * K, W)
    del fk

    def find(v, right):
        v = v[:, None, :].expand(-1, K, -1).reshape(Q * K, n_t).contiguous()
        pos = torch.searchsorted(seq, v, right=right).reshape(Q, K, n_t)
        return torch.minimum(pos, oc[:, :, None])

    win = find(tmax, True) - find(tmin, False)
    probe = (present & (torch.arange(K, device=dev) > 0)[None, :])[:, :, None]
    probe = probe & (first < n0[:, None])[:, None, :] & (win > 0)
    n_tile = (lastp - first + 1)[:, None, :]
    whole = torch.zeros_like(probe)
    whole[:, 1] = (oc[:, 1] <= WHOLE_FIRST)[:, None]
    past = probe & ~whole & (win > SLOT - 8)
    ratio = probe & ~whole & ~past & (win > n_tile * DIRECT_RATIO)
    staged = probe & ~past & ~ratio
    return (ordered, oc.to(torch.int32),
            {"staged": int(staged.sum()), "past_slot": int(past.sum()),
             "by_ratio": int(ratio.sum()),
             "first_past_slot": int(past[:, 1].sum()),
             "first_by_ratio": int(ratio[:, 1].sum())})


def _k3_bound(torch, lists, ncnt, kvt):
    """K3's bound on these inputs with the lists taken in the order given:
    list j is needed only while the running AND of lists 0 .. j-1 is
    non-empty, so the plain version's running counts decide which lists
    count. Returns (bound ms, bound_by, valid values, needed values)."""
    from inverted_index_2_tpu_torch.ops import setops

    Q, K, W = lists.shape
    kv = kvt.cpu().numpy().astype(np.int64)
    c = ncnt.cpu().numpy().astype(np.int64)
    live = np.arange(K)[None, :] < kv[:, None]
    c = np.where(live, c, 0)
    run = np.zeros((Q, K), dtype=np.int64)  # run[:, j]: AND of lists 0..j
    run[:, 0] = c[:, 0]
    for j in range(1, K - 1):
        run[:, j] = setops.intersect_many(
            lists, ncnt, kvt.clamp(max=j + 1))[1].cpu().numpy()
    reached = live.copy()
    reached[:, 1:] &= run[:, :-1] > 0
    # bytes: the needed valid prefixes read once, the (Q, W) rows and
    # counts written once, counts and k_valid read once; operations: a
    # binary search of log2(count + 1) steps per surviving base value and
    # needed probe list
    ops = (run[:, :-1] * np.log2(c[:, 1:] + 1) * reached[:, 1:]).sum()
    b_ms, b_by = bound((c * reached).sum() * 4 + Q * W * 4 + Q * 4
                       + Q * K * 4 + Q * 4, ops)
    return b_ms, b_by, int(c.sum()), int((c * reached).sum())


def _check_k3(torch, lists, ncnt, kvt, label, baseline=None, timed=True):
    """K3 against its plain version on one input, whole rows and counts,
    timed, and with a baseline that version's kernel too. The bound takes
    the lists shortest first, as the kernel does (the count in list order
    is printed beside it). Returns (max abs err, ms, plain ms, bound ms,
    bound_by, the window plan)."""
    from inverted_index_2_tpu_torch.ops import cuda_bool, setops
    from inverted_index_2_tpu_torch.utils.u32 import to_i64

    Q, K, W = lists.shape
    po, pc = setops.intersect_many(lists, ncnt, kvt)
    ko, kc = cuda_bool.intersect_many(lists, ncnt, kvt)
    torch.cuda.synchronize()
    check(torch.equal(kc, pc), f"K3 {label}: counts differ from the plain "
          "version")
    err = int((to_i64(ko) - to_i64(po)).abs().max())
    check(err == 0 and torch.equal(ko, po),
          f"K3 {label}: rows differ from the plain version (max abs {err})")
    del ko
    ordered, ocnt, plan = k3_windows(torch, lists, ncnt, kvt)
    if not timed:
        return err, None, None, None, None, plan
    k_ms, e_ms = kernel_ms(torch, lambda: cuda_bool.intersect_many(
        lists, ncnt, kvt), 20)
    p_ms = time_ms(torch, lambda: setops.intersect_many(lists, ncnt, kvt), 3)
    b_ms, b_by, n_valid, n_need = _k3_bound(torch, ordered, ocnt, kvt)
    o_ms, _, _, o_need = _k3_bound(torch, lists, ncnt, kvt)
    del ordered
    check(b_ms <= k_ms, f"K3 {label}: the kernel beat its bound "
          f"({k_ms} < {b_ms} ms, by {b_by}; back to back {e_ms} ms; "
          f"{n_need} of {n_valid} valid values "
          "needed)")
    extra = ""
    if baseline is not None:
        keep_base = int(W * W <= setops._BROADCAST_LIMIT)
        bo, bc = baseline.intersect(torch, lists, ncnt, kvt, keep_base)
        torch.cuda.synchronize()
        check(torch.equal(bo, po) and torch.equal(bc, pc),
              f"K3 {label}: the baseline's rows differ")
        t = kernel_ms(torch, lambda: baseline.intersect(
            torch, lists, ncnt, kvt, keep_base), 20)
        extra = f"; baseline kernel {t[0]:.4f} ms ({t[1]:.4f} back to back)"
    print(f"[phase 3] K3 intersect {label} Q={Q} K={K} width={W}: "
          f"bit-identical ({int(pc.sum())} kept, {n_valid} valid values, "
          f"{n_need} needed shortest first, {o_need} in list order; windows "
          f"{plan}); kernel {k_ms:.4f} ms ({e_ms:.4f} back to back), plain "
          f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; in list order "
          f"{o_ms:.4f} ms), {k_ms / b_ms:.2f}x{extra}")
    return err, k_ms, p_ms, b_ms, b_by, plan


def check_k3_branches(torch, dev):
    """Phase 3, K3 on the synthetic input that takes every branch, in both
    regimes of the plain version (W = 512: a k_valid = 0 row keeps its
    base), against the plain version and a numpy oracle."""
    from inverted_index_2_tpu_torch.ops import cuda_bool

    for W in (12288, 27136, 512):
        vals, counts, kv, names = k3_branch_input(W, seed=W)
        lists = torch.from_numpy(vals.view(np.int32)).to(dev)
        ncnt = torch.from_numpy(counts).to(dev)
        kvt = torch.from_numpy(kv).to(dev)
        plan = _check_k3(torch, lists, ncnt, kvt, f"branches W={W}",
                         timed=False)[5]
        got = cuda_bool.intersect_many(lists, ncnt, kvt)[1].cpu().numpy()
        want = k3_branch_counts(vals, counts, kv)
        check(np.array_equal(got, want),
              f"K3 branches W={W}: counts {got.tolist()} differ from the "
              f"oracle's {want.tolist()}")
        if W >= 12288:
            # searches in place run in a tile's first batch, which no early
            # exit skips, and staged windows beside them
            check(plan["first_past_slot"] > 0 and plan["first_by_ratio"] > 0
                  and plan["staged"] > 0,
                  f"K3 branches W={W}: the input misses a branch: {plan}")
        print(f"[phase 3] K3 intersect, {len(names)} synthetic rows at "
              f"W={W} ({'; '.join(names)}): equal to the plain "
              f"version and the oracle, counts {got.tolist()}, windows "
              f"{plan}")


def check_k3_no_terms(torch, dev):
    """Phase 3, K3 on rows with k_valid = 0 and a non-empty base, in both
    regimes of the plain version: at L = 128 (broadcast) the row keeps its
    base's valid prefix, at L = 1024 (sort) it is empty; the card answers
    as the plain version does at each."""
    from inverted_index_2_tpu_torch.ops import cuda_bool, setops

    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    for L in (128, 1024):
        Q, K = 256, 4
        steps = torch.randint(1, 9, (Q, K, L), device=dev, generator=gen)
        lists = torch.cumsum(steps, dim=2).to(torch.int32)
        counts = torch.randint(1, L + 1, (Q, K), device=dev,
                               generator=gen).to(torch.int32)
        kv = torch.randint(0, K + 1, (Q,), device=dev,
                           generator=gen).to(torch.int32)
        kv[::3] = 0
        ko, kc = cuda_bool.intersect_many(lists, counts, kv)
        po, pc = setops.intersect_many(lists, counts, kv)
        torch.cuda.synchronize()
        check(torch.equal(kc, pc) and torch.equal(ko, po),
              f"K3 k_valid = 0 rows at L={L}: differ from the plain version")
        none = kv == 0
        want = counts[none, 0] if L * L <= setops._BROADCAST_LIMIT else 0
        check(bool((kc[none] == want).all()),
              f"K3 k_valid = 0 rows at L={L}: not the regime's answer")
        print(f"[phase 3] K3 intersect, {int(none.sum())} rows with k_valid "
              f"= 0 and a non-empty base at L={L}: equal to the plain "
              f"version ({int(kc[none].sum())} values kept)")


class CaptureK4:
    """While active, records the arguments of the first K4 sort and the
    first K4 compaction that ops/setops.py, ops/concat_bool.py and
    ops/cuda_concat.py (sorts only: the concat kernels compact on their
    own) dispatch, and passes every call through: .sort = (x, run),
    .compact = (vals, keep)."""

    def __enter__(self):
        from inverted_index_2_tpu_torch.ops import (
            concat_bool, cuda_concat, setops)

        self.sort = self.compact = None
        self._mods = (setops, concat_bool)
        self._saved = [(m, m.sort_rows, m.compact_rows) for m in self._mods]
        self._saved_concat = cuda_concat.sort_rows
        self._concat = cuda_concat
        real_sort, real_compact = setops.sort_rows, setops.compact_rows

        def sort_rows(x, run=1):
            if self.sort is None:
                self.sort = (x, run)
            return real_sort(x, run=run)

        def compact_rows(vals, keep):
            if self.compact is None:
                self.compact = (vals, keep)
            return real_compact(vals, keep)

        for m in self._mods:
            m.sort_rows, m.compact_rows = sort_rows, compact_rows
        self._concat.sort_rows = sort_rows
        return self

    def __exit__(self, *exc):
        for m, srt, cmp_ in self._saved:
            m.sort_rows, m.compact_rows = srt, cmp_
        self._concat.sort_rows = self._saved_concat
        return False

    def verify(self, torch, label, compact=True):
        """The captured dispatches against the plain versions and against
        their preconditions (compact=False: the path compacts nothing)."""
        check(self.sort is not None, f"K4 {label}: no sort was dispatched")
        x, run = self.sort
        _check_sort(torch, x, run, f"real dispatch, {label}", reps=3)
        check((self.compact is not None) == compact,
              f"K4 {label}: a compaction was "
              f"{'not ' if compact else ''}dispatched")
        if compact:
            vals, keep = self.compact
            _check_compact(torch, vals, keep, f"real dispatch, {label}",
                           reps=3)
        self.sort = self.compact = None


class CaptureConcat:
    """While active, records the arguments of the first concat step that
    models/staged.py dispatches and of its largest (the most lanes), and
    passes every call through: .first and .largest = (args, kwargs)."""

    def __enter__(self):
        from inverted_index_2_tpu_torch.models import staged

        self.first = self.largest = None
        self._staged, self._real = staged, staged.concat_step
        real = self._real

        def lanes(step):
            return step[0][6].shape[0] * step[0][7]

        def concat_step(*a, **kw):
            if self.first is None:
                self.first = (a, kw)
            if self.largest is None or lanes((a, kw)) > lanes(self.largest):
                self.largest = (a, kw)
            return real(*a, **kw)

        staged.concat_step = concat_step
        return self

    def __exit__(self, *exc):
        self._staged.concat_step = self._real
        return False

    def verify(self, torch, label):
        """The first and the largest captured step against the plain
        versions (_check_concat); returns the largest's rows."""
        check(self.first is not None, f"{label}: no concat step dispatched")
        if self.largest is not self.first:
            _check_concat(torch, self.first, f"{label}, first chunk", reps=3)
        res = _check_concat(torch, self.largest, f"{label}, largest chunk")
        self.first = self.largest = None
        return res


def _check_concat(torch, step, label, reps=10):
    """One captured concat step (CaptureConcat) run again through the
    concat kernels (ops/cuda_concat.py) and through their plain versions
    on the same inputs: the decode's flat rows and meta, then, on K4's sort
    of them, the compaction in the step's form. The page form writes copies
    of one buffer of random bits, compared whole; the wire form compacts
    nothing, so its sorted lanes and lane counts are held to the plain
    chain's and the full form of its op runs on them. Each bit-identical,
    timed beside its plain version and its bound. Returns {"concat_decode",
    "concat_compact"}: (0, ms, plain ms, None, bound ms, bound_by)."""
    from inverted_index_2_tpu_torch.ops import cuda_concat
    from inverted_index_2_tpu_torch.ops.concat_bool import (
        boolean_concat_step,
        concat_compact_torch,
        concat_decode_torch,
        concat_layout,
    )
    from inverted_index_2_tpu_torch.ops.cuda_sort import sort_rows

    a, kw = step
    blocks, tbs, counts, idx, found, kv, rows, SB, op = a
    P = int(kw.get("prefix_p", 0))
    wire = bool(kw.get("wire_dedup", False))
    dev = blocks.device
    n, K, S = rows.shape[0], idx.shape[1], SB * 128
    stride = int(blocks.shape[1])
    r = rows.to(torch.int64)
    plain_args = (blocks, tbs, counts, idx[r], found[r], kv[r], SB)

    def decode():
        return cuda_concat.concat_decode(blocks, tbs, counts, idx, found, kv,
                                         rows, SB)

    flat, meta = decode()
    wflat, wmeta = concat_decode_torch(*plain_args)
    torch.cuda.synchronize()
    check(torch.equal(flat, wflat) and torch.equal(meta, wmeta),
          f"concat_decode {label}: flat rows or meta differ from the plain "
          "version")
    del wflat, wmeta
    # bytes: each used slot's header, anchor and packed deltas read (128
    # bytes per 8 bits of delta width, within the arena row), every lane
    # of flat and the meta written; operations: one select per lane
    live = found[r] & (torch.arange(K, device=dev)[None, :]
                       < kv[r].to(torch.int64)[:, None])
    cnt = torch.where(live, counts[idx[r]].to(torch.int64), 0)
    slots, in_use = concat_layout(tbs[idx[r]].to(torch.int64), cnt, SB)[:2]
    cls = ((blocks[slots[in_use], 0] & 0xFF) >> 3).to(torch.int64)
    used_bytes = int((8 + 128 * cls).clamp(max=4 * stride).sum())
    del live, cnt, slots, in_use, cls
    k_ms, e_ms = kernel_ms(torch, decode, reps)
    p_ms = time_ms(torch, lambda: concat_decode_torch(*plain_args), 3)
    b_ms, b_by = bound(used_bytes + n * S * 4 + 16 * n, n * S)
    print(f"[phase 3] concat_decode ({n}, {S}) K={K}, {label}: bit-identical, "
          f"flat rows and meta, kernel {k_ms:.4f} ms ({e_ms:.4f} back to "
          f"back), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    res = {"concat_decode": (0, k_ms, p_ms, None, b_ms, b_by)}

    svals = sort_rows(flat, run=128)
    n_valid = int(meta[0].sum())
    if wire:
        got = cuda_concat.concat_step(blocks, tbs, counts, idx, found, kv,
                                      rows, SB, op, wire_dedup=True)
        want = boolean_concat_step(*plain_args, op, wire_dedup=True)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"concat step, wire form, {label}: sorted lanes or lane "
              "counts differ from the plain chain")
        del got, want
    if P:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SB)
        buf = torch.randint(-2**31, 2**31, (int(idx.shape[0]), P + 1),
                            dtype=torch.int32, device=dev, generator=gen)
        got_b, want_b = buf.clone(), buf.clone()

        def compact():
            return cuda_concat.concat_compact(svals, meta, op, K, P, got_b,
                                              rows)

        def plain():
            return concat_compact_torch(svals, meta, op, K, P, want_b, rows)

        compact()
        plain()
        torch.cuda.synchronize()
        check(torch.equal(got_b, want_b),
              f"concat_compact, page form P={P}, {label}: the (Q, P+1) "
              "buffer differs from the plain version's")
        form, out_bytes = f"page form P={P}", n * (P + 1) * 4
        del buf
    else:
        def compact():
            return cuda_concat.concat_compact(svals, meta, op, K)

        def plain():
            return concat_compact_torch(svals, meta, op, K)

        got, want = compact(), plain()
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"concat_compact {op}, full form, {label}: rows or counts "
              "differ from the plain version")
        form, out_bytes = f"{op} full form", n * S * 4 + 4 * n
        del got, want
    # bytes: the valid lanes and the meta read once, the output written;
    # operations: a compare and a scan step per valid lane
    k_ms, e_ms = kernel_ms(torch, compact, reps)
    p_ms = time_ms(torch, plain, 3)
    b_ms, b_by = bound(4 * n_valid + 16 * n + out_bytes, 2 * n_valid)
    wired = " (and the wire step's output)" if wire else ""
    print(f"[phase 3] concat_compact ({n}, {S}) {form}{wired}, "
          f"{label}: bit-identical, {n_valid} valid lanes, kernel "
          f"{k_ms:.4f} ms ({e_ms:.4f} back to back), plain {p_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})")
    res["concat_compact"] = (0, k_ms, p_ms, None, b_ms, b_by)
    del flat, meta, svals
    return res


class CaptureWire:
    """While active, records the arguments of the wire codec's calls that
    models/staged.py and parallel/mesh_engine.py make (the masked max delta
    of each full-result chunk, the pack of each chunk shipped at 8 or 16
    bits), the first and the largest (the most lanes) of each, and passes
    every call through: .meta and .pack = {"first", "largest"}."""

    def __enter__(self):
        from inverted_index_2_tpu_torch.models import staged
        from inverted_index_2_tpu_torch.ops import cuda_wire
        from inverted_index_2_tpu_torch.parallel import mesh_engine

        self.meta, self.pack = {}, {}
        targets = ((staged, "wire_meta"), (staged, "wire_pack"),
                   (mesh_engine, "wire_meta"))
        self._saved = [(m, a, getattr(m, a)) for m, a in targets]

        def keep(got, args):
            got.setdefault("first", args)
            big = got.get("largest")
            if big is None or args[0].numel() > big[0].numel():
                got["largest"] = args

        def wire_meta(o, oc):
            keep(self.meta, (o, oc))
            return cuda_wire.wire_meta(o, oc)

        def wire_pack(o, bits, maxc):
            keep(self.pack, (o, bits, maxc))
            return cuda_wire.wire_pack(o, bits, maxc)

        for m, a, _ in self._saved:
            setattr(m, a, wire_meta if a == "wire_meta" else wire_pack)
        return self

    def __exit__(self, *exc):
        for m, a, real in self._saved:
            setattr(m, a, real)
        return False

    def verify(self, torch, label, pack=True):
        """The first and the largest captured call of each against the
        plain steps (_check_wire); pack=False: the path may ship every
        chunk raw. Returns the largest calls' rows."""
        check("first" in self.meta, f"{label}: no wire meta was computed")
        check(not pack or "first" in self.pack,
              f"{label}: no chunk was packed at 8 or 16 bits")
        res = {}
        for name, got in (("wire_meta", self.meta), ("wire_pack", self.pack)):
            if not got:
                print(f"[phase 3] {name}, {label}: not called (every chunk "
                      "shipped raw or held one value a row)")
                continue
            if got["largest"] is not got["first"]:
                _check_wire(torch, name, got["first"], f"{label}, first",
                            reps=3)
            res[name] = _check_wire(torch, name, got["largest"],
                                    f"{label}, largest")
        self.meta, self.pack = {}, {}
        return res


def _check_wire(torch, name, args, label, reps=10):
    """One captured wire codec call (CaptureWire) run again through the
    kernel (ops/cuda_wire.py) and through the plain step on the same
    inputs, bit-identical, timed beside the plain step and its bound.
    Returns (0, ms, plain ms, None, bound ms, bound_by)."""
    from inverted_index_2_tpu_torch.models.steps import (
        _wire_meta_step, _wire_pack_step)
    from inverted_index_2_tpu_torch.ops.cuda_wire import wire_meta, wire_pack

    o = args[0]
    n, S = o.shape
    if name == "wire_meta":
        oc = args[1]
        got, want = wire_meta(o, oc), _wire_meta_step(o, oc)
        torch.cuda.synchronize()
        check(int(got) == int(want), f"wire_meta {label}: {int(got)}, the "
              f"plain step {int(want)}")
        kept = int(oc.to(torch.int64).clamp(0, S).sum())
        # bytes: the kept lanes and the counts read, the word written
        nbytes = 4 * kept + 4 * n + 8
        what = f"max delta {int(got)}, {kept} kept lanes"

        def kernel():
            return wire_meta(o, oc)

        def plain():
            return _wire_meta_step(o, oc)
    else:
        bits, maxc = args[1], args[2]
        f, dd = wire_pack(o, bits, maxc)
        pf, pdd = _wire_pack_step(o, bits)
        torch.cuda.synchronize()
        check(torch.equal(f, pf) and torch.equal(dd, pdd[:, :maxc - 1]),
              f"wire_pack {label}: the first values or the deltas differ "
              "from the plain step's")
        del f, dd, pf, pdd
        # bytes: maxc lanes a row read, the first values and the deltas
        # written
        nbytes = n * maxc * 4 + n * 4 + n * (maxc - 1) * bits // 8
        what = f"{bits} bits, maxc {maxc}"

        def kernel():
            return wire_pack(o, bits, maxc)

        def plain():  # as the stream ran it: the whole row, then cut
            first, deltas = _wire_pack_step(o, bits)
            return first, deltas[:, :maxc - 1]
    k_ms, e_ms = kernel_ms(torch, kernel, reps)
    p_ms = time_ms(torch, plain, 3)
    b_ms, b_by = bound(nbytes, 0)
    print(f"[phase 3] {name} ({n}, {S}) {label}: bit-identical, {what}, "
          f"kernel {k_ms:.4f} ms ({e_ms:.4f} back to back), plain "
          f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return (0, k_ms, p_ms, None, b_ms, b_by)


def phase_intersect(torch, eng, st, batches, baseline=None):
    """Phase 3, K3: bit-identical to its plain version, whole rows and
    counts, on the lists the dual step's AND runs on in the delta window
    (state `st`): the pass at L_MAIN over the first uniform batch, (Q, K,
    2 L_MAIN), then the first ladder re-serve dispatch at each level,
    made as _drain_levels makes them from the re-served rows of all the
    `batches` (one stream). Each is timed beside the plain version and,
    with a baseline, that version's kernel. The pair union that makes each
    of these inputs dispatches K4's two-run merge and compaction: the first of each per
    level is captured and held against its plain version and its
    precondition. No single PyTorch call computes a sorted-set AND,
    so there is no library time. Returns the kernels-line row: the pass."""
    from inverted_index_2_tpu_torch.models.steps import _RESERVE_BUDGET

    packed = [eng._pack_boolean(st, b) for b in batches]
    items = []  # (need, level, qk row, kv) of every re-served row
    res = {}
    for bi, (qk, kv) in enumerate(packed):
        with CaptureK4() as cap:
            lists, ncnt, kvt, need = _dual_inputs(torch, st, qk, kv, L_MAIN)
        if bi == 0:
            cap.verify(torch, f"dual pass at L={L_MAIN}")
            err, k_ms, p_ms, b_ms, b_by, _ = _check_k3(
                torch, lists, ncnt, kvt, "dual pass", baseline)
            res["intersect_many"] = (err, k_ms, p_ms, None, b_ms, b_by)
        del cap
        del lists, ncnt
        need = need.cpu().numpy()
        for i in np.nonzero(need > L_MAIN)[0]:
            items.append((qk[i], int(kv[i]),
                          eng._level_for(int(need[i]), st)))
        torch.cuda.empty_cache()
    # _drain_levels' dispatches: rows by level, largest first (a stable
    # sort), each dispatch at the level of its first row; keep the first
    # dispatch at each level
    items.sort(key=lambda t: -t[2])
    K = max(t[0].shape[0] for t in items)
    firsts, i = {}, 0
    while i < len(items):
        lv = items[i][2]
        rows = items[i: i + max(1, _RESERVE_BUDGET // (K * lv))]
        firsts.setdefault(lv, rows)
        i += len(rows)
    check(len(firsts) >= 2, f"K3: the re-serves reach levels "
          f"{list(firsts)} only")
    for lv, rows in firsts.items():
        qk = eng._stack_rows([t[0] for t in rows])
        kv = np.array([t[1] for t in rows], dtype=np.int32)
        with CaptureK4() as cap:
            lists, ncnt, kvt, _ = _dual_inputs(torch, st, qk, kv, lv)
        cap.verify(torch, f"re-serve level {lv}")
        del cap
        _check_k3(torch, lists, ncnt, kvt,
                  f"re-serve level {lv} ({len(items)} re-served rows)",
                  baseline)
        del lists, ncnt
        torch.cuda.empty_cache()
    return res


def phase_refresh(torch, device):
    """Phase 4, refresh(): an InvertedIndex (the port's) served by one
    engine through an additive delta, a tombstone-only refresh, a
    promotion and a compaction, each state checked against a numpy oracle
    of the index's host reads: lookup, AND and OR, staged rows and pages,
    with and without the tombstone filter."""
    from inverted_index_2_tpu_torch import InvertedIndex, QueryEngine, to_slice
    from inverted_index_2_tpu_torch.models.snapshot import _collect_removed
    from inverted_index_2_tpu_torch.ops import cuda_bool

    rng = np.random.default_rng(13)
    vocab = [f"v{i:03d}".encode() for i in range(40)]
    with tempfile.TemporaryDirectory() as d:
        ii = InvertedIndex(d)
        for v in range(1, 801):
            ii.put([b"common"] + [vocab[j] for j in
                                  rng.choice(len(vocab), 2, replace=False)],
                   v)
        while ii.merge(1, 100, 2) > 0:
            pass
        eng = QueryEngine.from_index(ii, L=128, device=device)
        queries = [[b"common", vocab[1]], [vocab[2], vocab[3]],
                   [b"common"], [vocab[4], b"missing"]]

        def verify(stage):
            host = {tv.term: tv.values for tv in to_slice(ii.read(None, None))}
            removed = _collect_removed(ii)
            terms = sorted(host) + [b"missing"]
            qs = queries + [[t, b"common"] for t in sorted(host)[:6]]
            for fr in (False, True):
                def oracle(v):
                    return np.setdiff1d(v, removed) if fr else v
                for t, got in zip(terms, eng.lookup(terms, filter_removed=fr)):
                    want = None if t not in host else oracle(host[t])
                    check((got is None and want is None) or (
                        got is not None and want is not None
                        and np.array_equal(got, want)),
                        f"{stage}: lookup {t!r} filter_removed={fr}")
                for op in ("and", "or"):
                    want = []
                    for q in qs:
                        sets = [host.get(t, np.zeros(0, np.uint32)) for t in q]
                        w = sets[0]
                        for v in sets[1:]:
                            w = (np.intersect1d(w, v) if op == "and"
                                 else np.union1d(w, v))
                        want.append(oracle(w.astype(np.uint32)))
                    got = eng.boolean(qs, op, filter_removed=fr)
                    pv, pvo, pc = eng.boolean_staged([qs], op, fr,
                                                     columnar=True,
                                                     prefix_p=4)[0]
                    for i, w in enumerate(want):
                        check(np.array_equal(got[i], w),
                              f"{stage}: {op} query {i} fr={fr}")
                        check(pc[i] == len(w) and np.array_equal(
                            pv[pvo[i]:pvo[i + 1]], w[:4]),
                            f"{stage}: {op} page {i} fr={fr}")
            check(eng.refresh(ii) is False, f"{stage}: a no-op refreshed")

        verify("from_index")
        main = eng.snap
        k3 = cuda_bool.intersect_many.launches
        for v in range(1001, 1004):  # additive, under DELTA_FRACTION
            ii.put([b"common", vocab[v % 40], f"fresh-term-{v}".encode()], v)
        check(eng.refresh(ii) and eng.snap is main and eng.delta is not None,
              "an additive change did not make a delta")
        verify("delta")
        check(device == "cpu" or cuda_bool.intersect_many.launches > k3,
              "the delta window's AND never launched K3")
        ii.put_removed([5, 6, 1003])  # tombstones only
        check(eng.refresh(ii) and eng.snap is main and eng.delta is not None,
              "a tombstone-only refresh replaced the tiers")
        verify("tombstones")
        for v in range(2001, 2031):  # a delta above DELTA_FRACTION: promote
            ii.put([b"common", f"promo-{v}".encode()], v)
        check(eng.refresh(ii) and eng.delta is None and eng.snap is not main,
              "a large delta did not promote")
        verify("promotion")
        main = eng.snap
        while ii.merge(1, 1000, 2) > 0:  # compaction: a rebuild
            pass
        check(eng.refresh(ii) and eng.delta is None and eng.snap is not main,
              "a compaction did not rebuild")
        verify("compaction")
    print("[phase 4] refresh(): additive delta, tombstone-only refresh, "
          "promotion and compaction rebuild; lookup, AND, OR and pages equal "
          "the oracle in every state")


def phase_engine_small(torch, device):
    """Phase 4: the engine from an InvertedIndex against a numpy oracle."""
    from inverted_index_2_tpu_torch import InvertedIndex, QueryEngine, to_slice

    rng = np.random.default_rng(11)
    vocab = [f"w{i:03d}".encode() for i in range(50)]
    with tempfile.TemporaryDirectory() as d:
        ii = InvertedIndex(d)
        for v in range(1, 1201):
            terms = [b"common"] + [vocab[j] for j in
                                   rng.choice(len(vocab), 3, replace=False)]
            if v % 2:
                terms.append(b"odd")
            if v <= 100:
                terms += [b"x1", b"x2"]
            ii.put(terms, v)
        while ii.merge(1, 100, 2) > 0:
            pass
        ii.put_removed([7, 8, 500, 1001])  # pending: the lists still hold them
        ii.put([b"common", b"late"], 5000)
        host = {tv.term: tv.values for tv in to_slice(ii.read(None, None))}
        eng = QueryEngine.from_index(ii, L=128, device=device)
    removed = eng.tables.removed
    check(set(removed.tolist()) == {7, 8, 500, 1001},
          "tombstones not in the snapshot")
    look = [b"common", b"odd", b"late", b"w001", b"missing"]
    for fr in (False, True):
        for term, got in zip(look, eng.lookup(look, filter_removed=fr)):
            if term not in host:
                check(got is None, f"lookup {term!r}: a miss returned rows")
                continue
            want = np.setdiff1d(host[term], removed) if fr else host[term]
            check(got is not None and np.array_equal(got, want),
                  f"lookup {term!r} filter_removed={fr}")
    queries = [[b"common", b"odd"],        # base > L: ladder re-serve
               [b"x1", b"x2"],             # 100 results: small-P overflow
               [b"w001", b"missing"],      # missing term empties the AND
               [b"w002"],                  # single term
               [b"late", b"common", b"w003"],
               [b"w004", b"w005", b"common"]]

    def oracle(q, op="and", fr=False):
        sets = [host[t] for t in q if t in host]
        if op == "or":
            out = (np.unique(np.concatenate(sets)) if sets
                   else np.zeros(0, np.uint32))
        elif len(sets) < len(q):
            out = np.zeros(0, np.uint32)
        else:
            out = sets[0]
            for v in sets[1:]:
                out = np.intersect1d(out, v)
        return np.setdiff1d(out, removed) if fr else out

    want = [oracle(q) for q in queries]
    got = eng.boolean(queries, "and")
    staged = eng.boolean_staged([queries, queries[::-1]], "and")
    cols = eng.boolean_staged([queries], "and", columnar=True)[0]
    for i, w in enumerate(want):
        check(np.array_equal(got[i], w), f"boolean AND query {i}")
        check(np.array_equal(staged[0][i], w), f"staged AND query {i}")
        check(np.array_equal(staged[1][len(want) - 1 - i], w),
              f"staged AND query {i} (second batch)")
        check(np.array_equal(cols[0][cols[1][i]:cols[1][i + 1]], w),
              f"columnar staged AND query {i}")
    fr = eng.boolean(queries[:2], "and", filter_removed=True)
    for g, w in zip(fr, want[:2]):
        check(np.array_equal(g, np.setdiff1d(w, removed)), "filtered AND")
    st = eng.last_stream_stats
    check(st["ladder_reserve"] >= 1 and st["small_p_overflow"] >= 1,
          f"phase 4 did not reach the follow-up classes: {st}")

    # OR, pages and staged lookup; one class of 8 blocks, so every query
    # over 1024 postings goes singly (the path beyond the largest class)
    eng._SB_CLASSES = (8,)
    orq = queries + [[b"common", b"late", b"missing"], [b"missing"]]
    check(len(host[b"common"]) > 1024, "phase 4: no query reaches the singles")
    for flt in (False, True):
        w_or = [oracle(q, "or", flt) for q in orq]
        for i, g in enumerate(eng.boolean(orq, "or", filter_removed=flt)):
            check(np.array_equal(g, w_or[i]), f"OR query {i} fr={flt}")
        vals, vo = eng.boolean_staged([orq], "or", flt, columnar=True)[0]
        for i, w in enumerate(w_or):
            check(np.array_equal(vals[vo[i]:vo[i + 1]], w),
                  f"staged OR query {i} fr={flt}")
        for op in ("and", "or"):
            pv, pvo, pc = eng.boolean_staged([orq], op, flt, columnar=True,
                                             prefix_p=4)[0]
            for i, q in enumerate(orq):
                w = oracle(q, op, flt)
                check(pc[i] == len(w) and np.array_equal(
                    pv[pvo[i]:pvo[i + 1]], w[:4]),
                    f"{op} page of query {i} fr={flt}")
    lk = eng.lookup_staged([look], columnar=True)[0]
    for i, term in enumerate(look):
        w = host.get(term, np.zeros(0, np.uint32))
        check(np.array_equal(lk[0][lk[1][i]:lk[1][i + 1]], w),
              f"lookup_staged {term!r}")
    print(f"[phase 4] engine from InvertedIndex: lookup, AND, OR, pages and "
          f"lookup_staged equal the oracle ({len(orq)} queries, "
          f"{len(look)} lookups, AND follow-ups {st})")


def device_view(torch, eng):
    """An engine over eng's serving state without the retained tables:
    the same snapshot tensors (nothing uploads again), so every read and
    stream takes the device route."""
    from inverted_index_2_tpu_torch import QueryEngine

    bare = QueryEngine(eng.snap, L=eng.L, device=eng.device)
    bare._publish(eng._state.replace(tables=None, delta_tables=None))
    return bare


def phase_checkpoint_small(torch, device):
    """Phase 4, checkpoints and reads: an InvertedIndex (the port's) whose
    terms hold bytes 0x80 and 0xFF and a posting 0xFFFFFFFF; its checkpoint
    round-trips the tables and fingerprint; from_checkpoint against the
    same index unchanged (no refresh), after an additive put (a delta) and
    after a merge (a rebuild); in every state lookup, read_range and
    prefix_search on the host route (retained tables) and the device route
    (none) equal the index's host reads."""
    import os

    from inverted_index_2_tpu_torch import InvertedIndex, QueryEngine, to_slice
    from inverted_index_2_tpu_torch.models.checkpoint import (
        _ARRAYS, load_checkpoint, load_fingerprint)
    from inverted_index_2_tpu_torch.models.snapshot import (
        _index_fingerprint, snapshot_tables)
    from inverted_index_2_tpu_torch.ops import cuda_decode

    rng = np.random.default_rng(17)
    vocab = ([f"r{i:03d}".encode() for i in range(60)]
             + [b"\x80a", b"\x80\xff", b"\xff", b"\xff\xff\x01", b"z\x80"])
    prefixes = [b"r0", b"r05", b"r", b"\x80", b"\x80\xff", b"\xff",
                b"\xff\xff", b"z", b"q", b"", b"r059", b"\x7f", b"\xff\x00"]
    ranges = [(None, None), (b"r010", b"r040"), (b"\x80", None),
              (None, b"r003"), (b"s", b"t"), (b"\xff", b"\xff\xff\xff")]
    with tempfile.TemporaryDirectory() as d:
        ii = InvertedIndex(os.path.join(d, "idx"))
        for v in range(1, 400):
            ii.put([vocab[j] for j in rng.choice(len(vocab), 3,
                                                 replace=False)], v)
        ii.put([b"r001", b"\xff"], 0xFFFFFFFF)
        while ii.merge(1, 100, 2) > 0:
            pass
        path = os.path.join(d, "snap.ckpt")

        def same_rows(got, want):
            return len(got) == len(want) and all(
                a[0] == b[0] and np.array_equal(a[1], b[1])
                for a, b in zip(got, want))

        def reads(eng, stage):
            bare = device_view(torch, eng)
            k1 = cuda_decode.decode_postings.launches
            host = {tv.term: tv.values for tv in to_slice(ii.read(None, None))}
            terms = sorted(host) + [b"missing", b"\x80"]
            for t, got in zip(terms, eng.lookup(terms)):
                check((got is None and t not in host) or (
                    got is not None and np.array_equal(got, host[t])),
                    f"{stage}: lookup {t!r}")
            want_p = ii.prefix_search(prefixes)
            for route, e in (("host", eng), ("device", bare)):
                for mn, mx in ranges:
                    # read() walks the shards in turn: sort by term
                    want = sorted(((tv.term, tv.values)
                                   for tv in to_slice(ii.read(mn, mx))),
                                  key=lambda tv: tv[0])
                    check(same_rows(list(e.read_range(mn, mx)), want),
                          f"{stage}: {route} read_range({mn!r}, {mx!r})")
                got = e.prefix_search(prefixes)
                check(set(got) == set(want_p) and all(
                    np.array_equal(got[p], want_p[p]) for p in got),
                    f"{stage}: {route} prefix_search")
            check(device == "cpu" or cuda_decode.decode_postings.launches > k1,
                  f"{stage}: the device reads never launched K1")

        eng = QueryEngine.from_index(ii, L=128, device=device)
        eng.save_checkpoint(ii, path)
        t, meta = load_checkpoint(path)
        fresh = snapshot_tables(ii)
        check(all(np.array_equal(getattr(t, n), getattr(fresh, n))
                  for n in _ARRAYS)
              and load_fingerprint(meta) == _index_fingerprint(ii, False),
              "the checkpoint did not round-trip the tables")
        reads(eng, "from_index")
        stages = []
        for stage in ("unchanged index", "additive put", "merged index"):
            if stage == "additive put":
                ii.put([b"r002", b"\x80new", b"\xff"], 5000)
            elif stage == "merged index":
                while ii.merge(1, 1000, 2) > 0:
                    pass
            w = QueryEngine.from_checkpoint(path, index=ii, L=128,
                                            device=device)
            w.device_wait()
            check(w.device_ready() and w.refresh(ii) is False
                  and w._fingerprint == _index_fingerprint(ii, False),
                  f"checkpoint, {stage}: not reconciled with the index")
            check((w.delta is not None) == (stage == "additive put"),
                  f"checkpoint, {stage}: delta tier {w.delta is not None}")
            reads(w, f"checkpoint, {stage}")
            stages.append(f"{stage}: delta {w.delta is not None}")
    print(f"[phase 4] checkpoints: tables and fingerprint round-trip; "
          f"from_checkpoint ({'; '.join(stages)}); lookup, read_range and "
          f"prefix_search on both routes equal the index's host reads")


def prefix_oracle(terms_mat, term_list, p: bytes):
    """The sorted union of the values of every corpus term (12 bytes, rows
    of terms_mat in order) that starts with p; None when no term does."""
    if len(p) > 12:
        return None
    head = terms_mat[:, :len(p)]
    pref = np.frombuffer(p, dtype=np.uint8)
    rows = np.nonzero((head == pref).all(axis=1))[0]
    if not len(rows):
        return None
    # a sort and a compare of neighbours: numpy's unique hashes from 2.3 on,
    # many times slower on these unions
    v = np.sort(np.concatenate([term_list(i) for i in rows]))
    return v[np.concatenate([[True], v[1:] != v[:-1]])]


def phase_host(torch, eng, terms_mat, main_list, term_bytes, streams, qps,
               drive):
    """Phase 5, the host route and the rest of the engine's surface at full
    size: the router's host route against the device streams of phase 5,
    the routing of auto, the hybrid AND stream, range and prefix reads on
    the device, a warm checkpoint start, warmup() and stats()."""
    import gc

    from inverted_index_2_tpu_torch import QueryEngine
    from inverted_index_2_tpu_torch.codec import native
    from inverted_index_2_tpu_torch.models import query_engine as qe
    from inverted_index_2_tpu_torch.models.checkpoint import save_tables

    uniform, zipf, first_terms = streams
    t_phase = time.perf_counter()
    calls = {"serve": 0, "lookup": 0}
    serve0, tier0 = eng._host_serve_columnar, eng._host_tier_columnar

    def serve(*a, **k):
        calls["serve"] += 1
        return serve0(*a, **k)

    def tier(*a, **k):
        calls["lookup"] += 1
        return tier0(*a, **k)

    eng._host_serve_columnar, eng._host_tier_columnar = serve, tier
    host_qps = {}
    with env(TPI_HOST_BOOL="all"):
        for path, stream, op, lookup in (
                ("host and uniform", uniform, "and", False),
                ("host and zipf", zipf, "and", False),
                ("host or uniform", uniform[:2], "or", False),
                ("host lookup_staged", first_terms, "or", True)):
            _, host_qps[path] = drive(path, lambda: run_stream(
                eng, main_list, term_bytes, stream, path, op=op,
                lookup=lookup, stream_stats=False))
    del eng._host_serve_columnar, eng._host_tier_columnar
    check(calls["serve"] > 0 and calls["lookup"] > 0,
          f"the host serve did not run: {calls}")
    print(f"[phase 5] host route, native codec {native.available()}: QPS "
          + ", ".join(f"{p[5:]} {q:.1f} (device {qps[p[5:]]:.1f})"
                      for p, q in host_qps.items())
          + f"; host serve calls {calls}")

    # routing: auto's pick per op against the port's thresholds
    with env(TPI_HOST_BOOL=None, TPI_LINK_MBPS=None):
        probe = qe._link_mbps(eng.device)
        busy = eng._host_busy()
        picks = {"and staged": eng._host_boolean_route("and", staged=True),
                 "and one-shot": eng._host_boolean_route("and"),
                 "or staged": eng._host_boolean_route("or", staged=True),
                 "or one-shot": eng._host_boolean_route("or")}
    and_host = probe < eng._HOST_ROUTE_LINK_MBPS
    or_host = probe < eng._HOST_ROUTE_OR_LINK_MBPS
    check(picks == {"and staged": and_host and not busy,
                    "and one-shot": and_host,
                    "or staged": or_host and not busy,
                    "or one-shot": or_host},
          f"auto's picks {picks} do not follow the thresholds")
    print(f"[phase 5] routing: link probe {probe:.1f} MiB/s (AND threshold "
          f"{eng._HOST_ROUTE_LINK_MBPS}, OR threshold "
          f"{eng._HOST_ROUTE_OR_LINK_MBPS}), host busy {busy}; auto takes "
          + ", ".join(f"{k} {'host' if v else 'device'}"
                      for k, v in picks.items()))

    # the hybrid AND stream: both sides serve, the result is the device's
    ub = [[[term_bytes[i] for i in q] for q in b] for b in uniform]
    want = eng.boolean_staged(ub, "and", columnar=True, depth=4)
    with env(TPI_HOST_BOOL=None, TPI_HYBRID="1",
             TPI_LINK_MBPS=str(eng._HOST_ROUTE_LINK_MBPS / 2)):
        check(eng._hybrid_staged("and"), "the hybrid stream is not on")
        t0 = time.perf_counter()
        got = drive("hybrid and uniform", lambda: eng.boolean_staged(
            ub, "and", columnar=True, depth=4))
        dt = time.perf_counter() - t0
    hb = eng.last_stream_stats["host_batches"]
    db = eng.last_stream_stats["device_batches"]
    check(hb > 0 and db > 0, f"hybrid: the host served {hb} and the device "
          f"{db} of {len(ub)} batches")
    check(all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
              for a, b in zip(got, want)),
          "hybrid: the result differs from the device-only stream")
    print(f"[phase 5] hybrid AND uniform: of {len(ub)} batches the host "
          f"served {hb} and the device {db} (a stolen batch counts on both), "
          f"{BATCH * len(ub) / dt:.1f} QPS in one pass; bit-identical to the "
          "device-only stream")
    del got, want

    # range and prefix reads on the device: an engine over the same
    # snapshot with no tables, against the host route and an oracle
    bare = device_view(torch, eng)
    rng = np.random.default_rng(41)
    n = len(terms_mat)
    # a 1-byte prefix of this corpus holds about 7,700 terms (7.7M values)
    # and a 2-byte one about 300, so few of them: the time of the reads is
    # the union of what they hold
    pick = rng.choice(n, size=200, replace=False)
    prefixes = ([term_bytes[i][:1] for i in pick[:1]]
                + [term_bytes[i][:2] for i in pick[1:17]]
                + [term_bytes[i][:3] for i in pick[17:194]]
                + [term_bytes[i] for i in pick[194:200]]
                + [term_bytes[i][:5] for i in rng.choice(n, 40)]
                + [b"0", b"A", b"\x7f", b"\x80", b"\xff", b"a\x80", b"b\xff",
                   b"zz\xff", b"\xff\xff", b"m\x80\x80", b"z" * 13,
                   b"q\x00", b"\x80\xff", b"yy\x7f", b"{", b"`"])
    t0 = time.perf_counter()
    pd = drive("device prefix", lambda: bare.prefix_search(prefixes))
    t_dev_p = time.perf_counter() - t0
    t0 = time.perf_counter()
    ph = eng.prefix_search(prefixes)
    t_host_p = time.perf_counter() - t0
    check(set(pd) == set(ph), "prefix_search: the routes match different "
          "prefixes")
    for p in prefixes:
        w = prefix_oracle(terms_mat, main_list, p)
        check((w is None and p not in pd) or (
            w is not None and np.array_equal(pd[p], w)
            and np.array_equal(ph[p], w)),
            f"prefix_search {p!r} differs from the oracle")
    nvals = sum(len(v) for v in pd.values())
    lo = int(rng.integers(0, n - 4 * 4096))
    windows = [(term_bytes[lo], term_bytes[lo + 3 * 4096 + 100]),
               (term_bytes[n - 5000], None)]
    t_dev_r = t_host_r = 0.0
    n_rows = 0
    for mn, mx in windows:
        t0 = time.perf_counter()
        rd = drive("device range", lambda: list(bare.read_range(mn, mx)))
        t_dev_r += time.perf_counter() - t0
        t0 = time.perf_counter()
        rh = list(eng.read_range(mn, mx))
        t_host_r += time.perf_counter() - t0
        first = term_bytes.index(mn)
        last = n - 1 if mx is None else term_bytes.index(mx)
        check(len(rd) == len(rh) == last - first + 1,
              f"read_range({mn!r}, {mx!r}): {len(rd)} and {len(rh)} terms")
        for j, ((td, vd), (th, vh)) in enumerate(zip(rd, rh)):
            check(td == th == term_bytes[first + j]
                  and np.array_equal(vd, vh)
                  and np.array_equal(vd, main_list(first + j)),
                  f"read_range: term {first + j} differs")
        n_rows += len(rd)
    print(f"[phase 5] prefix_search: {len(prefixes)} prefixes, {len(pd)} "
          f"matched, {nvals} values; device {t_dev_p:.4f} s, host tables "
          f"{t_host_p:.4f} s; read_range: {n_rows} terms in 2 windows "
          f"(chunks of {eng._RANGE_CHUNK}); device {t_dev_r:.4f} s, host "
          f"tables {t_host_r:.4f} s; both routes equal the oracle")
    del bare, pd, ph, rd, rh

    # a warm checkpoint start of the phase-5 tables
    lk_terms = [term_bytes[i] for i in rng.choice(n, size=BATCH,
                                                  replace=False)]
    want_lk = eng.lookup(lk_terms)
    want_and = eng.boolean_staged(ub[:1], "and", columnar=True)[0]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "main.ckpt")
        t0 = time.perf_counter()
        save_tables(eng.tables, path)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = QueryEngine.from_checkpoint(path, L=L_MAIN, device=eng.device)
        t_load = time.perf_counter() - t0
        lk = warm.lookup(lk_terms)
        t_first = time.perf_counter() - t0
        in_window = not warm.device_ready()
        first_and = warm.boolean_staged(ub[:1], "and", columnar=True)[0]
        warm.device_wait()
        t_ready = time.perf_counter() - t0
        lk2 = warm.lookup(lk_terms)
        second_and = warm.boolean_staged(ub[:1], "and", columnar=True)[0]
        os.remove(path)
    for got in (lk, lk2):
        check(all(np.array_equal(a, b) for a, b in zip(got, want_lk)),
              "warm start: a lookup differs from the phase-5 engine")
    for got in (first_and, second_and):
        check(all(np.array_equal(a, b) for a, b in zip(got, want_and)),
              "warm start: the AND batch differs from the phase-5 engine")
    print(f"[phase 5] warm start: checkpoint saved in {t_save:.4f} s; "
          f"from_checkpoint returned in {t_load:.4f} s, first answer "
          f"({BATCH} lookups) at {t_first:.4f} s, "
          + ("inside the upload window" if in_window else
             "after the upload window had closed")
          + f"; upload {warm.upload_seconds:.4f} s on a side stream, device "
          f"ready at {t_ready:.4f} s; lookups and an AND batch equal the "
          "phase-5 engine before and after the swap")
    del warm, lk, lk2, first_and, second_and
    gc.collect()

    t0 = time.perf_counter()
    nw = eng.warmup()
    print(f"[phase 5] warmup(): {nw} paths in {time.perf_counter() - t0:.4f} "
          f"s; stats() {eng.stats()}")
    print(f"[phase 5] host route phase took {time.perf_counter() - t_phase:.4f}"
          " s")
    return prefixes, windows


def run_stream(eng, term_list, term_bytes, stream, name, op="and",
               prefix_p=0, depth=4, lookup=False, reps=3, stream_stats=True,
               tag="phase 5", sink=None):
    """Serve one stream `reps` times after a warm pass; check a sample of
    the last pass against the oracle (term_list(i): term i's postings).
    stream: batches of queries (term index arrays), or of term indexes with
    lookup=True. An AND stream's counts (last_stream_stats) are checked
    unless stream_stats is False (the host route and the mesh keep none).
    The last pass's results are appended to `sink` when one is given.
    Returns the byte batches and the median QPS."""
    if lookup:
        batches = [[term_bytes[i] for i in b] for b in stream]

        def serve(bs):
            return eng.lookup_staged(bs, columnar=True, depth=depth)
    else:
        batches = [[[term_bytes[i] for i in q] for q in b] for b in stream]

        def serve(bs):
            return eng.boolean_staged(bs, op, columnar=True, depth=depth,
                                      prefix_p=prefix_p)
    serve(batches[:1])  # warm
    nq = sum(len(b) for b in batches)
    qps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = serve(batches)
        qps.append(nq / (time.perf_counter() - t0))
    stats = ""
    if op == "and" and not prefix_p and not lookup and stream_stats:
        st = dict(eng.last_stream_stats)
        check(st["queries"] == nq, f"{name}: served {st['queries']} of {nq}")
        stats = f"; follow-ups {st}"
    rng = np.random.default_rng(23)
    checked = 0
    for bi in range(len(batches)):
        vals, vo = out[bi][0], out[bi][1]
        check(len(vo) == len(batches[bi]) + 1, f"{name}: batch {bi} shape")
        for qi in rng.choice(len(batches[bi]), size=64, replace=False):
            if lookup:
                want = term_list(stream[bi][qi])
            elif op == "and":
                want = and_oracle(term_list, stream[bi][qi])
            else:
                want = or_oracle(term_list, stream[bi][qi])
            got = vals[vo[qi]:vo[qi + 1]]
            if prefix_p:
                check(out[bi][2][qi] == len(want),
                      f"{name}: batch {bi} query {qi} count differs")
                want = want[:prefix_p]
            check(np.array_equal(got, want),
                  f"{name}: batch {bi} query {qi} differs from the oracle")
            checked += 1
    nres = sum(len(o[0]) for o in out)
    if sink is not None:
        sink.append(out)
    print(f"[{tag}] {name}: {nq} queries per pass, QPS of {reps} passes "
          f"{[round(q, 1) for q in qps]}; {nres} result values{stats}; "
          f"{checked} sampled queries equal the oracle")
    return batches, sorted(qps)[len(qps) // 2]


# after K2 the AND streams launch no compaction: neither torch.topk's
# kernels nor K4's (lower case, matched within the profiler's kernel names)
NO_COMPACTION = ("topk", "kthvalue", "bitonicsort", "compact_rows_kernel")


def profile_stream(torch, serve, name, forbid=(), tag="phase 5"):
    """Device busy share of one stream pass: the summed time of the kernels
    and copies on the card over the pass's wall time (torch.profiler). No
    kernel whose name holds a word of `forbid` may have run. Returns the
    launches of each kernel of K1-K4 in the pass, by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    banned = [e.key for e in events
              if any(w in e.key.lower() for w in forbid)]
    check(not banned, f"profile {name}: kernels that the path should no "
          f"longer launch: {banned}")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    launches = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    # K4's device time by kernel (csrc/sort_rows.cu) and its share
    k4 = {k: [0.0, 0] for k in K4_KERNELS}
    k23 = {k: [0.0, 0] for k in K1_KERNELS + AND_KERNELS}
    for e in events:
        for group in (k4, k23):
            for k in group:
                if k in e.key:
                    group[k][0] += e.self_device_time_total
                    group[k][1] += e.count
    k4_us = sum(v[0] for v in k4.values())
    print(f"[{tag}] profile {name}: wall {wall:.6f} s, device busy "
          f"{busy_us / 1e6:.6f} s = {busy_us / 1e6 / wall:.4f} of the pass, "
          f"{launches} kernel launches; top device time: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total:.1f} us "
                      f"x{e.count}" for e in top)
          + f"; K4 {k4_us:.1f} us = {k4_us / max(busy_us, 1e-9):.4f} of the "
          "device time: "
          + ", ".join(f"{k} {v[0]:.1f} us x{v[1]}" for k, v in k4.items())
          + "; K1, K2 and K3: "
          + ", ".join(f"{k} {v[0]:.1f} us x{v[1]}" for k, v in k23.items())
          + (f"; none of {forbid} ran" if forbid else ""))
    return {k: v[1] for group in (k4, k23) for k, v in group.items()}


def phase_main(torch, args, device="cuda"):
    """Phase 5 setup: corpus, host tables, upload, engine."""
    from inverted_index_2_tpu_torch import QueryEngine
    from inverted_index_2_tpu_torch.models.snapshot import (
        build_host_tables, upload_tables)

    t0 = time.perf_counter()
    terms_mat, offsets, values, voffs = gen_corpus(args.terms, 1000, args.seed)
    t1 = time.perf_counter()
    tables = build_host_tables(terms_mat.tobytes(), offsets, values, voffs)
    t2 = time.perf_counter()
    snap = upload_tables(tables, device=device)
    int(snap.blocks[-1, 0])  # waits for the upload
    t3 = time.perf_counter()
    eng = QueryEngine(snap, L=L_MAIN, tables=tables, device=device)
    print(f"[phase 5] corpus: {len(terms_mat)} terms, {len(values)} postings "
          f"(generate {t1 - t0:.4f} s, host tables {t2 - t1:.4f} s, upload "
          f"{t3 - t2:.4f} s); arena {tuple(snap.blocks.shape)} = "
          f"{snap.blocks.numel() * 4} bytes, device tables "
          f"{snap.device_bytes()} bytes, ladder {eng._levels()}")
    return eng, terms_mat, values, voffs


def phase_delta_setup(torch, eng, terms_mat, values, voffs, term_bytes,
                      seed):
    """Phase 5 delta setup: the delta tier's tables (gen_delta) built and
    uploaded as _try_delta_refresh builds them, and the serving state that
    refresh would publish; plus the oracle over the union of both tiers."""
    from inverted_index_2_tpu_torch.models.snapshot import (
        build_host_tables, upload_tables)

    t0 = time.perf_counter()
    mat, ids, dvals, dvoffs, new = gen_delta(terms_mat, values, voffs,
                                             DELTA_TERMS, seed)
    t1 = time.perf_counter()
    dt = build_host_tables(mat.tobytes(),
                           np.arange(len(mat) + 1, dtype=np.int64) * 12,
                           dvals, dvoffs)
    dsnap = upload_tables(dt, device=eng.device)
    int(dsnap.blocks[-1, 0])  # waits for the upload
    t2 = time.perf_counter()
    n_main = len(terms_mat)
    dmap = {int(i): dvals[dvoffs[k]:dvoffs[k + 1]] for k, i in enumerate(ids)}

    def term_list(i):
        base = (values[voffs[i]:voffs[i + 1]] if i < n_main
                else np.zeros(0, np.uint32))
        extra = dmap.get(int(i))
        return base if extra is None else np.union1d(base, extra).astype(
            np.uint32)

    state = eng._state.replace(delta=dsnap, delta_tables=dt)
    print(f"[phase 5] delta: {len(mat)} terms ({int((ids < n_main).sum())} "
          f"grown main terms, {len(new)} new), {len(dvals)} postings "
          f"(generate {t1 - t0:.4f} s, host tables and upload "
          f"{t2 - t1:.4f} s); ladder over both tiers "
          f"{eng._levels(state)}")
    return {"state": state, "snap": dsnap, "tables": dt,
            "term_list": term_list, "n_terms": n_main + len(new),
            "term_bytes": term_bytes + [t.tobytes() for t in new]}


def phase_delta_window(torch, eng, delta, d_uniform, d_zipf, drive):
    """Phase 5, the delta window: the delta published as refresh publishes
    it, then the dual AND stream over uniform and Zipf batches, OR pages,
    full-result OR and lookup over the union vocabulary, sampled results
    against the per-term union oracle, and one profiled dual AND pass."""
    eng._publish(eng._state.replace(delta=delta["snap"],
                                    delta_tables=delta["tables"]))
    check(eng.delta is not None, "the delta was not published")
    tl, tb = delta["term_list"], delta["term_bytes"]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    dub, q_du = drive("dual and uniform", lambda: run_stream(
        eng, tl, tb, d_uniform, "dual AND uniform"))
    dzb, q_dz = drive("dual and zipf", lambda: run_stream(
        eng, tl, tb, d_zipf, "dual AND zipf"))
    _, q_dp = drive("dual or pages", lambda: run_stream(
        eng, tl, tb, d_uniform, f"dual OR pages P={PAGE_P}", op="or",
        prefix_p=PAGE_P))
    _, q_do = drive("dual or", lambda: run_stream(
        eng, tl, tb, d_uniform[:1], "dual OR", op="or", reps=2))
    pick = np.random.default_rng(29).choice(delta["n_terms"], size=BATCH,
                                            replace=False)
    t1 = time.perf_counter()
    got = drive("dual lookup", lambda: eng.lookup([tb[i] for i in pick]))
    dt = time.perf_counter() - t1
    n = min(512, BATCH)
    for j in np.random.default_rng(31).choice(BATCH, size=n, replace=False):
        check(got[j] is not None and np.array_equal(got[j], tl(pick[j])),
              f"dual lookup of term {pick[j]} differs from the union")
    print(f"[phase 5] dual lookup: {BATCH} terms in {dt:.4f} s; {n} sampled "
          f"lists equal the union of both tiers")
    print(f"[phase 5] delta window median QPS: dual AND uniform {q_du:.1f}, "
          f"dual AND zipf {q_dz:.1f}, dual OR pages {q_dp:.1f}, dual OR "
          f"{q_do:.1f}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes")
    profile_stream(torch, lambda: eng.boolean_staged(
        dub, "and", columnar=True, depth=4), "dual AND uniform")
    profile_stream(torch, lambda: eng.boolean_staged(
        dub, "or", columnar=True, depth=4, prefix_p=PAGE_P), "dual OR pages")
    print(f"[phase 5] delta window took {time.perf_counter() - t0:.4f} s")



# phase 6: the mesh engine at the phase-5 size, on partitions of one card
MESH_DS = (1, 4)
N_MESH_BATCHES = 2
MESH_DELTA_DOCS = 64
# phase 7: one shard of the config-3 deployment (10M terms over 1,024
# shards) in overlapping segments
MERGE_TERMS = 9_800
MERGE_SEGMENTS = 8

# the library sorts that would stand in for K4 (lower case, within the
# profiler's kernel names)
TORCH_SORTS = ("bitonicsort", "radixsort", "topk", "kthvalue")


@contextlib.contextmanager
def capture_first(mod, name):
    """While active, records the positional arguments of the first call of
    mod.name (and passes every call through): yields a list that holds
    them once the call has happened."""
    got = []
    real = getattr(mod, name)

    def spy(*a, **k):
        if not got:
            got.append(a)
        return real(*a, **k)

    setattr(mod, name, spy)
    try:
        yield got
    finally:
        setattr(mod, name, real)


def phase_mesh_kernels(torch, m, batch):
    """Phase 6, K1, K3 and K4 at the shapes the partitions give them, each
    against its plain version and timed beside it and its bound: K1 on
    partition 0 for every term slot of one uniform batch with the
    partition's found mask (the rows it does not hold stay unwritten), K3 on
    the first query tile of that batch's AND pass, K4's sort and compaction
    on the first tile of its OR pass. Returns the kernels-line rows."""
    from types import SimpleNamespace

    from inverted_index_2_tpu_torch.models import steps
    from inverted_index_2_tpu_torch.ops.dict_search import resolve
    from inverted_index_2_tpu_torch.utils.u32 import to_device

    s = m.snap
    dev = s.devices[0]
    qk, kv = steps._pack_queries(batch, s.width)
    Q, K = qk.shape[:2]
    flat = to_device(qk, dev).reshape(Q * K, -1)
    idx, found = resolve(s.keys[0], flat, s.hash_slots[0], s.max_probes)
    check(0 < int(found.sum()) < int(kv.sum()),
          "K1 mesh: partition 0 holds all or none of the batch's terms")
    part = SimpleNamespace(blocks=s.blocks[0],
                           term_block_start=s.term_block_start[0],
                           counts=s.counts[0])
    res = {"decode_postings.mesh": _check_k1(
        torch, part, idx.to(torch.int32), L_MAIN, found)}
    del flat, idx, found
    with capture_first(steps, "intersect_many") as got:
        m.boolean(batch, "and")
    lists, ncnt, kvt = got[0]
    err, k_ms, p_ms, b_ms, b_by, _ = _check_k3(
        torch, lists, ncnt, kvt, f"mesh tile, D={s.n_devices}")
    res["intersect_many.mesh"] = (err, k_ms, p_ms, None, b_ms, b_by)
    del lists, ncnt, kvt, got
    with CaptureK4() as cap:
        m.boolean(batch, "or")
    x, run = cap.sort
    res["sort_rows.mesh"] = _check_sort(torch, x, run,
                                        f"mesh OR tile, D={s.n_devices}")
    vals, keep = cap.compact
    res["compact_rows.mesh"] = _check_compact(
        torch, vals, keep, f"mesh OR tile, D={s.n_devices}")
    del cap, x, vals, keep
    with CaptureWire() as cw:
        m.boolean(batch, "or")
    cw.verify(torch, f"mesh OR pass, D={s.n_devices}", pack=False)
    torch.cuda.empty_cache()
    return res


def _same_staged(a, b):
    return len(a) == len(b) and all(
        len(x) == len(y) and all(np.array_equal(u, w) for u, w in zip(x, y))
        for x, y in zip(a, b))


def phase_mesh(torch, eng, terms_mat, values, voffs, term_bytes, uniform,
               main_list, drive, reads, seed):
    """Phase 6: MeshQueryEngine at the phase-5 size, D = 1 and D = 4
    partitions on cuda:0, started from a checkpoint of the phase-5 tables
    reconciled against an (empty) InvertedIndex. For each D: lookup of
    BATCH terms, boolean_staged AND and OR over N_MESH_BATCHES uniform
    batches (a query of the two longest lists among them, so the ladder
    re-serves), OR pages, lookup_staged, prefix_search and read_range
    (phase 5's inputs); every result equal to the single-card QueryEngine's
    bit for bit, sampled results to the oracle. Then refresh() through an
    additive put (a delta on partition 0) and one dual AND batch, equal to
    the single-card engine's dual stream and the oracle. At D = 4 the
    kernels are checked at the partition shapes and one AND and one OR
    pass are profiled. Returns the kernels-line rows."""
    import gc

    from inverted_index_2_tpu_torch import InvertedIndex, MeshQueryEngine
    from inverted_index_2_tpu_torch.models.checkpoint import save_tables
    from inverted_index_2_tpu_torch.models.snapshot import (
        _index_fingerprint, snapshot_tables, upload_tables)

    t_phase = time.perf_counter()
    n = len(terms_mat)
    prefixes, windows = reads
    longest = np.argsort(np.diff(voffs))[-2:]
    stream = [list(b) for b in uniform[:N_MESH_BATCHES]]
    stream[0][0] = longest
    first_terms = [[q[0] for q in b] for b in stream]
    pick = np.random.default_rng(seed + 6).choice(n, size=BATCH,
                                                  replace=False)
    lk_terms = [term_bytes[i] for i in pick]

    # the single-card engine's answers on the device route (reads on its
    # tables), main tier only
    eng._publish(eng._state.replace(delta=None, delta_tables=None))
    ub = [[[term_bytes[i] for i in q] for q in b] for b in stream]
    lb = [[term_bytes[i] for i in b] for b in first_terms]
    ref = {"lookup": eng.lookup(lk_terms),
           "and": eng.boolean_staged(ub, "and", columnar=True, depth=4),
           "or": eng.boolean_staged(ub, "or", columnar=True, depth=4),
           "pages": eng.boolean_staged(ub, "or", columnar=True, depth=4,
                                       prefix_p=PAGE_P),
           "lookup_staged": eng.lookup_staged(lb, columnar=True),
           "prefix": eng.prefix_search(prefixes),
           "range": [list(eng.read_range(mn, mx)) for mn, mx in windows]}

    # the additive put of the refresh: documents of 6 main terms and 2 of
    # 32 new ones (first byte a digit: never a main term), ids above main's
    rng = np.random.default_rng(seed + 7)
    new_terms = [b"%d" % (i % 10) + bytes(rng.integers(97, 123, 11,
                                                       dtype=np.uint8))
                 for i in range(32)]
    top = int(values.max()) + 1
    docs = []
    for k in range(MESH_DELTA_DOCS):
        terms = ([term_bytes[i] for i in rng.choice(n, 6, replace=False)]
                 + [new_terms[j] for j in rng.choice(32, 2, replace=False)])
        docs.append((terms, top + 7 * k))
    added = {}
    for terms, doc in docs:
        for t in terms:
            added.setdefault(t, []).append(doc)
    index_of = {term_bytes[i]: i for i in range(n)}

    def union_list(t):
        base = (main_list(index_of[t]) if t in index_of
                else np.zeros(0, np.uint32))
        extra = np.array(added.get(t, []), dtype=np.uint32)
        return np.union1d(base, extra).astype(np.uint32)

    # the dual batch: each delta document's first grown term with its new
    # terms, then a uniform batch
    dual_batch = ([[terms[0], terms[6], terms[7]] for terms, _ in docs]
                  + ub[1][: BATCH - len(docs)])

    rows = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "main.ckpt")
        # the checkpoint's fingerprint is an empty index's: an engine
        # started from it against an empty index has nothing to reconcile,
        # and the index's writes are its delta
        save_tables(eng.tables, path, fingerprint=_index_fingerprint(
            InvertedIndex(os.path.join(d, "empty")), False))
        for D in MESH_DS:
            tag = f"mesh{D}"
            ii = InvertedIndex(os.path.join(d, tag))
            t0 = time.perf_counter()
            m = MeshQueryEngine.from_checkpoint(
                path, index=ii, mesh=[eng.device] * D, L=L_MAIN)
            t_build = time.perf_counter() - t0
            check(m.delta is None and m.refresh(ii) is False,
                  f"{tag}: the checkpoint is not reconciled with the index")
            nw = m.warmup()
            st = m.stats()
            print(f"[phase 6] D={D}: from_checkpoint in {t_build:.4f} s, "
                  f"warmup() {nw} paths; partition {st['partition']}, "
                  f"ladder {st['ladder']}")
            if D == max(MESH_DS):
                rows = phase_mesh_kernels(torch, m, ub[0])
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got = drive(f"{tag} lookup", lambda: m.lookup(lk_terms))
            t_lk = time.perf_counter() - t0
            check(all(np.array_equal(a, b) for a, b in zip(got, ref["lookup"])),
                  f"{tag}: lookup differs from the single-card engine")
            for j in np.random.default_rng(3).choice(BATCH, 256,
                                                     replace=False):
                check(np.array_equal(got[j], main_list(pick[j])),
                      f"{tag}: lookup of term {pick[j]} differs from the "
                      "corpus")
            qps = {}
            for name, op, P, lookup, src in (
                    ("and", "and", 0, False, stream),
                    ("or", "or", 0, False, stream),
                    ("pages", "or", PAGE_P, False, stream),
                    ("lookup_staged", "or", 0, True, first_terms)):
                sink = []
                _, qps[name] = drive(f"{tag} {name}", lambda: run_stream(
                    m, main_list, term_bytes, src, f"{tag} {name}", op=op,
                    prefix_p=P, lookup=lookup, reps=2, stream_stats=False,
                    tag="phase 6", sink=sink))
                check(_same_staged(sink[0], ref[name]),
                      f"{tag} {name}: differs from the single-card engine")
            want = and_oracle(main_list, longest)
            got0 = ref["and"][0]
            check(np.array_equal(got0[0][got0[1][0]:got0[1][1]], want),
                  f"{tag}: the AND of the two longest lists differs")
            t0 = time.perf_counter()
            pm_ = drive(f"{tag} prefix", lambda: m.prefix_search(prefixes))
            t_p = time.perf_counter() - t0
            check(list(pm_) == list(ref["prefix"]) and all(
                np.array_equal(pm_[p], ref["prefix"][p]) for p in pm_),
                f"{tag}: prefix_search differs from the single-card engine")
            t0 = time.perf_counter()
            rr = [drive(f"{tag} range", lambda: list(m.read_range(mn, mx)))
                  for mn, mx in windows]
            t_r = time.perf_counter() - t0
            check(all(len(a) == len(b) and all(
                x[0] == y[0] and np.array_equal(x[1], y[1])
                for x, y in zip(a, b)) for a, b in zip(rr, ref["range"])),
                f"{tag}: read_range differs from the single-card engine")
            del pm_, rr, got
            print(f"[phase 6] D={D} median QPS: AND uniform "
                  f"{qps['and']:.1f}, OR uniform {qps['or']:.1f}, OR pages "
                  f"{qps['pages']:.1f}, lookup_staged "
                  f"{qps['lookup_staged']:.1f}; lookup {BATCH} terms in "
                  f"{t_lk:.4f} s; prefix_search {len(prefixes)} prefixes in "
                  f"{t_p:.4f} s; read_range {len(windows)} windows in "
                  f"{t_r:.4f} s; every result equals the single-card engine; "
                  f"max_memory_allocated {torch.cuda.max_memory_allocated()} "
                  "bytes")
            if D == max(MESH_DS):
                got = profile_stream(torch, lambda: m.boolean_staged(
                    ub, "and", columnar=True, depth=4),
                    f"mesh D={D} AND uniform", K4_KERNELS + TORCH_SORTS,
                    tag="phase 6")
                check(got["decode_postings_kernel"] > 0
                      and got["intersect_kernel"] > 0,
                      f"mesh D={D} AND: K1 or K3 did not run: {got}")
                got = profile_stream(torch, lambda: m.boolean_staged(
                    ub, "or", columnar=True, depth=4),
                    f"mesh D={D} OR uniform", TORCH_SORTS, tag="phase 6")
                check(got["decode_postings_kernel"] > 0
                      and got["merge_runs_kernel"] > 0
                      and got["compact_rows_kernel"] > 0,
                      f"mesh D={D} OR: K1 or K4 did not run: {got}")

            # refresh through an additive put, then one dual AND batch
            for terms, doc in docs:
                ii.put(terms, doc)
            t0 = time.perf_counter()
            check(m.refresh(ii) is True and m.delta is not None,
                  f"{tag}: the additive put made no delta tier")
            t_ref = time.perf_counter() - t0
            if D == MESH_DS[0]:
                dt = snapshot_tables(ii)  # the index holds the delta alone
                eng._publish(eng._state.replace(
                    delta=upload_tables(dt, device=eng.device),
                    delta_tables=dt))
                ref["dual"] = eng.boolean_staged([dual_batch], "and",
                                                 columnar=True)
                eng._publish(eng._state.replace(delta=None,
                                                delta_tables=None))
                check(m.stats()["delta_terms"] == dt.n_terms,
                      f"{tag}: the delta tier holds the wrong terms")
            t0 = time.perf_counter()
            got = drive(f"{tag} dual and", lambda: m.boolean_staged(
                [dual_batch], "and", columnar=True))
            t_dual = time.perf_counter() - t0
            check(_same_staged(got, ref["dual"]),
                  f"{tag}: the dual AND batch differs from the single-card "
                  "engine's dual stream")
            vals, vo = got[0]
            hits = 0
            for qi in list(range(len(docs))) + list(
                    np.random.default_rng(5).choice(len(dual_batch), 64)):
                w = None
                for t in dual_batch[qi]:
                    v = union_list(t)
                    w = v if w is None else np.intersect1d(w, v)
                check(np.array_equal(vals[vo[qi]:vo[qi + 1]], w),
                      f"{tag}: dual AND query {qi} differs from the oracle")
                hits += len(w) > 0
            print(f"[phase 6] D={D}: refresh() with {len(docs)} new "
                  f"documents in {t_ref:.4f} s, delta "
                  f"{m.delta.n_real.tolist()} terms by partition; one dual "
                  f"AND batch of {len(dual_batch)} in {t_dual:.4f} s equals "
                  f"the single-card dual stream and the oracle ({hits} "
                  "checked queries non-empty)")
            del m, got
            gc.collect()
            torch.cuda.empty_cache()
    print(f"[phase 6] took {time.perf_counter() - t_phase:.4f} s")
    return rows


def _segment_bytes(d):
    names = sorted(x for x in os.listdir(d) if x.endswith(("_dict", "_vals")))
    return sorted(open(os.path.join(d, x), "rb").read() for x in names)


def phase_merge(torch, seed, device="cuda"):
    """Phase 7: the device merge at one shard of the config-3 deployment:
    MERGE_TERMS terms of geometric length (mean 1,000) written from numpy
    arrays as MERGE_SEGMENTS normal segments (each posting in one random
    segment, a tenth of them in a second: the inputs overlap), and 1% of
    the distinct doc ids tombstoned. merge_views_device on the card
    against merge_views, both timed; then Shard.merge at the default
    threshold, which takes the device branch, against a host merge of a
    copy of the shard: the same segment files, the same reads."""
    import shutil

    import inverted_index_2_tpu_torch.shard as shard_mod
    from inverted_index_2_tpu_torch import Shard, to_slice
    from inverted_index_2_tpu_torch.ops import merge as merge_mod
    from inverted_index_2_tpu_torch.segment import writer as seg_writer

    t_phase = time.perf_counter()
    terms_mat, _, values, voffs = gen_corpus(MERGE_TERMS, 1000, seed)
    n = len(terms_mat)
    rng = np.random.default_rng(seed)
    term_of = np.repeat(np.arange(n), np.diff(voffs))
    seg = rng.integers(0, MERGE_SEGMENTS, size=len(values))
    seg2 = np.where(rng.random(len(values)) < 0.1,
                    rng.integers(0, MERGE_SEGMENTS, size=len(values)), -1)
    distinct = np.unique(values)
    removed = np.sort(rng.choice(distinct, size=len(distinct) // 100,
                                 replace=False)).astype(np.uint32)
    with tempfile.TemporaryDirectory() as d:
        a, b = os.path.join(d, "device"), os.path.join(d, "host")
        os.makedirs(a)
        n_in = 0
        for k in range(MERGE_SEGMENTS):
            sel = (seg == k) | (seg2 == k)
            cnt = np.bincount(term_of[sel], minlength=n)
            live = np.nonzero(cnt)[0]
            sv = np.zeros(len(live) + 1, dtype=np.int64)
            np.cumsum(cnt[live], out=sv[1:])
            seg_writer.write_normal_segment(
                a, terms_mat[live].tobytes(),
                np.arange(len(live) + 1, dtype=np.int64) * 12,
                values[sel], sv)
            n_in += int(sel.sum())
        sh = Shard(a)
        sh.remove(removed)
        shutil.copytree(a, b)
        views = [s.view for s in sh.segments.snapshot()]
        est = sum(shard_mod._estimate_values(v) for v in views)
        check(len(views) == MERGE_SEGMENTS
              and est >= shard_mod.DEVICE_MERGE_MIN_VALUES,
              f"phase 7: {len(views)} segments of {est} postings")
        rem = sh.removed_list.values()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            got = merge_mod.merge_views_device(views, rem, device=device)
            times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = shard_mod.merge_views(views, rem)
        t_host = time.perf_counter() - t0
        check(got[0] == want[0] and all(np.array_equal(x, y) for x, y in
                                        zip(got[1:], want[1:])),
              "phase 7: merge_views_device differs from merge_views")
        n_out = len(want[2])
        del got, views
        calls = []
        real = merge_mod.merge_views_device

        def spy(views, removed=None, *, device="cuda"):
            calls.append(str(device))
            return real(views, removed, device=device)

        merge_mod.merge_views_device = spy
        try:
            t0 = time.perf_counter()
            check(sh.merge(2, MERGE_SEGMENTS) == MERGE_SEGMENTS,
                  "phase 7: Shard.merge did not take every segment")
            t_shard = time.perf_counter() - t0
        finally:
            merge_mod.merge_views_device = real
        check(calls == [str(shard_mod.MERGE_DEVICE)],
              f"phase 7: the device branch ran {calls}")
        host_sh = Shard(b)
        limit = shard_mod.DEVICE_MERGE_MIN_VALUES
        shard_mod.DEVICE_MERGE_MIN_VALUES = 1 << 62
        try:
            t0 = time.perf_counter()
            check(host_sh.merge(2, MERGE_SEGMENTS) == MERGE_SEGMENTS,
                  "phase 7: the host Shard.merge did not take every segment")
            t_shard_host = time.perf_counter() - t0
        finally:
            shard_mod.DEVICE_MERGE_MIN_VALUES = limit
        check(_segment_bytes(a) == _segment_bytes(b),
              "phase 7: the device merge's segment files differ from the "
              "host merge's")
        rd = [(tv.term, tv.values) for tv in to_slice(sh.read(None, None))]
        rh = [(tv.term, tv.values) for tv in to_slice(host_sh.read(None,
                                                                   None))]
        blob, offs, vals, vo = want
        check(len(rd) == len(rh) == len(offs) - 1 and all(
            x[0] == y[0] == blob[offs[i]:offs[i + 1]]
            and np.array_equal(x[1], y[1])
            and np.array_equal(x[1], vals[vo[i]:vo[i + 1]])
            for i, (x, y) in enumerate(zip(rd, rh))),
            "phase 7: the merged shard reads back differently")
        del rd, rh, want
    print(f"[phase 7] device merge of one shard: {MERGE_SEGMENTS} segments, "
          f"{n} terms, {len(values)} postings ({n_in} with the overlap), "
          f"{len(removed)} tombstones, {n_out} postings out; "
          f"merge_views_device {times[1]:.4f} s (first call "
          f"{times[0]:.4f} s), merge_views {t_host:.4f} s, bit-identical; "
          f"Shard.merge at the default threshold "
          f"({shard_mod.DEVICE_MERGE_MIN_VALUES}) took the device branch in "
          f"{t_shard:.4f} s (host merge {t_shard_host:.4f} s): the same "
          f"segment files, the same reads; phase took "
          f"{time.perf_counter() - t_phase:.4f} s")


# bench_torch.py --quick: the kernels each phase must launch (its sidecar's
# per-phase counts)
BENCH_KERNELS = {"query": ("K1", "K3", "K4"),
                 "postlen1k": ("K1", "K2", "K3", "K4"),
                 "api_postlen1k": ("K2", "K4"),
                 "mesh": ("K1", "K3"),
                 "api": ("K2", "K4"),
                 "scale": ("K1", "K2", "K4")}


def _run_script(args, label, timeout=300):
    """Run a script of the repository with this interpreter; its stdout
    lines. Fails the phase on a non-zero exit."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, timeout=timeout,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(res.returncode == 0, f"{label} exited {res.returncode}: "
          f"{res.stderr[-2000:]}")
    lines = res.stdout.strip().splitlines()
    print(f"[phase 8] {label}: exit 0 in {time.perf_counter() - t0:.4f} s, "
          f"last line {lines[-1][:160]!r}")
    return lines, res.stderr


def phase_entry(torch, drive):
    """Phase 8: the entry points on the card. entry()'s step, then the same
    call on CPU copies of its inputs, where each kernel wrapper runs its
    plain version: equal counts and need, equal valid prefixes; the same on
    queries whose AND is not empty (a term repeated, 1-4 slots live).
    Then dryrun_multichip(4), which holds its results against numpy
    answers, and its results against the same run on four CPU partitions;
    both examples; bench_torch.py --quick."""
    import functools

    from inverted_index_2_tpu_torch import entry
    from inverted_index_2_tpu_torch.codec import keys as K
    from inverted_index_2_tpu_torch.utils.u32 import to_device, to_numpy_u32

    t_phase = time.perf_counter()
    fn, args = entry.entry()
    check(all(a.device.type == "cuda" for a in args),
          "entry() left an argument off the card")
    plain = functools.partial(fn.func, **{**fn.keywords,
                                          "slots": fn.keywords["slots"].cpu()})
    terms_blob, toffs = K.unpack_keys(to_numpy_u32(args[0][:64]))
    terms = [terms_blob[toffs[i]:toffs[i + 1]].tobytes() for i in range(64)]
    qk = np.stack([K.pack_terms([t] * 4, width=int(args[0].shape[1]) - 1)
                   for t in terms])
    kv = (np.arange(64) % 4 + 1).astype(np.int32)
    cases = {"entry": args[4:],
             "overlapping": (to_device(qk, "cuda"), to_device(kv, "cuda"))}
    for name, (q, k) in cases.items():
        out, oc, need = drive(f"entry {name}",
                              lambda: fn(*args[:4], q, k))
        p_out, p_oc, p_need = plain(*(a.cpu() for a in args[:4]), q.cpu(),
                                    k.cpu())
        oc_h = oc.cpu()
        check(torch.equal(oc_h, p_oc) and torch.equal(need.cpu(), p_need),
              f"entry step ({name}): counts or need differ from the plain "
              "versions")
        o, po = to_numpy_u32(out), to_numpy_u32(p_out)
        for i in range(len(oc_h)):
            c = int(oc_h[i])
            check(np.array_equal(o[i, :c], po[i, :c]),
                  f"entry step ({name}): row {i} differs")
        print(f"[phase 8] entry step ({name}): {len(oc_h)} queries, "
              f"{int((oc_h > 0).sum())} non-empty, equal to the plain "
              "versions")
    # the dry run holds each result against numpy answers itself; the card's
    # results must also equal those of the same run on four CPU partitions
    # (the plain versions)
    t0 = time.perf_counter()
    card = drive("dryrun", lambda: entry.dryrun_multichip(4))
    t_card = time.perf_counter() - t0
    plain_res = entry.dryrun_multichip(4, device="cpu")
    check(entry.same_results(card, plain_res), "dryrun_multichip(4): the "
          "card's results differ from the CPU partitions'")
    print(f"[phase 8] dryrun_multichip(4) on one card passed in "
          f"{t_card:.4f} s, its numpy answers held and its "
          f"{sum(len(v) for v in card.values())} result rows "
          f"({', '.join(card)}) equal to the run on four CPU partitions")
    _run_script(["examples/quickstart_torch.py"], "quickstart_torch.py")
    _run_script(["examples/serving_mesh_torch.py"], "serving_mesh_torch.py")
    lines, err = _run_script(["bench_torch.py", "--quick"],
                             "bench_torch.py --quick")
    head = json.loads(lines[-1])
    missing = [k for k in bench_torch.HEADLINE_KEYS
               if not head.get(bench_torch.PREFIX + k, 0) > 0]
    check(not missing, f"bench --quick: headline keys absent or not "
          f"positive: {missing}")
    with open(bench_torch.DETAILS_PATH) as f:
        side = json.load(f)
    for ph, kernels in BENCH_KERNELS.items():
        got = side["phase_launches"][ph]
        check(all(got[k] > 0 for k in kernels),
              f"bench --quick: phase {ph} launched {got}, wants {kernels}")
    print(f"[phase 8] bench --quick: {len(bench_torch.HEADLINE_KEYS)} "
          f"headline keys positive; launches by phase "
          f"{side['phase_launches']}; phase seconds {side['phase_s']}")
    print(f"[phase 8] took {time.perf_counter() - t_phase:.4f} s")


# phase 9: the write-while-serving lifecycle at the config-3 size
LIFE_DOCS = 4096        # documents of a put round
LIFE_SENTINEL = 8       # of them carrying GROW, and as many carrying VICTIM
LIFE_REMOVE = 256       # ids a tombstone round removes
LIFE_SAMPLE = 512       # sampled queries a form at each quiet state
LIFE_IDLE_S = 8.0       # the readers' window with the writer idle
LIFE_D = 4              # mesh partitions on the one card
LIFE_WINDOW = 1024      # corpus terms in the range reader's window
# the sentinel terms: GROW's documents are never removed (no published one
# may go missing); VICTIM's are removed each round (none may come back)
GROW = b"zz-life-grow"
VICTIM = b"zz-life-victim"
# the writer's rounds, (what it puts, whether it ends with a merge): each
# puts and refreshes, removes and refreshes; round 1 puts past
# DELTA_FRACTION (a promotion), round 2 merges and refreshes (a rebuild)
LIFE_ROUNDS = (("docs", False), ("promote", False), ("docs", True))


def _same(a, b) -> bool:
    """Equal results: arrays, None, bytes, and lists, tuples and dicts of
    them, compared element by element."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if a is None or b is None or isinstance(a, bytes):
        return a == b
    return np.array_equal(a, b)


def _shard_of(term: bytes) -> int:
    """The index's shard of a term (shard.shard_key as an int)."""
    return ((term[0] << 8) | term[1]) >> 6 if len(term) >= 2 else 0


class LifeModel:
    """Phase 9's numpy oracle: the postings every term has in the index's
    host reads (the corpus, every put, and each merge's purge, in the
    shards it merged, of the tombstones put before it). Term ids: corpus
    term i is i, later terms follow in the order they were first put."""

    def __init__(self, terms_mat, values, voffs):
        self.values, self.voffs = values, voffs
        self.n_corpus = len(terms_mat)
        self.terms = [terms_mat[i].tobytes() for i in range(self.n_corpus)]
        self.ids = {t: i for i, t in enumerate(self.terms)}
        self.shards = [_shard_of(t) for t in self.terms]
        self.added = {}        # term id -> arrays of put ids
        self.tombs = []        # tombstone batches, in order
        self.merged_at = {}    # shard -> tombstone batches its merge purged
        self._purged = {0: np.zeros(0, np.uint32)}
        self.docs = []         # (doc ids, term-id offsets, term ids) a put

    def term_id(self, t: bytes) -> int:
        i = self.ids.get(t)
        if i is None:
            i = self.ids[t] = len(self.terms)
            self.terms.append(t)
            self.shards.append(_shard_of(t))
        return i

    def put(self, doc_ids, doc_terms):
        offs = np.zeros(len(doc_terms) + 1, dtype=np.int64)
        np.cumsum([len(d) for d in doc_terms], out=offs[1:])
        tids = np.concatenate(doc_terms).astype(np.int64)
        self.docs.append((np.asarray(doc_ids, np.uint32), offs, tids))
        pairs = np.unique(np.stack([tids, np.repeat(
            np.asarray(doc_ids, np.int64), np.diff(offs))], axis=1), axis=0)
        cuts = np.flatnonzero(np.diff(pairs[:, 0])) + 1
        for grp in np.split(pairs, cuts):
            self.added.setdefault(int(grp[0, 0]), []).append(
                grp[:, 1].astype(np.uint32))

    def remove(self, ids):
        self.tombs.append(np.unique(np.asarray(ids, np.uint32)))

    def merged(self, shards):
        for s in shards:
            self.merged_at[s] = len(self.tombs)

    def _purge(self, k: int) -> np.ndarray:
        if k not in self._purged:
            self._purged[k] = np.unique(np.concatenate(self.tombs[:k]))
        return self._purged[k]

    def postings(self, i: int) -> np.ndarray:
        parts = self.added.get(i, [])
        if i < self.n_corpus:
            parts = [self.values[self.voffs[i]:self.voffs[i + 1]]] + parts
        if not parts:
            return np.zeros(0, np.uint32)
        v = np.unique(np.concatenate(parts)) if len(parts) > 1 else parts[0]
        k = self.merged_at.get(self.shards[i], 0)
        return v[~np.isin(v, self._purge(k))] if k else v

    def doc_query(self, rng):
        """The terms of one document put earlier (its AND holds the doc)."""
        ids, offs, tids = self.docs[int(rng.integers(len(self.docs)))]
        j = int(rng.integers(len(ids)))
        return np.unique(tids[offs[j]:offs[j + 1]])


def life_put(rng, model, n_docs, first_id, weights=None, n_promote=0):
    """One round's documents: (doc ids, term-id arrays, term bytes lists).
    n_promote = 0: n_docs documents of 2-8 terms drawn by `weights` (rank
    Zipf over the corpus), 1% of the draws new terms; else n_promote
    distinct corpus terms, 4 a document. The first LIFE_SENTINEL documents
    also carry GROW, the next LIFE_SENTINEL VICTIM."""
    if n_promote:
        perm = rng.permutation(model.n_corpus)[:n_promote]
        doc_terms = [perm[i:i + 4] for i in range(0, n_promote, 4)]
    else:
        k = rng.integers(2, 9, size=n_docs)
        draws = rng.choice(model.n_corpus, size=int(k.sum()), p=weights)
        fresh = np.flatnonzero(rng.random(len(draws)) < 0.01)
        n_new = max(1, len(fresh) // 2)
        new_ids = []
        while len(new_ids) < n_new:
            t = rng.integers(97, 123, size=12, dtype=np.uint8).tobytes()
            if t not in model.ids:
                new_ids.append(model.term_id(t))
        draws[fresh] = rng.choice(new_ids, size=len(fresh))
        doc_terms = np.split(draws, np.cumsum(k)[:-1])
    g, v = model.term_id(GROW), model.term_id(VICTIM)
    doc_terms = [np.append(d, g) if j < LIFE_SENTINEL else
                 np.append(d, v) if j < 2 * LIFE_SENTINEL else d
                 for j, d in enumerate(doc_terms)]
    ids = np.arange(first_id, first_id + len(doc_terms), dtype=np.uint32)
    docs = [([model.terms[t] for t in d], int(i))
            for d, i in zip(doc_terms, ids)]
    return ids, doc_terms, docs


class _Gate:
    """Readers pass it before each batch; the writer closes it and waits
    until no batch is in flight (a quiet state), then opens it again."""

    def __init__(self):
        self.cv = threading.Condition()
        self.open = True
        self.busy = 0

    def enter(self):
        with self.cv:
            while not self.open:
                self.cv.wait()
            self.busy += 1

    def leave(self):
        with self.cv:
            self.busy -= 1
            self.cv.notify_all()

    def close(self):
        with self.cv:
            self.open = False
            while self.busy:
                self.cv.wait()

    def reopen(self):
        with self.cv:
            self.open = True
            self.cv.notify_all()


class _Timers:
    """Seconds spent in named functions of the refresh paths, summed until
    take(); the functions are wrapped where the engines look them up and
    unwrapped by restore()."""

    def __init__(self, targets):
        self.spent = {}
        self._orig = []
        for mod, attr, name in targets:
            fn = getattr(mod, attr)
            self._orig.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, name))

    def _wrap(self, fn, name):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.spent[name] = (self.spent.get(name, 0.0)
                                    + time.perf_counter() - t0)
        return timed

    def take(self):
        out, self.spent = self.spent, {}
        return {k: round(v, 4) for k, v in out.items()}

    def restore(self):
        for mod, attr, fn in self._orig:
            setattr(mod, attr, fn)


def write_life_corpus(d, terms_mat, values, voffs, seed):
    """The corpus as the segment files of an InvertedIndex at `d`: each
    shard's postings in two overlapping segments (each posting in one of
    them at random, a tenth in both), written by the port's segment
    writer from numpy arrays. Returns the shards' posting counts."""
    from inverted_index_2_tpu_torch.segment import writer as seg_writer

    rng = np.random.default_rng(seed)
    shard = (terms_mat[:, 0].astype(np.int64) << 2) | (
        terms_mat[:, 1].astype(np.int64) >> 6)
    # terms ascend, so a shard's terms, and their postings, are contiguous
    cuts = np.flatnonzero(np.diff(shard)) + 1
    t_lo = np.concatenate([[0], cuts])
    t_hi = np.concatenate([cuts, [len(shard)]])
    sizes = {}
    for a, b in zip(t_lo, t_hi):
        lo, hi = int(voffs[a]), int(voffs[b])
        counts = np.diff(voffs[a:b + 1])
        term_of = np.repeat(np.arange(a, b), counts)
        which = rng.random(hi - lo) < 0.5
        both = rng.random(hi - lo) < 0.1
        sd = os.path.join(d, f"{int(shard[a]):04d}")
        os.makedirs(sd)
        for side in (False, True):
            sel = (which == side) | both
            live, cnt = np.unique(term_of[sel], return_counts=True)
            sv = np.zeros(len(live) + 1, dtype=np.int64)
            np.cumsum(cnt, out=sv[1:])
            seg_writer.write_normal_segment(
                sd, terms_mat[live].tobytes(),
                np.arange(len(live) + 1, dtype=np.int64) * 12,
                values[lo:hi][sel], sv)
        sizes[int(shard[a])] = hi - lo
    return sizes


def phase_lifecycle(torch, terms_mat, values, voffs, seed, device="cuda",
                    mesh=None):
    """Phase 9: the write-while-serving lifecycle at the config-3 size. The
    corpus (terms_mat, values, voffs) goes to disk as the segments of an
    InvertedIndex (write_life_corpus), served by QueryEngine.from_index
    (with a checkpoint_path, so every main rebuild saves it) and by a
    MeshQueryEngine of LIFE_D partitions started from that checkpoint.
    Reader threads serve all the while: boolean_staged AND (columnar, two
    batches of BATCH, filter_removed) and OR pages (prefix_p = PAGE_P),
    lookup_staged and read_range on the device route, and one reader
    through the mesh engine; each holds the storm's invariants (no id
    whose tombstone refresh has returned comes back; no id whose put and
    refresh have returned is lost). A writer thread runs LIFE_ROUNDS:
    put_many, refresh (a delta; round 1 puts past DELTA_FRACTION: a
    promotion), put_removed, refresh (tombstones only), and in round 2 a
    merge-until-zero, refresh (a rebuild). After every refresh, with the
    readers paused, LIFE_SAMPLE sampled queries of every form, with and
    without the tombstone filter, on the device route and on auto, equal
    a numpy oracle of the index's host reads (LifeModel), and the mesh
    engine's answers equal the single engine's. Returns the refresh kinds
    of both engines and the readers' QPS (writer idle, storm)."""
    import inverted_index_2_tpu_torch.shard as shard_mod
    from inverted_index_2_tpu_torch import (InvertedIndex, MeshQueryEngine,
                                            QueryEngine, to_slice)
    from inverted_index_2_tpu_torch.models import query_engine as qe_mod
    from inverted_index_2_tpu_torch.models import snapshot as snap_mod
    from inverted_index_2_tpu_torch.models.checkpoint import (
        load_checkpoint, load_fingerprint)
    from inverted_index_2_tpu_torch.models.snapshot import _collect_removed
    from inverted_index_2_tpu_torch.ops import merge as merge_mod
    from inverted_index_2_tpu_torch.parallel import mesh as pm

    cuda = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed)
    model = LifeModel(terms_mat, values, voffs)
    n_main = model.n_corpus
    weights = 1.0 / (1 + rng.permutation(n_main))  # rank Zipf, s = 1
    weights /= weights.sum()

    def say(msg):
        print(f"[phase 9] {msg}")

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        sizes = write_life_corpus(os.path.join(d, "index"), terms_mat,
                                  values, voffs, seed)
        t_write = time.perf_counter() - t0
        ii = InvertedIndex(os.path.join(d, "index"))
        ckpt = os.path.join(d, "serving.ckpt")
        t0 = time.perf_counter()
        eng = QueryEngine.from_index(ii, L=L_MAIN, device=device,
                                     checkpoint_path=ckpt)
        t_build = time.perf_counter() - t0
        eng.checkpoint_wait()
        t0 = time.perf_counter()
        meng = MeshQueryEngine.from_checkpoint(
            ckpt, index=ii, L=L_MAIN,
            mesh=mesh if mesh is not None else pm.default_mesh(LIFE_D))
        t_mesh = time.perf_counter() - t0
        big = sum(n >= shard_mod.DEVICE_MERGE_MIN_VALUES
                  for n in sizes.values())
        say(f"corpus: {n_main} terms, {len(values)} postings in "
            f"{len(sizes)} shards of {min(sizes.values())}-"
            f"{max(sizes.values())} postings, two overlapping segments a "
            f"shard, written in {t_write:.4f} s; {big} of them at or "
            f"above TPI_DEVICE_MERGE_MIN "
            f"({shard_mod.DEVICE_MERGE_MIN_VALUES}): their merges take the "
            f"device branch, the others the host's; from_index "
            f"{t_build:.4f} s, MeshQueryEngine.from_checkpoint at D = "
            f"{len(meng.mesh)} {t_mesh:.4f} s")

        # the readers' batches; GROW and VICTIM lead each
        model.term_id(GROW)
        model.term_id(VICTIM)
        tb = model.terms
        and_b = [[[GROW], [VICTIM]] + [[tb[i] for i in q] for q in b[2:]]
                 for b in uniform_stream(rng, n_main, 2, BATCH)]
        or_b = [[[GROW], [VICTIM]] + [[tb[i] for i in q] for q in b[2:]]
                for b in uniform_stream(rng, n_main, 2, BATCH)]
        lk_b = [[GROW, VICTIM] + [tb[i] for i in rng.choice(n_main,
                                                            BATCH - 2)]
                for _ in range(2)]
        w0 = int(rng.integers(0, n_main - LIFE_WINDOW))
        window = (tb[w0], tb[w0 + LIFE_WINDOW - 1])

        lock = threading.Lock()
        ban = np.zeros(0, np.uint32)       # removed and refreshed
        grown = np.zeros(0, np.uint32)     # GROW ids put and refreshed
        gate, done, failed = _Gate(), threading.Event(), []
        log = {}                           # reader -> (t0, seconds, n)

        def no_banned(name, vals, banned):
            bad = np.isin(vals, banned)
            check(not bad.any(), f"phase 9 {name}: removed ids came back: "
                  f"{vals[bad][:8].tolist()}")

        def has_grown(name, row, want):
            lost = np.setdiff1d(want, row)
            check(not len(lost), f"phase 9 {name}: published ids lost: "
                  f"{lost[:8].tolist()}")

        busy = []  # the router's load signal, read by the AND reader

        def serve_and(banned, want):
            busy.append(eng._host_busy())
            out = eng.boolean_staged(and_b, "and", True, columnar=True)
            for vals, vo in out:
                no_banned("AND reader", vals, banned)
                has_grown("AND reader", vals[vo[0]:vo[1]], want)
            return sum(len(b) for b in and_b)

        def serve_pages(banned, want):
            out = eng.boolean_staged(or_b, "or", True, columnar=True,
                                     prefix_p=PAGE_P)
            for vals, vo, cnt in out:
                no_banned("OR-page reader", vals, banned)
                check(cnt[0] >= len(want), "phase 9 OR-page reader: GROW "
                      f"counts {cnt[0]} of {len(want)} published ids")
            return sum(len(b) for b in or_b)

        def serve_lookup(banned, want):
            out = device_view(torch, eng).lookup_staged(lk_b, True,
                                                        columnar=True)
            for vals, vo in out:
                no_banned("lookup_staged reader", vals, banned)
                has_grown("lookup_staged reader", vals[vo[0]:vo[1]], want)
            return sum(len(b) for b in lk_b)

        def serve_range(banned, want):
            view = device_view(torch, eng)
            rows = list(view.read_range(*window))
            g = [v for t, v in view.read_range(GROW, GROW) if t == GROW]
            has_grown("range reader", g[0] if g else np.zeros(0, np.uint32),
                      want)
            return len(rows) + 1

        def serve_mesh(banned, want):
            (vals, vo), = meng.boolean_staged(and_b[:1], "and", True,
                                              columnar=True)
            no_banned("mesh reader", vals, banned)
            has_grown("mesh reader", vals[vo[0]:vo[1]], want)
            v, g = meng.lookup([VICTIM, GROW], filter_removed=True)
            no_banned("mesh reader", np.zeros(0, np.uint32) if v is None
                      else v, banned)
            has_grown("mesh reader", g, want)
            return len(and_b[0]) + 2

        readers = {"and": serve_and, "or pages": serve_pages,
                   "lookup_staged": serve_lookup, "read_range": serve_range,
                   "mesh and": serve_mesh}

        def reader(name, serve):
            try:
                while not done.is_set():
                    gate.enter()
                    try:
                        with lock:
                            banned, want = ban, grown
                        t0 = time.perf_counter()
                        n = serve(banned, want)
                        log[name].append((t0, time.perf_counter() - t0, n))
                    finally:
                        gate.leave()
            except BaseException as e:
                failed.append((name, e))
                done.set()

        # -- the quiet-state oracle -------------------------------------
        qrng = np.random.default_rng(seed + 1)

        def sample_queries():
            U = len(model.terms)
            half = LIFE_SAMPLE // 2
            uni = [qrng.choice(U, size=int(qrng.integers(2, 9)),
                               replace=False) for _ in range(LIFE_SAMPLE)]
            ands = uni[:half] + ([model.doc_query(qrng) for _ in
                                  range(LIFE_SAMPLE - half)]
                                 if model.docs else uni[half:])
            look = list(qrng.choice(U, size=LIFE_SAMPLE - 3))
            look += [model.term_id(GROW), model.term_id(VICTIM)]
            pref = sorted({model.terms[int(i)][:3] for i in
                           qrng.choice(U, size=LIFE_SAMPLE)})
            return ands, uni, look, pref

        def quiet(stage):
            gate.close()
            t0 = time.perf_counter()
            try:
                if failed:
                    raise SmokeError(f"phase 9: a reader failed: {failed[0]}")
                n = life_check(stage)
            finally:
                gate.reopen()
            return time.perf_counter() - t0, n

        spent = {}  # quiet-state seconds by part

        @contextlib.contextmanager
        def part(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0

        def life_check(stage):
            with part("sample"):
                ands, ors, look, pref = sample_queries()
            removed = _collect_removed(ii)
            memo = {}
            with part("sample"):
                order = sorted(range(len(model.terms)),
                               key=model.terms.__getitem__)
                sorted_terms = [model.terms[i] for i in order]

            def want(i, fr):
                i = int(i)
                if i not in memo:
                    memo[i] = model.postings(i)
                v = memo[i]
                return v[~np.isin(v, removed)] if fr else v

            def qb(qs):
                return [[model.terms[int(i)] for i in q] for q in qs]

            def oracle(q, op):
                """(unfiltered, filtered) answers of query q."""
                if op == "and":
                    out = want(q[0], False)
                    for i in q[1:]:
                        out = np.intersect1d(out, want(i, False),
                                             assume_unique=True)
                else:
                    out = np.unique(np.concatenate(
                        [want(i, False) for i in q]))
                out = out.astype(np.uint32)
                return out, out[~np.isin(out, removed)]

            def same_rows(name, vals, vo, wants, counts=None):
                check(len(vo) == len(wants) + 1, f"{stage}: {name} shape")
                for j, w in enumerate(wants):
                    if counts is not None:
                        check(counts[j] == len(w),
                              f"{stage}: {name} query {j} count")
                        w = w[:PAGE_P]
                    check(np.array_equal(vals[vo[j]:vo[j + 1]], w),
                          f"{stage}: {name} query {j} differs from the "
                          "oracle")

            and_q, or_q, lk_t = qb(ands), qb(ors), [model.terms[int(i)]
                                                   for i in look]
            lk_t.append(b"zz-life-missing")
            with part("oracle"):
                w = {}
                for op, qs in (("and", ands), ("or", ors)):
                    both = [oracle(q, op) for q in qs]
                    w[op, False] = [a for a, _ in both]
                    w[op, True] = [b for _, b in both]
                for fr in (False, True):
                    w["lookup", fr] = [want(i, fr) for i in look] + [
                        np.zeros(0, np.uint32)]
                # reads do not filter
                lo = bisect.bisect_left(sorted_terms, window[0])
                hi = bisect.bisect_right(sorted_terms, window[1])
                w_range = [(sorted_terms[j], want(order[j], False))
                           for j in range(lo, hi)]
                w_range = [(t, v) for t, v in w_range if len(v)]
                w_pref = {}
                for p in pref:
                    lo = bisect.bisect_left(sorted_terms, p)
                    hi = bisect.bisect_left(sorted_terms, p + b"\xff" * 16)
                    vs = [want(order[j], False) for j in range(lo, hi)]
                    vs = [v for v in vs if len(v)]
                    if vs:
                        w_pref[p] = np.unique(np.concatenate(vs))
            with part("host read"):
                host = [(tv.term, tv.values) for tv in
                        to_slice(ii.read(*window))]
            check(_same(host, w_range),
                  f"{stage}: the oracle differs from the index's host read")
            single = {}
            for route in ("0", "auto"):
                with env(TPI_HOST_BOOL=route):
                    view = eng if route == "auto" else device_view(torch,
                                                                   eng)
                    for fr in (False, True):
                        tag = f"route={route} fr={fr}"
                        with part("AND"):
                            (v, vo), = eng.boolean_staged(
                                [and_q], "and", fr, columnar=True)
                        same_rows(f"AND {tag}", v, vo, w["and", fr])
                        single["and", fr] = (v, vo)
                        with part("OR"):
                            (v, vo), = eng.boolean_staged(
                                [or_q], "or", fr, columnar=True)
                        same_rows(f"OR {tag}", v, vo, w["or", fr])
                        with part("OR pages"):
                            (v, vo, c), = eng.boolean_staged(
                                [or_q], "or", fr, columnar=True,
                                prefix_p=PAGE_P)
                        same_rows(f"OR pages {tag}", v, vo, w["or", fr], c)
                        single["pages", fr] = (v, vo, c)
                        with part("lookup"):
                            got = eng.lookup(lk_t, filter_removed=fr)
                        for j, x in enumerate(w["lookup", fr]):
                            g = got[j]
                            check(not len(x) if g is None
                                  else np.array_equal(g, x),
                                  f"{stage}: lookup {tag} term {lk_t[j]!r}")
                        single["lookup", fr] = got
                        with part("lookup_staged"):
                            (v, vo), = view.lookup_staged([lk_t], fr,
                                                          columnar=True)
                        same_rows(f"lookup_staged {tag}", v, vo,
                                  w["lookup", fr])
                        single["lookup_staged", fr] = (v, vo)
                    with part("read_range"):
                        rows = list(view.read_range(*window))
                    check(_same(rows, w_range), f"{stage}: read_range "
                          f"route={route} differs from the oracle")
                    single["range"] = rows
                    with part("prefix_search"):
                        got = view.prefix_search(pref)
                    check(_same(got, w_pref), f"{stage}: prefix_search "
                          f"route={route} differs from the oracle")
                    single["prefix"] = got
            n_checked = 2 * (2 * (4 * LIFE_SAMPLE + len(lk_t)) + len(w_range)
                             + len(pref))
            # the mesh engine against the single engine, bit for bit
            with part("mesh"):
                mesh_same(stage, and_q, or_q, lk_t, pref, single)
            return n_checked

        def mesh_same(stage, and_q, or_q, lk_t, pref, single):
            for fr in (False, True):
                got = {"and": meng.boolean_staged([and_q], "and", fr,
                                                  columnar=True)[0],
                       "pages": meng.boolean_staged(
                           [or_q], "or", fr, columnar=True,
                           prefix_p=PAGE_P)[0],
                       "lookup_staged": meng.lookup_staged(
                           [lk_t], fr, columnar=True)[0],
                       "lookup": meng.lookup(lk_t, filter_removed=fr)}
                for form, out in got.items():
                    check(_same(out, single[form, fr]), f"{stage}: mesh "
                          f"{form} fr={fr} differs from the single engine")
            check(_same(list(meng.read_range(*window)), single["range"]),
                  f"{stage}: mesh read_range differs")
            check(_same(meng.prefix_search(pref), single["prefix"]),
                  f"{stage}: mesh prefix_search differs")

        # -- the writer ---------------------------------------------------
        kinds = {"single": [], "mesh": []}
        refreshes = []  # (stage, engine, kind, seconds, split, peak bytes)
        quiet_s = []    # (stage, seconds, answers checked)
        peaks = {}
        timers = _Timers([
            (qe_mod, "snapshot_tables", "snapshot_tables"),
            (snap_mod, "build_host_tables", "build_host_tables"),
            (qe_mod, "build_host_tables", "build_host_tables"),
            (qe_mod, "upload_tables", "upload_tables"),
            (qe_mod, "merge_views", "merge_views of the tiers"),
            (qe_mod, "_SnapshotTier", "decode a tier (K1)"),
            (pm, "build_sharded_snapshot", "build_sharded_snapshot")])
        calls = []
        for name in ("_promote_delta", "_publish_main"):
            orig = getattr(eng, name)
            setattr(eng, name, (lambda f, n: lambda *a, **kw: (
                calls.append(n), f(*a, **kw))[1])(orig, name))
        next_id = int(values.max()) + 1
        n_promote = int(1.2 * QueryEngine.DELTA_FRACTION * n_main) + 4
        grow_ids, merge_log = [], []

        def segments(st):
            return [(key, segs) for key, segs, _ in st.fingerprint[1]]

        def refresh_both(stage, peak=False):
            if peak and cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            for label, e in (("single", eng), ("mesh", meng)):
                before = e._state
                calls.clear()
                timers.take()
                t0 = time.perf_counter()
                check(e.refresh(ii), f"{stage}: the {label} engine saw no "
                      "change")
                dt = time.perf_counter() - t0
                after = e._state
                if after.snap is not before.snap:
                    kind = ("promotion" if "_promote_delta" in calls
                            else "rebuild")
                elif segments(after) != segments(before):
                    kind = "delta"
                else:
                    kind = "tombstones"  # the tombstone counts alone moved
                kinds[label].append(kind)
                refreshes.append((stage, label, kind, dt, timers.take(),
                                  t0))
            if peak and cuda:
                torch.cuda.synchronize()
                peaks[stage] = torch.cuda.max_memory_allocated()
            if meng.delta is not None:
                n_real = meng.delta.n_real.tolist()
                check(n_real[0] > 0 and not any(n_real[1:]),
                      f"{stage}: the mesh delta is not on partition 0: "
                      f"{n_real}")
            quiet_s.append((stage,) + quiet(stage))

        def writer():
            nonlocal next_id, ban, grown
            try:
                for r, (put_kind, merge) in enumerate(LIFE_ROUNDS):
                    ids, doc_terms, docs = life_put(
                        rng, model, LIFE_DOCS, next_id, weights,
                        n_promote if put_kind == "promote" else 0)
                    next_id += len(ids)
                    ii.put_many(docs)
                    model.put(ids, doc_terms)
                    refresh_both(f"round {r} put", peak=put_kind == "promote")
                    with lock:
                        grow_ids.extend(ids[:LIFE_SENTINEL].tolist())
                        grown = np.array(sorted(grow_ids), np.uint32)
                    # this round's VICTIM docs, other new docs and corpus
                    # ids; never a GROW doc
                    others = ids[2 * LIFE_SENTINEL:]
                    gone = np.concatenate([
                        ids[LIFE_SENTINEL:2 * LIFE_SENTINEL],
                        rng.choice(others, size=min(len(others), 8),
                                   replace=False),
                        rng.choice(values, size=LIFE_REMOVE
                                   - LIFE_SENTINEL - 8)]).astype(np.uint32)
                    ii.put_removed(gone)
                    model.remove(gone)
                    refresh_both(f"round {r} put_removed")
                    with lock:
                        ban = np.union1d(ban, gone).astype(np.uint32)
                    if merge:
                        before = {sh.get_key(): tuple(
                            s.key for s in sh.segments.snapshot())
                            for sh in ii._snapshot()}
                        dev_calls = []
                        real = merge_mod.merge_views_device

                        def spy(views, removed=None, *, device="cuda"):
                            dev_calls.append(len(views))
                            return real(views, removed, device=device)

                        merge_mod.merge_views_device = spy
                        t0 = time.perf_counter()
                        try:
                            n_in = 0
                            while (m := ii.merge(2, 1000, 4)) > 0:
                                n_in += m
                        finally:
                            merge_mod.merge_views_device = real
                        after = {sh.get_key(): tuple(
                            s.key for s in sh.segments.snapshot())
                            for sh in ii._snapshot()}
                        done_shards = [int(k) for k in after
                                       if after[k] != before.get(k)]
                        model.merged(done_shards)
                        merge_log.append((time.perf_counter() - t0, n_in,
                                          len(done_shards), len(dev_calls)))
                        refresh_both(f"round {r} merge", peak=True)
            except BaseException as e:
                failed.append(("writer", e))
            finally:
                done.set()
                gate.reopen()

        try:
            quiet_s.append(("start",) + quiet("start"))
            for name, serve in readers.items():  # one warm call each
                serve(ban, grown)
            log.update({name: [] for name in readers})
            threads = [threading.Thread(target=reader, args=item,
                                        name=f"life-{item[0]}")
                       for item in readers.items()]
            t_idle = time.perf_counter()
            for th in threads:
                th.start()
            time.sleep(LIFE_IDLE_S)
            t_storm = time.perf_counter()
            w = threading.Thread(target=writer, name="life-writer")
            w.start()
            w.join()
            t_end = time.perf_counter()
            for th in threads:
                th.join()
        finally:
            timers.restore()
            done.set()
        if failed:
            name, err = failed[0]
            raise SmokeError(f"phase 9: the {name} thread failed: "
                             f"{err!r}") from err
        expect = ["delta", "tombstones", "promotion", "tombstones", "delta",
                  "tombstones", "rebuild"]
        check(kinds["single"] == expect, f"phase 9: the single engine's "
              f"refreshes were {kinds['single']}, want {expect}")
        check(kinds["mesh"] == [("rebuild" if k == "promotion" else k)
                                for k in expect],
              f"phase 9: the mesh engine's refreshes were {kinds['mesh']}")
        eng.checkpoint_wait()
        fp = load_fingerprint(load_checkpoint(ckpt)[1])
        check(fp == eng._main_fp, "phase 9: the checkpoint does not hold "
              "the last main rebuild")

    for stage, label, kind, dt, split, _ in refreshes:
        say(f"refresh {stage} ({label}): {kind} in {dt:.4f} s"
            + (f", of which {split}" if split else ""))
    for stage, dt, n in quiet_s:
        say(f"quiet state {stage}: {n} answers equal the oracle, the mesh "
            f"equal to the single engine, in {dt:.4f} s")
    paused = sum(dt for stage, dt, _ in quiet_s if stage != "start")
    storm = t_end - t_storm - paused

    def rate(rows, lo, hi, span):
        # queries served in [lo, hi], a call counted by its share inside
        n = sum(k * max(0.0, min(t0 + dt, hi) - max(t0, lo)) / dt
                for t0, dt, k in rows)
        return n / span

    qps = {}
    for name, rows in log.items():
        idle = [r for r in rows if r[0] < t_storm]
        during = [r for r in rows if r[0] + r[1] > t_storm]
        check(during, f"phase 9: the {name} reader served nothing during "
              "the storm")
        qps[name] = (rate(rows, t_idle, t_storm, t_storm - t_idle),
                     rate(rows, t_storm, t_end, storm))
        slow = max(during, key=lambda r: r[1])
        # the main rebuilds the slowest call overlapped (the GIL is held
        # through much of a host build)
        hit = sorted({f"{st} ({lb})" for st, lb, kd, dt, _, r0 in refreshes
                      if kd in ("promotion", "rebuild")
                      and r0 < slow[0] + slow[1] and slow[0] < r0 + dt})
        say(f"reader {name}: {len(rows)} calls; QPS {qps[name][0]:.1f} "
            f"with the writer idle, {qps[name][1]:.1f} in the storm (its "
            f"quiet states taken out); slowest call "
            f"{max(r[1] for r in idle or rows):.4f} s idle, "
            f"{slow[1]:.4f} s in the storm, overlapping the main rebuilds "
            f"{hit or 'none'}")
    say(f"_host_busy read True in {sum(busy)} of {len(busy)} AND reader "
        "calls (the index's puts, removals and merges in flight, or the "
        "load average)")
    for dt, n_in, n_sh, n_dev in merge_log:
        say(f"merge-until-zero: {n_in} input segments of {n_sh} shards in "
            f"{dt:.4f} s; {n_dev} shard merges took the device branch")
    say("quiet-state seconds by part: "
        + ", ".join(f"{k} {v:.4f}" for k, v in spent.items()))
    say(f"max_memory_allocated: {peaks}")
    say(f"refresh kinds: single {kinds['single']}, mesh {kinds['mesh']}; "
        f"the checkpoint holds the last rebuild; phase took "
        f"{time.perf_counter() - t_phase:.4f} s")
    return {"kinds": kinds, "qps": qps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--terms", type=int, default=200_000,
                    help="dictionary size of the phase-5 corpus")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline-csrc", default=None, metavar="DIR",
                    help="the csrc directory of an earlier version of the "
                    "package: its K2 and K3 are built too and timed beside "
                    "this version's on the same inputs")
    args = ap.parse_args(argv)

    import torch

    # the phases below measure the device routes, as they did before the
    # router existed; phase_host sets its own (env)
    os.environ["TPI_HOST_BOOL"] = "0"
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[phase 1] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    from inverted_index_2_tpu_torch.ops import (
        _build, cuda_bool, cuda_concat, cuda_decode, cuda_fused, cuda_sort,
        cuda_wire)

    t0 = time.perf_counter()
    _build.library()
    built = ("found built" if _build.build_seconds is None
             else f"built by nvcc in {_build.build_seconds:.4f} s")
    print(f"[phase 2] kernels {built}, loaded in "
          f"{time.perf_counter() - t0:.4f} s: {_build.library_path().name}")
    print(_build.build_log.strip())
    baseline = Baseline(args.baseline_csrc) if args.baseline_csrc else None

    eng, terms_mat, values, voffs = phase_main(torch, args)
    rng = np.random.default_rng(args.seed + 1)
    uniform = uniform_stream(rng, len(terms_mat), N_BATCHES, BATCH)
    zipf = zipf_stream(rng, len(terms_mat), N_BATCHES, BATCH)
    term_bytes = [terms_mat[i].tobytes() for i in range(len(terms_mat))]
    uniform_b = [[[term_bytes[i] for i in q] for q in b] for b in uniform[:1]]

    def main_list(i):
        return values[voffs[i]:voffs[i + 1]]

    kern = phase_kernels(torch, eng, terms_mat, uniform_b, baseline)
    # the concat step on real dispatches: the AND follow-ups' route
    # (_boolean_concat; no list of this corpus is past MAX_LEVEL, so no
    # follow-up reaches it, and it is driven on the first uniform batch),
    # the OR stream (the wire form) and the OR page stream (the page form).
    # The concat kernels against their plain versions, and K4's sort from
    # runs of 128 on the first chunk; the concat kernel compacts, so K4's
    # compaction runs on none of them
    st0 = eng._serving_state()
    qk0, kv0 = eng._pack_boolean(st0, uniform_b[0])
    with CaptureConcat() as cc, CaptureWire() as cw:
        eng._boolean_concat(st0, uniform_b[0], qk0, kv0, "and", None)
    kern.update(cc.verify(torch, "the AND follow-ups' route, uniform batch"))
    cw.verify(torch, "the AND follow-ups' route, uniform batch", pack=False)
    del st0, qk0, kv0
    with CaptureK4() as cap, CaptureConcat() as cc, CaptureWire() as cw:
        eng.boolean_staged(uniform_b, "or", columnar=True)
    cap.verify(torch, "first concat-class chunk of the OR stream",
               compact=False)
    cc.verify(torch, "the OR stream")
    # the wire codec's rows of the kernels line: the OR stream's chunks
    # (wire dedup: K4's sorted stream and its lane counts)
    kern.update(cw.verify(torch, "the OR stream"))
    with CaptureK4() as cap, CaptureConcat() as cc, CaptureWire() as cw:
        eng.boolean_staged(uniform_b, "or", columnar=True, prefix_p=PAGE_P)
    cap.verify(torch, "first concat-class chunk of the OR page stream",
               compact=False)
    cc.verify(torch, "the OR page stream")
    check(not cw.meta and not cw.pack,
          "the OR page stream called the full-result wire codec")
    del cap, cc
    phase_engine_small(torch, "cuda")
    phase_refresh(torch, "cuda")
    phase_checkpoint_small(torch, "cuda")

    # phase 5: the main paths; each path's kernel launches are counted from
    # 0 just before it and read just after
    counters = {"decode_postings": cuda_decode.decode_postings,
                "fused_and": cuda_fused.fused_and,
                "intersect_many": cuda_bool.intersect_many,
                "sort_rows": cuda_sort.sort_rows,
                "concat_decode": cuda_concat.concat_decode,
                "concat_compact": cuda_concat.concat_compact,
                "wire_meta": cuda_wire.wire_meta,
                "wire_pack": cuda_wire.wire_pack}
    launches = {name: 0 for name in counters}
    per_path = {}

    entries = cuda_sort.sort_rows.entries  # K4's calls by entry
    # ... and K2's by output
    split = {"sort_rows.": entries, "fused_and.": cuda_fused.fused_and.entries}
    for prefix, d in split.items():
        for name in d:
            launches[prefix + name] = 0

    def drive(path, fn):
        for c in counters.values():
            c.launches = 0
        for d in split.values():
            for name in d:
                d[name] = 0
        out = fn()
        torch.cuda.synchronize()
        got = {name: c.launches for name, c in counters.items()}
        for prefix, d in split.items():
            got.update({prefix + name: n for name, n in d.items()})
        per_path[path] = got
        for name, n in got.items():
            launches[name] += n
        return out

    t_main = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ub, qps_u = drive("and uniform", lambda: run_stream(
        eng, main_list, term_bytes, uniform, "AND uniform"))
    zb, qps_z = drive("and zipf", lambda: run_stream(
        eng, main_list, term_bytes, zipf, "AND zipf"))
    pick = np.random.default_rng(args.seed + 2).choice(
        len(terms_mat), size=BATCH, replace=False)
    t0 = time.perf_counter()
    got = drive("lookup", lambda: eng.lookup([term_bytes[i] for i in pick]))
    dt = time.perf_counter() - t0
    for j in np.random.default_rng(3).choice(BATCH, size=512, replace=False):
        i = pick[j]
        check(np.array_equal(got[j], main_list(i)),
              f"lookup of term {i} differs from the corpus")
    n_long = int((np.diff(voffs)[pick] > L_MAIN).sum())
    print(f"[phase 5] lookup: {BATCH} terms in {dt:.4f} s ({n_long} longer "
          f"than L re-served); 512 sampled lists equal the corpus")
    orb, qps_or = drive("or uniform", lambda: run_stream(
        eng, main_list, term_bytes, uniform[:2], "OR uniform", op="or"))
    orzb, qps_orz = drive("or zipf", lambda: run_stream(
        eng, main_list, term_bytes, zipf[:2], "OR zipf", op="or"))
    pgb, qps_pg = drive("or pages", lambda: run_stream(
        eng, main_list, term_bytes, uniform, f"OR pages P={PAGE_P}",
        op="or", prefix_p=PAGE_P, depth=4))
    first_terms = [[q[0] for q in b] for b in uniform[:4]]
    # with retained tables lookup_staged takes the host route: the device
    # stream runs on a view of the same snapshot without them
    dev_eng = device_view(torch, eng)
    lkb, qps_lk = drive("lookup_staged", lambda: run_stream(
        dev_eng, main_list, term_bytes, first_terms, "lookup_staged",
        lookup=True, depth=3))
    print(f"[phase 5] median QPS: AND uniform {qps_u:.1f}, AND zipf "
          f"{qps_z:.1f}, OR uniform {qps_or:.1f}, OR zipf {qps_orz:.1f}, "
          f"OR pages {qps_pg:.1f}, lookup_staged {qps_lk:.1f}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    profile_stream(torch, lambda: eng.boolean_staged(
        ub, "and", columnar=True, depth=4), "AND uniform", NO_COMPACTION)
    profile_stream(torch, lambda: eng.boolean_staged(
        zb, "and", columnar=True, depth=4), "AND zipf", NO_COMPACTION)
    profile_stream(torch, lambda: eng.boolean_staged(
        orb, "or", columnar=True, depth=4), "OR uniform")
    profile_stream(torch, lambda: eng.boolean_staged(
        orzb, "or", columnar=True, depth=4), "OR zipf")
    profile_stream(torch, lambda: eng.boolean_staged(
        pgb, "or", columnar=True, depth=4, prefix_p=PAGE_P), "OR pages")
    profile_stream(torch, lambda: dev_eng.lookup_staged(
        lkb, columnar=True, depth=3), "lookup_staged")
    del dev_eng
    print(f"[phase 5] main tier paths took {time.perf_counter() - t_main:.4f} s")
    reads = phase_host(torch, eng, terms_mat, main_list, term_bytes,
                       (uniform, zipf, first_terms),
                       {"and uniform": qps_u, "and zipf": qps_z,
                        "or uniform": qps_or, "lookup_staged": qps_lk},
                       drive)

    # the delta tier is made after the main tier's paths, so those run in
    # the same process state as before it existed; K3's phase-3 check
    # needs the delta's lists and runs here
    delta = phase_delta_setup(torch, eng, terms_mat, values, voffs,
                              term_bytes, args.seed + 5)
    d_uniform = uniform_stream(rng, delta["n_terms"], N_DUAL_BATCHES,
                               BATCH)
    d_zipf = zipf_stream(rng, delta["n_terms"], N_DUAL_BATCHES, BATCH)
    d_uniform_b = [[[delta["term_bytes"][i] for i in q] for q in b]
                   for b in d_uniform]
    kern["decode_postings.found"] = phase_decode_dual(
        torch, eng, delta["state"], d_uniform_b[0])
    check_k3_no_terms(torch, eng.device)
    check_k3_branches(torch, eng.device)
    kern.update(phase_intersect(torch, eng, delta["state"], d_uniform_b,
                                baseline))
    del d_uniform_b
    phase_delta_window(torch, eng, delta, d_uniform, d_zipf, drive)
    del delta
    kern.update(phase_mesh(torch, eng, terms_mat, values, voffs, term_bytes,
                           uniform, main_list, drive, reads, args.seed))
    phase_merge(torch, args.seed)
    phase_entry(torch, drive)
    # phase 9 builds engines of its own at the same size: the phase-5
    # engine's device memory goes first
    del eng, ub, zb, orb, orzb, pgb, lkb, reads
    torch.cuda.empty_cache()
    drive("lifecycle", lambda: phase_lifecycle(torch, terms_mat, values,
                                               voffs, args.seed + 9))
    print(f"[phase 9] kernel launches {per_path['lifecycle']}")
    print(f"[phases 5-9] kernel launches per path {per_path}; total "
          f"{launches}")
    runs = ("sort_rows.runs",)
    # the engine's concat classes: the concat kernels around K4's sort
    concat = runs + ("concat_decode",)
    dual = ("decode_postings", "sort_rows.two_run", "sort_rows.compact")
    for path, names in (
            ("and uniform", ("fused_and", "fused_and.width",
                             "fused_and.compact")),
            ("and zipf", ("fused_and.width",)),
            ("lookup", ("decode_postings",)),
            ("or uniform", concat + ("wire_meta",)),
            ("or zipf", concat + ("wire_meta",)),
            ("or pages", concat + ("concat_compact",)),
            ("lookup_staged", concat),
            ("dual and uniform", dual + ("intersect_many",)),
            ("dual and zipf", dual + ("intersect_many",)),
            ("dual or pages", dual + ("sort_rows.runs",)),
            ("dual or", dual + ("sort_rows.runs",)),
            ("dual lookup", ("decode_postings",)),
            ("hybrid and uniform", ("fused_and", "fused_and.width")),
            ("device prefix", ("decode_postings",)),
            ("device range", ("decode_postings",)),
            ("entry entry", ("decode_postings", "intersect_many")),
            ("entry overlapping", ("decode_postings", "intersect_many")),
            ("lifecycle", ("decode_postings", "fused_and", "intersect_many",
                           "sort_rows")),
            ("dryrun", ("decode_postings", "intersect_many",
                        "sort_rows.runs", "sort_rows.compact"))) + tuple(
                (f"mesh{D} {p}", names) for D in MESH_DS
                for p, names in (
                    ("lookup", ("decode_postings", "wire_meta")),
                    ("and", ("decode_postings", "intersect_many",
                             "wire_meta")),
                    ("or", ("decode_postings",) + runs
                     + ("sort_rows.compact", "wire_meta")),
                    ("pages", ("decode_postings",) + runs
                     + ("sort_rows.compact",)),
                    ("lookup_staged", ("decode_postings",
                                       "sort_rows.compact")),
                    ("prefix", ("decode_postings",)),
                    ("range", ("decode_postings",)),
                    ("dual and", dual + ("intersect_many",)))):
        for name in names:
            check(per_path[path][name] > 0,
                  f"the {path} path never launched {name}")
    mesh_launches = {name: 0 for name in launches}
    for path, got in per_path.items():
        if path.startswith("mesh"):
            # the JAX mesh has no fused path, and neither has the port's
            check(got["fused_and"] == 0, f"the {path} path launched K2")
            for name, c in got.items():
                mesh_launches[name] += c
    # the concat stream's page form writes its buffer: no wire codec
    check(per_path["or pages"]["wire_meta"] == 0
          and per_path["or pages"]["wire_pack"] == 0,
          "the or pages path called the full-result wire codec")
    for path in ("host and uniform", "host and zipf", "host or uniform",
                 "host lookup_staged"):
        check(not any(per_path[path].values()),
              f"the {path} path launched kernels: {per_path[path]}")
    for path, got in per_path.items():
        # every call site states its runs: nothing takes the whole network
        check(got["sort_rows.general"] == 0,
              f"the {path} path sorted {got['sort_rows.general']} matrices "
              "without a hint")
        check(got["sort_rows"] == sum(got["sort_rows." + n] for n in entries),
              f"the {path} path's K4 entries do not add up")
        # the card compacts inside K2: no path asks for the masked rows
        check(got["fused_and.masked"] == 0,
              f"the {path} path took K2's masked output "
              f"{got['fused_and.masked']} times")

    src = "inverted_index_2_tpu_torch/csrc/"
    k1 = (src + "decode_postings.cu",
          "inverted_index_2_tpu/ops/pallas_decode.py:81")
    k2 = (src + "fused_and.cu", "inverted_index_2_tpu/ops/pallas_fused.py:380")
    k3 = (src + "intersect.cu", "inverted_index_2_tpu/ops/pallas_bool.py:113")
    k4 = (src + "sort_rows.cu", "inverted_index_2_tpu/ops/pallas_sort.py:86")
    # no TPU kernel: the JAX package runs the concat step as plain XLA
    concat_src = (src + "concat_step.cu",
                  "inverted_index_2_tpu/ops/concat_bool.py:139")
    # no TPU kernel either: the JAX package's wire steps are plain XLA
    wire_src = src + "wire.cu"
    # name -> (source, replaces, the launch count it reports). K1 has one
    # entry (its second row is the dual step's shape). K2 has a row per
    # output that the paths launch: "fused_and" is the width-P page of the
    # staged stream, "fused_and.compact" the whole compacted row of the
    # follow-ups; no path takes the masked rows (checked above). K3's row
    # is the dual pass (its times at the re-serve levels are in the phase-3
    # lines). K4 has a row per entry that the paths launch: "sort_rows" is the sort from 128-lane
    # runs at the modal concat class and counts every K4 call; no path
    # launches the general sort (checked above), whose times are in the
    # phase-3 lines only. The ".mesh" rows are phase 6's partition shapes
    # (K1 with partition 0's found mask, K3 on a query tile, K4's sort and
    # compaction of an OR tile), with the launches of the mesh paths alone.
    # The concat rows are the largest chunk of the AND follow-ups' route
    # (phase 3; the OR stream's and the page stream's are in its lines),
    # the wire rows the largest chunk of the OR stream (phase 3; the AND
    # route's and the mesh's are in the phase-3 lines)
    meta = {"decode_postings": k1 + ("decode_postings",),
            "decode_postings.found": k1 + ("decode_postings",),
            "fused_and": k2 + ("fused_and.width",),
            "fused_and.compact": k2 + ("fused_and.compact",),
            "intersect_many": k3 + ("intersect_many",),
            "sort_rows": k4 + ("sort_rows",),
            "sort_rows.two_run": k4 + ("sort_rows.two_run",),
            "compact_rows": k4 + ("sort_rows.compact",),
            "decode_postings.mesh": k1 + ("decode_postings",),
            "intersect_many.mesh": k3 + ("intersect_many",),
            "sort_rows.mesh": k4 + ("sort_rows.runs",),
            "compact_rows.mesh": k4 + ("sort_rows.compact",),
            "concat_decode": concat_src + ("concat_decode",),
            "concat_compact": concat_src + ("concat_compact",),
            "wire_meta": (wire_src, "inverted_index_2_tpu/models/steps.py:459",
                          "wire_meta"),
            "wire_pack": (wire_src, "inverted_index_2_tpu/models/steps.py:468",
                          "wire_pack")}
    rows = []
    for name, (source, replaces, counted) in meta.items():
        err, ms, plain_ms, lib_ms, b_ms, b_by = kern[name]
        check(b_ms <= ms, f"{name}: its time {ms} ms beat its bound "
              f"{b_ms} ms ({b_by})")
        n = (mesh_launches if name.endswith(".mesh") else launches)[counted]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": n,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms, "lib_ms": lib_ms})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
