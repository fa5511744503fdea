#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (inverted_index_2_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--terms N] [--seed S]

Phases; any failure raises and the script exits non-zero:
  1. the card: CUDA must be available; prints nvidia-smi's name and power
     limit;
  2. build: nvcc builds the kernels of inverted_index_2_tpu_torch/csrc
     (kernel K1, posting decode; kernel K2, fused decode + AND);
  3. each kernel against its plain torch version on the card, at the
     slice's shapes (Q=8192 queries of up to 8 terms, L=2048, and the ladder
     level 8192), bit-identical on valid prefixes, masked rows and counts;
  4. a small engine check: an InvertedIndex built with put / put_removed /
     merge, served by QueryEngine.from_index(..., device="cuda"), against a
     numpy oracle (long lists, tombstones, misses, single-term queries,
     ladder re-serves, small-P overflow);
  5. the main path at a realistic size: the config-3 deployment of
     BASELINE.md (Boolean AND of 2-8 terms, mean posting length 1k), cut
     from 10M to --terms terms, served by boolean_staged(columnar=True,
     depth=4) over 8 uniform batches of 8192 queries and a Zipf stream
     (three timed passes each), plus one batch of 8192 lookups; sampled
     results against the oracle, the kernels' launch counts from this
     phase, and then one profiled pass of each stream (device busy share).
The last line is {"ok": true, "device": {...}}; before it come one JSON
line with each kernel's launches, error and time against its plain
version, and nvidia-smi's name and power limit of the card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# keep every merge of the host layers on the host C++ path: the device merge
# of inverted_index_2_tpu (shard.py) would import jax
os.environ["TPI_DEVICE_MERGE_MIN"] = str(1 << 62)

import numpy as np

L_MAIN = 2048
BATCH = 8192
N_BATCHES = 8


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def gen_corpus(n_terms: int, mean_len: int, seed: int):
    """The bench's config-3 generator (bench.py gen_corpus): 12-byte terms,
    geometric list lengths with the given mean, gaps 1..1999."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(97, 123, size=(n_terms, 12), dtype=np.uint8)
    terms_mat = np.unique(raw, axis=0)
    n = len(terms_mat)
    offsets = np.arange(n + 1, dtype=np.int64) * 12
    lens = np.maximum(1, rng.geometric(1.0 / mean_len, size=n)).astype(np.int64)
    total = int(lens.sum())
    gaps = rng.integers(1, 2 * 1000, size=total, dtype=np.uint16)
    voffs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=voffs[1:])
    csum = np.cumsum(gaps, dtype=np.int64)
    base = csum[np.maximum(voffs[:-1] - 1, 0)]
    base[0] = 0
    heads = np.zeros(total, dtype=np.int8)
    heads[voffs[1:-1]] = 1
    gidx = np.cumsum(heads, dtype=np.int64)
    values = (csum - base[gidx]).astype(np.uint32)
    return terms_mat, offsets, values, voffs


def and_oracle(values, voffs, idxs):
    out = None
    for i in idxs:
        v = values[voffs[i]:voffs[i + 1]]
        out = v if out is None else np.intersect1d(out, v, assume_unique=True)
    return out


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


def phase_kernels(torch, eng, terms_mat, uniform):
    """Phase 3: K1 and K2 against their plain versions on the card."""
    from inverted_index_2_tpu.codec import keys as keys_mod
    from inverted_index_2_tpu_torch.models.steps import fused_rows
    from inverted_index_2_tpu_torch.ops import cuda_decode, cuda_fused
    from inverted_index_2_tpu_torch.ops.decode import gather_postings_arena
    from inverted_index_2_tpu_torch.ops.dict_search import resolve
    from inverted_index_2_tpu_torch.utils.u32 import to_device, to_i64

    s = eng.snap
    dev = eng.device
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
    errs, times = [], []
    for L, ti in ((L_MAIN, idx), (4 * L_MAIN, idx[longest].contiguous())):
        kv_, kc = cuda_decode.decode_postings(
            s.blocks, s.term_block_start, s.counts, ti, L)
        pv, pc = gather_postings_arena(s.blocks, s.term_block_start,
                                       s.counts, ti, L)
        torch.cuda.synchronize()
        check(torch.equal(kc, pc), f"K1 L={L}: counts differ")
        valid = (torch.arange(L, device=dev)[None, :]
                 < pc.clamp(max=L).long()[:, None])
        diff = (to_i64(kv_) - to_i64(pv)).abs()[valid]
        err = int(diff.max()) if diff.numel() else 0
        check(err == 0, f"K1 L={L}: values differ (max abs {err})")
        k_ms = time_ms(torch, lambda: cuda_decode.decode_postings(
            s.blocks, s.term_block_start, s.counts, ti, L), 20)
        p_ms = time_ms(torch, lambda: gather_postings_arena(
            s.blocks, s.term_block_start, s.counts, ti, L), 5)
        print(f"[phase 3] K1 decode Q={ti.shape[0]} L={L}: bit-identical "
              f"({int(valid.sum())} values), kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms")
        errs.append(err)
        times.append((k_ms, p_ms))
    res["decode_postings"] = (max(errs), times[0][0], times[0][1])

    # K2 on the first uniform batch, then on its longest bases at 4L
    qk, kv = eng._pack_boolean(eng._state, uniform[0])
    kvt = to_device(kv, dev)
    rows, cnts, need = fused_rows(s.keys, s.term_block_start, s.counts,
                                  to_device(qk, dev), kvt, s.hash_slots,
                                  s.max_probes)
    top = torch.argsort(need, descending=True)[:256]
    errs, times = [], []
    for L, args in ((L_MAIN, (rows, cnts, kvt)),
                    (4 * L_MAIN, (rows[top].contiguous(),
                                  cnts[top].contiguous(),
                                  kvt[top].contiguous()))):
        ko, kc = cuda_fused.fused_and(s.blocks, *args, L, compact=False)
        po, pc = cuda_fused.fused_and_torch(s.blocks, *args, L)
        torch.cuda.synchronize()
        check(torch.equal(kc, pc), f"K2 L={L}: keep counts differ")
        err = int((to_i64(ko) - to_i64(po)).abs().max())
        check(err == 0 and torch.equal(ko, po),
              f"K2 L={L}: masked rows differ (max abs {err})")
        k_ms = time_ms(torch, lambda: cuda_fused.fused_and(
            s.blocks, *args, L, compact=False), 20)
        p_ms = time_ms(torch, lambda: cuda_fused.fused_and_torch(
            s.blocks, *args, L), 2)
        print(f"[phase 3] K2 fused AND Q={args[0].shape[0]} K={args[0].shape[1]} "
              f"L={L}: bit-identical ({int(kc.sum())} kept, "
              f"{int((need > L).sum()) if L == L_MAIN else 0} bases > L), "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        errs.append(err)
        times.append((k_ms, p_ms))
    res["fused_and"] = (max(errs), times[0][0], times[0][1])
    return res


def phase_engine_small(torch, device):
    """Phase 4: the engine from an InvertedIndex against a numpy oracle."""
    from inverted_index_2_tpu import InvertedIndex, to_slice
    from inverted_index_2_tpu_torch import QueryEngine

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

    def oracle(q):
        if any(t not in host for t in q):
            return np.zeros(0, np.uint32)
        out = host[q[0]]
        for t in q[1:]:
            out = np.intersect1d(out, host[t])
        return out

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
    print(f"[phase 4] engine from InvertedIndex: lookup, boolean and "
          f"boolean_staged AND equal the oracle ({len(queries)} queries, "
          f"{len(look)} lookups, follow-ups {st})")


def zipf_stream(rng, n_terms, n_batches):
    """bench.py's Zipf mix: a pool of 4096 queries of 2-8 terms drawn with
    weight 1/rank."""
    pool = [rng.choice(n_terms, size=int(rng.integers(2, 9)), replace=False)
            for _ in range(4096)]
    w = 1.0 / np.arange(1, len(pool) + 1, dtype=np.float64)
    w /= w.sum()
    return [[pool[i] for i in rng.choice(len(pool), size=BATCH, p=w)]
            for _ in range(n_batches)]


def uniform_stream(rng, n_terms, n_batches):
    return [[rng.choice(n_terms, size=int(rng.integers(2, 9)), replace=False)
             for _ in range(BATCH)] for _ in range(n_batches)]


def run_stream(eng, values, voffs, term_bytes, stream, name, reps=3):
    """Serve one stream `reps` times after a warm pass; check a sample of
    the last pass against the oracle. Returns the QPS of each pass."""
    batches = [[[term_bytes[i] for i in q] for q in b] for b in stream]
    eng.boolean_staged(batches[:1], "and", columnar=True, depth=4)  # warm
    nq = sum(len(b) for b in batches)
    qps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = eng.boolean_staged(batches, "and", columnar=True, depth=4)
        qps.append(nq / (time.perf_counter() - t0))
    stats = dict(eng.last_stream_stats)
    check(stats["queries"] == nq, f"{name}: served {stats['queries']} of {nq}")
    rng = np.random.default_rng(23)
    checked = 0
    for bi in range(len(batches)):
        vals, vo = out[bi]
        check(len(vo) == len(batches[bi]) + 1, f"{name}: batch {bi} shape")
        for qi in rng.choice(len(batches[bi]), size=64, replace=False):
            want = and_oracle(values, voffs, stream[bi][qi])
            check(np.array_equal(vals[vo[qi]:vo[qi + 1]], want),
                  f"{name}: batch {bi} query {qi} differs from the oracle")
            checked += 1
    nres = sum(len(o[0]) for o in out)
    print(f"[phase 5] {name}: {nq} queries per pass, QPS of {reps} passes "
          f"{[round(q, 1) for q in qps]}; {nres} result values; follow-ups "
          f"{stats}; {checked} sampled queries equal the oracle")
    return batches, sorted(qps)[len(qps) // 2]


def profile_stream(torch, eng, batches, name):
    """Device busy share of one stream pass: the summed time of the kernels
    and copies on the card over the pass's wall time (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.boolean_staged(batches, "and", columnar=True, depth=4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    launches = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    print(f"[phase 5] profile {name}: wall {wall:.6f} s, device busy "
          f"{busy_us / 1e6:.6f} s = {busy_us / 1e6 / wall:.4f} of the pass, "
          f"{launches} kernel launches; top device time: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total:.1f} us "
                      f"x{e.count}" for e in top))


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--terms", type=int, default=200_000,
                    help="dictionary size of the phase-5 corpus")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

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

    from inverted_index_2_tpu_torch.ops import _build, cuda_decode, cuda_fused

    t0 = time.perf_counter()
    _build.library()
    built = ("found built" if _build.build_seconds is None
             else f"built by nvcc in {_build.build_seconds:.4f} s")
    print(f"[phase 2] kernels {built}, loaded in "
          f"{time.perf_counter() - t0:.4f} s: {_build.library_path().name}")
    print(_build.build_log.strip())

    eng, terms_mat, values, voffs = phase_main(torch, args)
    rng = np.random.default_rng(args.seed + 1)
    uniform = uniform_stream(rng, len(terms_mat), N_BATCHES)
    zipf = zipf_stream(rng, len(terms_mat), N_BATCHES)
    term_bytes = [terms_mat[i].tobytes() for i in range(len(terms_mat))]
    uniform_b = [[[term_bytes[i] for i in q] for q in b] for b in uniform[:1]]

    kern = phase_kernels(torch, eng, terms_mat, uniform_b)
    phase_engine_small(torch, "cuda")

    # phase 5: the main path; count only its kernel launches
    torch.cuda.reset_peak_memory_stats()
    cuda_decode.decode_postings.launches = 0
    cuda_fused.fused_and.launches = 0
    ub, qps_u = run_stream(eng, values, voffs, term_bytes, uniform, "uniform")
    zb, qps_z = run_stream(eng, values, voffs, term_bytes, zipf, "zipf")
    pick = np.random.default_rng(args.seed + 2).choice(
        len(terms_mat), size=BATCH, replace=False)
    t0 = time.perf_counter()
    got = eng.lookup([term_bytes[i] for i in pick])
    dt = time.perf_counter() - t0
    for j in np.random.default_rng(3).choice(BATCH, size=512, replace=False):
        i = pick[j]
        check(np.array_equal(got[j], values[voffs[i]:voffs[i + 1]]),
              f"lookup of term {i} differs from the corpus")
    n_long = int((np.diff(voffs)[pick] > L_MAIN).sum())
    launches = {"decode_postings": cuda_decode.decode_postings.launches,
                "fused_and": cuda_fused.fused_and.launches}
    print(f"[phase 5] lookup: {BATCH} terms in {dt:.4f} s ({n_long} longer "
          f"than L re-served); 512 sampled lists equal the corpus")
    print(f"[phase 5] median QPS uniform {qps_u:.1f}, zipf {qps_z:.1f}, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, "
          f"kernel launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"the main path never launched {name}")
    profile_stream(torch, eng, ub, "uniform")
    profile_stream(torch, eng, zb, "zipf")

    src = "inverted_index_2_tpu_torch/csrc/"
    meta = {"decode_postings": (src + "decode_postings.cu",
                                "inverted_index_2_tpu/ops/pallas_decode.py:81"),
            "fused_and": (src + "fused_and.cu",
                          "inverted_index_2_tpu/ops/pallas_fused.py:380")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0],
         "replaces": meta[name][1], "launches": launches[name],
         "max_abs_err": kern[name][0], "ms": kern[name][1],
         "plain_ms": kern[name][2]} for name in ("decode_postings",
                                                 "fused_and")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
