#!/usr/bin/env python3
"""The concat-class step's kernels at the chunk shapes the staged streams
launch, for the kernel table in PERF.md: the concat decode, K4's sort from
runs of 128 and the concat compaction (ops/cuda_concat.py), each beside its
bound (bytes over 3.35 TB/s), and at the same shape the plain chain
(ops/concat_bool.py::boolean_concat_step, torch ops around K4) and K4's
compaction of the same kept lanes (ops/compaction.py, one CTA a row).

    python3 experiments/concat_kernels.py [--reps 20] [--seed 0]
        [--out build/concat_kernels.json]

Shapes: 8 rows of 2^20 lanes (SB 8192) with K = 6 and with K = 2, one row
of 2^24 lanes (SB 131072), and OR pages 64 x 2^18 (SB 2048, K = 4, P = 32),
each row about nine tenths full of lists that overlap (gaps of 1 or 2).
Times by chip_smoke.kernel_ms (each call alone, L2 emptied first; the
second figure is back to back). Prints one JSON line per shape, then the
card and its power limit on standard error. The card only: it exits 1
without CUDA.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from inverted_index_2_tpu_torch.models.snapshot import (  # noqa: E402
    build_host_tables,
    upload_tables,
)
from inverted_index_2_tpu_torch.ops import cuda_concat  # noqa: E402
from inverted_index_2_tpu_torch.ops.compaction import compact_rows  # noqa: E402
from inverted_index_2_tpu_torch.ops.concat_bool import (  # noqa: E402
    boolean_concat_step,
    concat_marks_torch,
)
from inverted_index_2_tpu_torch.ops.cuda_sort import sort_rows  # noqa: E402

# (name, op, rows n, SB, K, pool of lists the queries draw from, P)
SHAPES = [
    ("and 8 x 2^20, K=6", "and", 8, 8192, 6, 12, 0),
    ("and 8 x 2^20, K=2", "and", 8, 8192, 2, 6, 0),
    ("and 1 x 2^24, K=3", "and", 1, 131072, 3, 3, 0),
    ("or pages 64 x 2^18, K=4, P=32", "or", 64, 2048, 4, 16, 32),
]
FILL = 0.9


def shape_input(rng, dev, n, SB, K, pool):
    """(snapshot, idx, found, kv, rows, nb per term): n queries of K lists
    drawn from a pool, each list FILL * SB / K blocks long."""
    per = int(FILL * SB * 128 / K)
    lists = []
    for _ in range(pool):
        gaps = rng.integers(1, 3, size=per, dtype=np.int64)
        lists.append((int(rng.integers(0, 64)) + np.cumsum(gaps))
                     .astype(np.uint32))
    voffs = np.zeros(pool + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    blob = b"".join(f"t{i:05d}".encode() for i in range(pool))
    offs = np.arange(pool + 1, dtype=np.int64) * 6
    t = build_host_tables(blob, offs, np.concatenate(lists), voffs)
    snap = upload_tables(t, device=dev)
    idx = np.stack([rng.choice(pool, size=K, replace=False)
                    for _ in range(n)])
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (snap, to(idx.astype(np.int64)), to(np.ones((n, K), bool)),
            to(np.full(n, K, np.int32)), to(np.arange(n, dtype=np.int32)),
            -(-t.counts.astype(np.int64) // 128))


def measure(name, op, n, SB, K, pool, P, reps, rng, dev):
    snap, idx, found, kv, rows, nb = shape_input(rng, dev, n, SB, K, pool)
    args = (snap.blocks, snap.term_block_start, snap.counts, idx, found, kv)
    S = SB * 128
    flat, meta = cuda_concat.concat_decode(*args, rows, SB)
    svals = sort_rows(flat, run=128)
    obuf = torch.zeros((n, P + 1), dtype=torch.int32, device=dev) if P \
        else None

    def compact():
        return cuda_concat.concat_compact(svals, meta, op, K, P, obuf, rows)

    def chain():
        return boolean_concat_step(*args, SB, op, prefix_p=P)

    def step():
        return cuda_concat.concat_step(*args, rows, SB, op, prefix_p=P,
                                       obuf=obuf)

    keep, _ = concat_marks_torch(svals, meta, op, K)  # the plain marks

    def k4_compact():
        return compact_rows(svals, keep)

    stride = int(snap.blocks.shape[1])
    used = int(nb[idx.cpu().numpy()].sum())
    n_valid = int(meta[0].sum())
    dec_bytes = used * stride * 4 + n * S * 4 + idx.numel() * 9
    sort_bytes = 2 * n * S * 4
    cmp_bytes = n_valid * 4 + (n * (P + 1) * 4 if P else n * (S + 1) * 4)
    row = {"shape": name, "n": n, "lanes": S, "K": K, "P": P,
           "n_valid": n_valid}
    for key, fn, nbytes in (
            ("decode", lambda: cuda_concat.concat_decode(*args, rows, SB),
             dec_bytes),
            ("sort", lambda: sort_rows(flat, run=128), sort_bytes),
            ("compact", compact, cmp_bytes),
            ("step", step, dec_bytes + sort_bytes + cmp_bytes),
            ("plain_chain", chain, dec_bytes + sort_bytes + cmp_bytes),
            ("k4_compact", k4_compact, n * S * 9)):
        ms, between = chip_smoke.kernel_ms(torch, fn, reps)
        row[key] = {"ms": round(ms, 4), "back_to_back_ms": round(between, 4),
                    "bound_ms": round(chip_smoke.bound(nbytes, 0)[0], 4)}
    del snap, flat, svals, keep
    torch.cuda.empty_cache()
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "concat_kernels.json"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("concat_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[concat_kernels] {card.strip()}", file=sys.stderr)
    rng = np.random.default_rng(a.seed)
    rows = []
    for shp in SHAPES:
        rows.append(measure(*shp, a.reps, rng, torch.device("cuda")))
        print(json.dumps(rows[-1]), flush=True)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump({"card": card.strip(), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
