#!/usr/bin/env python3
"""The full-result wire codec's kernels (ops/cuda_wire.py) on the result
matrices of the concat step's chunk shapes, for the wire table in PERF.md:
the masked max delta (wire_meta) and the delta pack (wire_pack) each beside
its bound (bytes over 3.35 TB/s) and beside the plain torch steps as the
stream ran them before (models/steps.py: _wire_meta_step, and
_wire_pack_step over the whole row cut to the widest row's count).

    python3 experiments/wire_kernels.py [--reps 20] [--seed 0]
        [--out build/wire_kernels.json]

Shapes: the AND chunks of experiments/concat_kernels.py (8 rows of 2^20
lanes with K = 6 and with K = 2, one row of 2^24 lanes with K = 3), whose
result matrices come from the concat step itself, so each row holds its
real count of values and the fill after it. Times by chip_smoke.kernel_ms
(each call alone, L2 emptied first; the second figure is back to back).
Prints one JSON line per shape, then the card and its power limit on
standard error. The card only: it exits 1 without CUDA.
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
sys.path.insert(0, os.path.join(REPO, "experiments"))

import chip_smoke  # noqa: E402
from concat_kernels import shape_input  # noqa: E402
from inverted_index_2_tpu_torch.models.steps import (  # noqa: E402
    _wire_meta_step,
    _wire_pack_step,
)
from inverted_index_2_tpu_torch.ops import cuda_concat  # noqa: E402
from inverted_index_2_tpu_torch.ops.cuda_wire import (  # noqa: E402
    wire_meta,
    wire_pack,
)

# (name, rows n, SB, K, pool of lists the queries draw from)
SHAPES = [
    ("and 8 x 2^20, K=6", 8, 8192, 6, 12),
    ("and 8 x 2^20, K=2", 8, 8192, 2, 6),
    ("and 1 x 2^24, K=3", 1, 131072, 3, 3),
]


def measure(name, n, SB, K, pool, reps, rng, dev):
    snap, idx, found, kv, rows, _ = shape_input(rng, dev, n, SB, K, pool)
    o, oc = cuda_concat.concat_step(snap.blocks, snap.term_block_start,
                                    snap.counts, idx, found, kv, rows, SB,
                                    "and")
    md = int(wire_meta(o, oc))
    check_md = int(_wire_meta_step(o, oc))
    chip_smoke.check(md == check_md, f"wire_meta {name}: {md} against the "
                     f"plain step's {check_md}")
    bits = 8 if md < 256 else 16
    chip_smoke.check(md < 1 << 16, f"{name}: max delta {md} ships raw u32")
    oc_h = oc.cpu().numpy().astype(np.int64)
    maxc = int(oc_h.max())
    f, dd = wire_pack(o, bits, maxc)
    pf, pdd = _wire_pack_step(o, bits)
    chip_smoke.check(torch.equal(f, pf) and torch.equal(dd, pdd[:, :maxc - 1]),
                     f"wire_pack {name}: differs from the plain step")
    del f, dd, pf, pdd

    def plain_pack():
        first, deltas = _wire_pack_step(o, bits)
        return first, deltas[:, :maxc - 1]

    S = int(o.shape[1])
    # bytes: the meta reads each row's kept lanes and its count and writes
    # one word; the pack reads maxc lanes a row and writes the first value
    # and maxc - 1 deltas of bits / 8 bytes
    meta_bytes = 4 * int(np.maximum(oc_h, 0).sum()) + 4 * n + 8
    pack_bytes = n * maxc * 4 + n * 4 + n * (maxc - 1) * bits // 8
    row = {"shape": name, "n": n, "lanes": S, "K": K, "bits": bits,
           "max_delta": md, "kept_lanes": int(oc_h.sum()), "maxc": maxc}
    for key, fn, nbytes in (
            ("meta", lambda: wire_meta(o, oc), meta_bytes),
            ("pack", lambda: wire_pack(o, bits, maxc), pack_bytes),
            ("plain_meta", lambda: _wire_meta_step(o, oc), meta_bytes),
            ("plain_pack", plain_pack, pack_bytes)):
        ms, between = chip_smoke.kernel_ms(torch, fn, reps)
        row[key] = {"ms": round(ms, 4), "back_to_back_ms": round(between, 4),
                    "bound_ms": round(chip_smoke.bound(nbytes, 0)[0], 4)}
    del snap, o, oc
    torch.cuda.empty_cache()
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "wire_kernels.json"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("wire_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[wire_kernels] {card.strip()}", file=sys.stderr)
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
