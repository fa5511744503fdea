#!/usr/bin/env python3
"""How many concat-class steps one benchmark call launches, by class: the
cell's set-up, then `--calls` of its window's calls, each step counted by
its block budget SB (the class, or the single's own budget past the
largest class) beside the call's `last_stream_stats["concat_chunks"]`, and
the concat decode kernel's launches (ops/cuda_concat.py) beside their sum.

    python3 experiments/concat_chunks.py --workload <cell> --seed <n> \
        [--calls 20] [--device cuda]

Prints one JSON line: the per-call chunk counts (median, min, max), the
steps by class per call (mean), the singles per call, and whether the
decode kernel launched once per counted chunk. The card's name and power
limit go to standard error.
"""
import argparse
import collections
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")


def count(workload, seed, calls, device):
    import torch

    import corpus as corpus_mod
    import harness
    from inverted_index_2_tpu_torch.models import staged
    from inverted_index_2_tpu_torch.ops import cuda_concat

    decl = harness.load_declaration(REPO)
    _, cfg, mix = harness.load_cell(decl, workload)
    dev = torch.device(device)
    corp = corpus_mod.generate(cfg, seed, dev)
    gen = harness.traffic(mix)
    stream = gen.build(mix, corp, seed)
    eng = harness.default_engine(corp, dev)
    for call in stream.warm:
        gen.serve(eng, stream, call)
    by_sb = collections.Counter()
    real = staged.concat_step

    def counted(*a, **k):
        by_sb[a[7]] += 1  # SB
        return real(*a, **k)

    staged.concat_step = counted
    launches0 = cuda_concat.concat_decode.launches
    chunks, singles = [], []
    try:
        for call in stream.calls[:calls]:
            _, stats = gen.serve(eng, stream, call)
            chunks.append(stats["concat_chunks"])
            singles.append(stats["concat_singles"])
    finally:
        staged.concat_step = real
    launched = cuda_concat.concat_decode.launches - launches0
    classes = set(type(eng)._SB_CLASSES)
    n = len(chunks)
    return {
        "workload": workload, "seed": seed, "calls": n,
        "queries_per_call": stream.queries_per_call,
        "chunks_per_call": {"median": statistics.median(chunks),
                            "min": min(chunks), "max": max(chunks)},
        "chunks_by_class_per_call": {
            str(sb): by_sb[sb] / n for sb in sorted(classes) if by_sb[sb]},
        "singles_per_call": sum(singles) / n,
        "steps_counted": sum(by_sb.values()), "chunks_summed": sum(chunks),
        "decode_launches": launched,
        "every_chunk_through_the_kernels": (
            dev.type == "cuda" and launched == sum(chunks)
            == sum(by_sb.values())),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for k in [k for k in os.environ if k.startswith("TPI_")]:
        del os.environ[k]
    sys.path[:0] = [p for p in (BENCH, REPO) if p not in sys.path]
    import harness

    print(json.dumps(count(args.workload, args.seed, args.calls,
                           args.device)), flush=True)
    if args.device == "cuda":
        print(f"[concat_chunks] card: {harness.card_line()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
