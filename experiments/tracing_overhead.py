#!/usr/bin/env python3
"""What the port's spans cost while they record: untraced benchmark windows
of one cell with `utils/tracing.enable(True)` against the same windows with
tracing off, on one set-up per seed, in turns (off, on, on, off).

    python3 experiments/tracing_overhead.py --workload <cell> \
        --seeds 11,12,13 [--seconds 15] [--device cuda]

The set-up and the windows are the benchmark's (benchmark/harness.py); no
profiler runs. Prints one JSON line per window (seed, tracing, qps,
p95_call_ms, calls), then one with each side's median over all windows and
their ratio, and the card with its power limit on standard error.
"""
import argparse
import gc
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")


def windows(workload, seed, seconds, device):
    import numpy as np
    import torch

    import corpus as corpus_mod
    import harness
    from inverted_index_2_tpu_torch.utils import tracing

    decl = harness.load_declaration(REPO)
    _, cfg, mix = harness.load_cell(decl, workload)
    dev = torch.device(device)
    corp = corpus_mod.generate(cfg, seed, dev)
    gen = harness.traffic(mix)
    stream = gen.build(mix, corp, seed)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    eng = harness.default_engine(corp, dev)
    for call in stream.warm:
        gen.serve(eng, stream, call)
    rows = []
    for on in (False, True, True, False):
        tracing.enable(on)
        try:
            w = harness.window(gen, eng, stream, seconds, seed, traced=False)
        finally:
            tracing.enable(False)
        times = np.array(w.times)
        rows.append({"workload": workload, "seed": seed, "tracing": on,
                     "qps": len(times) * stream.queries_per_call / w.seconds,
                     "p95_call_ms": float(np.percentile(times, 95)) * 1e3,
                     "calls": len(times)})
        print(json.dumps(rows[-1]), flush=True)
    del eng, corp, stream
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for k in [k for k in os.environ if k.startswith("TPI_")]:
        del os.environ[k]
    sys.path[:0] = [p for p in (BENCH, REPO) if p not in sys.path]
    import harness

    rows = []
    for s in args.seeds.split(","):
        rows += windows(args.workload, int(s), args.seconds, args.device)
    out = {"workload": args.workload}
    for key in ("qps", "p95_call_ms"):
        off = statistics.median(r[key] for r in rows if not r["tracing"])
        on = statistics.median(r[key] for r in rows if r["tracing"])
        out[key] = {"off": off, "on": on, "on_over_off": on / off}
    print(json.dumps(out), flush=True)
    if args.device == "cuda":
        print(f"[overhead] card: {harness.card_line()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
