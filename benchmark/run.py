#!/usr/bin/env python3
"""The benchmark of inverted_index_2_tpu_torch on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json (at the root of the checkout) on this
machine's card: makes the configuration's corpus and the mix's queries from
the seed, builds and uploads the index and warms it up (set-up), serves the
window's calls for `--seconds`, then holds a sample of the answers against
the plain numpy reference. The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer metrics read from a torch.profiler trace of
the window), device (with --trace 1 also busy_s and window_s), breakdown
(--trace 1) and checks, the numbers compared beside their limits. Every
other line goes to standard error, the checks last.

Exits non-zero and prints no result when CUDA is missing, when the card
count is below the cell's, or when jax, jaxlib, flax or the JAX package is
loaded once the window has closed. TPI_* variables are cleared, so the
program runs as the configuration states.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for k in [k for k in os.environ if k.startswith("TPI_")]:
        del os.environ[k]
    sys.path[:0] = [p for p in (BENCH, REPO) if p not in sys.path]
    import harness
    import torch

    decl = harness.load_declaration(REPO)
    cell, _ = harness.find_cell(decl, args.workload)
    if not torch.cuda.is_available():
        print("[bench] CUDA is not available: no card to measure",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"[bench] {torch.cuda.device_count()} card(s), the cell asks "
              f"for {cell['chips']}", file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", decl=decl,
                             t_start=T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"[bench] loaded in this process: {', '.join(loaded)}; the "
              "benchmark measures the port alone", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
