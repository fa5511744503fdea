#!/usr/bin/env python3
"""The control of the check that decides `correct`: the plain reference put
in the program's place, with the step that breaks the configuration's
guarantee of exact answers (every list cut to its first `--truncate` ids,
the fast path's pad, before the set operation: the ladder re-serves and the
concat AND skipped). It must come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--truncate 1024] [--calls N]

Makes each seed's corpus and stream as a run does (on the card when there
is one), draws the check's sample from the calls a full window would keep
(or from a window of N calls), answers the sampled queries with the control
and holds them against the exact reference. Prints one JSON line: per seed,
the answers compared and the wrong ones. The benchmark's runs never run it.
"""
import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [p for p in (BENCH, os.path.dirname(BENCH)) if p not in sys.path]

import check as check_mod  # noqa: E402
import corpus as corpus_mod  # noqa: E402
import harness  # noqa: E402
from reference import Reference  # noqa: E402


def control_reading(workload: str, seed: int, truncate: int, device,
                    calls=None, decl=None, cfg=None, mix=None) -> dict:
    """Wrong answers of the control on one seed's sample."""
    decl = decl if decl is not None else harness.load_declaration()
    _, cfg_file, mix_file = harness.load_cell(decl, workload)
    cfg = cfg if cfg is not None else cfg_file
    mix = mix if mix is not None else mix_file
    corp = corpus_mod.generate(cfg, seed, device)
    gen = harness.traffic(mix)
    stream = gen.build(mix, corp, seed)
    n = len(stream.calls)
    done = n if calls is None else int(calls)
    kept = sorted({w % n for w in harness.drawn_calls(seed) if w < done}
                  | {(done - 1) % n})
    rows = harness.rows_of_calls(stream, kept)
    picks = check_mod.draw_sample(gen.classes(stream, corp, rows),
                                  mix["check"]["per_class"], seed)
    exact = Reference(corp.values, corp.voffs, corp.D)
    cut = Reference(corp.values, corp.voffs, corp.D, truncate=truncate)
    verdict = check_mod.compare(
        picks, lambda row: gen.expected(stream, cut, row),
        lambda row: gen.expected(stream, exact, row),
        lambda got, want: gen.same(stream, got, want))
    return {"seed": seed, "compared": verdict["compared"],
            "wrong_answers": len(verdict["wrong"]),
            "by_class": verdict["by_class"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--truncate", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=None)
    args = ap.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    out = []
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        r = control_reading(args.workload, int(s), args.truncate, device,
                            args.calls)
        r["seconds"] = time.perf_counter() - t0
        print(f"[control] {args.workload} {r}", file=sys.stderr, flush=True)
        out.append(r)
    print(json.dumps({"workload": args.workload, "truncate": args.truncate,
                      "device": device, "readings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
