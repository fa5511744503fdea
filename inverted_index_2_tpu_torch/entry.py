"""Entry points of the port (counterpart of the repository's
__graft_entry__.py).

entry(device)              -> (fn, example_args): the flagship forward step,
                              a batched boolean AND over a device snapshot
                              (hash-probe resolve -> posting decode through
                              K1 -> K-way AND through K3).
dryrun_multichip(n, device) -> one full pass of the partitioned serving
                              steps over n partitions (parallel/mesh.py) on
                              tiny shapes, then the MeshQueryEngine
                              lifecycle, each result held against a numpy
                              answer; returns the results.

Both run on the card unless the caller asks for the CPU. On one card the n
partitions share it; on several, partition d lives on card d mod count.

    python -m inverted_index_2_tpu_torch.entry [--device cpu] [--n N]
"""
from __future__ import annotations

import argparse
import functools
import sys
import tempfile

import numpy as np
import torch

from .utils.u32 import to_device, to_numpy_u32


def _check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _synthetic_snapshot_arrays(n_terms=512, mean_len=32, seed=0, width=3,
                               device="cuda"):
    """Small synthetic index snapshot on `device` and its sorted terms."""
    from .models.snapshot import build_snapshot_arrays

    rng = np.random.default_rng(seed)
    terms = sorted({f"term{i:06d}".encode() for i in range(n_terms)})
    lists = [
        np.unique(rng.integers(0, 1_000_000,
                               size=max(1, int(rng.poisson(mean_len))),
                               dtype=np.uint32))
        for _ in terms
    ]
    blob = b"".join(terms)
    offsets = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum([len(t) for t in terms], out=offsets[1:])
    voffs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=voffs[1:])
    snap = build_snapshot_arrays(blob, offsets, np.concatenate(lists), voffs,
                                 None, width, device=device)
    return snap, terms


def entry(device="cuda"):
    """The forward step on the flagship configuration (one device): fn is
    steps.boolean_step with L=256 and op="and"; the arguments are the
    snapshot's tensors and 64 packed queries of 4 terms on `device`."""
    from .codec import keys as K
    from .models.steps import boolean_step

    snap, terms = _synthetic_snapshot_arrays(device=device)
    Q, Kq = 64, 4
    rng = np.random.default_rng(1)
    qk = np.zeros((Q, Kq, snap.width + 1), dtype=np.uint32)
    for i in range(Q):
        chosen = [terms[j] for j in rng.choice(len(terms), size=Kq,
                                               replace=False)]
        qk[i] = K.pack_terms(chosen, width=snap.width)
    k_valid = np.full(Q, Kq, dtype=np.int32)
    fn = functools.partial(
        boolean_step,
        L=256,
        op="and",
        removed=None,
        slots=snap.hash_slots,
        max_probes=snap.max_probes,
    )
    example_args = (
        snap.keys,
        snap.blocks,
        snap.term_block_start,
        snap.counts,
        to_device(qk, snap.device),
        to_device(k_valid, snap.device),
    )
    return fn, example_args


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.cpu(), b.cpu()))


def _rows(vals: torch.Tensor, counts: torch.Tensor) -> list:
    """Each row's valid prefix vals[i, :counts[i]], on the host (the lanes
    past a count are undefined)."""
    v, c = to_numpy_u32(vals), counts.cpu().numpy()
    return [v[i, :int(c[i])].copy() for i in range(len(c))]


def _and(lists) -> np.ndarray:
    out = lists[0]
    for v in lists[1:]:
        out = np.intersect1d(out, v, assume_unique=True)
    return out.astype(np.uint32)


def _or(lists) -> np.ndarray:
    return np.unique(np.concatenate(lists)).astype(np.uint32)


def _rows_equal(got: list, want: list, what: str) -> None:
    _check(len(got) == len(want), f"{what}: {len(got)} rows, want "
           f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        _check(np.array_equal(g, w), f"{what}: row {i} differs from the "
               f"numpy answer ({len(g)} values, want {len(w)})")


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One pass of every partitioned serving form over n_devices partitions
    (tiny shapes): the lookup and its reduce-scatter form, AND in three
    formulations (the psum form, the concat form, the reduce-scatter form),
    OR, prefix search and range read; then the MeshQueryEngine lifecycle
    (tombstone filter, OR, staged pages, lookup_staged, a delta refresh and
    an AND across both tiers). Each result is held against a numpy answer
    over the generated lists, and the forms against each other. Raises
    AssertionError on the first disagreement; returns the results (name ->
    list of uint32 arrays, valid prefixes only), which are the same on
    every device for the same n_devices."""
    from .codec import keys as K
    from .inverted_index import InvertedIndex
    from .models.snapshot import build_snapshot_arrays
    from .parallel import MeshQueryEngine
    from .parallel import mesh as pm

    mesh = pm.default_mesh(n_devices, device)
    dev0 = mesh[0]

    # one tiny partition per device: disjoint term ranges (as the prefix
    # router would produce)
    rng = np.random.default_rng(0)
    parts, all_terms, posting = [], [], {}
    for d in range(n_devices):
        terms = sorted(f"{d:02d}term{i:03d}".encode() for i in range(32))
        all_terms.extend(terms)
        lists = [
            np.unique(rng.integers(0, 10_000, size=int(rng.integers(1, 64)),
                                   dtype=np.uint32))
            for _ in terms
        ]
        posting.update(zip(terms, lists))
        blob = b"".join(terms)
        offsets = np.zeros(len(terms) + 1, dtype=np.int64)
        np.cumsum([len(t) for t in terms], out=offsets[1:])
        voffs = np.zeros(len(lists) + 1, dtype=np.int64)
        np.cumsum([len(v) for v in lists], out=voffs[1:])
        parts.append(build_snapshot_arrays(
            blob, offsets, np.concatenate(lists), voffs, None, 3,
            device=mesh[d]))
    snap = pm.stack_partitions(parts, mesh)
    res = {}

    L = 128
    lookup = pm.make_sharded_lookup(snap, L)
    booland = pm.make_sharded_boolean(snap, L, "and")

    # 16 owned terms and one that no partition holds (Q = 17 also pads the
    # reduce-scatter's query axis)
    queries = [all_terms[i]
               for i in rng.choice(len(all_terms), size=16, replace=False)]
    queries.append(b"zz-missing")
    want = [posting.get(t, np.zeros(0, np.uint32)) for t in queries]
    qk = to_device(K.pack_terms(queries, width=snap.width), dev0)
    found, vals, n, raw = lookup(qk)
    _check(found.cpu().tolist() == [t in posting for t in queries],
           "sharded lookup: found differs from the terms held")
    _check(raw.cpu().tolist() == [len(w) for w in want],
           "sharded lookup: counts differ from the lists")
    res["lookup"] = _rows(vals, n)
    _rows_equal(res["lookup"], want, "sharded lookup")

    # reduce-scatter lookup (the engine's serving form) agrees bit for bit
    # on the valid prefixes (K1 leaves the lanes past a count undefined)
    fr, vr, nr, rr = pm.make_sharded_lookup_scatter(snap, L)(qk)
    _check(_same(rr, raw) and _same(nr, n) and _same(fr, found),
           "reduce-scatter lookup counts differ")
    res["lookup scatter"] = _rows(vr, nr)
    _rows_equal(res["lookup scatter"], want, "reduce-scatter lookup")

    # 8 random pairs (mostly empty ANDs) and 8 pairs whose AND is not empty
    Kq = 2
    pairs = [tuple(all_terms[j] for j in rng.choice(len(all_terms), size=Kq,
                                                   replace=False))
             for _ in range(8)]
    for i, j in zip(*np.triu_indices(len(all_terms), 1)):
        if len(pairs) == 16:
            break
        a, b = all_terms[i], all_terms[j]
        if len(_and([posting[a], posting[b]])):
            pairs.append((a, b))
    _check(len(pairs) == 16, "the corpus has too few overlapping pairs")
    bq = np.stack([K.pack_terms(list(p), width=snap.width) for p in pairs])
    bq_t = to_device(bq, dev0)
    kv = to_device(np.full(len(pairs), Kq, dtype=np.int32), dev0)
    want_and = [_and([posting[t] for t in p]) for p in pairs]
    want_need = [max(len(posting[t]) for t in p) for p in pairs]
    out, oc, need = booland(bq_t, kv)
    _check(need.cpu().tolist() == want_need, "AND need differs from the "
           "longest list")
    res["and"] = _rows(out, oc)
    _rows_equal(res["and"], want_and, "sharded AND")

    concat_and = pm.make_sharded_boolean_concat(snap, SB=4, op="and")
    outc, occ = concat_and(bq_t, kv)
    _check(_same(occ, oc), "concat AND must agree with the padded form")
    res["and concat"] = _rows(outc, occ)
    _rows_equal(res["and concat"], want_and, "concat AND")

    # reduce-scatter: the set op runs query-sharded (Q/D per partition) and
    # must agree bit for bit with the replicated psum form
    rs_and = pm.make_sharded_boolean_scatter(snap, L, "and")
    outr, ocr, needr = rs_and(bq_t, kv)
    _check(_same(ocr, oc), "reduce-scatter AND must agree with the "
           "replicated form")
    _check(_same(outr, out), "reduce-scatter AND rows differ")
    _check(_same(needr, need), "reduce-scatter AND need differs")
    res["and scatter"] = _rows(outr, ocr)

    boolor = pm.make_sharded_boolean(snap, L, "or")
    out2, oc2, need2 = boolor(bq_t, kv)
    _check(_same(need2, need), "OR need differs from AND's")
    res["or"] = _rows(out2, oc2)
    _rows_equal(res["or"], [_or([posting[t] for t in p]) for p in pairs],
                "sharded OR")

    # sharded prefix search + globally sorted range read over the mesh
    # "0" spans every partition (n < 10), the second prefix one of them
    prefixes = [all_terms[0][:1], all_terms[-1][:6], b"\xff-none"]
    pf = pm.sharded_prefix_search(snap, prefixes, L=L)
    want_pf = {p: _or([v for t, v in posting.items() if t.startswith(p)])
               for p in prefixes[:2]}
    _check(sorted(pf) == sorted(want_pf), "sharded prefix search: prefixes "
           "found")
    res["prefix"] = [pf[p] for p in prefixes[:2]]
    _rows_equal(res["prefix"], [want_pf[p] for p in prefixes[:2]],
                "sharded prefix search")
    stream = list(pm.sharded_read_range(snap, all_terms[1], all_terms[-2],
                                        L=L))
    _check([t for t, _ in stream] == all_terms[1:-1],
           "sharded range read: terms or order")
    res["range"] = [v for _, v in stream]
    _rows_equal(res["range"], [posting[t] for t in all_terms[1:-1]],
                "sharded range read")

    # MeshQueryEngine: the serving paths on the mesh: tombstone filter,
    # staged pages, an incremental delta refresh, AND across both tiers
    with tempfile.TemporaryDirectory() as td:
        ii = InvertedIndex(td)
        vocab = [bytes([65 + d * 3, 65]) + f"t{d}{i}".encode()
                 for d in range(8) for i in range(4)]
        docs = {}
        for doc in range(1, 9):
            for t in vocab[doc - 1::3][:4]:
                docs.setdefault(t, set()).add(doc)
            ii.put(vocab[doc - 1::3][:4], doc)
        ii.put_removed(np.asarray([2], dtype=np.uint32))

        def held(terms, op="or", drop=()):
            sets = [docs.get(t, set()) for t in terms]
            s = set.intersection(*sets) if op == "and" else set().union(*sets)
            return np.asarray(sorted(s - set(drop)), dtype=np.uint32)

        eng = MeshQueryEngine(ii, mesh=mesh, L=128)
        _check(eng.refresh(ii) is False, "unchanged index must not refresh")
        rows = eng.lookup(vocab[:4], filter_removed=True)
        res["engine lookup"] = [np.zeros(0, np.uint32) if r is None else r
                                for r in rows]
        _rows_equal(res["engine lookup"],
                    [held([t], drop=(2,)) for t in vocab[:4]],
                    "engine lookup (tombstones filtered)")
        q_or = [[vocab[0], vocab[3]], [vocab[1]]]
        res["engine or"] = [eng.boolean(q_or[:1], "or",
                                        filter_removed=True)[0]]
        _rows_equal(res["engine or"], [held(q_or[0], drop=(2,))],
                    "engine OR (tombstones filtered)")
        # staged pages: true counts and the first P values per query
        (pv, pvo, pc), = eng.boolean_staged([q_or], "or", columnar=True,
                                            prefix_p=2)
        full = [held(q) for q in q_or]
        _check([int(c) for c in pc] == [len(w) for w in full], "page counts")
        res["engine pages"] = [pv[pvo[i]:pvo[i + 1]] for i in range(2)]
        _rows_equal(res["engine pages"], [w[:2] for w in full],
                    "engine OR pages")
        (lv, lo, lc), = eng.lookup_staged(
            [[vocab[0], b"zz-missing"]], columnar=True, prefix_p=2)
        _check([int(c) for c in lc] == [len(held([vocab[0]])), 0],
               "staged lookup counts")
        res["engine lookup_staged"] = [lv[lo[i]:lo[i + 1]] for i in range(2)]
        _rows_equal(res["engine lookup_staged"],
                    [held([vocab[0]])[:2], np.zeros(0, np.uint32)],
                    "staged lookup pages")
        # an additive change makes a delta tier; the AND sees it
        ii.put([vocab[0], b"zz-new"], 99)
        for t in (vocab[0], b"zz-new"):
            docs.setdefault(t, set()).add(99)
        _check(eng.refresh(ii) is True and eng.delta is not None,
               "additive put must refresh into a delta tier")
        got = eng.boolean([[vocab[0], b"zz-new"], [vocab[0], vocab[3]]],
                          "and")
        res["engine dual and"] = [np.zeros(0, np.uint32) if r is None else r
                                  for r in got]
        _rows_equal(res["engine dual and"],
                    [held([vocab[0], b"zz-new"], "and"),
                     held([vocab[0], vocab[3]], "and")],
                    "AND across both tiers")
    return {k: [np.asarray(v, dtype=np.uint32) for v in rows]
            for k, rows in res.items()}


def same_results(a: dict, b: dict) -> bool:
    """Two dryrun_multichip results equal, name by name and row by row."""
    return a.keys() == b.keys() and all(
        len(a[k]) == len(b[k])
        and all(np.array_equal(x, y) for x, y in zip(a[k], b[k]))
        for k in a)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run entry()'s step once and dryrun_multichip(n).")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n", type=int, default=8,
                    help="partitions of the dry run")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("entry: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    fn, example_args = entry(args.device)
    out, oc, need = fn(*example_args)
    print("entry ok:", tuple(out.shape), tuple(oc.shape))
    dryrun_multichip(args.n, args.device)
    print("dryrun ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
