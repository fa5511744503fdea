"""Quickstart of the PyTorch/CUDA port: the full capability surface in one
script (the twin of examples/quickstart.py).

Run: python examples/quickstart_torch.py [--device cpu]   (the card by default)
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import inverted_index_2_tpu_torch as tpt
from inverted_index_2_tpu_torch import QueryEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = ap.parse_args(argv).device

    base = tempfile.mkdtemp(prefix="tpi_quickstart_")
    ii = tpt.InvertedIndex(base, enable_logging=False)

    # --- ingest: one document = terms sharing one uint32 value -------------
    ii.put([b"apple", b"banana", b"cherry"], 1)
    ii.put([b"apple", b"banana"], 2)
    ii.put([b"banana", b"date"], 3)

    # batch ingestion (vectorized router; np bytes + offsets)
    terms = [f"bulk{i:04d}".encode() for i in range(1000)]
    blob = np.frombuffer(b"".join(terms), dtype=np.uint8)
    offsets = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum([len(t) for t in terms], out=offsets[1:])
    ii.put_packed(blob, offsets, 4)

    # batched multi-document ingest: ONE segment per touched shard per call
    ii.put_many([([b"apple", b"elderberry"], 5), ([b"fig", b"banana"], 6)])

    # --- streaming reads ---------------------------------------------------
    print("range [apple..cherry]:")
    for tv in tpt.to_slice(ii.read(b"apple", b"cherry")):
        print("  ", tv.term, tv.values.tolist())

    print("prefix search:", {k: v.tolist() for k, v in
                             ii.prefix_search([b"ba", b"bulk000"]).items()})

    # --- delete + compaction -----------------------------------------------
    ii.put_removed([1])
    while ii.merge(2, 100, concurrency=4) > 0:
        pass
    print("after purge:", {tv.term: tv.values.tolist() for tv in
                           tpt.to_slice(ii.read(b"apple", b"banana"))})
    print("stats:", ii.stats())

    # --- frozen snapshot: batched serving on the card ----------------------
    # With the compact host tables retained (from_index's default) the
    # engine routes each op: full-result OR and staged lookups serve from
    # the tables on the host, AND and pages on the card (K1-K4).
    # TPI_HOST_BOOL / TPI_LINK_MBPS override; results are bit-identical
    # either way.
    eng = QueryEngine.from_index(ii, L=128, device=device)
    print("batched lookup:", [None if g is None else g.tolist()
                              for g in eng.lookup([b"banana", b"nope"])])
    print("AND:", [g.tolist() for g in
                   eng.boolean([[b"apple", b"banana"]], op="and")])
    print("OR: ", [g.tolist() for g in
                   eng.boolean([[b"cherry", b"date"]], op="or")])
    print("serving stats:", {k: eng.stats()[k] for k in
                             ("host_serving", "tables_bytes", "device_bytes")})

    # pipelined stream serving: batch i+1 dispatches before batch i
    # downloads; columnar=True returns (values, voffs) per batch
    stream = [[[b"apple", b"banana"]], [[b"banana", b"fig"]]]
    for vals, voffs in eng.boolean_staged(stream, op="and", columnar=True):
        print("staged batch:", [vals[voffs[i]:voffs[i + 1]].tolist()
                                for i in range(len(voffs) - 1)])
    # pagination for large-result ops: true counts + the first prefix_p
    # values per query in one bounded fetch per batch; lookup_staged
    # streams single-term lookups the same way
    (pv, pvo, pc), = eng.boolean_staged(
        [[[b"banana"], [b"apple", b"banana"]]], op="or", columnar=True,
        prefix_p=2,
    )
    print("paginated OR (first 2):",
          [pv[pvo[i]:pvo[i + 1]].tolist() for i in range(len(pc))],
          "true counts:", pc.tolist())
    print("stream lookup:",
          [r.tolist() for r in eng.lookup_staged([[b"banana", b"nope"]])[0]])
    print("engine prefix:", {k: v.tolist() for k, v in
                             eng.prefix_search([b"ba"]).items()})
    print("engine range read:", [(t, v.tolist()) for t, v in
                                 eng.read_range(b"apple", b"banana")])

    # --- reopen (the index IS its files) -----------------------------------
    ii2 = tpt.InvertedIndex(base)
    now = {tv.term: tv.values.tolist()
           for tv in tpt.to_slice(ii2.read(None, None))}
    if now != {tv.term: tv.values.tolist()
               for tv in tpt.to_slice(ii.read(None, None))}:
        raise RuntimeError("the reopened index differs")
    print("reopen: state identical")
    return 0


if __name__ == "__main__":
    sys.exit(main())
