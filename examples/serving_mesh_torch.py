"""Serving lifecycle of the PyTorch/CUDA port: live index -> device snapshot
-> partitioned fan-out (the twin of examples/serving_mesh.py).

Eight partitions of the index, on the card by default: with one card they
share it, with several partition d lives on card d mod count. Shows:

  1. ingest + compaction on the live (host) index
  2. QueryEngine serving with O(delta) incremental refresh
  3. the partitioned snapshot: fan-out lookup, concat-decode boolean,
     sharded prefix search, globally sorted range read, skew stats

Usage: python examples/serving_mesh_torch.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import inverted_index_2_tpu_torch as tpt
from inverted_index_2_tpu_torch import (
    InvertedIndex,
    MeshQueryEngine,
    QueryEngine,
    save_checkpoint,
)
from inverted_index_2_tpu_torch.codec import keys as K
from inverted_index_2_tpu_torch.parallel import mesh as pm
from inverted_index_2_tpu_torch.utils.u32 import to_device, to_numpy_u32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = ap.parse_args(argv).device

    ii = InvertedIndex(tempfile.mkdtemp(prefix="mesh_demo_"))
    rng = np.random.default_rng(0)
    vocab = [f"{chr(97 + i % 26)}{chr(97 + (i // 26) % 26)}-term{i:04d}".encode()
             for i in range(400)]
    for doc in range(1, 301):
        terms = [vocab[i] for i in rng.choice(len(vocab), size=5,
                                              replace=False)]
        ii.put(terms, doc)
    while ii.merge(2, 100, 4) > 0:
        pass

    # --- single-device serving with incremental refresh ------------------
    eng = QueryEngine.from_index(ii, L=128, device=device)
    print("stats:", eng.stats())
    # two terms that share doc 1 -> a non-empty intersection
    doc1 = [tv.term for tv in tpt.to_slice(ii.read(None, None))
            if 1 in tv.values][:2]
    print("AND", doc1, "->", eng.boolean([doc1], op="and")[0].tolist())
    ii.put([vocab[0], b"zz-breaking-news"], 999)   # fresh write
    eng.refresh(ii)                                # O(delta): delta tier only
    if eng.delta is None:
        raise RuntimeError("an additive put must refresh into a delta tier")
    print("fresh term:", eng.lookup([b"zz-breaking-news"])[0].tolist())

    # --- partitioned fan-out ---------------------------------------------
    mesh = pm.default_mesh(8, device)
    snap = pm.build_sharded_snapshot(ii, mesh)
    # lowercase-ASCII prefixes concentrate in a narrow band of the 10-bit
    # shard-key space; balanced_ranges cuts contiguous ranges at about
    # equal block volume so real corpora still spread over every partition
    print("partition skew:", pm.partition_stats(snap))

    lookup = pm.make_sharded_lookup(snap, L=128)
    qk = K.pack_terms([vocab[3], vocab[7]], width=snap.width)
    found, vals, n, raw = lookup(to_device(qk, mesh[0]))
    print("mesh lookup found:", found.cpu().numpy().tolist())

    booland = pm.make_sharded_boolean_concat(snap, SB=4, op="and")
    bq = np.zeros((8, 2, snap.width + 1), dtype=np.uint32)
    bq[0] = K.pack_terms(doc1, width=snap.width)
    kv = np.zeros(8, dtype=np.int32)
    kv[0] = 2
    out, oc = booland(to_device(bq, mesh[0]), to_device(kv, mesh[0]))
    print("mesh AND:", to_numpy_u32(out[0, : int(oc[0])]).tolist())

    pf = pm.sharded_prefix_search(snap, [vocab[0][:3]], L=128)
    print("mesh prefix:", {k: v[:5].tolist() for k, v in pf.items()})

    # --- MeshQueryEngine: the single-device engine's serving on the
    # partitions (tombstone filters, fingerprint refresh with an O(delta)
    # tier, ladder re-serves; the same results as QueryEngine)
    meng = MeshQueryEngine(ii, mesh=mesh, L=128)
    meng.warmup(k_max=3)
    print("mesh engine stats:", meng.stats())
    ii.put_removed([2])
    ii.put([vocab[1], b"zz-more-news"], 1000)
    if not meng.refresh(ii):  # additive + tombstone change -> delta tier
        raise RuntimeError("the mesh engine missed a change")
    print("mesh AND (filtered):",
          meng.boolean([doc1], "and", filter_removed=True)[0].tolist())
    print("mesh fresh term:", meng.lookup([b"zz-more-news"])[0].tolist())

    stream = pm.sharded_read_range(snap, vocab[0], vocab[2], L=128)
    print("mesh range read:", [(t, v.tolist()[:3]) for t, v in stream][:3])

    # --- pipelined mesh stream serving -----------------------------------
    # boolean_staged / lookup_staged mirror the single-device contracts:
    # the pagination form returns TRUE counts + the first prefix_p values
    # per query in one bounded fetch per batch
    (sv, so, sc), = meng.boolean_staged(
        [[doc1, [vocab[1], b"zz-more-news"]]], "or",
        columnar=True, prefix_p=2,
    )
    print("mesh staged OR pages:",
          [(int(sc[i]), sv[so[i]:so[i + 1]].tolist()) for i in range(2)])
    print("mesh staged lookup:",
          [r.tolist() for r in meng.lookup_staged([[vocab[0], b"nope"]])[0]])

    # --- warm restarts: serving-snapshot checkpoints ---------------------
    # One file warm-starts BOTH engines; with checkpoint_path the engine
    # saves it again on every main-tier rebuild, and a stale file
    # reconciles at load.
    ckpt = os.path.join(tempfile.mkdtemp(prefix="mesh_demo_ckpt_"),
                        "serving.ckpt")
    save_checkpoint(ii, ckpt)
    chip = QueryEngine.from_checkpoint(ckpt, index=ii, L=128,
                                       checkpoint_path=ckpt, device=device)
    warm_mesh = MeshQueryEngine.from_checkpoint(ckpt, index=ii, mesh=mesh,
                                                L=128)
    print("warm single-chip:", chip.lookup([b"zz-more-news"])[0].tolist())
    print("warm mesh:", warm_mesh.lookup([b"zz-more-news"])[0].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
