"""bench_torch.py on the CPU at tiny sizes: every phase returns its whole
key set, an oracle check fails on a corrupted result, the environment pins
are restored, main() refuses to run without CUDA (one line, non-zero), and
the sidecar goes under build/, never to the TPU bench's BENCH_DETAILS.json.
The tests call the phases with device="cpu"; a card run's numbers come
only from the card."""
import hashlib
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_torch as B

torch.set_num_threads(1)

ROOT = Path(B.__file__).resolve().parent

_API = {"and_qps", "and_dev_qps", "and_dev_bulk_qps", "staged_and_qps",
        "staged_and_dev_qps", "staged_and_dev_zipf_qps",
        "staged_and_dev_zipf_nodedup_qps", "staged_or_qps",
        "staged_or_prefix_qps", "staged_or_zipf_qps",
        "staged_or_zipf_nodedup_qps", "staged_or_zipf_wire_qps",
        "staged_lookup_qps"}

KEYS = {
    "ingest": {"ingest_terms_per_s", "ingest_s", "ingest_routed_terms_per_s",
               "ingest_doc_puts_per_s", "ingest_put_many_docs_per_s"},
    "compaction": {"compaction_segments", "compaction_s",
                   "compaction_postings_per_s", "compaction_merge"},
    "compression": {"compressed_bytes", "raw_bytes", "ratio"},
    "query": {"snapshot_build_s", "lookup_qps", "lookup_dispatch_ms",
              "and_qps", "prefix_range_qps", "and8_qps", "or_qps",
              "intersect_gbps", "n_terms", "n_postings"},
    "postlen1k": {"postlen1k_n_terms", "postlen1k_build_s",
                  "postlen1k_snapshot_mb", "and_qps_postlen1k",
                  "and_qps_postlen1k_fused", "postlen1k_reserve_frac",
                  "and_qps_postlen1k_sort", "postlen1k_reserve_frac_sort",
                  "or_qps_postlen1k_padded", "fused_overhead_us_per_q",
                  "or_qps_postlen1k", "or_qps_postlen1k_devcompact",
                  "or_postlen1k_covered_frac", "intersect_gbps_postlen1k"},
    "api_postlen1k": {"api_postlen1k_" + k for k in _API},
    "host_contended": {"host_idle_and_qps", "host_idle_or_qps",
                       "host_contended_and_qps", "host_contended_or_qps",
                       "host_contended_merges", "host_contended_merge"},
    "checkpoint": {"checkpoint_mb", "checkpoint_save_s", "checkpoint_load_s",
                   "checkpoint_upload_s", "checkpoint_warm_start_s",
                   "checkpoint_first_query_s", "checkpoint_device_swap_s",
                   "checkpoint_cold_build_s", "checkpoint_host_tables_s"},
    "mesh": {"mesh_devices", "mesh_freeze_s", "mesh_words_mb",
             "mesh_arena_mb", "mesh_lookup_qps", "mesh_lookup_rs_qps",
             "plain_lookup_same_shape_qps", "mesh_overhead_x",
             "mesh_and_rs_qps"},
    "api": {"api_" + k for k in _API},
    "scale": {"scale_terms", "scale_postings_m", "scale_tables_build_s",
              "scale_upload_s", "scale_hbm_gb", "scale_staged_and_dev_qps",
              "scale_staged_or_prefix_dev_qps",
              "scale_staged_lookup_dev_qps", "scale_lookup_postings_per_q",
              "scale_staged_lookup_host_qps", "scale_staged_and_host_qps"},
}


@pytest.fixture(scope="module")
def corpus():
    return B.gen_corpus(2000, 10, seed=0)


@pytest.fixture(scope="module")
def corpus1k():
    """The config-3 phases' corpus at a tiny size: every query of 2-8 terms
    falls in the first OR class, so the class pass covers the stream."""
    c = B.gen_corpus(200, 100, seed=11)
    snap, build_s, tables = B.build_snapshot(c, "cpu")
    return c, snap, build_s, tables


def _run(phase, corpus, corpus1k, spreads):
    kw = dict(device="cpu", spreads=spreads)
    c1k, snap1k, build1k, tables1k = corpus1k
    if phase == "ingest":
        return B.bench_ingest(2000, 1000, n_routed=1000, n_docs=20, **kw)
    if phase == "compaction":
        return B.bench_compaction(terms_per_seg=200, **kw)
    if phase == "compression":
        return B.bench_compression(corpus[2], corpus[3], device="cpu")
    if phase == "query":
        return B.bench_query(corpus, 64, 2, **kw)
    if phase == "postlen1k":
        return B.bench_postlen1k(c1k, snap1k, build1k, 64, 2, **kw)
    if phase == "api_postlen1k":
        return B.bench_api(c1k, Q=16, iters=2, L=2048, name="api_postlen1k",
                           snap=snap1k, tables=tables1k, stream_q=32,
                           stream_nb=2, pool=32, **kw)
    if phase == "host_contended":
        return B.bench_host_contended(c1k, snap1k, tables1k, Q=32, nb=2, **kw)
    if phase == "checkpoint":
        return B.bench_checkpoint(corpus, device="cpu")
    if phase == "mesh":
        return B.bench_mesh(corpus, Q=64, iters=2, **kw)
    if phase == "api":
        return B.bench_api(corpus, Q=32, iters=2, stream_q=64, stream_nb=2,
                           pool=32, **kw)
    assert phase == "scale"
    return B.bench_scale(3000, Q=32, nb=2, **kw)


@pytest.mark.parametrize("phase", B.PHASES)
def test_phase_returns_its_keys(phase, corpus, corpus1k, monkeypatch,
                                tmp_path):
    monkeypatch.setenv("BENCH_DIR", str(tmp_path))
    spreads = {}
    out = _run(phase, corpus, corpus1k, spreads)
    assert set(out) == KEYS[phase]
    for k, v in out.items():
        if k.endswith(("_qps", "_per_s")):
            # a median of at least 5 repetitions, with its spread kept
            lo, med, hi = spreads[k]
            assert 0 < lo <= med == v <= hi, k
    if phase == "compaction":
        assert out["compaction_merge"] == "host"  # under 2M postings
    if phase == "host_contended":
        assert out["host_contended_merge"] == "host"
        assert out["host_contended_merges"] >= 0


@pytest.mark.parametrize("over", [False, True])
def test_merge_branch_names_the_branch_shard_merge_takes(over, monkeypatch,
                                                         tmp_path):
    """_merge_branch(n) against the branch Shard.merge runs on n postings,
    with the threshold at n (device) or just past it (host)."""
    from inverted_index_2_tpu_torch import shard as shard_mod
    from inverted_index_2_tpu_torch.ops import merge as merge_mod

    ran = []
    host, dev = shard_mod.merge_views, merge_mod.merge_views_device
    monkeypatch.setattr(shard_mod, "merge_views",
                        lambda *a, **k: ran.append("host") or host(*a, **k))
    monkeypatch.setattr(merge_mod, "merge_views_device",
                        lambda *a, **k: ran.append("device") or dev(*a, **k))
    monkeypatch.setattr(shard_mod, "MERGE_DEVICE", "cpu")
    sh = B.Shard(str(tmp_path / "0000"))
    n = 0
    for s in range(3):
        terms = [f"t{s}{i:03d}".encode() for i in range(40)]
        sh.put_packed(np.frombuffer(b"".join(terms), np.uint8),
                      np.arange(41, dtype=np.int64) * 5, s + 1)
        n += len(terms)
    monkeypatch.setattr(shard_mod, "DEVICE_MERGE_MIN_VALUES",
                        n if over else n + 1)
    assert sh.merge(2, 3) == 3
    sh.close()
    assert ran == ["device" if over else "host"]
    assert B._merge_branch(n) == ("host or device" if over else "host")


def test_headline_keys_come_from_the_phases():
    every = set().union(*KEYS.values())
    assert set(B.HEADLINE_KEYS) <= every
    assert set(B.FLOOR_KEYS) <= set(B.HEADLINE_KEYS)


def test_a_corrupted_row_fails_the_oracle(corpus):
    oracle = B.Oracle(corpus)
    snap, _, _ = B.build_snapshot(corpus, "cpu")
    idx = np.arange(8)
    qk = B.to_device(B.to_numpy_u32(snap.keys)[idx], "cpu")
    f, v, c, raw = B.lookup_step(snap.keys, snap.blocks,
                                 snap.term_block_start, snap.counts, qk, 128,
                                 snap.hash_slots, snap.max_probes)
    want = lambda j: oracle.lst(idx[j])[:128]  # noqa: E731
    assert B.check_rows("lookup", v, c, None, 128, want, idx) == 8
    bad = v.clone()
    bad[3, 0] += 1
    with pytest.raises(B.BenchError, match="row 3"):
        B.check_rows("lookup", bad, c, None, 128, want, idx)
    short = c.clone()
    short[5] -= 1
    with pytest.raises(B.BenchError, match="row 5"):
        B.check_rows("lookup", v, short, None, 128, want, idx)
    # a staged stream's columnar result
    terms = [oracle.terms[i].tobytes() for i in range(50)]
    batches = [[[terms[0], terms[1]], [terms[2]]] for _ in range(2)]
    res = [(np.concatenate([oracle.or_([0, 1]), oracle.lst(2)]),
            np.array([0, len(oracle.or_([0, 1])),
                      len(oracle.or_([0, 1])) + len(oracle.lst(2))]))] * 2
    B.check_columnar("or", res, batches, oracle, "or", 0)
    vals = res[0][0].copy()
    vals[-1] += 1
    with pytest.raises(B.BenchError, match="differs"):
        B.check_columnar("or", [(vals, res[0][1])] * 2, batches, oracle,
                         "or", 0)


def test_main_without_cuda_exits_nonzero_with_one_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert B.main([]) == 1
    cap = capsys.readouterr()
    assert cap.out == ""
    assert len(cap.err.strip().splitlines()) == 1
    assert "cuda_" not in cap.err


@pytest.mark.parametrize("before", [None, "auto"])
def test_env_pins_are_restored(before, corpus, monkeypatch):
    pins = ("TPI_HOST_BOOL", "TPI_STAGED_DEDUP", "TPI_HOST_DEDUP")
    for k in pins:
        if before is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, before)
    B.bench_api(corpus, Q=16, iters=1, stream_q=16, stream_nb=1, pool=16,
                device="cpu")
    for k in pins:
        assert os.environ.get(k) == before
    with pytest.raises(ZeroDivisionError):
        with B.env(TPI_HOST_BOOL="0"):
            1 / 0
    assert os.environ.get("TPI_HOST_BOOL") == before


def _sha(p: Path):
    return hashlib.sha256(p.read_bytes()).hexdigest() if p.exists() else None


def test_the_sidecar_goes_under_build(monkeypatch, tmp_path, capsys):
    side = Path(B.DETAILS_PATH)
    assert side.parent == ROOT / "build"
    assert side.name != "BENCH_DETAILS.json"
    ref = ROOT / "BENCH_DETAILS.json"
    ref_sha = _sha(ref)
    # main() on a faked card runs the host phase only; the sidecar path is
    # redirected so the test leaves the checkout as it was
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(B, "card_info", lambda: {
        "name": "test card", "smi": "test card, 1.00 W",
        "power_limit_w": 1.0, "count": 1})
    monkeypatch.setattr(B, "_reset_peak", lambda device: None)
    monkeypatch.setattr(B, "_peak", lambda device: 0)
    monkeypatch.setattr(B, "_sync", lambda device: None)
    target = tmp_path / "build" / "bench_torch_details.json"
    monkeypatch.setattr(B, "DETAILS_PATH", str(target))
    assert B.main(["--phases", "compression", "--quick"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["cuda_ratio"] > 1
    assert last["device"] == {"name": "test card", "power_limit_w": 1.0,
                              "count": 1}
    assert all(k.startswith("cuda_") for k in last
               if k not in ("noisy", "device", "details_file"))
    got = json.loads(target.read_text())
    assert got["cuda_compressed_bytes"] > 0
    assert set(got["phase_s"]) == {"gen_corpus", "compression"}
    assert _sha(ref) == ref_sha
