"""inverted_index_2_tpu_torch — the PyTorch/CUDA port of the device half of
inverted_index_2_tpu.

The host half (the LSM index on disk: InvertedIndex, shards, segments,
codecs, iterators, tombstones) does not touch an accelerator and is imported
from `inverted_index_2_tpu` unchanged. This package ports the device half:
frozen snapshots as torch tensors on an explicit device, batched exact
lookup, and batched AND serving, with the posting-block decode (K1) and the
fused decode+AND (K2) as CUDA C++ kernels for Hopper (`csrc/`).

Module names follow the JAX package's, so each counterpart is easy to find.
Nothing here imports `jax`.

Public surface:
    QueryEngine.from_index(index, L, device=...)
    QueryEngine(snapshot, L, tables=..., device=...)
        .lookup(terms, filter_removed)
        .boolean(queries, "and", filter_removed)
        .boolean_staged(batches, "and", columnar=...)
    build_host_tables, snapshot_tables, upload_tables, IndexSnapshot,
    HostTables (models/snapshot.py)
"""

from inverted_index_2_tpu import InvertedIndex

from .models.query_engine import QueryEngine
from .models.snapshot import (
    HostTables,
    IndexSnapshot,
    build_host_tables,
    snapshot_tables,
    upload_tables,
)

__all__ = [
    "InvertedIndex",
    "QueryEngine",
    "HostTables",
    "IndexSnapshot",
    "build_host_tables",
    "snapshot_tables",
    "upload_tables",
]
