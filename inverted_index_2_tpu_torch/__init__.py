"""inverted_index_2_tpu_torch — the PyTorch/CUDA port of inverted_index_2_tpu.

The host half (the LSM index on disk: InvertedIndex, shards, segments,
codecs, iterators, tombstones) does not touch an accelerator. The port keeps
its own copy of it (inverted_index.py, shard.py, iterators.py,
removed_list.py, evictable_pool.py, segment/, codec/, utils/ragged.py) with
the same on-disk formats, so each package opens a directory the other
wrote. A merge of TPI_DEVICE_MERGE_MIN postings or more runs its sort and
purge on the card (ops/merge.py), smaller ones on the host. The shared C++
codec loads from the repository's top-level native/ directory.

The device half serves frozen snapshots as torch tensors: batched exact
lookup, AND, OR, pagination, staged lookup, range reads and prefix search,
with the posting-block decode (K1), the fused decode+AND (K2), the sorted-set
AND of the delta window (K3) and the row sort (K4) as CUDA C++ kernels for
Hopper (`csrc/`). refresh() keeps an engine current while the index takes
writes (a delta tier beside the main one). With the compact host tables
retained, a host route serves the same results with no device at all, and a
router picks between the two per op; checkpoints of those tables give a
warm start that serves on the host while the arena uploads.
MeshQueryEngine serves the same over partitions of the index on several
devices (or several partitions of one card), one process driving them all.

Module names follow the JAX package's, so each counterpart is easy to find.
Nothing here imports `jax` or `inverted_index_2_tpu`.

Public surface:
    InvertedIndex(basedir) .put/.read/.prefix_search/.put_removed/.merge
    QueryEngine.from_index(index, L, device="cuda")
    QueryEngine.from_checkpoint(path, index=None, L, device="cuda")
    QueryEngine(snapshot, L, tables=..., device="cuda")
        .lookup(terms, filter_removed)
        .lookup_staged(batches, columnar=..., prefix_p=...)
        .boolean(queries, "and" | "or", filter_removed)
        .boolean_staged(batches, "and" | "or", columnar=..., prefix_p=...)
        .lookup_host / .boolean_host (the host route)
        .read_range(min_term, max_term), .prefix_search(prefixes)
        .refresh(index), .warmup(), .stats(), .lookup_device(qkeys)
        .save_checkpoint(index, path), .device_ready(), .device_wait()
    MeshQueryEngine(index, mesh=None, L) (parallel/: partitions on a list
        of devices, parallel/mesh.default_mesh; the CPU tests pass
        ["cpu"] * D) .from_checkpoint(path, index=None, mesh, L)
        .lookup / .boolean / .lookup_staged / .boolean_staged
        .prefix_search / .read_range / .refresh / .warmup / .stats
    build_host_tables, snapshot_tables, snapshot_index, upload_tables,
    build_snapshot_arrays, IndexSnapshot, HostTables (models/snapshot.py)
    save_checkpoint, save_tables, load_checkpoint (models/checkpoint.py)
    Bitmask (codec/bitmask.py)
"""

from .evictable_pool import Pool
from .inverted_index import InvertedIndex
from .iterators import (
    ClosingIterator,
    MergingIterator,
    SequentialDynamicIterator,
    TermValues,
    compare_term_values,
    merge_term_values,
    to_slice,
)
from .codec.bitmask import Bitmask
from .models.checkpoint import load_checkpoint, save_checkpoint, save_tables
from .models.query_engine import QueryEngine
from .parallel import MeshQueryEngine
from .models.snapshot import (
    HostTables,
    IndexSnapshot,
    build_host_tables,
    build_snapshot_arrays,
    snapshot_index,
    snapshot_tables,
    upload_tables,
)
from .removed_list import RemovedLists, unserialize_removed_list
from .shard import Shard, shard_key

__all__ = [
    "InvertedIndex",
    "Shard",
    "shard_key",
    "TermValues",
    "merge_term_values",
    "compare_term_values",
    "MergingIterator",
    "SequentialDynamicIterator",
    "ClosingIterator",
    "to_slice",
    "RemovedLists",
    "unserialize_removed_list",
    "Pool",
    "QueryEngine",
    "MeshQueryEngine",
    "HostTables",
    "IndexSnapshot",
    "build_host_tables",
    "snapshot_tables",
    "snapshot_index",
    "upload_tables",
    "build_snapshot_arrays",
    "save_checkpoint",
    "save_tables",
    "load_checkpoint",
    "Bitmask",
]
