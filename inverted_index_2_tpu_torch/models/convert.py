"""State carried across from the JAX package.

`snapshot_from_jax_arrays` turns the fields of an inverted_index_2_tpu
IndexSnapshot into the port's IndexSnapshot, so both packages can serve the
same arena. Each field is read through `np.asarray`, which accepts numpy
arrays and JAX arrays alike without this module importing `jax`.
"""
from __future__ import annotations

import numpy as np

from ..utils.u32 import to_device
from .snapshot import IndexSnapshot


def snapshot_from_jax_arrays(snap, *, device) -> IndexSnapshot:
    """JAX IndexSnapshot (or any object with its fields) -> the port's
    IndexSnapshot on `device`. The arena is taken as it is, trailing slack
    rows included; the port's kernels never read them."""
    slots = getattr(snap, "hash_slots", None)
    counts = np.asarray(snap.counts, dtype=np.int32)
    host_counts = getattr(snap, "host_counts", None)
    return IndexSnapshot(
        keys=to_device(np.asarray(snap.keys, dtype=np.uint32), device),
        blocks=to_device(np.asarray(snap.blocks, dtype=np.uint32), device),
        term_block_start=to_device(
            np.asarray(snap.term_block_start, dtype=np.int32), device),
        counts=to_device(counts, device),
        removed=to_device(np.asarray(snap.removed, dtype=np.uint32), device),
        width=int(snap.width),
        hash_slots=(None if slots is None else
                    to_device(np.asarray(slots, dtype=np.int32), device)),
        max_probes=int(snap.max_probes),
        max_count=int(snap.max_count),
        host_counts=(counts if host_counts is None
                     else np.asarray(host_counts, dtype=np.int32)),
    )
