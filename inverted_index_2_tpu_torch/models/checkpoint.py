"""Serving-snapshot checkpoints (counterpart of models/checkpoint.py):
persist the compact host tables of a QueryEngine build, so that a serving
restart skips the segment scan, the k-way merge, the posting re-encode and
the hash-table build of QueryEngine.from_index, and pays one file read and
the upload to the card.

The format is the JAX package's, byte for byte: one numpy.savez archive of
a version-tagged JSON meta entry and the HostTables arrays in _ARRAYS order,
written to `<path>.tmp` and published with one atomic os.replace. Either
package loads a checkpoint the other wrote.

Staleness is handled by fingerprint: the checkpoint embeds the
_index_fingerprint of the state it froze, and QueryEngine.from_checkpoint(
path, index=...) reconciles it through refresh(): an unchanged index is a
no-op, additive drift a delta tier, anything else a rebuild. A stale
checkpoint is never wrong, only less warm.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from .snapshot import HostTables, _index_fingerprint, snapshot_tables

MAGIC = "tpi-snapshot-checkpoint"
VERSION = 1

# array fields of HostTables, in archive order
_ARRAYS = ("keys", "words", "flat", "tbs", "counts", "removed", "slots")


def _fingerprint_to_json(fp) -> list:
    """(apply_removed, ((shard_key, (seg_key, ...), rl_len), ...)) -> JSON.
    Shard and segment keys are strings, so the form is JSON's own."""
    apply_removed, parts = fp
    return [bool(apply_removed),
            [[k, list(segs), int(rl)] for k, segs, rl in parts]]


def _fingerprint_from_json(obj) -> tuple:
    apply_removed, parts = obj
    return (bool(apply_removed),
            tuple((k, tuple(segs), int(rl)) for k, segs, rl in parts))


def save_checkpoint(index, path: str, apply_removed: bool = False,
                    width: Optional[int] = None) -> dict:
    """Freeze `index` into compact host tables and publish them at `path`.
    Returns the meta dict written. The index stays live: its segments are
    pinned only for the freeze."""
    fp = _index_fingerprint(index, apply_removed)
    t = snapshot_tables(index, apply_removed=apply_removed, width=width)
    return save_tables(t, path, fingerprint=fp, apply_removed=apply_removed)


def save_tables(t: HostTables, path: str, fingerprint=None,
                apply_removed: bool = False) -> dict:
    """Persist built HostTables (the low-level half of save_checkpoint)."""
    meta = {
        "magic": MAGIC,
        "version": VERSION,
        "width": int(t.width),
        "max_probes": int(t.max_probes),
        "max_count": int(t.max_count),
        "max_bw": int(t.max_bw),
        "apply_removed": bool(apply_removed),
        "n_terms": t.n_terms,
        "fingerprint": (None if fingerprint is None
                        else _fingerprint_to_json(fingerprint)),
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, meta=np.frombuffer(json.dumps(meta).encode("utf-8"),
                                       dtype=np.uint8),
                 **{name: getattr(t, name) for name in _ARRAYS})
        f.flush()
        if os.environ.get("TPI_FSYNC"):
            os.fsync(f.fileno())
    os.replace(tmp, path)
    return meta


def load_checkpoint(path: str) -> Tuple[HostTables, dict]:
    """Read a checkpoint back as (HostTables, meta). Raises ValueError on a
    foreign or differently versioned file."""
    with np.load(path) as z:
        try:
            meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        except Exception as e:  # no meta entry, or not JSON
            raise ValueError(f"not a tpi checkpoint: {path}") from e
        if meta.get("magic") != MAGIC:
            raise ValueError(f"not a tpi checkpoint: {path}")
        if meta.get("version") != VERSION:
            raise ValueError(f"checkpoint version {meta.get('version')} != "
                             f"{VERSION}: {path}")
        arrs = {name: z[name] for name in _ARRAYS}
    t = HostTables(**arrs, max_probes=int(meta["max_probes"]),
                   max_count=int(meta["max_count"]),
                   width=int(meta["width"]), max_bw=int(meta["max_bw"]))
    if (t.keys.ndim != 2 or t.keys.shape[1] != t.width + 1
            or len(t.tbs) != t.n_terms + 1):
        raise ValueError(f"checkpoint table shapes inconsistent: {path}")
    return t, meta


def load_fingerprint(meta: dict):
    raw = meta.get("fingerprint")
    return None if raw is None else _fingerprint_from_json(raw)
