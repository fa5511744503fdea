"""Ragged-array gather helpers (host numpy).

Variable-length posting lists / term byte-strings are handled as
(values, offsets) pairs; these helpers flatten ragged gathers into single
vectorized index operations — the host-side mirror of how the device code
handles raggedness with padded buckets.
"""
from __future__ import annotations

import numpy as np


def ragged_indices(starts: np.ndarray, counts: np.ndarray):
    """Flat gather indices for slices [starts[i], starts[i]+counts[i]).

    Returns (idx, rep) where idx are source indices, rep[i] = which slice each
    flat element belongs to.
    """
    starts = np.asarray(starts, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    rep = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    excl = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=excl[1:])
    intra = np.arange(total, dtype=np.int64) - excl[rep]
    return starts[rep] + intra, rep


def ragged_gather(src: np.ndarray, starts: np.ndarray, counts: np.ndarray):
    """Gather ragged slices from src; returns (flat, rep)."""
    idx, rep = ragged_indices(starts, counts)
    return src[idx], rep
