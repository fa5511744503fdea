"""The bytes a window's work must move at the least, whatever implements it:
the numerator of `kernels_roofline_pct`.

Each distinct query of the window counts once (a server that answered a
repeat from a cache would still have done this much). An AND must read
every id of its shortest list, so it counts that list's codec bytes
(codec_bytes.py); an OR page must read every list to give the true count,
so it counts all of them. Every query adds 4 bytes for each id it writes.
"""
from __future__ import annotations

import numpy as np

PEAK_BYTES_PER_S = 3.35e12   # NVIDIA H100 SXM, HBM3 (data sheet)


def least_bytes(stream, corpus, rows: np.ndarray,
                out_ids: np.ndarray) -> int:
    """Bytes for window rows `rows` (repeats allowed), which wrote
    `out_ids` ids each."""
    rows = np.asarray(rows, np.int64)
    _, first = np.unique(stream.qid[rows], return_index=True)
    rows, out_ids = rows[first], np.asarray(out_ids, np.int64)[first]
    pos = stream.qpos[rows]
    have = pos >= 0
    enc = np.where(have, corpus.enc_bytes[np.maximum(pos, 0)], 0)
    if stream.op == "and":
        df = corpus.df[np.maximum(pos, 0)]
        # the shortest list; of equal lengths, the fewest bytes
        key = np.where(have, df * (1 << 32) + enc, np.iinfo(np.int64).max)
        read = enc[np.arange(len(rows)), np.argmin(key, axis=1)]
    else:
        read = enc.sum(axis=1)
    return int(read.sum() + 4 * out_ids.sum())
