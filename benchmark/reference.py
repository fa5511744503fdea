"""The plain reference: boolean queries over the generated posting lists, in
numpy alone. It imports nothing of the program under test and takes nothing
the program made: only the lists the corpus generator produced.

`truncate` gives the control: every list cut to its first `truncate` ids
before the set operation, the step that would tempt an implementation (serve
each list at its fast-path pad and skip the exact re-serve of longer ones).
It breaks the configuration's guarantee of exact results.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def intersect(lists: Sequence[np.ndarray]) -> np.ndarray:
    """The ids in every list (each ascending, distinct)."""
    lists = sorted(lists, key=len)
    cur = lists[0]
    for other in lists[1:]:
        if len(cur) == 0:
            break
        if len(other) == 0:
            return other[:0]
        at = np.minimum(np.searchsorted(other, cur), len(other) - 1)
        cur = cur[other[at] == cur]
    return np.asarray(cur, np.uint32)


def union_page(lists: Sequence[np.ndarray], p: int,
               seen: np.ndarray) -> Tuple[np.ndarray, int]:
    """(the first p ids of the union, the union's size). `seen` is a zeroed
    bool scratch of one entry per document, left zeroed."""
    heads = np.unique(np.concatenate([l[:p] for l in lists]))[:p]
    for l in lists:
        seen[l] = True
    count = int(np.count_nonzero(seen))
    for l in lists:
        seen[l] = False
    return heads.astype(np.uint32), count


class Reference:
    """Answers over one corpus's lists (values, voffs) of documents [0, D)."""

    def __init__(self, values: np.ndarray, voffs: np.ndarray, D: int,
                 truncate: Optional[int] = None):
        self.values = values
        self.voffs = voffs
        self.truncate = truncate
        self._seen = np.zeros(D, bool)

    def lst(self, p: int) -> np.ndarray:
        a, b = int(self.voffs[p]), int(self.voffs[p + 1])
        if self.truncate is not None:
            b = min(b, a + self.truncate)
        return self.values[a:b]

    def and_(self, positions) -> np.ndarray:
        return intersect([self.lst(int(p)) for p in positions])

    def page(self, positions, p: int) -> Tuple[np.ndarray, int]:
        return union_page([self.lst(int(q)) for q in positions], p,
                          self._seen)
