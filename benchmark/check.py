"""What decides `correct`: a sample of the window's answers, drawn from the
seed, held against the plain reference (reference.py).

The sample is stratified by the classes the mix's generator names (its
`classes`: the paths its queries take through the program), so every class
is compared, not one easy part. The generator also reads the program's
answer to a row (`answer_of`), works out the reference's (`expected`) and
judges the two (`same`); this file draws and counts.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np


def draw_sample(classes: Dict[str, np.ndarray], per_class: dict,
                seed: int) -> List[Tuple[str, int]]:
    """(class, row) pairs: up to per_class[class] rows of each class,
    drawn from the seed."""
    rng = np.random.default_rng([int(seed), 2])
    picks = []
    for name, cand in classes.items():
        cap = int(per_class.get(name, 0))
        if len(cand) and cap:
            got = rng.choice(cand, size=min(cap, len(cand)), replace=False)
            picks += [(name, int(r)) for r in np.sort(got)]
    return picks


def compare(picks, answer: Callable, expected: Callable,
            same: Callable) -> dict:
    """Hold each picked row's answer, answer(row) (None when none came),
    against expected(row) by same(got, want). Returns the count compared,
    the count by class, and the rows that were wrong or unanswered."""
    wrong, missing = [], []
    by_class: Dict[str, int] = {}
    for name, row in picks:
        by_class[name] = by_class.get(name, 0) + 1
        got = answer(row)
        if got is None:
            missing.append(row)
        elif not same(got, expected(row)):
            wrong.append(row)
    return {"compared": len(picks), "by_class": by_class, "wrong": wrong,
            "missing": missing}
