"""The correctness check: every request compared (all of the window's,
or a sample drawn from the seed with the largest among them) against the
plain reference's stdout for the same tree, patterns and mode, and
every request's exit code against 0. Exact: each count's limit is 0."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from scanbench import mix as mixmod
from scanbench import reference
from scanbench.record import Done

LIMITS = {"stdout_mismatches": 0, "rc_nonzero": 0}


def chosen(requests: Sequence[mixmod.Request], sample: int, seed: int) -> List[mixmod.Request]:
    """The distinct requests to compare: all, or ``sample`` of them drawn
    from ``seed`` with the one over the most bytes always among them."""
    distinct = list(dict.fromkeys(requests))
    if sample <= 0 or len(distinct) <= sample:
        return distinct
    largest = max(range(len(distinct)), key=lambda i: distinct[i].nbytes)
    rest = [i for i in range(len(distinct)) if i != largest]
    pick = np.random.default_rng([seed, 11]).choice(len(rest), size=sample - 1, replace=False)
    return [distinct[largest]] + [distinct[rest[int(i)]] for i in sorted(pick)]


def expected(reqs: Sequence[mixmod.Request], workers: int, control: bool = False) -> Dict[tuple, bytes]:
    """The reference's stdout of each request (``control``: the control's)."""
    jobs = []
    for r in reqs:
        pats, literal = mixmod.patterns_of(r)
        jobs.append((r.target, pats, literal))
    outs = reference.tree_outputs(jobs, workers=workers, control=control)
    return {r.argv: o for r, o in zip(reqs, outs)}


def compare(done: Sequence[Tuple[mixmod.Request, Done]], want: Dict[tuple, bytes]) -> Tuple[Dict[str, int], int]:
    """(counts by check name, requests compared)."""
    mism = compared = 0
    for req, d in done:
        if req.argv in want:
            compared += 1
            mism += d.stdout != want[req.argv]
    rc_bad = sum(1 for _, d in done if d.rc != 0)
    return {"stdout_mismatches": mism, "rc_nonzero": rc_bad}, compared


def passed(counts: Dict[str, int], compared: int) -> bool:
    return compared > 0 and all(counts[k] <= LIMITS[k] for k in LIMITS)


def default_workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))
