"""The correctness check's control, run apart from the benchmark's runs:
the reference with one guarantee broken (``reference.py``,
``control=True``: a match across a 512-byte block boundary of its file
is not seen) put in the program's place, judged by the same comparison
as a run. It has to come out not correct.

    python3 scanbench/control.py --workload <cell> --seeds 11,12,13 [--requests N]

For each seed it prepares the cell's corpus as a run does (in the
checkout's ``.scanbench_cache/``), takes the first ``N`` requests of
the cell's sequence (about as many as a run sends), and prints one JSON
line of the counts the check compares. It needs no card; run it on the
chip's host at the cell's own size, never beside a run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scanbench import check, harness, mix as mixmod  # noqa: E402
from scanbench.corpus import prepare  # noqa: E402
from scanbench.record import Done  # noqa: E402


def control_counts(workload: str, seed: int, n_requests: int, workers: int, config_overrides=None,
                   cache_dir: str = os.path.join(harness.ROOT, ".scanbench_cache")):
    """(the check's counts for the control, requests compared) for one
    seed."""
    bench = harness.load_bench()
    cell = harness.cell_of(bench, workload)
    cfg = dict(harness.config_of(bench, cell["config"]), **(config_overrides or {}))
    mix = mixmod.load(cell["traffic"])
    corpus = prepare(cfg, seed, cache_dir)
    seq = mixmod.sequence(mix, corpus, seed)
    reqs = [seq[i % len(seq)] for i in range(n_requests)]
    chosen = check.chosen(reqs, int(mix.get("check_sample", 0)), seed)
    want = check.expected(chosen, workers)
    ctl = check.expected(chosen, workers, control=True)
    as_run = [(r, Done(r.argv, r.nbytes, 0.0, 0, ctl.get(r.argv, b""))) for r in reqs]
    return check.compare(as_run, want)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=0, help="default: one pass of the sequence, at most 300")
    args = ap.parse_args()
    bench = harness.load_bench()
    mix = mixmod.load(harness.cell_of(bench, args.workload)["traffic"])
    n = args.requests or min(300, int(mix["requests"]))
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        counts, compared = control_counts(args.workload, seed, n, check.default_workers())
        print(json.dumps({"workload": args.workload, "seed": seed, "requests": n, "compared": compared,
                          "control": counts, "control_correct": check.passed(counts, compared),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
