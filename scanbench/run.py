"""The benchmark's command: ``python3 scanbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``, from the root of a checkout
(scanbench/harness.py says what a run does)."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scanbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.run(t0=T0))
