"""Median over requests of the client's latency less the program's
--stats seconds (request handling, pattern compile, Engine and scanner
lookup), in ms."""

import numpy as np


def read(run):
    d = [r.latency_s - r.stats.seconds for r in run.requests if r.rc == 0 and r.stats is not None]
    if not d:
        return None
    return float(np.median(d)) * 1e3
