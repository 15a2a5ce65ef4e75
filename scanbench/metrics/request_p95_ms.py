"""95th percentile of the client's latency over every request completed in the
window, in ms (numpy's linear interpolation). A failed request is
counted in the result's ``failed`` and makes the run not correct."""

import numpy as np


def read(run):
    lat = [r.latency_s for r in run.requests if r.rc == 0]
    if not lat:
        return None
    return float(np.percentile(lat, 95)) * 1e3
