"""Shared arithmetic of the device_idle readers: 1 - (union of the
device's operation spans) / (the trace's window), summed over the
traced requests, in %."""


def idle_share(run):
    ts = [r.trace for r in run.requests if r.trace is not None and r.trace.window_us > 0]
    if not ts or not any(t.busy_us > 0 for t in ts):
        return None
    return 100.0 * (1.0 - sum(t.busy_us for t in ts) / sum(t.window_us for t in ts))
