"""Shared arithmetic of the kernel_roofline readers: the corpus bytes
read once at the card's published memory rate, over the kernel's device
time in the traces, in %. Where a trace holds fewer launches of the
kernel than the scan ran batches (a launch the profiler did not
record), the bytes are counted for the launches it holds only."""


def roofline(run, kernel: str):
    if not run.peak_bytes_per_s:
        return None
    nbytes, us = 0.0, 0.0
    for r in run.requests:
        if r.rc != 0 or r.trace is None or r.stats is None or not r.stats.batches:
            continue
        t = sum(v for k, v in r.trace.ops_us.items() if kernel in k)
        n = sum(v for k, v in r.trace.ops_n.items() if kernel in k)
        if n == 0:
            continue
        nbytes += r.stats.bytes * min(n, r.stats.batches) / r.stats.batches
        us += t
    if us <= 0:
        return None
    return 100.0 * (nbytes / run.peak_bytes_per_s) / (us * 1e-6)
