"""Share of the client's latency spent before the program's --stats
clock starts (the server's request handling, the pattern compile,
the Engine and scanner lookup), summed over the traced requests, in %."""


def read(run):
    rs = [r for r in run.requests if r.rc == 0 and r.stats is not None]
    lat = sum(r.latency_s for r in rs)
    if not rs or lat <= 0:
        return None
    return 100.0 * sum(max(0.0, r.latency_s - r.stats.seconds) for r in rs) / lat
