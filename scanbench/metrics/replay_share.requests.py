"""Share of the client's latency spent in the host's exact replay of
candidate blocks (--stats replay=), summed over requests, in %."""


def read(run):
    rs = [r for r in run.requests if r.rc == 0 and r.stats is not None]
    lat = sum(r.latency_s for r in rs)
    if not rs or lat <= 0:
        return None
    return 100.0 * sum(r.stats.replay_s for r in rs) / lat
