"""Corpus bytes that the window's completed requests covered, over the
client's wall time of all of them (a closed loop of one client: the
window), in GB/s."""


def read(run):
    done = [r for r in run.requests if r.rc == 0]
    wall = sum(r.latency_s for r in done)
    if not done or wall <= 0:
        return None
    return sum(r.nbytes for r in done) / wall / 1e9
