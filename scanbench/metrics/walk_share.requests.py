"""Share of the client's latency that the scan pipeline spent blocked on
the walk (the program's ``walk`` span, --stats ``walk=``), summed over
the requests that carry spans, in % (metrics/_spans.py)."""

from scanbench.metrics._spans import share


def read(run):
    return share(run, "walk")
