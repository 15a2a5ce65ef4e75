"""Share of the client's latency spent staging the scan buffers into
pinned memory (the program's ``stage`` span), summed over the requests
that carry spans, in % (metrics/_spans.py)."""

from scanbench.metrics._spans import share


def read(run):
    return share(run, "stage")
