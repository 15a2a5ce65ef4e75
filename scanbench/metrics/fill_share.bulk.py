"""Share of the client's latency spent in the pread fill of the scan
buffers (the program's ``fill`` span), summed over the requests that
carry spans, in % (metrics/_spans.py)."""

from scanbench.metrics._spans import share


def read(run):
    return share(run, "fill")
