"""The device's idle share over the traced requests' scans, in %
(metrics/_idle.py)."""

from scanbench.metrics._idle import idle_share


def read(run):
    return idle_share(run)
