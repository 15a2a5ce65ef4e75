"""Share of the client's latency spent compiling the request's patterns
and their exact matchers (the program's ``compile`` span, every request:
the server caches scanners, not compiled patterns), summed over the
requests that carry spans, in % (metrics/_spans.py)."""

from scanbench.metrics._spans import share


def read(run):
    return share(run, "compile")
