"""Seconds from the run's start to its first timed request: the
server's start and warm-up, the corpus written, the warm-up
requests."""


def read(run):
    return run.setup_s
