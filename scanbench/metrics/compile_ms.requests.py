"""Median over requests of the pattern compile and the scanner lookup
or build in the Engine's construction (the program's ``compile`` and
``scanner`` spans), in ms (metrics/_spans.py)."""

from scanbench.metrics._spans import median_ms


def read(run):
    return median_ms(run, "compile", "scanner")
