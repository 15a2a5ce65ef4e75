"""Shared reading of the program's request spans from each request's
``--stats`` line (grab_tpu_torch's ``ScanStats``): the fields after
``replay=``, `` | req=N compile=Xs scanner=hit:Xs pack=Xs fill=Xs
stage=Xs launch=Xs wait=Xs pull=Xs pulls=N kernel_load=...``, with the
line's own ``walk=``. A line without them (a program that records no
spans) gives nothing, and so does a run whose requests carry none."""

import re

import numpy as np

_LINE = re.compile(
    rb"tpugrep: [^\n]*? walk=(?P<walk>[0-9.]+)s [^\n]*? \| req=\d+ "
    rb"compile=(?P<compile>[0-9.]+)s scanner=[a-z]+:(?P<scanner>[0-9.]+)s "
    rb"pack=(?P<pack>[0-9.]+)s fill=(?P<fill>[0-9.]+)s stage=(?P<stage>[0-9.]+)s "
    rb"launch=(?P<launch>[0-9.]+)s wait=(?P<wait>[0-9.]+)s pull=(?P<pull>[0-9.]+)s "
)


def spans(stderr: bytes):
    """{span: seconds} of the last stats line in ``stderr``, or None."""
    m = None
    for m in _LINE.finditer(stderr):
        pass
    return None if m is None else {k: float(v) for k, v in m.groupdict().items()}


def carried(run):
    """(request, its spans) for each completed request that carries them."""
    out = []
    for r in run.requests:
        s = spans(r.stderr) if r.rc == 0 else None
        if s is not None:
            out.append((r, s))
    return out


def share(run, name: str):
    """Σ of span ``name`` over Σ client latency of the requests that
    carry spans, in %."""
    rs = carried(run)
    lat = sum(r.latency_s for r, _ in rs)
    if not rs or lat <= 0:
        return None
    return 100.0 * sum(s[name] for _, s in rs) / lat


def median_ms(run, *names: str):
    """Median over the requests that carry spans of the sum of ``names``, in ms."""
    rs = carried(run)
    if not rs:
        return None
    return float(np.median([sum(s[n] for n in names) for _, s in rs])) * 1e3
