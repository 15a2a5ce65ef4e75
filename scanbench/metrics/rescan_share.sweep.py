"""Share of the scanned corpus bytes that the host replay searched again:
Σ of ``--stats`` ``replay_bytes=`` (the bytes of the candidate windows
the replay handed to the exact matchers) over Σ ``bytes=``, over the
requests whose stats line carries the field, in %. A program whose
stats line has no ``replay_bytes=`` gives nothing."""

import re

_FIELD = re.compile(rb" replay_bytes=(\d+) ")


def _replay_bytes(stderr: bytes):
    m = None
    for m in _FIELD.finditer(stderr):
        pass
    return None if m is None else int(m[1])


def read(run):
    replayed = scanned = 0
    for r in run.requests:
        if r.rc != 0 or r.stats is None:
            continue
        n = _replay_bytes(r.stderr)
        if n is None:
            continue
        replayed += n
        scanned += r.stats.bytes
    if scanned <= 0:
        return None
    return 100.0 * replayed / scanned
