"""What a run records of each request, and the program's ``--stats``
line parsed (``cli.main``: ``tpugrep: <s>s[, <r> GB/s] | files=... bytes=...
cand_blocks=... batches=... walk=...s scan=...s ... replay=...s ...``)."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

from scanbench.tracefile import TraceSummary

_STATS = re.compile(
    rb"tpugrep: (?P<seconds>[0-9.]+)s[^|\n]*\| files=(?P<files>\d+)/(?P<seen>\d+) .*?"
    rb"bytes=(?P<bytes>\d+) cand_blocks=(?P<cand>\d+) batches=(?P<batches>\d+) "
    rb"walk=(?P<walk>[0-9.]+)s scan=(?P<scan>[0-9.]+)s.*?replay=(?P<replay>[0-9.]+)s"
)


@dataclass
class Stats:
    seconds: float  # cli.main's own clock: after the Engine is built, to the end
    files: int
    bytes: int
    cand_blocks: int
    batches: int
    scan_s: float
    replay_s: float


def parse_stats(stderr: bytes) -> Optional[Stats]:
    m = None
    for m in _STATS.finditer(stderr):
        pass
    if m is None:
        return None
    return Stats(float(m["seconds"]), int(m["files"]), int(m["bytes"]), int(m["cand"]),
                 int(m["batches"]), float(m["scan"]), float(m["replay"]))


@dataclass
class Done:
    argv: Tuple[str, ...]
    nbytes: int  # corpus bytes under the request's target
    latency_s: float  # the client's clock, connect to the exit code
    rc: Optional[int]  # None: the connection failed
    stdout: bytes = b""
    stderr: bytes = b""
    stats: Optional[Stats] = None
    trace: Optional[TraceSummary] = None


@dataclass
class RunData:
    """What a metric reader is given."""

    requests: List[Done]
    setup_s: float
    window_s: float
    kind: str  # the device's name
    peak_bytes_per_s: Optional[float]
