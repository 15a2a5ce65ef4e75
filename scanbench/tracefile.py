"""Reading a request's Chrome trace (``--trace D`` writes
``D/trace.json``, torch.profiler's export) into what the metrics use:
the device's busy time as the union of its operations' spans (the
arithmetic of ``chip_smoke.py`` ``phase_e2e``), the trace's window, the
device time of each operation by name, and where the device sat idle."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceSummary:
    window_us: float = 0.0  # first event's start to last event's end
    busy_us: float = 0.0  # union of the device operations' spans
    ops_us: Dict[str, float] = field(default_factory=dict)  # device op name -> µs
    ops_n: Dict[str, int] = field(default_factory=dict)  # device op name -> count
    gaps_us: Dict[str, float] = field(default_factory=dict)  # idle time by what came around it


def union_us(spans: List[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) spans."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def summarize(events: List[dict]) -> TraceSummary:
    t = TraceSummary()
    lo, hi = None, None
    dev = []
    for ev in events:
        if ev.get("ph") != "X" or "ts" not in ev:
            continue
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        lo = s if lo is None else min(lo, s)
        hi = e if hi is None else max(hi, e)
        if str(ev.get("cat", "")).lower() in DEVICE_CATS and e > s:
            dev.append((s, e))
            name = str(ev.get("name", "?"))
            t.ops_us[name] = t.ops_us.get(name, 0.0) + (e - s)
            t.ops_n[name] = t.ops_n.get(name, 0) + 1
    if lo is None:
        return t
    t.window_us = hi - lo
    t.busy_us = union_us(dev)
    if dev:
        first = min(s for s, _ in dev)
        last = max(e for _, e in dev)
        t.gaps_us = {
            "before the first device op (walk, first fill)": first - lo,
            "after the last device op (resolve, replay, emit)": hi - last,
        }
        t.gaps_us["between device ops (pack, fill, staging)"] = max(
            0.0, t.window_us - t.busy_us - sum(t.gaps_us.values()))
    else:
        t.gaps_us = {"no device op in the scan": t.window_us}
    return t


def read(path: str) -> TraceSummary:
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    return summarize(events)
