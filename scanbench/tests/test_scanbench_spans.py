"""The readers of the program's request spans (metrics/_spans.py) on
synthetic --stats lines, with and without the span fields."""

import pytest

from scanbench.metrics import reader
from scanbench.record import Done, RunData, parse_stats

OLD = (b"tpugrep: 2.500s | files=10/12 (pruned=2, clean=9) bytes=1000000000 cand_blocks=3 batches=4 "
       b"walk=0.000s scan=2.000s (0.50 GB/s) replay=0.250s (4.00 GB/s)\n")


def line(walk, compile_s, scanner_s, fill, stage, scanner="hit"):
    return (OLD.replace(b"walk=0.000s", b"walk=%.3fs" % walk).rstrip(b"\n")
            + b" | req=3 compile=%.4fs scanner=%s:%.4fs pack=0.0100s fill=%.4fs stage=%.4fs "
              b"launch=0.0200s wait=0.0300s pull=0.0010s pulls=1 kernel_load=0.0000s/0/0\n"
            % (compile_s, scanner.encode(), scanner_s, fill, stage))


def run_of(*stderrs, latency=4.0):
    reqs = [Done(("-r", "x", "/t"), 1_000_000_000, latency, 0, stderr=b"warning\n" + e) for e in stderrs]
    return RunData(reqs, setup_s=1.0, window_s=10.0, kind="NVIDIA H100 80GB HBM3", peak_bytes_per_s=3.35e12)


NEW = ["walk_share.requests", "fill_share.bulk", "stage_share.bulk", "compile_ms.requests"]


def test_span_readers():
    run = run_of(line(0.4, 0.002, 0.0005, 1.2, 0.6, "miss"), line(0.8, 0.004, 0.0001, 2.0, 1.0))
    assert reader("walk_share.requests")(run) == pytest.approx(100 * 1.2 / 8.0)
    assert reader("fill_share.bulk")(run) == pytest.approx(100 * 3.2 / 8.0)
    assert reader("stage_share.bulk")(run) == pytest.approx(100 * 1.6 / 8.0)
    assert reader("compile_ms.requests")(run) == pytest.approx((2.5 + 4.1) / 2)
    # the stats line as the older readers see it is unchanged by the new fields
    assert parse_stats(run.requests[0].stderr) == parse_stats(OLD.replace(b"walk=0.000s", b"walk=0.400s"))


@pytest.mark.parametrize("name", NEW)
def test_span_readers_find_nothing_without_the_fields(name):
    # a program without spans prints the old line: its walk=0.000s is not a reading
    assert reader(name)(run_of(OLD, OLD)) is None
    assert reader(name)(run_of(b"tpugrep: pattern compile error\n")) is None
    failed = run_of(line(0.4, 0.002, 0.0005, 1.2, 0.6))
    failed.requests[0].rc = 255
    assert reader(name)(failed) is None


def test_span_readers_skip_requests_without_the_fields():
    run = run_of(line(0.4, 0.002, 0.0005, 1.2, 0.6), OLD)
    assert reader("fill_share.bulk")(run) == pytest.approx(100 * 1.2 / 4.0)
    assert reader("compile_ms.requests")(run) == pytest.approx(2.5)
