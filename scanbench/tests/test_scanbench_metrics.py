"""Metric arithmetic on a synthetic Chrome trace and on --stats lines."""

import json

import pytest

from scanbench import tracefile
from scanbench.metrics import reader
from scanbench.record import Done, RunData, parse_stats

STATS = (b"tpugrep: 2.500s | files=10/12 (pruned=2, clean=9) bytes=1000000000 cand_blocks=3 batches=4 "
         b"walk=0.000s scan=2.000s (0.50 GB/s) replay=0.250s (4.00 GB/s)\n")


def trace_events():
    return [
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1000.0, "dur": 10000.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 2000.0, "dur": 1000.0},
        {"ph": "X", "cat": "kernel", "name": "_Z16core_word_kernelPKj5Table", "ts": 2500.0, "dur": 1000.0},
        {"ph": "X", "cat": "kernel", "name": "core_word_kernel(unsigned int const*)", "ts": 6000.0, "dur": 500.0},
        {"ph": "i", "cat": "cpu_instant_event", "name": "marker", "ts": 0.0},
    ]


def test_trace_union_and_gaps():
    t = tracefile.summarize(trace_events())
    assert t.window_us == 10000.0
    assert t.busy_us == 2000.0  # [2000, 3500) and [6000, 6500)
    assert t.ops_n == {"Memcpy HtoD": 1, "_Z16core_word_kernelPKj5Table": 1, "core_word_kernel(unsigned int const*)": 1}
    assert t.gaps_us["before the first device op (walk, first fill)"] == 1000.0
    assert t.gaps_us["after the last device op (resolve, replay, emit)"] == 4500.0
    assert t.gaps_us["between device ops (pack, fill, staging)"] == 2500.0


def test_trace_file_read(tmp_path):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": trace_events()}))
    assert tracefile.read(str(p)).busy_us == 2000.0


def test_stats_line():
    s = parse_stats(b"warning\n" + STATS)
    assert (s.seconds, s.files, s.bytes, s.cand_blocks, s.batches, s.scan_s, s.replay_s) == \
        (2.5, 10, 1000000000, 3, 4, 2.0, 0.25)
    assert parse_stats(b"tpugrep: 0.010s, 1.50 GB/s | files=1/1 (pruned=0, clean=1) bytes=5 cand_blocks=0 "
                       b"batches=1 walk=0.000s scan=0.002s replay=0.000s\n").bytes == 5
    assert parse_stats(b"nothing here") is None


def run_data():
    t = tracefile.summarize(trace_events())
    reqs = [Done(("-r", "x", "/t"), 2_000_000_000, 4.0, 0, stats=parse_stats(STATS), trace=t),
            Done(("-r", "x", "/t"), 2_000_000_000, 6.0, 0, stats=parse_stats(STATS), trace=t)]
    return RunData(reqs, setup_s=12.5, window_s=10.0, kind="NVIDIA H100 80GB HBM3", peak_bytes_per_s=3.35e12)


def test_end_to_end_readers():
    run = run_data()
    assert reader("scan_GBps")(run) == pytest.approx(4e9 / 10.0 / 1e9)
    assert reader("request_p95_ms")(run) == pytest.approx(5900.0)
    assert reader("setup_s")(run) == 12.5
    failed = RunData(run.requests + [Done(("-r",), 1, 0.1, 255)], 1.0, 1.0, "x", None)
    assert reader("request_p95_ms")(failed) == reader("request_p95_ms")(run)  # failures: `failed`, not a latency


def test_per_layer_readers():
    run = run_data()
    assert reader("prescan_share.bulk")(run) == pytest.approx(100 * (1.5 + 3.5) / 10.0)
    assert reader("prescan_ms.requests")(run) == pytest.approx(2500.0)
    assert reader("pipeline_GBps.bulk")(run) == pytest.approx(2e9 / 4.0 / 1e9)
    assert reader("replay_share.requests")(run) == pytest.approx(100 * 0.5 / 10.0)
    assert reader("device_idle.bulk")(run) == pytest.approx(80.0)
    assert reader("device_idle.requests")(run) == pytest.approx(80.0)
    # two launches recorded of four batches: the bytes of two batches over 1.5 ms of kernel
    want = 100 * (1e9 * 2 / 4 / 3.35e12) / 1.5e-3
    assert reader("kernel_roofline.b1")(run) == pytest.approx(want)
    other = RunData(run.requests, 1.0, 1.0, "NVIDIA H100 80GB HBM3", 3.35e12)
    for r in other.requests:
        r.trace.ops_n = {k.replace("core_word", "fused"): v for k, v in r.trace.ops_n.items()}
    assert reader("kernel_roofline.b1")(other) is None  # no core-word launch in the trace: nothing to read


def test_readers_read_nothing_without_their_source():
    bare = RunData([Done(("-r",), 10, 1.0, 0)], 1.0, 1.0, "cpu", None)
    for name in ("prescan_share.bulk", "pipeline_GBps.bulk", "device_idle.bulk", "kernel_roofline.b1",
                 "replay_share.requests", "prescan_ms.requests"):
        assert reader(name)(bare) is None
