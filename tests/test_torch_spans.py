"""The request spans of the port's scan (engine.py ScanStats.span) on
the CPU: where they are recorded, that the pipeline's spans partition
``scan=``, that a request without --stats or --trace records nothing,
the --stats line's new fields, the spans as ranges of a --trace, and
the scan server's cache counted as hits and misses."""

import io
import json
import os
import re
import threading
import time

import numpy as np
import pytest

from grab_tpu_torch import _build
from grab_tpu_torch import cli as port_cli
from grab_tpu_torch import server as server_mod
from grab_tpu_torch.engine import PIPELINE_SPANS, Engine, EngineConfig
from scanbench import tracefile
from scanbench.metrics import _spans
from scanbench.record import parse_stats
from tests._torch_threads import _one_thread  # noqa: F401 (autouse: one intra-op thread)

BUF = 64 << 10  # small scan buffers: several batches over the tree
SLEEP = 0.02  # the slowed walk's pause before each file
ROUTES = {
    "one device": dict(device="cpu"),
    "-n 2": dict(device="cpu,cpu", n_shards=2),
}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Six files of 10-150 KB, needleXY in three of them."""
    root = tmp_path_factory.mktemp("spantree")
    (root / "sub").mkdir()
    rng = np.random.default_rng(5)
    for i, n in enumerate((10_000, 150_000, 40_000, 90_000, 25_000, 120_000)):
        data = bytearray(rng.integers(97, 123, size=n, dtype=np.uint8))
        data[::97] = b"\n" * len(data[::97])
        if i % 2:
            data[n // 2 : n // 2 + 8] = b"needleXY"
        (root / ("sub" if i % 3 else ".") / f"f{i}.txt").write_bytes(bytes(data))
    return root


def _entries(root):
    return sorted(
        (os.path.join(d, f), os.path.getsize(os.path.join(d, f)))
        for d, _, fs in os.walk(root) for f in fs
    )


def _slowed(items):
    for item in items:
        time.sleep(SLEEP)
        yield item


def _scan(root, kind, route, record=True):
    eng = Engine(b"needleXY", EngineConfig(scan_buf_size=BUF, record=record, **ROUTES[route]))
    out = []
    entries = _entries(root)
    if kind == "paths":
        eng.scan_corpus_paths(_slowed(entries), out.append)
    else:
        data = [(p, open(p, "rb").read()) for p, _ in entries]
        eng.scan_corpus(_slowed(data), out.append)
    return eng, b"".join(out), len(entries)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", ["paths", "data"])
def test_pipeline_spans_partition_the_scan(tree, kind, route):
    """The walk reads at least the slowed walk's sleeps; walk + pack +
    fill + stage + launch + wait + pull is scan= within 5% or 5 ms;
    replay= is the replay span; pulls counts the batches with hits."""
    eng, out, n = _scan(tree, kind, route)
    st = eng.stats
    assert out.count(b"needleXY") == 3
    assert st.wall_walk >= n * SLEEP and st.spans["walk"] == st.wall_walk
    parts = st.spans["walk"] + sum(st.spans.get(k, 0.0) for k in PIPELINE_SPANS)
    assert abs(parts - st.wall_scan) <= max(0.05 * st.wall_scan, 0.005), (parts, st.wall_scan, st.spans)
    assert st.spans["replay"] > 0 and st.wall_replay == st.spans["replay"]
    assert f"replay={st.spans['replay']:.3f}s" in st.summary()
    assert f"walk={st.spans['walk']:.3f}s" in st.summary()
    assert 1 <= st.pulls <= st.device_batches and st.device_batches >= 4
    assert st.scanner == "none" and st.spans["compile"] > 0 and "scanner" in st.spans
    for k in ("fill",) if kind == "paths" else ():
        assert st.spans[k] > 0


@pytest.mark.parametrize("route", list(ROUTES))
def test_no_recording_makes_no_clock_calls(tree, route, monkeypatch):
    """Without --stats or --trace the recorder is the shared no-op: no
    clock read from the port, no span total, the output unchanged."""
    calls = []
    clock = time.perf_counter

    def counted():
        calls.append(__import__("sys")._getframe(1).f_globals.get("__name__", ""))
        return clock()

    want = _scan(tree, "paths", route)[1]
    monkeypatch.setattr(time, "perf_counter", counted)
    eng, out, _ = _scan(tree, "paths", route, record=False)
    monkeypatch.setattr(time, "perf_counter", clock)
    assert out == want
    assert [c for c in calls if c.startswith("grab_tpu_torch")] == []
    st = eng.stats
    assert st.spans == {} and st.span("walk") is st.span("pull")
    assert " | req=" not in st.summary()


def _cli(argv, request=0, cache=None):
    out, err = io.BytesIO(), io.StringIO()
    if cache is None:
        rc = port_cli.main(argv, out=out, err=err, request=request)
    else:
        rc = server_mod._run_with_cache(argv, cache, out, err, request)
    assert rc == 0, err.getvalue()
    return out.getvalue(), err.getvalue().encode()


def test_stats_line_keeps_its_fields(tree):
    """The --stats line parses as before (scanbench.record) to the values
    of its first fields, and the span fields follow replay=."""
    engines = []

    def keep(pats, cfg):
        engines.append(Engine(pats, cfg))
        return engines[-1]

    err = io.StringIO()
    rc = port_cli.main(["--stats", "-r", "needleXY", str(tree)], out=io.BytesIO(), err=err,
                       engine_factory=keep, request=5)
    assert rc == 0
    line = err.getvalue().encode()
    st = engines[0].stats
    s = parse_stats(line)
    assert (s.files, s.bytes, s.cand_blocks, s.batches) == \
        (st.files_scanned, st.bytes_scanned, st.candidate_blocks, st.device_batches)
    assert (s.scan_s, s.replay_s) == (round(st.wall_scan, 3), round(st.wall_replay, 3))
    m = re.search(rb"walk=([0-9.]+)s scan=[^|]*replay=[^|]*\| req=5 compile=", line)
    assert m and float(m[1]) > 0
    got = _spans.spans(line)
    assert got["fill"] == round(st.spans["fill"], 4) and got["walk"] == float(m[1])
    assert re.search(rb"scanner=none:[0-9.]+s .* pulls=\d+ inplace=%d replay_bytes=%d "
                     rb"kernel_load=0\.0000s/0/0\n" % (st.device_batches, st.replay_bytes), line)
    assert st.replay_bytes > 0
    assert re.search(rb" pull=[0-9.]+s compiled=none seqgate=%d/%d pulls=\d+ " % st.seqgate, line)


def test_trace_holds_the_spans_as_ranges(tree, tmp_path):
    """--trace: the spans are user_annotation ranges inside the profiler's
    window; the trace's summary is the same without them; the request's
    id is the trace's metadata."""
    d = tmp_path / "t"
    _, err = _cli(["--stats", "--trace", str(d), "-r", "-O", "needleXY", str(tree)], request=9)
    assert b" | req=9 " in err
    doc = json.loads((d / "trace.json").read_text())
    assert doc["request"] == "9"
    events = doc["traceEvents"]
    prof = [e for e in events if str(e.get("name", "")).startswith("PyTorch Profiler")][0]
    lo, hi = prof["ts"], prof["ts"] + prof["dur"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    assert {"walk", "pack", "fill", "launch", "replay"} <= {e["name"] for e in ranges}
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in ranges)
    bare = [e for e in events if e.get("cat") != "user_annotation"]
    a, b = tracefile.summarize(events), tracefile.summarize(bare)
    assert (a.window_us, a.busy_us, a.gaps_us) == (b.window_us, b.busy_us, b.gaps_us)


def test_gpu_user_annotation_is_not_device_time():
    """kineto's device-side copy of a range that encloses launches is no
    device operation."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "launch", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "launch", "ts": 10.0, "dur": 80.0},
        {"ph": "X", "cat": "kernel", "name": "core_word_kernel", "ts": 20.0, "dur": 5.0},
    ]
    t = tracefile.summarize(ev)
    assert t.busy_us == 5.0 and list(t.ops_us) == ["core_word_kernel"]


def test_scanner_cache_miss_then_hit(tree):
    cache = server_mod._EngineCache()
    argv = ["--stats", "-r", "needleXY", str(tree)]
    first, e1 = _cli(argv, 1, cache)
    again, e2 = _cli(argv, 2, cache)
    assert first == again and first.count(b"needleXY") == 3
    assert b" | req=1 " in e1 and b"scanner=miss:" in e1 and e1.endswith(b" cache=0/1\n")
    assert b" | req=2 " in e2 and b"scanner=hit:" in e2 and e2.endswith(b" cache=1/1\n")
    assert (cache.hits, cache.misses) == (1, 1)
    assert b" compiled=miss seqgate=" in e1 and b" compiled=hit seqgate=" in e2
    assert (cache.compile_hits, cache.compile_misses) == (1, 1)
    # the span a hit reads is the lookup: far under the compile it saved
    c1, c2 = (float(re.search(rb" compile=([0-9.]+)s ", e)[1]) for e in (e1, e2))
    assert c2 <= c1


def test_kernel_load_is_the_requests_share(tree, monkeypatch):
    loads = _build.KernelLoads(seconds=3.0, built=2, loaded=4)
    monkeypatch.setattr(_build, "kernel_loads", loads)
    eng = Engine(b"needleXY", EngineConfig(device="cpu", record=True))
    loads.seconds, loads.built, loads.loaded = 3.25, 3, 6
    assert eng.stats.summary().endswith(" kernel_load=0.2500s/1/2")


def test_server_start_line(tmp_path, capsys):
    """The listening line gives the start's split (the CPU: no context,
    kernels or warm-up)."""
    path = str(tmp_path / "s.sock")
    threading.Thread(target=server_mod.serve, args=(path,), daemon=True).start()
    for _ in range(400):
        if os.path.exists(path):
            break
        time.sleep(0.05)
    assert os.path.exists(path)
    err = capsys.readouterr().err
    assert re.search(
        r"tpugrep-server: listening on \S+ \(start: torch\+context [0-9.]+s, kernels 0\.00s, "
        r"warm 0\.00s\)", err), err
