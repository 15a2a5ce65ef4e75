"""The port's bench (``grab_tpu_torch.bench``) against the JAX package's ``bench.py``.

On the CPU: the headline runs on the core-word kernel's plain PyTorch
version at 8 MiB and prints one JSON line under the reference's metric
name and keys; the secondary metrics, at small sizes, print exactly the
reference's names (read from ``bench.py``'s source text, which is not
imported); a failing metric is reported and counted, never skipped; and
without a card the bench refuses to run unless the CPU is named.
Times here are CPU times and are not checked.
"""

import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from grab_tpu_torch import bench
from tests._torch_threads import _one_thread  # noqa: F401 (autouse: one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_source() -> str:
    with open(os.path.join(REPO, "bench.py"), encoding="utf-8") as f:
        return f.read()


def reference_secondary_names():
    """The reference's secondary metric names: every quoted
    ``*_bytes_per_sec`` string but the headline line's own key
    (``line["measured_roofline_bytes_per_sec"]``)."""
    return re.findall(r'(?<!\[)"([a-z0-9_]+_bytes_per_sec)"', _reference_source())


def reference_headline_keys():
    src = _reference_source()
    keys = set(re.findall(r'line\["([a-z_]+)"\]', src))
    body = re.search(r"line = \{(.*?)\}", src, re.S).group(1)
    return keys | set(re.findall(r'"([a-z_]+)":', body))


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if k != "GRAB_TPU_TORCH_DEVICE"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", **kw)
    return env


def test_headline_on_cpu():
    r = subprocess.run([sys.executable, "-m", "grab_tpu_torch.bench", "--device", "cpu"],
                       cwd=REPO, env=_env(GRAB_TPU_BENCH_MB="8"), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == bench.METRIC == "literal_scan_bytes_per_sec_per_chip"
    assert line["unit"] == "bytes/s" and line["value"] > 0
    assert line["backend"] == "cpu" and line["bytes"] == 8 << 20
    # no card, no spec rate: vs_baseline is left out, and stderr says so
    assert set(line) >= reference_headline_keys() - {"vs_baseline"}
    assert "vs_baseline" not in line and "vs_baseline left out" in r.stderr
    assert reference_headline_keys() >= {"metric", "value", "unit", "vs_baseline",
                                         "measured_roofline_bytes_per_sec"}


def test_headline_asserts_a_miss(monkeypatch):
    monkeypatch.setattr(bench, "LITERAL", b"abcd")  # lowercase: hits everywhere
    with pytest.raises(RuntimeError, match="miss pattern produced"):
        bench.headline(torch.device("cpu"), 1, reps=1)


def test_secondary_metrics_emit_the_reference_names():
    names = reference_secondary_names()
    assert len(names) == len(set(names)) == 18
    assert sorted(bench.SECONDARY_METRICS) == sorted(names)
    out = io.StringIO()
    failed = bench.secondary_metrics(torch.device("cpu"), None, out=out, n=2 << 20,
                                     big=2 << 20, mbuf=2 << 20, depth=1, reps=1)
    lines = [json.loads(l) for l in out.getvalue().splitlines()]
    assert failed == []
    assert tuple(l["metric"] for l in lines) == bench.SECONDARY_METRICS
    for l in lines:
        assert "error" not in l and l["value"] > 0 and l["unit"] == "bytes/s", l


def test_failing_metric_is_reported(monkeypatch):
    from grab_tpu_torch.ingest import native

    out = io.StringIO()
    emit = bench._Emitter(out, roofline=None)
    emit("ok", lambda: (100, 1.0), torch.device("cpu"))
    # no native library: the host transpose raises, it is not skipped
    monkeypatch.setattr(native, "available", lambda: False)
    emit("host_transpose_bytes_per_sec", lambda: bench.host_transpose(2 << 20, 1),
         torch.device("cpu"))
    assert emit.failed == ["host_transpose_bytes_per_sec"]
    ok, bad = (json.loads(l) for l in out.getvalue().splitlines())
    assert ok == {"metric": "ok", "value": 100.0, "unit": "bytes/s"}
    assert bad["metric"] == "host_transpose_bytes_per_sec" and "did not build" in bad["error"]


def test_suspect_above_the_roofline():
    out = io.StringIO()
    emit = bench._Emitter(out, roofline=100.0)
    emit("fast", lambda: (106, 1.0), torch.device("cpu"))
    emit("ok", lambda: (104, 1.0), torch.device("cpu"))
    a, b = (json.loads(l) for l in out.getvalue().splitlines())
    assert a["suspect"] is True and "suspect" not in b


def test_no_card_no_run():
    # the card, if any, is hidden: the bench must refuse, not fall back
    r = subprocess.run([sys.executable, "-m", "grab_tpu_torch.bench"], cwd=REPO,
                       env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    assert "torch.cuda.is_available() is false" in r.stderr
