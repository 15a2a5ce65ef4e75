"""BENCHMARK.json against the benchmark's contract, and a run's last
line against its schema (a whole run on the CPU at a tiny size)."""

import json
import os
import re

import pytest

from scanbench.tests.tiny import ROOT, cpu_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["scanbench"] and bench["command"] == ["python3", "scanbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = 24  # what a full check must fit with the most cells it may hold
    assert (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("scanbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "scanbench", "traffic", w["traffic"] + ".json"))
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert [w["name"] for w in bench["workloads"]] == ["linux_src.requests", "log_ioc.hunt"]
    assert {w["config"] for w in bench["workloads"]} == configs
    cellnames = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert set(m.get("workloads", cellnames)) <= cellnames
        assert os.path.exists(os.path.join(ROOT, "scanbench", "metrics", m["name"] + ".py"))
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cellnames))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for cell in cellnames:  # every cell: setup_s, another end-to-end metric, a per-layer metric
        assert sum(cell in m.get("workloads", cellnames) for m in bench["end_to_end"]) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])
    assert len(json.dumps(bench)) < 64 << 10


def check_line(res, trace):
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(res)[-1] == "checks"
    assert res["device"]["count"] == 1 and set(res["device"]) >= {"platform", "kind", "memory_peak_bytes"}
    if trace:
        assert "busy_s" in res["device"] and "window_s" in res["device"]
        for k in ("device_ops", "idle_gaps"):
            assert len(res["breakdown"][k]) <= 10
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_schema(tmp_path, trace):
    rc, res = cpu_run("log_ioc.hunt", 2**31 + 77, 1.5, trace, tmp=tmp_path)
    assert rc == 0 and res["correct"] is True and res["attempted"] >= 1
    check_line(res, trace)
    want = {0: {"scan_GBps", "setup_s"}, 1: {"prescan_share.bulk", "pipeline_GBps.bulk"}}[trace]
    assert want <= set(res["metrics"])  # the CPU has no device trace: no idle share, no roofline
