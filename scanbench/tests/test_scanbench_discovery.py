"""A new configuration, traffic mix and metric are picked up from new
files and new BENCHMARK.json entries alone: a copy of the benchmark
gains them, no file of it is edited but BENCHMARK.json, and a run of
the new cell reports the new metric."""

import json
import os
import shutil
import subprocess
import sys

from scanbench.tests.tiny import ROOT, TINY


def test_new_files_alone(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "scanbench"), copy / "scanbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = dict(json.load(open(os.path.join(ROOT, "scanbench", "configs", "linux_src.json"))),
               **TINY["linux_src"], name="tiny_src")
    (copy / "scanbench" / "configs" / "tiny_src.json").write_text(json.dumps(cfg))
    (copy / "scanbench" / "traffic" / "fooq.json").write_text(json.dumps({
        "argv": ["-r", "-S", "{p}", "{root}"], "target": "root",
        "fields": {"p": {"fixed": "fooqbar"}, "root": {"dirs": "root"}}, "requests": 1, "draw_seed": 1,
        "check_sample": 0}))
    (copy / "scanbench" / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    bench["configs"].append({"name": "tiny_src", "source": "https://example.org", "reduced": [],
                             "file": "scanbench/configs/tiny_src.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny_src.fooq", "config": "tiny_src", "traffic": "fooq", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "requests_done", "unit": "requests", "better": "higher", "bound": 0.1,
                                "source": "host_clock", "workloads": ["tiny_src.fooq"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; from scanbench import harness; sys.exit(harness.run(['--workload', 'tiny_src.fooq', "
            "'--seed', '5', '--seconds', '1', '--trace', '0'], require_cuda=False, "
            "server_env={'GRAB_TPU_TORCH_DEVICE': 'cpu'}, workers=1))")
    env = dict(os.environ, PYTHONPATH=f"{copy}{os.pathsep}{ROOT}", TMPDIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], cwd=copy, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["metrics"]["requests_done"]["value"] >= 1
    assert set(res["metrics"]) == {"requests_done", "setup_s"}
