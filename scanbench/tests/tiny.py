"""Configurations cut small for CPU runs of the harness, and a runner."""

import io
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = {
    "linux_src": dict(files=600, total_bytes=8_000_000, dirs=20, base_bytes=4 << 20, max_file_bytes=200_000,
                      pool_lines=2000,
                      plants=[{"text": "zQx##missing##", "one_file_in": 20},
                              {"text": "QWERTY123456", "one_file_in": 50},
                              {"text": "x91827364550x", "one_file_in": 50},
                              {"text": "fooqbar", "one_file_in": 50}]),
    "log_ioc": dict(log_files=4, log_min_bytes=64 << 10, log_max_bytes=1 << 20, log_total_bytes=3_000_000,
                    big_log_bytes=[], binary_bytes=[65536], base_bytes=4 << 20, piece_bytes=256 << 10,
                    pool_lines=2000,
                    plants_per_file=[6, 10]),
}


def config(name: str) -> dict:
    with open(os.path.join(ROOT, "scanbench", "configs", name + ".json")) as f:
        return dict(json.load(f), **TINY[name])


def cpu_run(workload: str, seed: int, seconds: float, trace: int = 0, server_cmd=None, tmp=None):
    """A whole run of the harness on the CPU at the tiny size; returns
    (exit code, the result line parsed or None)."""
    from scanbench import harness

    if tmp is not None:
        os.environ["TMPDIR"] = str(tmp)
    out = io.StringIO()
    rc = harness.run(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                     require_cuda=False, server_env={"GRAB_TPU_TORCH_DEVICE": "cpu"}, server_cmd=server_cmd,
                     config_overrides=TINY[workload.split(".")[0]], workers=2,
                     cache_dir=os.path.join(str(tmp), "cache") if tmp is not None else None, out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
