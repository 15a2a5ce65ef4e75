"""One benchmark run: ``python3 scanbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` from the root of a checkout.

Set-up starts the program's scan server (``python -m
grab_tpu_torch.server <socket>``, its socket under ``TMPDIR``) as a
child process, prepares the cell's corpus while the server loads and
warms (``corpus.prepare``: the configuration's tree, kept in the
checkout's ``.scanbench_cache/`` and written by the first run there,
with this run's seed's strings planted), and sends the mix's warm-up
requests. The window is a closed loop of one client through the
``--via`` protocol, timed on the client's side; a request that starts
inside the window runs to its end. Then the server is stopped, the device memory peak read
(``nvidia-smi``, sampled through the run), the requests compared with
the plain reference, and one JSON line printed.

With ``--trace 1`` every request also carries ``--stats`` and ``--trace
<dir>``: the per-layer metrics are read from the stderr's stats line and
the request's Chrome trace.

Everything of one configuration, mix or metric is found by its name:
``configs/<config>.json`` (its ``generator`` in ``corpus/``),
``traffic/<mix>.json``, ``metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "grab_tpu")
SERVER_START_S = 1500  # a checkout's first run builds the kernels
REQUEST_TIMEOUT_S = 240


class RunError(RuntimeError):
    pass


class NoCard(RunError):
    pass


def _log(msg: str) -> None:
    print(f"scanbench: {msg}", file=sys.stderr, flush=True)


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise RunError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise RunError(f"no config {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if "workloads" not in m or cell in m["workloads"]]


def _kill_group(p: Optional[subprocess.Popen]) -> None:
    if p is None or p.poll() is not None:
        if p is not None:
            p.wait()
        return
    try:
        os.killpg(p.pid, signal.SIGTERM)
    except ProcessLookupError:
        pass
    try:
        p.wait(timeout=30)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()


def _socket_path(work: str) -> str:
    path = os.path.join(work, "s")
    if len(path.encode()) > 100:  # AF_UNIX's limit; both processes run in the checkout
        rel = os.path.relpath(path, os.getcwd())
        if len(rel.encode()) < len(path.encode()):
            path = rel
    return path


def _gpu_index() -> str:
    vis = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0].strip()
    return vis or "0"


def _smi(query: str) -> str:
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader", "-i", _gpu_index()],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


class _MemorySampler:
    """``nvidia-smi`` sampling the card's used memory through the run; its
    peak is ``memory_peak_bytes``."""

    def __init__(self, path: str):
        self.path = path
        self.proc = None
        try:
            self.out = open(path, "wb")
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits",
                 "-lms", "200", "-i", _gpu_index()],
                stdout=self.out, stderr=subprocess.DEVNULL, start_new_session=True)
        except OSError as e:
            raise RunError(f"nvidia-smi did not start: {e}")

    def stop(self) -> int:
        _kill_group(self.proc)
        self.out.close()
        peak = 0
        with open(self.path) as f:
            for line in f:
                try:
                    peak = max(peak, int(line.strip()))
                except ValueError:
                    pass
        return peak << 20


def _count_cards() -> dict:
    """torch's view of the cards; makes no CUDA context."""
    import torch

    available = torch.cuda.is_available()
    return {"available": available, "count": torch.cuda.device_count() if available else 0}


def _request(sock: str, argv: List[str]):
    from scanbench import client

    t0 = time.perf_counter()
    try:
        rc, out, err = client.request(sock, argv, timeout=REQUEST_TIMEOUT_S)
    except (OSError, ConnectionError) as e:
        rc, out, err = None, b"", f"request failed: {e}".encode()
    return rc, out, err, time.perf_counter() - t0


def run(argv: Optional[List[str]] = None, *, t0: Optional[float] = None, require_cuda: bool = True,
        server_cmd: Optional[List[str]] = None, server_env: Optional[Dict[str, str]] = None,
        config_overrides: Optional[dict] = None, workers: Optional[int] = None,
        root: str = ROOT, cache_dir: Optional[str] = None, out=None) -> int:
    """One run; returns the exit code. The keywords serve the tests: a
    run on the CPU (``require_cuda=False`` and the server's device in
    ``server_env``), a server command with a fault planted, a corpus cut
    small and kept elsewhere. ``out``: where the result line goes
    (default stdout)."""
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="scanbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    out = sys.stdout if out is None else out

    bench = load_bench(root)
    cell = cell_of(bench, args.workload)
    work = tempfile.mkdtemp(prefix="scanbench-", dir=os.environ.get("TMPDIR") or None)
    try:
        return _run(args, bench, cell, work, t0, require_cuda, server_cmd, server_env,
                    config_overrides, workers, root, cache_dir or os.path.join(root, ".scanbench_cache"), out)
    except NoCard as e:
        _log(str(e))
        return 2
    except RunError as e:
        _log(f"run failed: {e}")
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(args, bench, cell, work, t0, require_cuda, server_cmd, server_env, config_overrides, workers,
         root, cache_dir, out) -> int:
    from scanbench import check, mix as mixmod, tracefile
    from scanbench.corpus import prepare
    from scanbench.metrics import reader
    from scanbench.peaks import hbm_bytes_per_s
    from scanbench.record import Done, RunData, parse_stats

    cfg = dict(config_of(bench, cell["config"], root), **(config_overrides or {}))
    mix = mixmod.load(cell["traffic"])
    sock = _socket_path(work)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
               USE_FLAX="0", **(server_env or {}))
    cmd = server_cmd or [sys.executable, "-m", "grab_tpu_torch.server"]
    server = sampler = None
    log_path = os.path.join(work, "server.log")
    try:
        with open(log_path, "wb") as logf:
            server = subprocess.Popen(cmd + [sock], cwd=root, env=env, stdout=logf, stderr=logf,
                                      start_new_session=True)
        t = time.perf_counter()
        corpus = prepare(cfg, args.seed, cache_dir)
        _log(f"corpus: {len(corpus.files)} files, {corpus.total_bytes} bytes, ready in "
             f"{time.perf_counter() - t:.1f} s; {sum(corpus.planted.values())} strings planted")
        if require_cuda:  # torch's import overlaps the server's start
            cards = _count_cards()
            if not cards["available"] or cards["count"] < int(cell["chips"]):
                raise NoCard(f"needs {cell['chips']} CUDA card(s): torch.cuda.is_available() is "
                             f"{cards['available']}, {cards['count']} visible")
            sampler = _MemorySampler(os.path.join(work, "memory.csv"))
        seq = mixmod.sequence(mix, corpus, args.seed)
        while not os.path.exists(sock):
            if server.poll() is not None:
                with open(log_path, "rb") as f:
                    tail = f.read()[-3000:].decode(errors="replace")
                raise RunError(f"the server exited with {server.returncode}: {tail}")
            if time.perf_counter() - t0 > SERVER_START_S:
                raise RunError(f"the server's socket did not appear in {SERVER_START_S} s")
            time.sleep(0.05)
        _log(f"server up {time.perf_counter() - t0:.1f} s after the start")
        traces = os.path.join(work, "traces")

        def argv_of(req, i):
            if not args.trace:
                return list(req.argv)
            return ["--stats", "--trace", os.path.join(traces, str(i))] + list(req.argv)

        for i, req in enumerate(mixmod.warmups(mix, corpus, seq)):
            rc, _, err, lat = _request(sock, argv_of(req, f"w{i}"))
            if rc != 0:
                raise RunError(f"warm-up request {req.argv[:-1]} exited {rc}: {err[-2000:].decode(errors='replace')}")
        shutil.rmtree(traces, ignore_errors=True)

        done: list = []
        t_start = time.perf_counter()
        setup_s = t_start - t0
        i = 0
        while time.perf_counter() - t_start < args.seconds:
            req = seq[i % len(seq)]
            rc, o, e, lat = _request(sock, argv_of(req, i))
            done.append((req, Done(req.argv, req.nbytes, lat, rc, o, e)))
            i += 1
            if rc is None and server.poll() is not None:
                break
        window_s = time.perf_counter() - t_start
        _log(f"window: {len(done)} requests in {window_s:.3f} s, set-up {setup_s:.3f} s; latencies (s) "
             f"{[round(d.latency_s, 4) for _, d in done[:40]]}")
    finally:
        _kill_group(server)
        peak = sampler.stop() if sampler is not None else 0

    kind = "cpu"
    if require_cuda:
        import torch

        kind = torch.cuda.get_device_name(0)
    if args.trace:
        for i, (req, d) in enumerate(done):
            d.stats = parse_stats(d.stderr)
            path = os.path.join(traces, str(i), "trace.json")
            if os.path.exists(path):
                d.trace = tracefile.read(path)
                shutil.rmtree(os.path.dirname(path), ignore_errors=True)

    t = time.perf_counter()
    want = check.expected(check.chosen([r for r, _ in done], int(mix.get("check_sample", 0)), args.seed),
                          workers or check.default_workers())
    counts, compared = check.compare(done, want)
    correct = check.passed(counts, compared)
    _log(f"reference: {len(want)} distinct requests in {time.perf_counter() - t:.1f} s")

    data = RunData([d for _, d in done], setup_s, window_s, kind, hbm_bytes_per_s(kind))
    metrics = {}
    for m in metrics_for(bench, cell["name"], bool(args.trace)):
        v = reader(m["name"])(data)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if require_cuda else "cpu", "kind": kind, "count": int(cell["chips"]),
              "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(done), "failed": sum(1 for _, d in done if d.rc != 0),
              "metrics": metrics, "device": device}
    if args.trace:
        ts = [d for _, d in done if d.trace is not None]
        device["busy_s"] = sum(d.trace.busy_us for d in ts) / 1e6
        device["window_s"] = window_s
        result["breakdown"] = _breakdown(ts)

    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if loaded:
        _log(f"the benchmark's process holds {loaded} after the window: refused")
        return 3
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in counts.items()}
    _log(f"device: {kind}, power limit {_smi('power.limit') if require_cuda else 'n/a'}")
    _log(f"requests compared with the reference: {compared} of {len(done)}")
    for k, v in counts.items():
        print(f"check {k} {v} limit {check.LIMITS[k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


def _breakdown(done) -> dict:
    ops, gaps = {}, {}
    outside = 0.0
    for d in done:
        for k, v in d.trace.ops_us.items():
            ops[k] = ops.get(k, 0.0) + v / 1e6
        for k, v in d.trace.gaps_us.items():
            gaps[k] = gaps.get(k, 0.0) + v / 1e6
        outside += max(0.0, d.latency_s - d.trace.window_us / 1e6)
    gaps["outside the traced scan (request, pattern compile, Engine build)"] = outside
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}
