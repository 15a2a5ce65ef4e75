"""Scan server: a long-running daemon with warm device scanners.

The reference is a one-shot CLI; re-running it costs one pcre_compile
(~µs). Here every process pays for the CUDA context, the kernels' build
(or load) and, for a -H batch, the patterns' compile and the scanner's
tables before the first byte is scanned, so production serving keeps
one process alive:

    python -m grab_tpu_torch.server /tmp/tpugrep.sock   # start daemon
    tpugrep --via /tmp/tpugrep.sock -r <regex> <path>   # fast client

Protocol (unix stream socket):
    request:  one JSON line {"argv": [...]}
    response: length-prefixed frames — [u32 len][payload]... for stdout
              bytes, [u32 0][u32 exit_code] to finish; stderr text
              travels as frames tagged by a leading 0x01 byte (stdout
              frames lead with 0x00).

Compiled units (``engine.CompiledUnit``: the patterns' scan unit, the
exact matcher the replay runs and its class-sequence gates) are cached
keyed by what the compile reads: the patterns, the mode, the PCRE1
capture quirk and the active ctype tables (by content). The
``COMPILED_CAP`` most recently used are kept; a host-only request uses
them too. A repeated request therefore skips the compile (seconds for a
large -H batch), and its ``compile`` span reads only the lookup. Plans
(``DeviceScanner``: which kernels, and their tables) are cached keyed by
(patterns, mode, buffer size, device setting, effective shards); output
flags are per-request. The upload rings and streams belong to the device
lanes (``scan_pipeline.Lane``), which every cached plan shares, so a
miss builds tables, not a ring, and the server's memory does not grow
with the plans it has seen. The scan device is the server process's
(GRAB_TPU_TORCH_DEVICE, default cuda). Both caches count their hits and
misses; a request's ``--stats`` line says which it was
(``scanner=hit|miss``, ``none`` for a host-only scan;
``compiled=hit|miss``, ``none`` outside the server), the scanner cache's
running totals (``cache=HITS/MISSES``) and the request's number
(``req=``). Its ``pulls=N`` counts the batches whose flags left the
device, and ``inplace=N`` the batches filled straight into the buffer
the scan reads (the lane's pinned upload slot): every batch, except
where a stride member alone reads the batch (its host transpose into the
slot); ``replay_bytes=N`` the bytes of the candidate windows the host
replay searched; ``seqgate=C/P`` the request's searches of the exact
matchers gated by their class sequences, C settled without the VM and P
handed to it.

The operator's read of the start is the listening line on stderr:

    tpugrep-server: listening on S (start: torch+context 9.54s, kernels 6.81s, warm 0.01s)

``torch+context``: the imports (torch's among them) and the CUDA
context on each card; ``kernels``: the core-word kernel library built
(nvcc, on a checkout's first start) and loaded; ``warm``: ``_warm``'s
launches.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import struct  # noqa: E402
import sys  # noqa: E402
from collections import OrderedDict  # noqa: E402
from typing import Dict, List, Tuple  # noqa: E402

from grab_tpu_torch import cli as cli_mod  # noqa: E402
from grab_tpu_torch.engine import (  # noqa: E402
    CompiledUnit,
    Engine,
    EngineConfig,
    compile_key,
    effective_shards,
)

_IMPORT_S = time.perf_counter() - _T_START


COMPILED_CAP = 64  # compiled units kept; past it the least recently used goes


class _EngineCache:
    def __init__(self):
        self._scanners: Dict[tuple, object] = {}
        self._compiled: "OrderedDict[tuple, CompiledUnit]" = OrderedDict()
        self.hits = 0  # requests served by a cached scanner
        self.misses = 0  # requests that built one
        self.compile_hits = 0  # requests served by a cached compiled unit
        self.compile_misses = 0  # requests that compiled one

    def engine_for(self, patterns: List[bytes], cfg: EngineConfig) -> Engine:
        ckey = compile_key(patterns, cfg)
        unit = self._compiled.get(ckey)
        if unit is not None:
            self._compiled.move_to_end(ckey)
        # shard count and devices are part of the scanner's identity: a
        # 1-shard scanner must not serve a later -n N request
        key = (
            tuple(patterns),
            cfg.mode,
            cfg.scan_buf_size,
            cfg.device,
            effective_shards(cfg),
        )
        cached = self._scanners.get(key)
        eng = Engine(patterns, cfg, scanner=cached, unit=unit)
        if unit is None:
            self._compiled[ckey] = eng.unit
            if len(self._compiled) > COMPILED_CAP:
                self._compiled.popitem(last=False)
            self.compile_misses += 1
            eng.stats.compiled = "miss"
        else:
            self.compile_hits += 1
            eng.stats.compiled = "hit"
        if eng._scanner is not None:
            self._scanners[key] = eng._scanner
            if cached is None:
                self.misses += 1
                eng.stats.scanner = "miss"
            else:
                self.hits += 1
                eng.stats.scanner = "hit"
        eng.stats.cache = (self.hits, self.misses)
        return eng


def _handle(conn: socket.socket, cache: _EngineCache, request: int):
    f = conn.makefile("rb")
    line = f.readline()
    if not line:
        return
    try:
        argv = json.loads(line)["argv"]
        if not isinstance(argv, list) or not all(isinstance(a, str) for a in argv):
            raise ValueError("argv must be a list of strings")
    except (ValueError, KeyError, TypeError):
        conn.sendall(struct.pack("!I", 0) + struct.pack("!I", 255))
        return

    def send_frame(tag: int, payload: bytes):
        conn.sendall(struct.pack("!I", len(payload) + 1) + bytes([tag]) + payload)

    class SockWriter:
        def __init__(self, tag):
            self.tag = tag

        def write(self, data):
            if isinstance(data, str):
                data = data.encode("utf-8", "surrogateescape")
            if data:
                send_frame(self.tag, data)
            return len(data)

        def flush(self):
            pass

        def isatty(self):
            return False

    out_writer = SockWriter(0)
    err_writer = SockWriter(1)

    # streams are passed straight into cli.main — no process-global
    # sys.stdout/sys.stderr swapping, so in-process test clients can't
    # race on the globals
    try:
        rc = _run_with_cache(argv, cache, out_writer, err_writer, request)
    except (BrokenPipeError, ConnectionResetError):
        raise
    except Exception as e:
        err_writer.write(f"tpugrep-server: {e}\n")
        rc = 255
    conn.sendall(struct.pack("!I", 0) + struct.pack("!I", rc & 0xFF))


def _run_with_cache(argv: List[str], cache: _EngineCache, out, err, request: int) -> int:
    """cli.main with the server's scanner cache injected (no module
    globals touched); ``request``: the request's number."""

    def cached_engine(patterns, cfg):
        return cache.engine_for(
            [p if isinstance(p, bytes) else p.encode() for p in patterns], cfg
        )

    if argv[:1] == ["--via"]:
        print("tpugrep-server: --via inside a request", file=err)
        return 255
    return cli_mod.main(argv, out=out, err=err, engine_factory=cached_engine, request=request)


def serve(sock_path: str, warm: bool = True):
    context_s = kernels_s = warm_s = 0.0
    if warm:
        context_s, kernels_s, warm_s = _warm()
    if os.path.exists(sock_path):
        os.unlink(sock_path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    # bind under a temp name and rename only after listen(): clients
    # poll for the path, and a connect between bind and listen gets
    # ECONNREFUSED — the advertised path must always be accept-ready
    tmp = sock_path + ".tmp"
    if os.path.exists(tmp):
        os.unlink(tmp)
    srv.bind(tmp)
    srv.listen(8)
    os.rename(tmp, sock_path)
    print(
        f"tpugrep-server: listening on {sock_path} (start: torch+context "
        f"{_IMPORT_S + context_s:.2f}s, kernels {kernels_s:.2f}s, warm {warm_s:.2f}s)",
        file=sys.stderr,
    )
    cache = _EngineCache()
    request = 0
    while True:
        conn, _ = srv.accept()
        request += 1
        try:
            _handle(conn, cache, request)
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            conn.close()


def _warm() -> Tuple[float, float, float]:
    """Build and load the kernel library and launch the core-word kernel
    for the standard shapes on every CUDA shard device, so the first
    request is fast. A kernel that does not build or launch stops the
    server's start: every request would fail on it. Nothing to warm on
    the CPU. → seconds of (the CUDA contexts, the library's build and
    load, the launches)."""
    import torch

    from grab_tpu_torch import _build
    from grab_tpu_torch.ops.corewords import LANES, PAD_ROWS, CoreWordScanner
    from grab_tpu_torch.scan_pipeline import resolve_devices

    setting = EngineConfig().device  # the process's scan device
    if setting == "none":
        return 0.0, 0.0, 0.0
    devs = [d for d in dict.fromkeys(resolve_devices(setting)) if d.type == "cuda"]
    if not devs:
        return 0.0, 0.0, 0.0
    t0 = time.perf_counter()
    for dev in devs:
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    _build.cuda_library("corewords")
    t2 = time.perf_counter()
    rows = (32 << 20) // 512
    for dev in devs:
        words2d = torch.zeros((rows + PAD_ROWS, LANES), dtype=torch.int32, device=dev)
        # the common production shapes: single long literal (unmasked),
        # single short literal (masked 2-word), a compare bucket of 16
        for lits in (
            [b"warmupwarm"],
            [b"warm"],
            [b"warmup%02d" % i for i in range(16)],
        ):
            CoreWordScanner(lits).packed(words2d)
        torch.cuda.synchronize(dev)
    return t1 - t0, t2 - t1, time.perf_counter() - t2


def client(sock_path: str, argv: List[str]) -> int:
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.connect(sock_path)
    conn.sendall(json.dumps({"argv": argv}).encode() + b"\n")
    stdout = sys.stdout.buffer
    rc = 0
    buf = b""

    def recv_exact(n):
        nonlocal buf
        while len(buf) < n:
            chunk = conn.recv(65536)
            if not chunk:
                raise ConnectionError("server closed early")
            buf += chunk
        out, buf = buf[:n], buf[n:]
        return out

    try:
        while True:
            (length,) = struct.unpack("!I", recv_exact(4))
            if length == 0:
                (rc,) = struct.unpack("!I", recv_exact(4))
                break
            frame = recv_exact(length)
            tag, payload = frame[0], frame[1:]
            if tag == 0:
                stdout.write(payload)
            else:
                err_buf = getattr(sys.stderr, "buffer", None)
                if err_buf is not None:
                    err_buf.write(payload)
                else:  # captured stderr (tests) has no .buffer
                    sys.stderr.write(payload.decode("utf-8", "replace"))
        stdout.flush()
        sys.stderr.flush()
    finally:
        conn.close()
    return rc


if __name__ == "__main__":
    serve(sys.argv[1] if len(sys.argv) > 1 else "/tmp/tpugrep.sock")
