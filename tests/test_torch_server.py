"""The port's scan server on the CPU: the round trip of
tests/test_cli.py::test_server_roundtrip against grab_tpu_torch.server
on a thread, its scanner cache, and the protocol's failure paths.
Stdout through the server must equal the direct CLI's and the JAX
package's byte for byte (tolerance: exact).
"""

import io
import json
import os
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest

from grab_tpu import cli as ref_cli
from grab_tpu_torch import cli as port_cli
from grab_tpu_torch import server as server_mod
from grab_tpu_torch.engine import EngineConfig
from grab_tpu_torch.scan_pipeline import DeviceScanner

CPU4 = "cpu,cpu,cpu,cpu"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", CPU4)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("srvtree")
    rng = np.random.default_rng(31)
    (root / "sub").mkdir()
    for i, n in enumerate((40_000, 90_000, 300_000)):
        data = bytearray(rng.integers(97, 123, size=n, dtype=np.uint8))
        for p in range(0, n, 97):
            data[p] = 0x0A
        for p in range(500, n - 40, 7919):
            data[p : p + 8] = b"needle%02d" % i
        (root / ("sub" if i % 2 else ".") / f"f{i}.txt").write_bytes(bytes(data))
    (root / "pats.txt").write_bytes(b"needle00\nneedle02\nlongliteral07\n[0-9]{2}\\n\n")
    return root


@pytest.fixture(scope="module")
def sock(tmp_path_factory):
    """The server on a daemon thread (warm=False: nothing to warm on
    the CPU), as tests/test_cli.py starts the reference's."""
    path = str(tmp_path_factory.mktemp("srv") / "s.sock")
    t = threading.Thread(target=server_mod.serve, args=(path,), kwargs={"warm": False},
                         daemon=True)
    t.start()
    for _ in range(200):
        if os.path.exists(path):
            break
        time.sleep(0.05)
    assert os.path.exists(path), "the server did not start"
    return path


def _direct(cli, argv):
    out, err = io.BytesIO(), io.StringIO()
    rc = cli.main(list(argv), out=out, err=err)
    return rc, out.getvalue(), err.getvalue()


def _via(sock, argv, monkeypatch, entry=server_mod.client):
    """Run the client with stdout and stderr captured."""
    buf = io.BytesIO()

    class FakeStdout:
        buffer = buf

        @staticmethod
        def flush():
            pass

    err = io.StringIO()
    monkeypatch.setattr(sys, "stdout", FakeStdout())
    monkeypatch.setattr(sys, "stderr", err)
    try:
        rc = entry(sock, argv)
    finally:
        monkeypatch.undo()
        monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", CPU4)
    return rc, buf.getvalue(), err.getvalue()


ROUND_TRIPS = [
    ["-r", "-l", "-O", "needle"],
    ["-r", "needle0[0-9]"],
    ["-n", "4", "-r", "-O", "needle01"],
    ["-r", "-H", "-O", "@pats"],
    ["-r", "-S", "zQx##missing##"],
]


@pytest.mark.parametrize("argv", ROUND_TRIPS, ids=" ".join)
def test_server_roundtrip(sock, tree, monkeypatch, argv):
    argv = [str(tree / "pats.txt") if a == "@pats" else a for a in argv] + [str(tree)]
    rc, via, _ = _via(sock, argv, monkeypatch)
    rc_d, direct, _ = _direct(port_cli, argv)
    rc_r, ref, _ = _direct(ref_cli, argv)
    assert rc == rc_d == rc_r == 0
    assert via == direct == ref
    assert bool(via) == ("missing" not in argv[-2])
    # a second request reuses the cached scanner
    rc2, via2, _ = _via(sock, argv, monkeypatch)
    assert rc2 == 0 and via2 == via


def test_via_flag_routes_through_server(sock, tree, monkeypatch):
    argv = ["-r", "-O", "needle02", str(tree)]
    rc, via, _ = _via(sock, argv, monkeypatch,
                      entry=lambda s, a: port_cli.main(["--via", s] + a))
    assert (rc, via) == _direct(port_cli, argv)[:2] and via
    assert _direct(port_cli, ["--via"])[0] == 255


def test_nonexistent_path_through_server(sock, tree, monkeypatch):
    argv = ["-S", "needle", str(tree / "nope")]
    rc, out, err = _via(sock, argv, monkeypatch)
    want = _direct(port_cli, argv)
    assert (rc, out) == want[:2] == (255, b"")
    assert err == want[2] and "stat" in err


def test_usage_and_refusals_through_server(sock, tree, monkeypatch):
    rc, out, _ = _via(sock, ["needle"], monkeypatch)
    assert (rc, out) == _direct(port_cli, ["needle"])[:2] and rc == 1
    # multi-host is served now (ROADMAP A11); without a coordinator the
    # request fails at once, before any store starts, and the server goes on
    rc, out, err = _via(sock, ["--hosts", "2", "-r", "needle", str(tree)], monkeypatch)
    assert rc == 255 and out == b"" and "coordinator" in err
    rc, out, err = _via(sock, ["--via", sock, "-r", "needle", str(tree)], monkeypatch)
    assert rc == 255 and out == b"" and "--via" in err
    rc, out, err = _via(sock, ["-r", "(unclosed", str(tree)], monkeypatch)
    assert rc == 255 and "compile error" in err


@pytest.mark.parametrize("line", [b"not json\n", b'{"no_argv": 1}\n', b'{"argv": "needle"}\n',
                                  b'{"argv": [1, 2]}\n', b"[]\n"])
def test_malformed_request_gets_255(sock, line):
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(20)
    conn.connect(sock)
    conn.sendall(line)
    data = b""
    while len(data) < 8:
        chunk = conn.recv(64)
        if not chunk:
            break
        data += chunk
    conn.close()
    assert struct.unpack("!II", data) == (0, 255)


def test_server_survives_a_client_that_hangs_up(sock, tree, monkeypatch):
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.connect(sock)
    conn.sendall(json.dumps({"argv": ["-r", "needle", str(tree)]}).encode() + b"\n")
    conn.close()  # gone before the answer
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.connect(sock)
    conn.close()  # gone before the request
    argv = ["-r", "-l", "needle", str(tree)]
    rc, via, _ = _via(sock, argv, monkeypatch)
    assert (rc, via) == _direct(port_cli, argv)[:2] and via


def test_cache_keys_scanners():
    """The same (patterns, mode, buffer, devices, shards) gets the same
    scanner and builds no second one; another shard count, device list,
    buffer size, mode or pattern set gets its own."""
    cache = server_mod._EngineCache()

    def eng(pats=(b"needleXY",), **kw):
        kw.setdefault("device", CPU4)
        return cache.engine_for(list(pats), EngineConfig(**kw))

    a, b = eng(), eng()
    assert a is not b and a._scanner is b._scanner and isinstance(a._scanner, DeviceScanner)
    assert a.compiled is not b.compiled  # the patterns are compiled per request
    n2, n2b, n4 = eng(n_shards=2), eng(n_shards=2), eng(n_shards=4)
    assert isinstance(n2._scanner, DeviceScanner) and len(n2._scanner.lanes) == 2
    assert n2._scanner is n2b._scanner and n2._scanner is not a._scanner
    assert len(n4._scanner.lanes) == 4 and n4._scanner is not n2._scanner
    assert eng(n_shards=999)._scanner is n4._scanner  # capped: the same effective shards
    assert eng(device="cpu")._scanner is not a._scanner
    assert eng(device="cpu", n_shards=4)._scanner is eng(device="cpu")._scanner
    assert eng(scan_buf_size=64 << 10)._scanner is not a._scanner
    assert eng(mode="literal")._scanner is not a._scanner
    assert eng(pats=(b"needleXY", b"other"))._scanner is not a._scanner
    assert len(cache._scanners) == 7
    # no scanner, nothing cached: a host-only engine, a pattern the device cannot serve
    assert eng(device="none")._scanner is None
    assert eng(pats=(b"(needle)",))._scanner is None
    assert len(cache._scanners) == 7
    out = []
    b.scan_data("f", b"xx needleXY yy\n" * 50, out.append)
    assert b"".join(out).count(b"needleXY") >= 1


def test_cached_plans_share_the_device_lane(monkeypatch):
    """Two plans cached on one device fill the same slot buffers: the
    lane's, not the plan's. A stream started while another is
    unfinished gets a lane of its own, and the first lane serves again
    once that stream has ended."""
    from grab_tpu_torch import scan_pipeline
    from grab_tpu_torch.scan_pipeline import CorpusPipeline

    monkeypatch.setattr(scan_pipeline, "_LANES", {})
    claimed = []
    claim = DeviceScanner.claim

    def tap(sc, lane):
        slot = claim(sc, lane)
        claimed.append((sc, lane, slot.buf.ctypes.data))
        return slot

    monkeypatch.setattr(DeviceScanner, "claim", tap)
    cache = server_mod._EngineCache()
    cfg = dict(device="cpu", scan_buf_size=64 << 10)
    a = cache.engine_for([b"needleXY"], EngineConfig(**cfg))
    b = cache.engine_for([rb"[A-Z]{6}[0-9]{6}"], EngineConfig(**cfg))
    assert a._scanner is not b._scanner and (a._scanner.mode, b._scanner.mode) == (
        "literal", "class_seq")
    files = [(f"f{i}", b"xx needleXY QWERTY123456 yy\n" * 8000) for i in range(2)]
    for eng in (a, b):
        out = []
        eng.scan_corpus(iter(files), out.append)
        assert b"".join(out).count(b"\n") == 16000
    bufs = {sc: {p for s, _l, p in claimed if s is sc} for sc in (a._scanner, b._scanner)}
    assert len(bufs[a._scanner]) == 2 and bufs[a._scanner] == bufs[b._scanner]
    first = claimed[0][1]
    assert all(lane is first for _s, lane, _p in claimed)

    claimed.clear()
    held = CorpusPipeline(a._scanner).run(iter(files))
    next(held)  # the first file is out, the second not yet: the stream holds its lane
    assert claimed[-1][1] is first
    list(CorpusPipeline(b._scanner).run(iter(files)))
    assert claimed[-1][1] is not first and claimed[-1][2] not in bufs[a._scanner]
    list(held)  # the stream ends and hands its lane back
    list(CorpusPipeline(b._scanner).run(iter(files)))
    assert claimed[-1][1] is first


def test_warm_is_a_no_op_without_cuda_devices(monkeypatch):
    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", "cpu")
    server_mod._warm()
    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", "none")
    server_mod._warm()


def test_warm_failure_stops_the_start(monkeypatch, tmp_path):
    """On a CUDA setting a warm-up that cannot run is an error, not a
    warning: here there is no card at all."""
    import torch

    from grab_tpu_torch.scan_pipeline import DeviceUnavailable

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", "cuda")
    path = str(tmp_path / "never.sock")
    with pytest.raises(DeviceUnavailable):
        server_mod.serve(path)
    assert not os.path.exists(path)
