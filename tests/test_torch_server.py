"""The port's scan server on the CPU: the round trip of
tests/test_cli.py::test_server_roundtrip against grab_tpu_torch.server
on a thread, its scanner cache, and the protocol's failure paths.
Stdout through the server must equal the direct CLI's and the JAX
package's byte for byte (tolerance: exact).
"""

import io
import json
import os
import re
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
    buffer size, mode or pattern set gets its own. The same patterns and
    mode get the same compiled unit; another mode compiles anew."""
    cache = server_mod._EngineCache()

    def eng(pats=(b"needleXY",), **kw):
        kw.setdefault("device", CPU4)
        return cache.engine_for(list(pats), EngineConfig(**kw))

    a, b = eng(), eng()
    assert a is not b and a._scanner is b._scanner and isinstance(a._scanner, DeviceScanner)
    assert a.compiled is b.compiled  # the server keeps the compiled patterns
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
    assert eng(mode="pcre2").compiled is not a.compiled  # another mode compiles anew
    out = []
    b.scan_data("f", b"xx needleXY yy\n" * 50, out.append)
    assert b"".join(out).count(b"needleXY") >= 1


@pytest.fixture
def ctype_tables():
    """The regex ctype module, its active tables put back afterwards."""
    from grab_tpu_torch.regex import ctype

    saved = ctype.active()
    yield ctype
    ctype.set_tables(saved)


def _unit_cache_engine(cache, pats=(rb"foo[a-z]+bar",), **kw):
    kw.setdefault("device", "none")
    return cache.engine_for(list(pats), EngineConfig(**kw))


KEY_CHANGES = {
    "mode": dict(mode="pcre2"),
    "pcre1_quirks": dict(pcre1_quirks=False),
    "patterns": dict(pats=(rb"foo[a-z]+bar", b"needle")),
    "pattern order": dict(pats=(b"needle", rb"foo[a-z]+bar")),
}


@pytest.mark.parametrize("change", list(KEY_CHANGES) + ["ctype tables"])
def test_compile_cache_keys_what_the_compile_reads(change, ctype_tables):
    """The same patterns, mode, quirk setting and ctype tables get the
    same compiled unit, counted as a hit; a change to any of them
    compiles its own, counted as a miss."""
    ctype_tables.set_tables(None)
    cache = server_mod._EngineCache()
    a, b = _unit_cache_engine(cache), _unit_cache_engine(cache)
    assert a.unit is b.unit and a.compiled is b.compiled and a._exact is b._exact
    assert (a.stats.compiled, b.stats.compiled) == ("miss", "hit")
    if change == "ctype tables":
        ctype_tables.set_tables(ctype_tables.libc_tables())
        c = _unit_cache_engine(cache)
    else:
        c = _unit_cache_engine(cache, **KEY_CHANGES[change])
    assert c.unit is not a.unit and c.stats.compiled == "miss"
    assert (cache.compile_hits, cache.compile_misses) == (1, 2)
    assert len(cache._compiled) == 2


def test_compile_cache_ignores_what_the_compile_does_not_read(ctype_tables):
    """Buffer size, devices and shard count are the plan's, not the
    compile's: one unit serves them all, a host-only request included."""
    ctype_tables.set_tables(None)
    cache = server_mod._EngineCache()
    host = _unit_cache_engine(cache)
    others = [
        _unit_cache_engine(cache, device="cpu"),
        _unit_cache_engine(cache, device=CPU4, n_shards=4),
        _unit_cache_engine(cache, device="cpu", scan_buf_size=64 << 10),
    ]
    assert host._scanner is None and all(e._scanner is not None for e in others)
    assert all(e.unit is host.unit and e.stats.compiled == "hit" for e in others)
    assert (cache.compile_hits, cache.compile_misses) == (3, 1)


def test_compile_cache_evicts_the_least_recently_used(monkeypatch, ctype_tables):
    ctype_tables.set_tables(None)
    monkeypatch.setattr(server_mod, "COMPILED_CAP", 2)
    cache = server_mod._EngineCache()
    first = _unit_cache_engine(cache, pats=(b"one",)).unit
    second = _unit_cache_engine(cache, pats=(b"two",)).unit
    assert _unit_cache_engine(cache, pats=(b"one",)).unit is first  # now the newest
    _unit_cache_engine(cache, pats=(b"three",))
    assert len(cache._compiled) == 2
    assert _unit_cache_engine(cache, pats=(b"one",)).unit is first
    again = _unit_cache_engine(cache, pats=(b"two",))
    assert again.stats.compiled == "miss" and again.unit is not second
    assert (cache.compile_hits, cache.compile_misses) == (2, 4)


@pytest.fixture(scope="module")
def batch_tree(tmp_path_factory):
    """A small tree with plants of a -H batch: a literal, a regex with a
    literal factor, and a regex with none (a class-gated matcher)."""
    root = tmp_path_factory.mktemp("batchtree")
    rng = np.random.default_rng(7)
    (root / "sub").mkdir()
    plants = [b"needle07", b"fooqqbar", b"555-0123", b"call 867-5309 now"]
    for i, n in enumerate((30_000, 70_000, 120_000)):
        data = bytearray(rng.integers(97, 123, size=n, dtype=np.uint8))
        data[::97] = b"\n" * len(data[::97])
        for k, p in enumerate(range(300 + 41 * i, n - 40, 6011)):
            plant = plants[(i + k) % len(plants)]
            data[p : p + len(plant)] = plant
        (root / ("sub" if i % 2 else ".") / f"f{i}.txt").write_bytes(bytes(data))
    (root / "batch.txt").write_bytes(b"needle07\nfoo[a-z]+bar\n[0-9]{3}-[0-9]{4}\n")
    return root


def test_cached_batch_prints_what_an_uncached_engine_prints(batch_tree):
    """Two identical -H requests through one cache: the second takes the
    first's compiled unit, and both print the uncached Engine's stdout
    byte for byte and its seqgate= counts."""
    argv = ["--stats", "-r", "-O", "-H", str(batch_tree / "batch.txt"), str(batch_tree)]
    rc, direct, derr = _direct(port_cli, argv)
    assert rc == 0 and b"555-0123" in direct and b"fooqqbar" in direct
    gate = re.compile(r" compiled=(\w+) seqgate=(\d+/\d+) ")
    want = gate.search(derr)
    assert want[1] == "none" and want[2] != "0/0"
    cache = server_mod._EngineCache()
    for request, kind in ((1, "miss"), (2, "hit")):
        out, err = io.BytesIO(), io.StringIO()
        assert server_mod._run_with_cache(argv, cache, out, err, request) == 0
        assert out.getvalue() == direct
        got = gate.search(err.getvalue())
        assert (got[1], got[2]) == (kind, want[2])


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
