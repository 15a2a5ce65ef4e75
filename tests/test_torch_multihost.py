"""The port's multi-host scan against the JAX package's, on the CPU.

Mirrors tests/test_multihost.py with the port's torch.distributed
transport (host 0's TCPStore and a gloo process group): two processes on
localhost, GRAB_TPU_TORCH_DEVICE=cpu, a free port each run. Host 0's
stdout must equal the reference's single-process CLI byte for byte
(tolerance: exact), host 1's must be empty, and the summed count must be
the reference's. Every subprocess has a time limit and is killed on
expiry; GRAB_TPU_KV_TIMEOUT_MS bounds a wait on a peer that never
arrives to a minute.
"""

import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from grab_tpu import cli as ref_cli
from grab_tpu_torch.parallel import hostrun, multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(devices: str = "cpu") -> dict:
    env = dict(os.environ, GRAB_TPU_TORCH_DEVICE=devices, GRAB_TPU_KV_TIMEOUT_MS="60000",
               PYTHONPATH=REPO)
    for k in ("JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "JAX_COORDINATOR_ADDRESS"):
        env.pop(k, None)
    return env


def _run_hosts(argvs, env):
    """Start one process per argv, together; → [(rc, stdout, stderr)]."""
    procs = [
        subprocess.Popen(a, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=REPO)
        for a in argvs
    ]
    res = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            res.append((p.returncode, out, err.decode(errors="replace")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return res


def _ref(argv):
    out, err = io.BytesIO(), io.StringIO()
    rc = ref_cli.main(list(argv), out=out, err=err)
    assert rc == 0, err.getvalue()
    return out.getvalue()


def _write_corpus(root, seed, needle=b"needleXY"):
    root.mkdir()
    rng = np.random.default_rng(seed)
    offs = {}
    for i in range(6):
        n = 20_000 + 1000 * i
        b = bytearray(rng.integers(32, 127, size=n, dtype=np.uint8).tobytes())
        pos = 500 + 777 * i
        b[pos : pos + len(needle)] = needle
        offs[i] = pos
        (root / f"f{i:02d}.txt").write_bytes(bytes(b))
    return offs


LIB_WORKER = r"""
import os, sys
pid, n, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
from grab_tpu_torch.parallel import multihost
assert multihost.init_distributed(f"127.0.0.1:{port}", n, pid) == (pid, n)
assert multihost.init_distributed(f"127.0.0.1:{port}", n, pid) == (pid, n)  # once
entries = [f"file{i}" for i in range(6)]
mine = multihost.host_shard(entries, pid, n)
assert [i for i, _ in mine] == list(range(pid, 6, n))
total = multihost.psum_total(sum(i for i, _ in mine))
for i, name in mine:
    with open(os.path.join(outdir, f"{pid}.{i}.out"), "wb") as f:
        f.write(f"{name}\n".encode())
# the chunked point-to-root transport: 5 MiB + 3 bytes is three chunks
blob = bytes([pid + 1]) * (5 * (1 << 20) + 3)
got = multihost.gather_blobs_to_root(blob, multihost.next_run_tag(), n)
if pid == 0:
    assert [len(b) for b in got] == [len(blob)] * n
    assert [set(b) for b in got] == [{h + 1} for h in range(n)]
else:
    assert got is None
walk = multihost.broadcast_blob(b"a\x00b" if pid == 0 else None, multihost.next_run_tag())
assert walk == b"a\x00b"
multihost.psum_total(0)  # a last collective: host 0's store outlives every get
print("TOTAL", total, flush=True)
"""


def test_two_process_distributed_psum_and_merge(tmp_path):
    port = _free_port()
    res = _run_hosts(
        [[sys.executable, "-c", LIB_WORKER, str(pid), "2", str(port), str(tmp_path)]
         for pid in range(2)],
        _env(),
    )
    for rc, out, err in res:
        assert rc == 0, err[-2000:]
        assert b"TOTAL 15" in out, out
    chunks = []
    assert multihost.merge_host_outputs(str(tmp_path), chunks.append) == 6
    assert b"".join(chunks) == b"".join(f"file{i}\n".encode() for i in range(6))


E2E_WORKER = r"""
import os, sys
pid, n, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
from grab_tpu_torch.parallel import multihost
from grab_tpu_torch.engine import Engine, EngineConfig
from grab_tpu_torch.format.emitter import OutputConfig

multihost.init_distributed(f"127.0.0.1:{port}", n, pid)
corpus = os.path.join(outdir, "corpus")
names = sorted(os.listdir(corpus))                 # deterministic global walk
mine = multihost.host_shard(names, pid, n)
cfg = EngineConfig(
    output=OutputConfig(print_offset=True, print_line=False, recursive=True),
    mode="literal", device="cpu",
)
eng = Engine([b"needleXY"], cfg)
local_matches = 0
for i, name in mine:
    chunks = []
    eng.scan_file(os.path.join(corpus, name), chunks.append)
    out = b"".join(chunks)
    local_matches += out.count(b"Match at offset")
    with open(os.path.join(outdir, f"{pid}.{i}.out"), "wb") as f:
        f.write(out)
total = multihost.psum_total(local_matches)        # barrier + global count
print("TOTAL", total, flush=True)
if pid == 0:
    merged = []
    multihost.merge_host_outputs(outdir, merged.append)
    sys.stdout.buffer.write(b"".join(merged))
    sys.stdout.flush()
multihost.psum_total(0)
"""


def test_two_process_e2e_scan_psum_ordered_merge(tmp_path):
    corpus = tmp_path / "corpus"
    offs = _write_corpus(corpus, 5)
    port = _free_port()
    res = _run_hosts(
        [[sys.executable, "-c", E2E_WORKER, str(pid), "2", str(port), str(tmp_path)]
         for pid in range(2)],
        _env(),
    )
    for rc, out, err in res:
        assert rc == 0, err[-2000:]
        assert b"TOTAL 6" in out
    # host 0 printed the globally ordered merge: one offset line per
    # file, in global file order regardless of which host scanned it
    merged = res[0][1].split(b"TOTAL 6\n", 1)[1]
    want = b"".join(
        f"{corpus}/f{i:02d}.txt:Match at offset {offs[i]}\n".encode() for i in range(6)
    )
    assert merged == want, merged[:200]


def _cli_hosts(argv, n_hosts=2, devices="cpu"):
    port = _free_port()
    return _run_hosts(
        [[sys.executable, "-m", "grab_tpu_torch.cli", "--hosts", str(n_hosts), "--pid",
          str(pid), "--coordinator", f"127.0.0.1:{port}"] + argv
         for pid in range(n_hosts)],
        _env(devices),
    )


@pytest.mark.parametrize(
    "flags,devices",
    [
        (["-O", "-l", "-S", "needleXY"], "cpu"),
        (["-n", "2", "-O", "-l", "-S", "needleXY"], "cpu,cpu"),  # two lanes per host
        (["-O", "needle[A-Z]{2}"], "cpu"),
    ],
    ids=["literal", "n2", "regex"],
)
def test_two_tpugrep_cli_processes(tmp_path, flags, devices):
    """Config 5 as ONE command per host: two real port CLI processes;
    host 0's stdout equals the reference's single-process run byte for
    byte (the reference's own test shows its two-process run prints the
    same), host 1 prints nothing, and --stats gives the summed count."""
    corpus = tmp_path / "corpus"
    _write_corpus(corpus, 7)
    single = _ref(["-r"] + flags + [str(corpus)])
    assert single.count(b"needleXY") + single.count(b"Match at offset") >= 6
    res = _cli_hosts(["--stats", "-r"] + flags + [str(corpus)], devices=devices)
    for rc, _out, err in res:
        assert rc == 0, err[-2000:]
    assert res[0][1] == single, res[0][1][:300]
    assert res[1][1] == b""  # only host 0 emits
    n_lines = single.count(b"\n")
    assert f"{n_lines} match lines across 2 hosts" in res[0][2]
    assert "match lines" not in res[1][2]


RUN_WORKER = r"""
import io, json, os, sys
pid, port, corpus, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
from grab_tpu_torch.engine import Engine, EngineConfig
from grab_tpu_torch.format.emitter import OutputConfig
from grab_tpu_torch.parallel import hostrun, multihost

def run(pattern, mode="literal", **kw):
    cfg = EngineConfig(output=OutputConfig(print_offset=True, print_line=False),
                       mode=mode, device="cpu")
    out, err = [], io.StringIO()
    rc = hostrun.run_multihost(Engine([pattern], cfg), corpus, out.append, err=err,
                               coordinator=f"127.0.0.1:{port}", num_processes=2,
                               process_id=pid, **kw)
    return {"rc": rc, "out": b"".join(out).decode(), "err": err.getvalue(),
            "seq": multihost._run_seq}

runs = [run(b"needleXY"), run(b"[0-9]{3}qq", "pcre1")]
if sys.argv[5] == "cap":
    hostrun.GATHER_CAP = 0
    runs += [run(b"needleXY", outdir=outdir), run(b"needleXY")]
print(json.dumps(runs))
"""


@pytest.mark.parametrize("what", ["lockstep", "cap"])
def test_run_multihost_in_one_session(tmp_path, what):
    """Several run_multihost calls in one pair of processes: the
    run-unique tags advance in lockstep, so each call reads its own
    keys (two patterns, two correct and distinct outputs, no stale
    read). With GATHER_CAP = 0 every host takes the fallback: with
    --outdir host 0 prints what the gather route printed; without it
    every host exits 255 with the reference's line."""
    corpus = tmp_path / "corpus"
    _write_corpus(corpus, 9)
    (corpus / "g.txt").write_bytes(b"x 123qq y\n" * 3 + b"needleXY\n")
    port = _free_port()
    res = _run_hosts(
        [[sys.executable, "-c", RUN_WORKER, str(pid), str(port), str(corpus),
          str(tmp_path / "pieces"), what] for pid in range(2)],
        _env(),
    )
    for rc, _out, err in res:
        assert rc == 0, err[-2000:]
    runs = [json.loads(out) for _rc, out, _err in res]
    for i, pattern in enumerate([b"needleXY", b"[0-9]{3}qq"]):
        flags = ["-S"] if i == 0 else []
        want = _ref(["-r", "-O", "-l"] + flags + [pattern.decode(), str(corpus)])
        assert runs[0][i]["out"].encode() == want and want
        assert runs[1][i]["out"] == "" and runs[0][i]["rc"] == runs[1][i]["rc"] == 0
        assert runs[0][i]["seq"] == runs[1][i]["seq"]  # the tags agree
    assert runs[0][0]["out"] != runs[0][1]["out"]
    assert runs[0][1]["seq"] > runs[0][0]["seq"]
    if what == "cap":
        assert runs[0][2]["out"] == runs[0][0]["out"] and runs[1][2]["out"] == ""
        assert sorted(os.listdir(tmp_path / "pieces"))  # the shared-dir pieces
        line = ("tpugrep: output exceeds the gather cap and no --outdir given for the "
                "shared-directory fallback\n")
        for r in (runs[0][3], runs[1][3]):
            assert (r["rc"], r["out"], r["err"]) == (255, "", line)


def test_one_host_run_equals_reference(tmp_path):
    """--hosts 1: the session of one host (its own store) prints what
    the reference's single-process run prints."""
    corpus = tmp_path / "corpus"
    _write_corpus(corpus, 11)
    (rc, out, err), = _cli_hosts(["-r", "-O", "needleXY", str(corpus)], n_hosts=1)
    assert rc == 0, err[-2000:]
    assert out == _ref(["-r", "-O", "needleXY", str(corpus)])


@pytest.mark.parametrize("host", [0, 1, 2])
def test_host_entries_stripe(tmp_path, host):
    """Each host lstat's only its own round-robin stripe of the global
    list, keeps global indices, and reports a vanished file without
    stopping (no store is touched when the names are given)."""
    names = []
    for i in range(7):
        p = tmp_path / f"f{i}"
        p.write_bytes(b"x" * i)
        names.append(str(p))
    names.insert(4, str(tmp_path / "gone"))
    mine, n_stats = hostrun.host_entries(str(tmp_path), host, 3, names=names)
    want = [(g, names[g], g - (g > 4)) for g in range(host, 8, 3) if g != 4]
    assert mine == want and n_stats == len(want)


def test_host_entries_one_host_walks(tmp_path):
    """One host walks the tree itself, in the walker's order."""
    from grab_tpu_torch.ingest.walker import walk_files

    _write_corpus(tmp_path / "c", 3)
    (tmp_path / "c" / "sub").mkdir()
    (tmp_path / "c" / "sub" / "z").write_bytes(b"z")
    mine, n = hostrun.host_entries(str(tmp_path / "c"), 0, 1)
    assert [(p, s) for _g, p, s in mine] == [(e.path, e.size) for e in walk_files(str(tmp_path / "c"))]
    assert [g for g, _p, _s in mine] == list(range(n)) and n == 7


def test_kv_timeout_and_tags(monkeypatch):
    monkeypatch.delenv("GRAB_TPU_KV_TIMEOUT_MS", raising=False)
    assert multihost._kv_timeout_ms(None) == 600_000
    assert multihost._kv_timeout_ms(5) == 5
    monkeypatch.setenv("GRAB_TPU_KV_TIMEOUT_MS", "1234")
    assert multihost._kv_timeout_ms(None) == 1234
    a, b = multihost.next_run_tag(), multihost.next_run_tag("x")
    assert a.startswith("tg") and b == f"x{int(a[2:]) + 1}"
    assert multihost._KV_CHUNK == 2 << 20


def test_init_needs_all_three_settings(monkeypatch):
    """Without a coordinator (argument or JAX_COORDINATOR_ADDRESS) no
    store is started: the call raises at once instead of waiting."""
    for k in ("JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        multihost.init_distributed(None, None, 0)
    with pytest.raises(ValueError, match="outside"):
        multihost.init_distributed("127.0.0.1:1", 2, 2)
    assert multihost._SESSION is None
