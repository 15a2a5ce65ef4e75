"""The port's CLI against the JAX package's, on the CPU.

Stdout and exit code must be byte-identical to ``grab_tpu.cli.main``
(tolerance: exact) for every in-slice case: the conformance corpus of
tests/test_conformance.py plus a planted corpus whose files are larger
than the 2 MiB CPU scan buffer, so they span batches and their halos.
The port runs with GRAB_TPU_TORCH_DEVICE=cpu: the kernels' plain
PyTorch versions. Every single-device plan is served, -n N caps at the
shard devices and prints what -n 1 prints, --via goes to the scan
server, recursive multi-host (run here as a session of one host in a
subprocess) prints what the reference's single-process run prints, and
multi-host without -r gets the reference's own line.
"""

import io
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from grab_tpu import cli as ref_cli
from grab_tpu_torch import cli as port_cli


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_ENV = ("JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "JAX_COORDINATOR_ADDRESS")


def _run(cli, argv):
    out, err = io.BytesIO(), io.StringIO()
    rc = cli.main(list(argv), out=out, err=err)
    return rc, out.getvalue(), err.getvalue()


def _one_host(argv, by_env=False):
    """The port's CLI as a multi-host session of one host (its own
    store on a free localhost port), in a subprocess so no session stays
    in the test process: by flags (--hosts 1 --pid 0 --coordinator) or by
    the launcher's environment. → (rc, stdout, stderr)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items() if k not in HOST_ENV}
    env.update(GRAB_TPU_TORCH_DEVICE="cpu", GRAB_TPU_KV_TIMEOUT_MS="60000", PYTHONPATH=REPO)
    if by_env:
        env.update(JAX_NUM_PROCESSES="1", JAX_PROCESS_ID="0", JAX_COORDINATOR_ADDRESS=addr)
    else:
        argv = ["--hosts", "1", "--pid", "0", "--coordinator", addr] + list(argv)
    p = subprocess.Popen([sys.executable, "-m", "grab_tpu_torch.cli"] + argv, cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    return p.returncode, out, err.decode(errors="replace")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The conformance corpus (tests/test_conformance.py)."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(77)
    for d in ["src", "src/deep", "docs"]:
        (root / d).mkdir(parents=True)
    texts = {
        "src/main.c": b"int main() { return needle; }\n" * 50,
        "src/deep/util.py": b"def f():\n    pass  # needle here\n" * 30,
        "docs/readme.md": b"nothing to see\n" * 100,
        "empty.txt": b"",
        "oneline": b"needle",
    }
    for name, content in texts.items():
        (root / name).write_bytes(content)
    blob = rng.integers(0, 256, size=65536, dtype=np.uint8)
    blob[4096:4102] = np.frombuffer(b"needle", dtype=np.uint8)
    (root / "src" / "blob.bin").write_bytes(blob.tobytes())
    (root / "long.txt").write_bytes(
        b"x" * 600 + b"needle" + b"y" * 600 + b"\n" + b"short needle line\n"
    )
    (root / "loop").symlink_to(root)
    return root


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """Files larger than the 2 MiB CPU buffer, with needles at batch
    seams: continuation segments restart 4 KiB (the halo) before each
    buffer's end, at file offsets near k * (2 MiB - 4 KiB)."""
    root = tmp_path_factory.mktemp("planted")
    rng = np.random.default_rng(5)
    needles = [b"needleXY", b"linus", b"lmnus", b"fooqbar", b"fooabcbar", b"\xffneedle"]
    (root / "sub").mkdir()
    for name, size in (("a.txt", 5 << 20), ("sub/b.log", (3 << 20) + 777),
                       ("sub/c.txt", 300_000), ("z.bin", (2 << 20) + 4096)):
        data = rng.integers(32, 127, size=size, dtype=np.uint8)
        data[::89] = 0x0A
        stride = (2 << 20) - 0x1000
        spots = [k * stride + d for k in range(1, size // stride + 1)
                 for d in (-7, 3, 0x1000 - 4, 0x1000 + 2)]
        spots += rng.integers(0, size - 16, size=12).tolist()
        for i, p in enumerate(spots):
            lit = needles[i % len(needles)]
            p = min(max(int(p), 0), size - len(lit))
            data[p : p + len(lit)] = np.frombuffer(lit, dtype=np.uint8)
        (root / name).write_bytes(data.tobytes())
    return root


# the conformance CASES: literal plans, and class-sequence plans
# (n[a-z]+e, [0-9]{3}, ...) served by the class_seq mode
CONFORMANCE = [
    ([], "needle"),
    (["-O"], "needle"),
    (["-l", "-O"], "needle"),
    (["-l"], "needle"),
    (["-s"], "needle"),
    ([], "ne+dle"),
    ([], "zzznotfound"),
    (["-O"], r"\bneedle\b"),
    (["-O"], "n[a-z]+e"),
    (["-O"], "[0-9]{3}"),
    ([], "[a-z]{4}[ ;]"),
    (["-O"], "[A-Za-z]{6}"),
    (["-l"], "[xy]{12}"),
]


@pytest.mark.parametrize("flags,pattern", CONFORMANCE,
                         ids=[f"{f}-{p}" for f, p in CONFORMANCE])
def test_conformance_cases_identical(corpus, flags, pattern):
    argv = flags + ["-r", pattern, str(corpus)]
    assert _run(port_cli, argv)[:2] == _run(ref_cli, argv)[:2]


FLAG_CASES = [
    ["-S", "-r", "needle"],
    ["-S", "-r", "ne+dle"],  # a literal in -S mode: no match
    ["-E", "-r", "needle"],
    ["-L", "-r", "-O", "needle"],
    ["-2", "-r", "needle"],
    ["-I", "-r", "needle"],
    ["-R", "-s", "-l", "needle"],
    ["-r", "zQx##missing##"],
    ["-r", "(needle)"],  # PCRE1 capture quirk: host-only, no output
    ["-r", "needle|nothing"],
    ["-S", "-r", "ne"],  # a 2-byte literal is a class-sequence plan
    ["-E", "-r", ".{0,2}[a-z ]{11,}"],  # gdfa, threading fixpoint
    ["-r", "-O", ".{0,2}[a-z ]{11}"],  # gdfa, boundary windows
    ["-E", "-r", "-O", "[0-9]{4,}"],  # class_seq, unbounded: the word kernel
]


@pytest.mark.parametrize("argv", FLAG_CASES, ids=[" ".join(a) for a in FLAG_CASES])
def test_flags_identical(corpus, argv):
    argv = argv + [str(corpus)]
    assert _run(port_cli, argv)[:2] == _run(ref_cli, argv)[:2]


def test_multi_pattern_file_identical(corpus, tmp_path):
    pats = tmp_path / "pats.txt"
    pats.write_bytes(b"needle\nnothing\nshort needle line\nint main\nzzz\n")
    argv = ["-H", "-r", "-O", str(pats), str(corpus)]
    got, want = _run(port_cli, argv), _run(ref_cli, argv)
    assert got[:2] == want[:2] and got[1]


def test_multiple_paths_identical(corpus):
    argv = ["-O", "needle", str(corpus / "src" / "main.c"), str(corpus / "long.txt")]
    got, want = _run(port_cli, argv), _run(ref_cli, argv)
    assert got[:2] == want[:2] and b"main.c:" in got[1]


def test_nonexistent_path_identical(corpus):
    argv = ["-S", "needle", str(corpus / "nope")]
    got, want = _run(port_cli, argv), _run(ref_cli, argv)
    assert got == want and got[0] == 255


def test_directory_without_recursion_identical(corpus, capsys):
    argv = ["needle", str(corpus)]
    got = _run(port_cli, argv)
    got_err = capsys.readouterr().err
    want = _run(ref_cli, argv)
    assert got == want and got[0] == 0 and got[1] == b""
    assert got_err == capsys.readouterr().err and "Add -R" in got_err


PLANTED_CASES = [
    ["-r", "-S", "needleXY"],
    ["-r", "-O", "linus"],
    ["-r", "l[imn]nus"],
    ["-r", "-O", "foo[a-z]+bar"],
    ["-r", "-l", "-O", "needle"],
    ["-S", "-O", "needleXY"],
]


@pytest.mark.parametrize("argv", PLANTED_CASES, ids=[" ".join(a) for a in PLANTED_CASES])
def test_planted_corpus_identical(planted, argv):
    path = str(planted / "a.txt") if "-r" not in argv else str(planted)
    rc, out, _ = _run(port_cli, argv + [path])
    assert (rc, out) == _run(ref_cli, argv + [path])[:2]
    assert out.count(b"\n") >= 4  # the planted needles were found


def test_device_scanner_flags_match_reference(planted):
    """Port DeviceScanner.resolve == reference DeviceScanner (Pallas
    interpret mode) on the same 64 KiB packer batches."""
    from grab_tpu.regex.compiler import compile_multi as ref_compile
    from grab_tpu.scan_pipeline import DeviceScanner as RefScanner
    from grab_tpu_torch.ingest.packer import BatchPacker, copy_segments
    from grab_tpu_torch.regex.compiler import compile_multi
    from grab_tpu_torch.scan_pipeline import DeviceScanner

    buf = 64 << 10
    pats = [b"l[imn]nus"]
    ref = RefScanner(ref_compile(pats), buf_size=buf, pallas_interpret=True)
    port = DeviceScanner(compile_multi(pats), buf_size=buf, devices=["cpu"])
    data = (planted / "sub" / "b.log").read_bytes()[: 9 * buf]
    batches = list(BatchPacker(buf).feed_size(0, len(data)))
    assert len(batches) >= 8
    flagged = 0
    for b in batches:
        filled = np.zeros(buf + 4096, dtype=np.uint8)
        copy_segments(filled, b.segments, lambda _i: data, 512)
        want = ref.resolve(ref.submit(filled))
        got = port.scan(filled)
        assert got.dtype == want.dtype and (got == want).all()
        flagged += int(got.sum())
    assert flagged > 0


@pytest.mark.parametrize(
    "argv,item",
    [  # item: the ROADMAP item; A6-A11 have landed and are served
        ([".{0,2}[0-9]{11}"], "ROADMAP A7"),  # alphabet-run plan
        # no stride plan (1001 states x 6 classes): the last-resort walk
        ([".{0,2}(?:[a-f][0-9][g-m][A-F][N-Z]){200}"], "ROADMAP A6"),
        (["-H", "@needle+seq"], "ROADMAP A8"),  # literals with sequences
        (["-n", "4", "needle"], "ROADMAP A10"),
        (["--hosts", "2", "needle"], "ROADMAP A11"),
        (["-n", "2", "-O", "needle"], "ROADMAP A10"),
        (["-n", "2", ".{0,2}[0-9]{11}"], "ROADMAP A10"),
        (["--hosts", "2", "--pid", "0", "needle"], "ROADMAP A11"),
    ],
)
def test_out_of_slice_refused(corpus, tmp_path, monkeypatch, argv, item):
    if argv[-1] == "@needle+seq":
        pats = tmp_path / "pats.txt"
        pats.write_bytes(b"needle\n[0-9]{3}[a-z]{2}\n")
        argv = argv[:-1] + [str(pats)]
    argv = argv[:-1] + ["-r", "-O", argv[-1], str(corpus)]
    if item == "ROADMAP A10":
        # in the slice now: -n N over the shard devices, as the reference
        # over its N devices; on one device it caps and still runs
        want = _run(ref_cli, argv)[:2]
        for devices in ("cpu,cpu,cpu,cpu", "cpu"):
            monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", devices)
            assert _run(port_cli, argv)[:2] == want and want[0] == 0
        assert want[1] or "needle" not in argv  # the corpus holds no 11-digit run
        return
    if item == "ROADMAP A11":
        # in the slice now: a multi-host session (here of one host)
        # prints what the reference's single-process run prints
        single = [a for i, a in enumerate(argv)
                  if a not in ("--hosts", "--pid") and argv[i - 1] not in ("--hosts", "--pid")]
        want = _run(ref_cli, single)[:2]
        rc, out, err = _one_host(single)
        assert (rc, out) == want and rc == 0 and out.count(b"\n") >= 4, err[-2000:]
        return
    rc, out, err = _run(port_cli, argv)
    assert item in ("ROADMAP A6", "ROADMAP A7", "ROADMAP A8")
    # in the slice now: served, byte for byte as the reference
    assert (rc, out) == _run(ref_cli, argv)[:2] and rc == 0
    if item == "ROADMAP A8":
        assert out.count(b"\n") >= 4


def test_via_and_big_batches_refused(corpus, tmp_path, monkeypatch):
    # --via is served now (ROADMAP A12): it goes to the scan server, and
    # without one listening the connect fails as the reference's does
    with pytest.raises(OSError):
        _run(port_cli, ["--via", str(tmp_path / "no.sock"), "-r", "needle", str(corpus)])
    # multi-host by environment is served now (ROADMAP A11); without a
    # coordinator it fails at once, before any store is started
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    for k in HOST_ENV[1:]:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        _run(port_cli, ["-r", "needle", str(corpus)])
    monkeypatch.delenv("JAX_NUM_PROCESSES")
    # a 20-literal batch is served now (two compare buckets, ROADMAP A9)
    pats = tmp_path / "many.txt"
    pats.write_bytes(b"\n".join([b"lit%02d" % i for i in range(19)] + [b"needle"]))
    argv = ["-H", "-r", "-O", str(pats), str(corpus)]
    rc, out, _ = _run(port_cli, argv)
    assert (rc, out) == _run(ref_cli, argv)[:2] and rc == 0 and out.count(b"\n") >= 4


STATS_LINE = re.compile(r"^tpugrep: \d+\.\d{3}s, \d+\.\d{2} GB/s \| files=")


def test_stats_with_n_prints_rate(corpus, monkeypatch):
    """-r -n 2 --stats goes through run_parallel, as the reference's
    does: its stderr line carries the GB/s figure, in the reference's
    form, and stdout equals -n 1's and the reference's -n 2."""
    from grab_tpu_torch.engine import Engine, EngineConfig
    from grab_tpu_torch.parallel.runner import run_parallel

    argv = ["-r", "-n", "2", "--stats", "needle", str(corpus)]
    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", "cpu,cpu")
    rc, out, err = _run(port_cli, argv)
    ref_rc, ref_out, ref_err = _run(ref_cli, argv)
    assert rc == ref_rc == 0 and out == ref_out and out.count(b"\n") >= 4
    assert STATS_LINE.match(err.strip()), err
    assert STATS_LINE.match(ref_err.strip()), ref_err
    one = _run(port_cli, ["-L", "-L", "-r", "needle", str(corpus)])
    assert one[:2] == (0, out)  # -n N quarters the chunk as -L -L does
    # the bytes it reports are the walked tree's, pruned files aside
    eng = Engine([b"needle"], EngineConfig(device="cpu,cpu"))
    want = sum(size for _path, size in eng._walk_iter(str(corpus)) if size >= 6)
    eng = Engine([b"needle"], EngineConfig(device="cpu,cpu"))
    assert run_parallel(eng, str(corpus), lambda b: None, 2) == want > 0
    assert eng.cfg.n_shards == 2 and len(eng._scanner.lanes) == 2
    # a scanner cached for another shard count is dropped, not reused
    old = eng._scanner
    assert run_parallel(eng, str(corpus), lambda b: None, 1) == want
    assert eng._scanner is not old


@pytest.mark.parametrize("how", ["--hosts", "JAX_NUM_PROCESSES"])
def test_multihost_without_recursion(corpus, monkeypatch, how):
    """Multi-host without -r: the reference's own line and exit 255,
    after the pattern compile (a bad pattern reports that first); with
    -r the port serves it (a session of one host, by flags or by the
    launcher's environment) and prints what the reference's
    single-process run prints."""
    argv = ["needle", str(corpus / "oneline")]
    if how == "--hosts":
        argv = ["--hosts", "2"] + argv
    else:
        monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    for cli in (ref_cli, port_cli):
        rc, out, err = _run(cli, argv)
        assert (rc, out, err) == (255, b"", "Multihost support only for recursive grabs.\n")
        bad = argv[:-2] + ["(unclosed", argv[-1]]
        rc, out, err = _run(cli, bad)
        assert rc == 255 and out == b"" and "pattern compile error" in err
        assert "Multihost" not in err
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    want = _run(ref_cli, ["-r", "needle", str(corpus)])[:2]
    rc, out, err = _one_host(["-r", "needle", str(corpus)], by_env=how != "--hosts")
    assert (rc, out) == want and rc == 0 and out.count(b"\n") >= 4, err[-2000:]


def test_cuda_device_without_card_raises(corpus, monkeypatch):
    from grab_tpu_torch.engine import Engine, EngineConfig
    from grab_tpu_torch.scan_pipeline import DeviceUnavailable

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv("GRAB_TPU_TORCH_DEVICE")
    assert EngineConfig().device == "cuda"
    with pytest.raises(DeviceUnavailable):
        Engine(b"needle", EngineConfig(device="cuda"))
    rc, out, err = _run(port_cli, ["-r", "needle", str(corpus)])
    assert rc == 255 and out == b"" and "cuda" in err


def test_trace_writes_profile(corpus, tmp_path):
    d = tmp_path / "trace"
    argv = ["--trace", str(d), "-r", "needle", str(corpus)]
    rc, out, _ = _run(port_cli, argv)
    assert rc == 0 and out == _run(ref_cli, argv[2:])[1]
    assert (d / "trace.json").stat().st_size > 0


# -- -E and factor-less patterns over a multi-batch corpus ----------------

# uncovered (no factor, no class sequence, no alphabet-run plan),
# unbounded: the gdfa mode's threading fixpoint (tests/test_exact_unbounded_device.py)
UNBOUNDED = r".{0,2}(?:[0-9a-zA-Z]{4})+"


@pytest.fixture(scope="module")
def punct(tmp_path_factory):
    """Punctuation-heavy files in which alnum runs of 4+ (the matches)
    occur only where planted: runs crossing 128-byte stream strides,
    one over 4 KiB, one across the 2 MiB batch edge of a 3 MiB file
    (fully replayed: unbounded matches can span batches), and small
    files that the no-split packer keeps whole."""
    root = tmp_path_factory.mktemp("punct")
    rng = np.random.default_rng(5)
    sym = np.frombuffer(b" -_=+()\n", dtype=np.uint8)

    def mk(name, size, plants):
        data = bytearray(rng.choice(sym, size=size).tobytes())
        for pos, span in plants:
            data[pos : pos + span] = (b"a1B2" * (span // 4 + 1))[:span]
        (root / name).write_bytes(bytes(data))

    (root / "sub").mkdir()
    mk("a.txt", 1 << 20, [(5000, 8), (131030, 300), (524288 - 10, 5000), (900001, 4)])
    mk("big.bin", 3 << 20, [((2 << 20) - 3000, 8000), (70000, 200)])
    for i in range(6):
        mk(f"sub/s{i}.txt", 150_000 + 7_777 * i, [(1000 * i + 17, 4 + 3 * i)])
    return root


UNBOUNDED_CASES = [
    ["-E", "-r", UNBOUNDED],
    ["-E", "-r", "-O", UNBOUNDED],
    ["-r", UNBOUNDED],  # default mode: chunk grammar, same device flags
    ["-E", "-r", "-l", "[0-9a-zA-Z]{12,}"],  # class_seq, unbounded
]


@pytest.mark.parametrize("argv", UNBOUNDED_CASES, ids=[" ".join(a) for a in UNBOUNDED_CASES])
def test_unbounded_corpus_identical(punct, argv):
    argv = argv + [str(punct)]
    rc, out, _ = _run(port_cli, argv)
    assert (rc, out) == _run(ref_cli, argv)[:2]
    assert out.count(b"\n") >= 4


def test_unbounded_engine_routes_gdfa_and_replays_oversize(punct):
    """The gdfa mode with the threading fixpoint serves the -E pattern
    on the CPU device; a file over one buffer is fully replayed."""
    from grab_tpu_torch.engine import Engine, EngineConfig
    from grab_tpu_torch.format.emitter import OutputConfig

    cfg = EngineConfig(output=OutputConfig(colored=False), exact=True, device="cpu")
    eng = Engine([UNBOUNDED.encode()], cfg)
    assert eng._device_usable() and eng._dfa_tier_unbounded()
    sc = eng._get_scanner()
    assert sc.mode == "gdfa" and not sc._gdfa.window_mode
    data = (punct / "big.bin").read_bytes()
    out = []
    eng.scan_data("big.bin", data, out.append)
    host = Engine([UNBOUNDED.encode()], EngineConfig(
        output=OutputConfig(colored=False), exact=True, device="none"))
    want = []
    host.scan_data("big.bin", data, want.append)
    assert b"".join(out) == b"".join(want) != b""


# -- the -H / -S literal ensemble and the remaining scan plans --------------

H_CASES = [
    # (patterns, flags): the conformance corpus's needle files under -H
    ([b"needle", b"nothing", b"int main"], ["-O"]),
    ([b"needle", b"[0-9]{3}[a-z]{2}", b"n[a-z]+e"], ["-O"]),  # literals with sequences
    ([b"lit%02d" % i for i in range(30)] + [b"needle", b"pass"], ["-l"]),
    ([b"longliteral%02d" % i for i in range(8)] + [b"short needle line"], []),  # XOR filter
    ([b"needle", b"return", b"nothing to see"], ["-S", "-O"]),  # -S -H
    ([b"ne", b"needle"], ["-S"]),  # a 2-byte literal beside a literal
    ([b".{0,2}[0-9]{11}", b"needle"], ["-O"]),  # an uncovered pattern in the batch
]


@pytest.mark.parametrize("pats,flags", H_CASES, ids=[f"H{i}" for i in range(len(H_CASES))])
def test_pattern_file_batches_identical(corpus, tmp_path, pats, flags):
    f = tmp_path / "pats.txt"
    f.write_bytes(b"\n".join(pats) + b"\n")
    argv = ["-H", "-r"] + flags + [str(f), str(corpus)]
    got, want = _run(port_cli, argv), _run(ref_cli, argv)
    assert got[:2] == want[:2] and got[0] == 0 and got[1]


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """The 100-literal + 10-regex batch of tests/test_mixed_batch.py as
    a pattern file, over a tree holding its planted data in files that
    span the 2 MiB CPU buffer."""
    import test_mixed_batch

    root = tmp_path_factory.mktemp("mixed")
    pats, data, _plants = test_mixed_batch.build()
    (root / "pats.txt").write_bytes(b"\n".join(pats) + b"\n")
    tree = root / "tree"
    (tree / "sub").mkdir(parents=True)
    (tree / "m.txt").write_bytes(data)
    (tree / "sub" / "big.txt").write_bytes(data * 4)  # 2.4 MB: two batches
    (tree / "sub" / "tail.txt").write_bytes(data[390_000:460_000])
    return root


@pytest.mark.parametrize("env", [{}, {"GRAB_TPU_NO_FUSED": "1"}, {"GRAB_TPU_SEQDFA": "0"}],
                         ids=["default", "no_fused", "no_seqdfa"])
def test_mixed_batch_identical(mixed, monkeypatch, env):
    for var in ("GRAB_TPU_NO_FUSED", "GRAB_TPU_SEQDFA"):
        monkeypatch.delenv(var, raising=False)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    argv = ["-r", "-H", "-O", str(mixed / "pats.txt"), str(mixed / "tree")]
    rc, out, _ = _run(port_cli, argv)
    assert (rc, out) == _run(ref_cli, argv)[:2] and rc == 0
    assert out.count(b"\n") >= 40  # 8 planted patterns in 5+ copies


ALPHA_CASES = [
    ["-r", "-O", ".{0,2}[0-9]{11}"],  # alpha, coarse
    ["-E", "-r", "-O", ".{0,2}[0-9]{11}"],
    # alpha with no automaton, fine mode (-2: no PCRE1 capture quirk)
    ["-2", "-r", "-O", ".{0,2}([0-9]{6})\\1"],
    ["-r", "-l", ".{0,2}(?:[a-f][0-9][g-m][A-F][N-Z]){3}"],  # the last-resort walk
]


@pytest.fixture(scope="module")
def digits(tmp_path_factory):
    """Text files with digit runs and a few a1gAN-shaped runs planted,
    one file over the 2 MiB CPU buffer."""
    root = tmp_path_factory.mktemp("digits")
    rng = np.random.default_rng(23)
    (root / "sub").mkdir()
    for i, n in enumerate((50_000, 64_000, (2 << 20) + 70_000)):
        data = bytearray(rng.integers(58, 127, size=n, dtype=np.uint8).tobytes())
        for p in range(0, n, 93):
            data[p] = 0x0A
        for p in range(500 + i * 37, n - 40, max(4999, n // 40)):
            data[p : p + 13] = b"x91827364550x"
            data[p + 20 : p + 32] = b"123456123456"
        stride = (2 << 20) - 0x1000
        if n > stride:
            data[stride - 5 : stride + 6] = b"00112233445"
            data[stride + 0x1000 - 4 : stride + 0x1000 + 11] = b"c3hDPa1gANb2hBO"
        data[300:315] = b"a1gANb2hBOc3hDP"
        (root / ("sub/" if i else "") / f"f{i}.txt").write_bytes(bytes(data))
    return root


@pytest.mark.parametrize("argv", ALPHA_CASES, ids=[" ".join(a) for a in ALPHA_CASES])
def test_alpha_and_walk_corpus_identical(digits, argv):
    argv = argv + [str(digits)]
    rc, out, _ = _run(port_cli, argv)
    assert (rc, out) == _run(ref_cli, argv)[:2] and rc == 0
    assert out.count(b"\n") >= 3


def test_engine_routes_alpha_and_walk(digits):
    """The engine builds the alpha and dfa modes on the CPU device."""
    from grab_tpu_torch.engine import Engine, EngineConfig

    eng = Engine([rb".{0,2}[0-9]{11}"], EngineConfig(device="cpu"))
    assert eng._device_usable() and eng._get_scanner().mode == "alpha"
    assert not eng._dfa_tier_unbounded()
    eng = Engine([rb".{0,2}([0-9]{6})\1"], EngineConfig(device="cpu"))
    assert eng.compiled.dfa is None and eng._get_scanner().mode == "alpha"
    eng = Engine([rb".{0,2}(?:[a-f][0-9][g-m][A-F][N-Z]){3}"],
                 EngineConfig(device="cpu", scan_buf_size=64 << 10))
    assert eng._get_scanner().mode == "dfa"


def test_resume_manifest_identical(tmp_path):
    """--resume (tests/test_cli.py test_resume_manifest): the first run
    prints 3 matches, the second nothing, and after touching b.txt the
    third only its 2; stdout, exit code and the manifest file equal
    grab_tpu.cli's at each step."""
    import time

    tree = tmp_path / "tree"
    (tree / "d").mkdir(parents=True)
    (tree / "d" / "a.txt").write_bytes(b"first needle line\nsecond line\n")
    (tree / "b.txt").write_bytes(b"needle at zero\nagain a needle\n")
    manifests = {"ref": tmp_path / "ref.jsonl", "port": tmp_path / "port.jsonl"}

    def step():
        got = {}
        for side, cli in (("ref", ref_cli), ("port", port_cli)):
            rc, out, _ = _run(cli, ["--resume", str(manifests[side]), "-r", "-l", "-O",
                                    "needle", str(tree)])
            got[side] = (rc, out, manifests[side].read_bytes())
        assert got["port"] == got["ref"]
        return got["port"][1]

    assert step().count(b"Match") == 3
    assert step() == b""
    t = time.time() + 5
    os.utime(tree / "b.txt", (t, t))
    out = step()
    assert out.count(b"Match") == 2 and b"a.txt" not in out
