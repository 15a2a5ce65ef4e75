"""-n N in the port: a DeviceScanner of N lanes inside the Engine, on the CPU.

Mirrors tests/test_sharded_engine.py and tests/test_sharded_word_scan.py.
The device list ``cpu,cpu,cpu,cpu,cpu,cpu,cpu,cpu`` is to the port what
the 8 virtual CPU devices are to the JAX package: eight lanes, each
running the kernels' plain PyTorch versions. Output with -n 8 must equal
the port's -n 1 and the reference's -n 8 byte for byte (tolerance:
exact), in every device mode; a short last group, a clean group and the
cap at the device count are checked too.
"""

import io

import numpy as np
import pytest
import torch

from grab_tpu import cli as ref_cli
from grab_tpu import engine as ref_engine
from grab_tpu.format.emitter import OutputConfig as RefOutputConfig
from grab_tpu_torch import cli as port_cli
from grab_tpu_torch import engine as port_engine
from grab_tpu_torch.format.emitter import OutputConfig
from grab_tpu_torch.parallel.scan_step import make_sharded_word_scan, shard_devices
from grab_tpu_torch.scan_pipeline import DeviceScanner, release_lanes, take_lanes

CPU8 = ",".join(["cpu"] * 8)
BUF = 64 << 10  # small fixed buffer → many batches per corpus
MIB = 1 << 20  # the smallest buffer that takes the strided-DFA walk


def _corpus(rng, n_files=6, base=120_000):
    """The corpus of tests/test_sharded_engine.py."""
    files = []
    for i in range(n_files):
        n = base + rng.integers(0, 30_000)
        data = bytearray(rng.integers(97, 123, size=n, dtype=np.uint8))
        for p in range(0, n, 97):
            data[p] = 0x0A
        for p in range(500, n - 40, 7919):
            data[p : p + 8] = b"needle%02d" % (i % 100)
        files.append((f"mem://f{i}", bytes(data)))
    return files


def _scan(files, patterns, n_shards, mode="pcre1", buf=BUF, ref=False, exact=False):
    if ref:
        cfg = ref_engine.EngineConfig(
            output=RefOutputConfig(recursive=True), mode=mode, scan_buf_size=buf,
            n_shards=n_shards, exact=exact, pallas_interpret=True,
        )
        eng = ref_engine.Engine(patterns, cfg)
    else:
        cfg = port_engine.EngineConfig(
            output=OutputConfig(recursive=True), mode=mode, scan_buf_size=buf,
            n_shards=n_shards, exact=exact, device=CPU8,
        )
        eng = port_engine.Engine(patterns, cfg)
    out = bytearray()
    eng.scan_corpus(iter(files), out.extend)
    return bytes(out), eng


@pytest.mark.parametrize(
    "pattern,mode",
    [
        (b"needle03", "literal"),  # literal kernel path
        (rb"needle[0-9]+", "pcre1"),  # factor-prefiltered regex
        (rb"[l-n]eedle[0-9][0-9]", "pcre1"),  # class-sequence path
    ],
)
def test_sharded_output_identical(pattern, mode):
    files = _corpus(np.random.default_rng(7))
    out1, _ = _scan(files, [pattern], 1, mode)
    out8, eng8 = _scan(files, [pattern], 8, mode)
    ref8, _ = _scan(files, [pattern], 8, mode, ref=True)
    assert out1, "corpus must produce matches for the test to mean anything"
    assert out8 == out1 and out8 == ref8
    sc = eng8._scanner
    assert isinstance(sc, DeviceScanner) and len(sc.lanes) == 8
    assert eng8.stats.device_batches >= 8
    # 13 batches: one full group and a short one of 5 lanes
    assert eng8.stats.device_batches % 8 != 0


def _big_corpus(rng, plant, n_files=5, fill=(97, 123)):
    """~9.5 MB in files of 1.5-2.3 MB: ten 1 MiB batches, so one full
    group of 8 and a short group of 2."""
    files = []
    for i in range(n_files):
        n = 1_500_000 + 200_000 * i
        data = bytearray(rng.integers(*fill, size=n, dtype=np.uint8))
        for p in range(0, n, 89):
            data[p] = 0x0A
        plant(data, i)
        files.append((f"mem://g{i}", bytes(data)))
    return files


def _plant_every(data, needles, step=180_001):
    for j, p in enumerate(range(700, len(data) - 64, step)):
        s = needles[j % len(needles)]
        data[p : p + len(s)] = s


MODE_CASES = {
    # gdfa, boundary windows: an uncovered bounded automaton
    "gdfa-window": ([rb".{0,2}[a-z ]{11}"], "pcre1", False, (33, 97),
                    [b"hello world", b"abc def ghij"]),
    # gdfa, threading fixpoint under -E
    "gdfa-thread": ([rb".{0,2}(?:[0-9a-zA-Z]{4})+"], "pcre1", True, (33, 48),
                    [b"a1B2c3D4", b"a1B2" * 40]),
    # alpha: a mandatory class run
    "alpha": ([rb".{0,2}[0-9]{11}"], "pcre1", False, (58, 127), [b"x91827364550x"]),
    # class_seq through the union stride member (its only upload is transposed)
    "seq-stride": ([rb"[A-Z]{6}[0-9]{6}"], "pcre1", False, (97, 123), [b"QWERTY123456"]),
    # -H batch: literals in the fused scanner beside a stride member (two uploads)
    "batch-stride": ([b"needleXY", b"longliteral07", b"lit", rb"[0-9]{3}[a-z]{2}",
                      rb"[A-Z]{5}[0-9]{2}"], "pcre1", False, (33, 48),
                     [b"needleXY", b"123ab", b"QWERT99", b"longliteral07", b"lit"]),
}


@pytest.mark.parametrize("case", list(MODE_CASES), ids=list(MODE_CASES))
def test_sharded_modes_identical(case):
    patterns, mode, exact, fill, needles = MODE_CASES[case]
    files = _big_corpus(np.random.default_rng(11), lambda d, i: _plant_every(d, needles),
                        fill=fill)
    out1, eng1 = _scan(files, patterns, 1, mode, buf=MIB, exact=exact)
    out8, eng8 = _scan(files, patterns, 8, mode, buf=MIB, exact=exact)
    ref8, ref_eng = _scan(files, patterns, 8, mode, buf=MIB, ref=True, exact=exact)
    assert out1.count(b"\n") >= 10
    assert out8 == out1 and out8 == ref8
    sc = eng8._scanner
    assert len(sc.lanes) == 8 and sc.mode == eng1._scanner.mode == ref_eng._scanner.mode
    assert [type(m).__name__ for m in sc.members] == [
        type(m).__name__ for m in eng1._scanner.members]
    if case == "batch-stride":
        assert [type(m).__name__ for m in sc.members] == [
            "FusedEnsembleScanner", "_StrideSeqMember"]
    batches = eng8.stats.device_batches
    assert batches > 8 and batches % 8 != 0  # a full group and a short one
    assert sc.payload_pulls > 0


def test_sharded_miss_is_clean():
    """A miss: every group is resolved from its counts alone."""
    files = _corpus(np.random.default_rng(8))
    out8, eng8 = _scan(files, [b"qZx9kWv3"], 8, "literal")
    assert out8 == b""
    assert eng8.stats.clean_files == len(files)
    assert eng8._scanner.payload_pulls == 0 and eng8.stats.device_batches >= 8


def test_group_pulls_only_hit_lanes():
    """One buffer of a group of three holds a hit: only its lane pulls
    its payload, the flags come back in submit order, and a short group
    uses the first lanes."""
    from grab_tpu_torch.regex.compiler import compile_multi

    sc = DeviceScanner(compile_multi([b"needleXY"]), buf_size=BUF,
                       devices=shard_devices(4, CPU8))
    assert [d.type for d in sc.lanes] == ["cpu"] * 4
    bufs = [np.full(BUF + 4096, ord("."), dtype=np.uint8) for _ in range(3)]
    for b in bufs:
        b[BUF:] = 0
    bufs[1][5000:5008] = np.frombuffer(b"needleXY", np.uint8)
    lanes = take_lanes(sc.lanes)
    handles = sc.submit(lanes, bufs)
    assert [h[0] for h in handles] == lanes[:3]  # the first lanes, in order
    flags = [sc.resolve(h) for h in handles]
    assert len(flags) == 3 and not flags[0].any() and not flags[2].any()
    assert flags[1][5000 // 512] == 1
    assert sc.payload_pulls == 1  # lane 1's alone
    with pytest.raises(ValueError):
        sc.submit(lanes, [])
    with pytest.raises(ValueError):
        sc.submit(lanes, bufs + bufs)
    release_lanes(lanes)
    single = sc.scan(bufs[1])
    assert np.array_equal(flags[1], single)


def _run(cli, argv):
    out, err = io.BytesIO(), io.StringIO()
    rc = cli.main(list(argv), out=out, err=err)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture
def tree(tmp_path):
    d = tmp_path / "tree"
    (d / "sub").mkdir(parents=True)
    for i, (_name, data) in enumerate(_corpus(np.random.default_rng(9), n_files=4, base=20_000)):
        (d / ("sub" if i % 2 else ".") / f"f{i}.txt").write_bytes(data)
    return d


@pytest.mark.parametrize("flags", [[], ["-O"], ["-l", "-O"], ["-E"]], ids=" ".join)
def test_cli_n8_matches_single(tree, monkeypatch, flags):
    """-n 8 quarters the chunk (main.cc:172-173); -L -L quarters it too,
    so the flush boundaries (and hence output) must agree exactly."""
    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", CPU8)
    rc8, out8, _ = _run(port_cli, flags + ["-n", "8", "-r", "needle0[0-9]", str(tree)])
    rc1, out_l, _ = _run(port_cli, flags + ["-L", "-L", "-r", "needle0[0-9]", str(tree)])
    rc_r, ref8, _ = _run(ref_cli, flags + ["-n", "8", "-r", "needle0[0-9]", str(tree)])
    assert rc8 == 0 and rc1 == 0 and rc_r == 0
    assert out8 == out_l and out8 == ref8
    assert out8  # matched something


def test_cli_n_needs_recursion(tree, monkeypatch):
    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", CPU8)
    argv = ["-n", "4", "needle", str(tree / "f0.txt")]
    got, want = _run(port_cli, argv), _run(ref_cli, argv)
    assert got == want and got[0] == 255 and "recursive" in got[2]


@pytest.mark.parametrize("device,want", [(CPU8, 8), ("cpu", 1), ("cpu,cpu,cpu", 3), ("none", 1)])
def test_n_shards_caps_at_device_count(device, want):
    """The reference hard-errors when threads > cores (main.cc:211-214);
    the JAX package degrades to the hardware, and so does the port:
    -n 999 runs over the shard devices there are."""
    cfg = port_engine.EngineConfig(device=device)
    cfg.n_shards = 999
    eng = port_engine.Engine([b"needleXY"], cfg)
    assert eng._effective_shards() == want == port_engine.effective_shards(cfg)
    if device != "none":
        assert isinstance(eng._scanner, DeviceScanner) and len(eng._scanner.lanes) == want
    cfg.n_shards = 2
    assert port_engine.effective_shards(cfg) == min(2, want)


def test_device_lists():
    from grab_tpu_torch.scan_pipeline import DeviceUnavailable, resolve_devices

    assert resolve_devices("cpu") == [torch.device("cpu")]
    assert resolve_devices("cpu, cpu") == [torch.device("cpu")] * 2
    assert shard_devices(3, CPU8) == [torch.device("cpu")] * 3
    assert len(shard_devices(None, CPU8)) == 8
    with pytest.raises(ValueError):
        shard_devices(9, CPU8)
    with pytest.raises(ValueError):
        resolve_devices("cpu,,cpu")
    with pytest.raises(ValueError):
        resolve_devices("cpu,meta")
    if not torch.cuda.is_available():
        for spec in ("cuda", "cpu,cuda:0", "cuda:0,cuda:0"):
            with pytest.raises(DeviceUnavailable):
                resolve_devices(spec)
        with pytest.raises(DeviceUnavailable):
            port_engine.Engine(b"needle", port_engine.EngineConfig(device="cuda:0,cuda:0",
                                                                   n_shards=2))


def test_sharded_corewords_sum_and_decode():
    """tests/test_sharded_word_scan.py on the port: per-shard packed
    flags, the summed count, host decode per shard; each shard's packed
    flags equal the reference kernel's (interpret mode)."""
    import jax.numpy as jnp

    from grab_tpu.ops.pallas_corewords import CoreWordTests as RefTests
    from grab_tpu.ops.pallas_corewords import core_word_bitmap, packed_block_flags
    from grab_tpu_torch.ops.corewords import BLOCK, LANES, PAD_ROWS, decode_packed_flags

    n_dev, shard_rows = 8, 128  # 64 KiB per shard
    lit = b"qZx9kWv3"
    rng = np.random.default_rng(3)
    bufs, planted = [], []
    for s in range(n_dev):
        b = rng.integers(32, 127, size=shard_rows * BLOCK, dtype=np.uint8)
        pos = 1000 + 517 * s
        b[pos : pos + len(lit)] = np.frombuffer(lit, dtype=np.uint8)
        planted.append((s, pos))
        w = b.view("<i4").reshape(shard_rows, LANES)
        bufs.append(np.concatenate([w, np.zeros((PAD_ROWS, LANES), "<i4")]))
    devices = shard_devices(n_dev, CPU8)
    fn = make_sharded_word_scan([lit], devices)
    packed, total = fn([torch.from_numpy(b) for b in bufs])
    assert int(total) == n_dev  # one hit block per shard, summed over the shards
    t, rt = fn.tests, RefTests([lit])
    for s, pos in planted:
        bm = core_word_bitmap(jnp.asarray(bufs[s]), jnp.asarray(rt.tab), rt.k, rt.n_words,
                              tile_rows=64, interpret=True, masked=rt.masked)
        assert np.array_equal(packed[s].numpy(), np.asarray(packed_block_flags(bm)[1]))
        flags = decode_packed_flags(packed[s].numpy(), shard_rows, t.probe_back, t.probe_fwd)
        assert flags[pos // BLOCK] == 1, (s, pos)
        assert flags.sum() <= 4  # exact block + probe slack only
    with pytest.raises(ValueError):
        fn([torch.from_numpy(bufs[0])])
