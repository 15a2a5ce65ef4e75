"""The readers of the ``log_ioc_h110.sweep`` cell (rescan_share.sweep,
compile_share.sweep, kernel_roofline.b6) on synthetic --stats lines and
traces, and the cell's configuration and mix loaded as a run loads them."""

import os

import pytest

from scanbench import harness, mix as mixmod, tracefile
from scanbench.corpus import prepare
from scanbench.metrics import reader
from scanbench.record import Done, RunData, parse_stats
from scanbench.tests.tiny import ROOT

HEAD = (b"tpugrep: 6.500s | files=28/28 (pruned=0, clean=20) bytes=2000000000 cand_blocks=40 batches=66 "
        b"walk=0.010s scan=1.000s (2.00 GB/s) replay=0.050s (40.00 GB/s)")


def stats_line(compile_s: float, replay_bytes=None) -> bytes:
    tail = b"" if replay_bytes is None else b"replay_bytes=%d " % replay_bytes
    return (HEAD + b" | req=2 compile=%.4fs scanner=hit:0.0001s pack=0.0100s fill=0.5000s stage=0.0100s "
            b"launch=0.0200s wait=0.0300s pull=0.0010s pulls=3 inplace=66 %skernel_load=0.0000s/0/0 cache=1/1\n"
            % (compile_s, tail))


def run_of(*stderrs, latency=8.0, traces=None):
    reqs = []
    for i, e in enumerate(stderrs):
        d = Done(("-r", "-H", "p", "/t"), 2_000_000_000, latency, 0, stderr=b"warning\n" + e,
                 stats=parse_stats(e), trace=None if traces is None else traces[i])
        reqs.append(d)
    return RunData(reqs, setup_s=20.0, window_s=51.0, kind="NVIDIA H100 80GB HBM3", peak_bytes_per_s=3.35e12)


def test_rescan_share_reads_replay_bytes():
    run = run_of(stats_line(5.0, 1_000_000), stats_line(6.0, 3_000_000))
    assert reader("rescan_share.sweep")(run) == pytest.approx(100 * 4e6 / 4e9)


def test_rescan_share_finds_nothing_without_the_field():
    assert reader("rescan_share.sweep")(run_of(stats_line(5.0), stats_line(6.0))) is None
    # a request without the field counts neither its replay nor its bytes
    run = run_of(stats_line(5.0, 2_000_000), stats_line(6.0))
    assert reader("rescan_share.sweep")(run) == pytest.approx(100 * 2e6 / 2e9)
    failed = run_of(stats_line(5.0, 2_000_000))
    failed.requests[0].rc = 255
    assert reader("rescan_share.sweep")(failed) is None


def test_compile_share_reads_the_compile_span():
    run = run_of(stats_line(5.0, 10), stats_line(6.0, 10))
    assert reader("compile_share.sweep")(run) == pytest.approx(100 * 11.0 / 16.0)
    assert reader("compile_share.sweep")(run_of(HEAD + b"\n")) is None


def fused_trace():
    return tracefile.summarize([
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 0.0, "dur": 10000.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 1000.0, "dur": 3000.0},
        {"ph": "X", "cat": "kernel", "name": "fused_kernel(unsigned int const*, unsigned int const*, int)",
         "ts": 4000.0, "dur": 400.0},
        {"ph": "X", "cat": "kernel", "name": "fused_kernel(unsigned int const*, unsigned int const*, int)",
         "ts": 5000.0, "dur": 400.0},
    ])


def test_b6_roofline_reads_fused_kernel_launches():
    run = run_of(stats_line(5.0, 10), traces=[fused_trace()])
    # two launches recorded of 66 batches: their share of the bytes over 0.8 ms of kernel
    want = 100 * (2e9 * 2 / 66 / 3.35e12) / 0.8e-3
    assert reader("kernel_roofline.b6")(run) == pytest.approx(want)
    b1 = fused_trace()
    b1.ops_us = {k.replace("fused", "core_word"): v for k, v in b1.ops_us.items()}
    b1.ops_n = {k.replace("fused", "core_word"): v for k, v in b1.ops_n.items()}
    assert reader("kernel_roofline.b6")(run_of(stats_line(5.0), traces=[b1])) is None


SMALL = dict(log_files=3, log_min_bytes=64 << 10, log_max_bytes=512 << 10, log_total_bytes=1_000_000,
             big_log_bytes=[], binary_bytes=[65536], base_bytes=1 << 20, piece_bytes=256 << 10,
             pool_lines=1000, plants_per_file=[16, 24])


def test_sweep_cell_loads_and_plants_regex_matches(tmp_path, monkeypatch):
    bench = harness.load_bench()
    cell = harness.cell_of(bench, "log_ioc_h110.sweep")
    cfg = dict(harness.config_of(bench, cell["config"]), **SMALL)
    with open(os.path.join(ROOT, "scanbench", cfg["plant_patterns"]), "rb") as f:
        plants = [ln for ln in f.read().splitlines() if ln]
    assert cfg["plant_literals"] == len(plants)
    with open(os.path.join(ROOT, "scanbench", "patterns", "ioc110.txt"), "rb") as f:
        assert plants[:100] == [ln for ln in f.read().splitlines() if ln][:100]
    corpus = prepare(cfg, 2**31 + 99, str(tmp_path))
    assert any(t.encode() not in plants[:100] for t in corpus.planted)  # regex plants among them
    mix = mixmod.load(cell["traffic"])
    seq = mixmod.sequence(mix, corpus, 2**31 + 99)
    assert len(seq) == 1 and mixmod.warmups(mix, corpus, seq) == seq
    req = seq[0]
    assert req.argv == ("-r", "-H", "scanbench/patterns/ioc110.txt", corpus.root)
    assert req.nbytes == corpus.total_bytes
    monkeypatch.chdir(ROOT)  # the server and the reference run from the checkout's root
    pats, literal = mixmod.patterns_of(req)
    assert len(pats) == 110 and not literal
