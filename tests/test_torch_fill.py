"""The scan pipeline's reused fill slots (scan_pipeline.FillSlot) on the
CPU path's ring: a batch is filled where the scan reads it, into a
buffer that earlier batches wrote, so the pipeline has to clear exactly
what they left there. Every case below holds the buffers, the flags,
the stdout and the candidate blocks of a small ``-r`` scan through the
reused ring to those of the same scan with a buffer zeroed fresh for
every batch; and ``fill_segments`` (the native pread pool and its
Python fallback) to a plain model of one segment's extent."""

import numpy as np
import pytest

from grab_tpu_torch import scan_pipeline
from grab_tpu_torch.engine import Engine, EngineConfig
from grab_tpu_torch.ingest import native
from tests._fill_cases import BUF, NEEDLES, PATTERNS, Tap, scan_tree, stats_field, text
from tests._torch_threads import _one_thread  # noqa: F401 (autouse: one intra-op thread)


@pytest.fixture(autouse=True)
def _own_lanes(monkeypatch):
    """Each test starts on lanes of its own, as a new process does: the
    process's lanes outlive a scan, and what earlier tests left in their
    slots must not decide which of this test's claims find stale bytes."""
    monkeypatch.setattr(scan_pipeline, "_LANES", {})


@pytest.mark.parametrize("shards", [1, 2], ids=["one device", "-n 2"])
@pytest.mark.parametrize("pattern", list(PATTERNS))
@pytest.mark.parametrize("case", ["stale_tail", "padding", "removed", "shrunk"])
def test_reused_slot_fill_matches_fresh_buffers(tmp_path, monkeypatch, case, pattern, shards):
    """Through the reused ring, every submitted buffer, its flags, the
    stdout and cand_blocks equal a scan whose every batch is filled into
    a buffer zeroed for it alone; the ring did hand out slots holding an
    earlier batch's bytes past the new batch's end. inplace= counts
    every batch where a member reads the linear words and none where
    the stride member alone reads them."""
    out, line, tap = scan_tree(tmp_path, case, pattern, shards, False, monkeypatch)
    want_out, want_line, want = scan_tree(tmp_path, case, pattern, shards, True, monkeypatch)
    assert out == want_out and out.count(b"\n") > 100
    assert [len(b) for b in tap.bufs] == [len(b) for b in want.bufs]
    for got_lane, want_lane in zip(tap.bufs, want.bufs):
        for g, w in zip(got_lane, want_lane):
            assert np.array_equal(g, w)
    for got_lane, want_lane in zip(tap.flags, want.flags):
        assert len(got_lane) == len(want_lane)
        for g, w in zip(got_lane, want_lane):
            assert np.array_equal(g, w)
    assert stats_field(line, "cand_blocks") == stats_field(want_line, "cand_blocks")
    assert tap.stale_claims >= 1 and want.stale_claims == 0
    batches = stats_field(line, "batches")
    assert batches >= 3 and len(tap.bufs) == shards
    assert stats_field(line, "inplace") == (batches if pattern == "linear" else 0)


# each turn's last batch is shorter than the last turn's (smaller files after the big one)
TURNS = [("linear", "removed"), ("stride-only", "padding"), ("linear", "stale_tail")]


@pytest.mark.parametrize("shards", [1, 2], ids=["one device", "-n 2"])
def test_plans_in_turn_on_one_lane_match_fresh_buffers(tmp_path, monkeypatch, shards):
    """Plans of different kinds fill the same lanes' slots in turn: a
    literal plan, then a stride-only plan, then a literal plan whose
    last batch is shorter. Each finds bytes that the one before left in
    its slots; every buffer submitted, its flags, the stdout and
    cand_blocks equal a scan whose every batch is filled into a buffer
    zeroed for it alone."""
    lanes = None
    for turn, (pattern, case) in enumerate(TURNS):
        root = tmp_path / str(turn)
        out, line, tap = scan_tree(root, case, pattern, shards, False, monkeypatch)
        want_out, want_line, want = scan_tree(root, case, pattern, shards, True, monkeypatch)
        assert out == want_out and out.count(b"\n") > 100
        for got, exp in ((tap.bufs, want.bufs), (tap.flags, want.flags)):
            assert [len(l) for l in got] == [len(l) for l in exp]
            for got_lane, exp_lane in zip(got, exp):
                for g, w in zip(got_lane, exp_lane):
                    assert np.array_equal(g, w)
        assert stats_field(line, "cand_blocks") == stats_field(want_line, "cand_blocks")
        assert tap.stale_claims >= 1 and len(tap.lanes) == shards
        assert lanes is None or all(a is b for a, b in zip(tap.lanes, lanes))
        lanes = tap.lanes


@pytest.mark.parametrize("kind", ["stale_tail", "padding"])
def test_reused_slot_copy_matches_fresh_buffers(monkeypatch, kind):
    """The in-memory path (CorpusPipeline.run, copy_segments) through
    the reused ring: buffers, flags and output equal fresh buffers'."""
    rng = np.random.default_rng(23)
    big = text(rng, (5 << 19) + 99)
    for pos in range(300, 1 << 20, 401):
        big[pos : pos + len(NEEDLES)] = NEEDLES
    sizes = [7001] if kind == "stale_tail" else [1000, 777, 3333, 5121, 513]
    files = [("a", bytes(big))] + [(f"b{i}", bytes(text(rng, n))) for i, n in enumerate(sizes)]
    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", "cpu")
    runs = []
    for fresh in (False, True):
        with monkeypatch.context() as m:
            tap = Tap(m, fresh)
            eng = Engine(b"needleXY", EngineConfig(scan_buf_size=BUF, record=True))
            out = []
            eng.scan_corpus(iter(files), out.append)
        runs.append((b"".join(out), tap, eng.stats))
    (out, tap, st), (want_out, want, want_st) = runs
    assert out == want_out and out.count(b"needleXY") > 1000
    assert st.candidate_blocks == want_st.candidate_blocks
    assert st.inplace == st.device_batches >= 3 and tap.stale_claims >= 1
    for g, w in zip(tap.bufs[0] + tap.flags[0], want.bufs[0] + want.flags[0]):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("impl", ["native", "python"])
def test_fill_segments_writes_each_extent_whole(tmp_path, monkeypatch, impl):
    """On a buffer full of stale bytes: a segment's bytes then zeros to
    the next block; a job longer than its file (a short read) zeros the
    rest of its extent; a missing file reports its errno and zeros its
    whole extent; bytes outside every extent are left alone."""
    if impl == "python":
        monkeypatch.setattr(native, "_load", lambda: None)
    elif not native.available():
        pytest.fail("the native ingest library did not build")
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, size=3000, dtype=np.uint8).tobytes()
    (tmp_path / "a").write_bytes(a)
    (tmp_path / "short").write_bytes(a[:700])
    path = lambda n: str(tmp_path / n).encode()  # noqa: E731
    jobs = [
        (path("a"), 100, 0, 1000),  # extent [0, 1024)
        (path("short"), 200, 1024, 900),  # 500 bytes left in the file
        (path("gone"), 0, 2048, 600),  # extent [2048, 3072)
        (path("a"), 2500, 3072, 500),  # extent [3072, 3584)
    ]
    buf = np.full(5000, 0xA5, dtype=np.uint8)
    errs = native.fill_segments(buf, jobs, 512, nthreads=3)
    want = np.full(5000, 0xA5, dtype=np.uint8)
    want[:3584] = 0
    want[0:1000] = np.frombuffer(a[100:1100], np.uint8)
    want[1024:1524] = np.frombuffer(a[200:700], np.uint8)
    want[3072:3572] = np.frombuffer(a[2500:3000], np.uint8)
    assert np.array_equal(buf, want)
    assert errs[0] == errs[1] == errs[3] == 0 and errs[2] == 2  # ENOENT
