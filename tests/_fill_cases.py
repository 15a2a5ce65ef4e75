"""The stale-slot sequences that tests/test_torch_fill.py (CPU) and
tests/test_torch_gpu.py (the card's pinned ring) drive through the scan
pipeline's reused fill slots: trees whose batches land in a slot that an
earlier batch wrote, a tap on DeviceScanner that records what each lane's
batches submitted and resolved, and a ``--stats -r`` scan of such a tree. No
import of the ``tests`` package, so that the card's test run, which
imports this module by its file's directory, finds it."""

import dataclasses
import io
import os
import re

import numpy as np

from grab_tpu_torch import cli as port_cli
from grab_tpu_torch.engine import Engine
from grab_tpu_torch.scan_pipeline import DeviceScanner, FillSlot

BUF = 1 << 20  # the smallest buffer with a stride member (MIN_STRIDE_BUF)
PATTERNS = {
    "linear": "needleXY",  # a literal: the core-word kernel reads the linear words
    "stride-only": "[A-Z]{6}[0-9]{6}",  # the union strided-DFA member alone
}
NEEDLES = b"needleXY ABCDEF123456"


def text(rng, n: int) -> bytearray:
    data = bytearray(rng.integers(97, 123, size=n, dtype=np.uint8).tobytes())
    data[::97] = b"\n" * len(data[::97])
    return data


def write_tree(root, case: str):
    """A 2.5 MiB file whose first MiB (batch 1, slot 0) is dense with
    both needles, then files whose batch 3 lands in slot 0 again: one
    small file after the big one's tail (stale_tail), files of sizes
    that are no multiple of 512 (padding), one removed or truncated
    after the walk has listed it (removed, shrunk). Returns the file
    that the walk's hook alters, or None."""
    rng = np.random.default_rng(17)
    big = text(rng, (5 << 19) + 1234)
    for pos in range(300, 1 << 20, 401):
        big[pos : pos + len(NEEDLES)] = NEEDLES
    big[-30 : -30 + len(NEEDLES)] = NEEDLES
    (root / "a_big.log").write_bytes(bytes(big))
    sizes = {
        "stale_tail": [7001],
        "padding": [1000, 777, 3333, 5121, 40_001, 513],
        "removed": [5000, 60_000, 9000],
        "shrunk": [5000, 60_000, 9000],
    }[case]
    for i, n in enumerate(sizes):
        data = text(rng, n)
        if n > 600:
            data[n - 25 : n - 25 + len(NEEDLES)] = NEEDLES  # a hit in the last block
        (root / f"b{i}.txt").write_bytes(bytes(data))
    return root / "b1.txt" if case in ("removed", "shrunk") else None


class Tap:
    """Records, per lane in order of first use, a copy of every buffer
    submitted and the flags resolved from it; counts the claims whose
    slot held bytes past the batch's end. With ``fresh`` every claim
    hands out a new zeroed buffer instead of the lane's slot."""

    def __init__(self, monkeypatch, fresh: bool):
        self.bufs, self.flags, self.stale_claims = [], [], 0
        self.lanes = []  # the lane of each record, in order of first use
        claimed = {}
        claim, submit, resolve = DeviceScanner.claim, DeviceScanner.submit, DeviceScanner.resolve

        def record(lane):
            if not any(l is lane for l in self.lanes):
                self.lanes.append(lane)
                self.bufs.append([])
                self.flags.append([])
            return next(i for i, l in enumerate(self.lanes) if l is lane)

        def tap_claim(sc, lane):
            if fresh:
                slot = FillSlot(np.zeros(sc._want, dtype=np.uint8))
                slot.dirty = 0
            else:
                slot = claim(sc, lane)
            claimed[id(slot.buf)] = (slot, slot.dirty)
            return slot

        def tap_submit(sc, lanes, bufs):
            for lane, buf in zip(lanes, bufs):
                slot, before = claimed.pop(id(buf))
                self.stale_claims += before > slot.dirty
                self.bufs[record(lane)].append(buf.copy())
            return submit(sc, lanes, bufs)

        def tap_resolve(sc, handle):
            flags = resolve(sc, handle)
            self.flags[record(handle[0])].append(flags.copy())
            return flags

        monkeypatch.setattr(DeviceScanner, "claim", tap_claim)
        monkeypatch.setattr(DeviceScanner, "submit", tap_submit)
        monkeypatch.setattr(DeviceScanner, "resolve", tap_resolve)


def scan_tree(tmp_path, case, pattern, shards, fresh, monkeypatch, device="cpu"):
    """One ``--stats -r`` scan of a new tree on ``shards`` lanes of
    ``device`` → (stdout, stats line, tap)."""
    root = tmp_path / ("fresh" if fresh else "reused")
    root.mkdir(parents=True)
    victim = write_tree(root, case)

    def factory(pats, cfg):
        eng = Engine(pats, dataclasses.replace(cfg, scan_buf_size=BUF))
        walk = eng._walk_iter

        def walked(r):
            for path, size in walk(r):
                yield path, size
                if victim is not None and path == str(victim):
                    if case == "removed":
                        os.remove(path)
                    else:
                        os.truncate(path, 20_000)

        eng._walk_iter = walked
        return eng

    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", ",".join([device] * shards))
    with monkeypatch.context() as m:
        tap = Tap(m, fresh)
        out, err = io.BytesIO(), io.StringIO()
        argv = ["--stats", "-r"] + (["-n", str(shards)] if shards > 1 else [])
        rc = port_cli.main(argv + [PATTERNS[pattern], str(root)], out=out, err=err,
                           engine_factory=factory)
    assert rc == 0, err.getvalue()
    line = [l for l in err.getvalue().splitlines() if l.startswith("tpugrep: ")][-1]
    return out.getvalue().replace(str(root).encode(), b"ROOT"), line, tap


def stats_field(line: str, name: str) -> int:
    return int(re.search(rf" {name}=(\d+)", line)[1])
