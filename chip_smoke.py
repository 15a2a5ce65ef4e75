#!/usr/bin/env python3
"""On-card smoke test of the grab_tpu_torch port (one NVIDIA H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It drives the port's paths through the CLI a user calls, on the CUDA
card, and fails (non-zero exit, no result line) if any phase fails:

  1. environment: torch, CUDA, the card's name and power limit;
  2. build: every kernel from the sources in the checkout (nvcc, sm_90a,
     one process per source, started together) and the native ingest
     library (g++), timed;
  3. each kernel against its plain PyTorch version at the main path's
     32 MiB geometry, bit for bit:
       - B1 core words ([65536 + 8, 128] int32) on text, binary and
         all-zero data with needles across block and 32-row group
         boundaries, at lane 127 and in the last word;
       - B4 class sequences (same geometry) with sets of 1, 8 and 32
         sequences, classes with bytes >= 0x80, the same data kinds and
         hit placements, also at 2045 groups (a multiple of 32 rows that
         no block of 8 groups divides) and at 40 MiB, with the
         profiler's split of its device time into the kernel body and
         the stream operations around it;
       - B2 strided-DFA walk (stream-major [512 * 128, 128], stride
         2048 B) for a plan of every family the planner emits (run k=4,
         k=2, k=1, runp, cls k=4 and k=2, 16-bit run and cls), start and
         random entries, bitmap and exit states, and an automaton that
         never synchronises (``Q(?:[a-z]{2})*Q`` over one Q per stream
         and lowercase letters: every segment's guess is wrong), also at
         77 and 5 word steps (not a multiple of the segment count); the
         words the kernel's fix-up re-walked, per case; then the scanner
         on the card against the plain path: the boundary-window pass
         (two walk launches), the threading fixpoint (one launch of the
         fixpoint kernel per run_t, whatever MAX_ROUNDS is: runs across
         stream boundaries, one longer than a stride, the grid capped at
         100 and 1 blocks, the non-synchronising automaton; the same
         number of walks) and the round-cap fallback at 2 and 1 walks;
       - B3 alphabet runs: coarse runs of 1, 2, 4 and 8 words and fine
         runs of 1, 2 and 4 bytes, ranges with byte 0 (the pad rows are
         members) and with bytes >= 0x80, runs planted across row,
         32-row group and buffer-end boundaries; at 2045 groups and at
         40 MiB too, and split as B4 is;
       - B5 XOR filter: 5, 40, 100 and 1000 literals of 7-11 bytes
         (remainder groups of arity 1 and 3 beside up to 10 full groups),
         needles at every phase, and a buffer of NUL words;
       - B6 fused ensemble: 100 long literals + 1 sequence, 60 short +
         40 long literals + 3 sequences, one bucket + 3 sequences, and the
         ensemble DeviceScanner builds for the 100-literal + 10-regex
         batch (``batch4``);
       - the last-resort DFA walk (csrc/dfa_walk.cu: the flags entry,
         one launch per buffer, and the counts entry, two) against its
         plain version on the card, total and packed flags and block
         counts: ``NO_PLAN`` (no stride plan) at 2 MiB and 32 MiB,
         ``.{0,2}[a-z ]{11}`` at 512 KiB, segments that are no multiple
         of the 512-byte block (2064 KiB: 64 of 33,024 bytes; 48 KiB: 64
         of 768 with a 768-byte halo), a class table too large for
         shared memory (1901 states x 64 classes, read from global
         memory) and an automaton that never synchronises
         (``Q(?:[a-z]{2})*Q`` over one Q a stream) at 32 MiB; matches
         planted across stream boundaries and ending in the halo must be
         flagged; the bytes the fix-up re-walked, per case;
       - B7 stride transpose ([16384, 512], [16384, 32], [16384, 640]
         int32 stream rows), beside one PyTorch call of the same
         function (``a.t().contiguous()``); then the scanner entries
         that run it: ``StrideDfaScanner.run`` on the linear upload
         against ``run_t`` on the buffer born transposed (a window-mode
         and a threading pattern) and ``_StrideSeqMember.packed``
         against ``packed_t``, hits planted across stream boundaries;
       - B8 bloom filter: 5, 100 and 1000 literals (3, 5 and 6 levels),
         needles at every phase and in the last row; then
         ``BloomWordScanner`` over three buffers: every block holding a
         planted literal is flagged;
  4. the main paths, each command through ``cli.main`` on the card with
     every launch counter set to 0 just before it and read just after;
     stdout must equal the port's host-only scan (device="none") byte
     for byte, and the command's route (DeviceScanner mode, member
     type) and its kernel's counter are checked:
       - the literal scan over a seeded corpus (one 64 MiB file and a
         tree of several thousand files plus 40-100 MiB files that span
         32 MiB batches);
       - class_seq through the union strided-DFA member
         (``[A-Z]{6}[0-9]{6}``) and through the class-sequence kernel
         (``\t[0-9]+\t``), and gdfa with the boundary windows
         (``.{0,2}[a-z ]{11}``), over a 2-batch tree with planted hits;
       - gdfa with the threading fixpoint (``-E
         .{0,2}(?:[0-9a-zA-Z]{4})+``) over a punctuation tree with runs
         across stream boundaries, one over 4 KiB, and one file over
         32 MiB, which is replayed in full;
       - alpha (``.{0,2}[0-9]{11}``; a backreference pattern with no
         automaton; a fine-mode plan), the last-resort walk kernel (an
         automaton without a stride plan; a stride-eligible one in a
         512 KiB buffer), and the literal ensemble: the 100-literal +
         10-regex batch (fused, and split with GRAB_TPU_NO_FUSED=1),
         100 literals + 10 bounded sequence patterns (fused + the
         stride member on two uploads, and with GRAB_TPU_SEQDFA=0 the
         sequences inside the fused kernel; a 4 MiB buffer over a 7 MB
         tree here, since the host-only scan runs 10 regex VMs, and the
         32 MiB buffer in the miss scan), ``-S -H`` with 100 literals,
         and 20 short literals;
     the host-only scans of the new routes (a Python regex VM, ~1 MB/s)
     run beside the card's work in subprocesses, each on a slice of the
     tree in walk order, and their outputs are joined in that order;
     then ``-n N``: ``-n 4`` caps at the cards present and prints what
     ``-n 1`` prints; with the device list ``cuda:0,cuda:0`` and ``-n 2``
     (two lanes and two streams on the one card: the group path, not
     scaling) one route of each mode prints what ``-n 1`` printed, and a
     miss scan's groups pull no payload; then the scan server as a
     subprocess (``python -m grab_tpu_torch.server``): requests through
     ``--via``'s client must print what the direct CLI printed, a
     nonexistent path gives exit 255, and the first and second ``-H``
     request are timed; then multi-host: two CLI processes sharing the
     card (``--hosts 2 --pid P --coordinator 127.0.0.1:PORT``, the
     store and gloo) for the literal miss scan over the tree, ``-O``
     with planted hits over mtree and ``-H batch4`` over gbulk (B6):
     host 0 prints what ``-n 1`` prints on the card, host 1 nothing,
     each process's launch counters read through ``--host-run`` (below),
     walls beside ``-n 1``'s (no rate is claimed); ``spot -n 8`` equals
     ``-n 1`` over the tree; B1's flags (32 MiB) and B2's (2 MiB) cover
     every block of an exact match from the port's ``golden``; and
     ``make_sharded_scan`` on ``cuda:0,cuda:0`` at 32 MiB per shard (a
     literal pattern through the literal kernel, csrc/literal_scan.cu,
     one launch per shard, and a literal-free one through the walk's
     counts entry in two launches per shard) equals the same call on
     the CPU, and the literal kernel alone equals its plain version on
     the card at 1, 16, 300 and 1000 literals and 300 literals sharing
     their first two bytes, in each of its forms; then the bench,
     ``python -m grab_tpu_torch.bench`` as a process at its full sizes
     (1 GiB headline, 256 MiB and 1 GiB
     stacks): exit 0, the headline one B1 launch within 1.05 of the run's
     measured roofline, each secondary metric once, finite, not suspect,
     every kernel but B7, W1 and W2 launched; and the dry run
     (``grab_tpu_torch.dryrun``): ``entry()`` gives (1, 2) on the card
     in one fixpoint launch, ``dryrun_multichip`` passes on
     ``cuda:0,cuda:0`` (and over every card when there are two or
     more), its byte step one literal-kernel launch per shard;
  5. times from CUDA events after warm-up: each kernel, its plain
     version, a device-to-device copy of the same bytes and the kernel's
     bound (the walk's also beside its longest chain of dependent
     lookups, and the chain of one thread per stream);
     then a miss or near-miss scan per route over the full-size trees
     (the last-resort walk's ``-r NO_PLAN tree`` among them): end-to-end
     rate, device idle share, the profiler's kernel times and the
     memsets and copies on the stream per scan;
  6. the card's name and power limit, a ``{"kernels": [...]}`` line and,
     last, ``{"ok": true, "device": {...}}``.

Details go to smoke_out/chip_smoke.json. The script imports nothing
of JAX (``jax`` is blocked in sys.modules) and nothing of grab_tpu.

``python3 chip_smoke.py --host-run COUNTS -- ARGS`` is the multi-host
phase's child: ``grab_tpu_torch.cli.main(ARGS)`` with its launch
counters written to COUNTS.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None  # the port must never reach JAX

SEED = 20261016
BUF = 32 << 20  # the device scan buffer of the main path
ROWS = BUF // 512
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
INT32_LANES_PER_SM = 64  # Hopper SM: 64 INT32 lanes (NVIDIA H100 white paper)
SLEEP_CYCLES = 100_000_000  # ~50 ms at 2 GHz: covers queueing 40 launches on a busy host

LITERAL_SETS = {
    "linus": [b"linus"],
    "needleXY": [b"needleXY"],
    "l[imn]nus": [b"linus", b"lmnus", b"lnnus"],
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


_T0 = time.time()


def log(msg: str) -> None:
    print(f"[chip_smoke {time.time() - _T0:5.0f}s] {msg}", flush=True)


def smi(query: str) -> str:
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0].strip()


def k16_literals(rng):
    """16 literals of 3-20 bytes, four of them 7+ bytes long, some with
    bytes >= 0x80 (negative int32 table entries)."""
    lens = [3, 4, 5, 6, 3, 4, 5, 6, 3, 4, 5, 6, 7, 11, 16, 20]
    out = []
    for i, n in enumerate(lens):
        lo, hi = (0x80, 256) if i % 3 == 0 else (0x41, 0x7B)
        out.append(bytes(rng.integers(lo, hi, size=n, dtype="u1").tolist()))
    return out


def kernel_buffers(np, rng, lits):
    """Host int32 [ROWS + 8, 128] word buffers: text, binary, zeros,
    each with the literals planted at the awkward places."""
    n = BUF
    text = rng.integers(32, 127, size=n, dtype=np.uint8)
    text[::97] = 0x0A
    binary = rng.integers(0, 256, size=n, dtype=np.uint8)
    zeros = np.zeros(n, dtype=np.uint8)
    spots = []
    for g in (1, 7, 1000, ROWS // 32 - 1):  # 32-row group boundaries
        spots += [g * 32 * 512 - 3, g * 32 * 512 - 1]
    for r in (0, 5, 4097, ROWS - 2):  # lane 127 → next row's lane 0
        spots += [r * 512 + 508 - 1, r * 512 + 509, r * 512 + 510]
    for b in (3, 64, 12345):  # block boundaries, every phase
        spots += [b * 512 - 2, b * 512 - 4, b * 512 + 1]
    out = {}
    for name, base in (("text", text), ("binary", binary), ("zeros", zeros)):
        buf = base.copy()
        for i, pos in enumerate(spots):
            lit = lits[i % len(lits)]
            buf[pos : pos + len(lit)] = np.frombuffer(lit, dtype=np.uint8)
        # a literal ending in the buffer's very last word
        last = lits[-1]
        buf[n - len(last) :] = np.frombuffer(last, dtype=np.uint8)
        words = np.zeros((ROWS + 8, 128), dtype="<i4")
        words[:ROWS] = buf.view("<i4").reshape(ROWS, 128)
        out[name] = words
    return out


def time_cuda(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device ms per call of fn(i) over ``iters`` calls, between
    two CUDA events. A sleep kernel queued first keeps the card busy
    while the host queues the calls, so host launch cost (tens of us
    of Python per wrapper call) leaves no gaps between them."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


ODD_ROWS = ROWS - 3 * 32  # 2045 groups: a multiple of 32 rows, of no larger block
ROWS_40M = (40 << 20) // 512  # 40 MiB, as B2's tiles are checked


def reshaped(np, words, rows: int):
    """A word buffer of ``rows`` rows (+ 8 zero pad rows) cut from, or
    repeated out of, a [ROWS + 8, 128] one; its last 64 bytes are the
    source's last 64, so a hit ends in the buffer's last word."""
    body = np.resize(words[:ROWS], (rows, 128))
    body[-1, -16:] = words[ROWS - 1, -16:]
    return np.concatenate([body, np.zeros((8, 128), dtype=words.dtype)])


def profile_split(torch, fn, iters: int = 20):
    """Device ms per call of fn(i), by the profiler's names: the kernel
    body apart from the stream operations queued around it (memsets,
    copies). → {name: mean ms per recorded op} (the mean over the ops the
    profiler recorded, which may be fewer than the calls)."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if t and e.count:
            out[e.key] = t / 1e3 / e.count
    return out


def word_kernel_case(torch, label, bufs, kernel, plain, ops, rate, extra, shapes=False):
    """One word kernel on the card against its plain version, bit for
    bit, on every buffer of ``bufs`` ({kind: host int32 [ROWS + 8,
    128]}), and with ``shapes`` also on each cut to ODD_ROWS rows and
    grown to 40 MiB, plus the profiler's split of its device time into
    the kernel body and the stream operations around it; then its time,
    the plain version's, a device copy's and the bound, on the text
    buffer. kernel(w) → (total, packed, bm); plain(w) → bm; ops: int32
    operations the test needs on the text buffer (a number, or a
    function of the device buffer)."""
    from grab_tpu_torch.ops import corewords as cw
    import numpy as np

    dev = torch.device("cuda")

    def agree(w, dname):
        check(w.is_cuda, f"{dname} buffer is not on the card")
        total, packed, bm = kernel(w)
        torch.cuda.synchronize()
        bm_ref = plain(w)
        total_ref, packed_ref = cw.packed_block_flags(bm_ref)
        torch.cuda.synchronize()
        check(
            torch.equal(bm, bm_ref) and torch.equal(packed, packed_ref)
            and torch.equal(total, total_ref),
            f"{label}: kernel != plain on {dname} data "
            f"(total {int(total.item())} vs {int(total_ref.item())})",
        )
        check(int(total.item()) > 0, f"{label}: planted hits not flagged on {dname}")

    dev_bufs = {k: torch.from_numpy(v).to(dev) for k, v in bufs.items()}
    for dname, w in dev_bufs.items():
        agree(w, dname)
    if shapes:
        for dname, v in bufs.items():
            for rows in (ODD_ROWS, ROWS_40M):
                agree(torch.from_numpy(reshaped(np, v, rows)).to(dev), f"{dname} {rows} rows")
    first = next(iter(dev_bufs.values()))
    ring = [first] + [first.clone() for _ in range(3)]
    ms = time_cuda(torch, lambda i: kernel(ring[i % 4]), 40)
    plain_ms = time_cuda(torch, lambda i: cw.packed_block_flags(plain(ring[i % 4])), 3, warmup=1)
    dst = torch.empty_like(ring[0])
    copy_ms = time_cuda(torch, lambda i: dst.copy_(ring[i % 4]), 40)
    in_bytes = ring[0].numel() * 4
    out_bytes = (ROWS // 32) * 128 * 4 + (ROWS // 32) * 4 + 4
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    n_ops = ops(ring[0]) if callable(ops) else ops
    ops_ms = n_ops / rate * 1e3
    res = dict(extra, max_abs_err=0, ms=ms, plain_ms=plain_ms, copy_ms=copy_ms,
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
               bytes=in_bytes + out_bytes, int32_ops=n_ops)
    if shapes:
        res["device_ms_by_name"] = split = profile_split(torch, lambda i: kernel(ring[i % 4]))
        log(f"{label}: also == plain at {ODD_ROWS} and {ROWS_40M} rows; device ms per launch "
            f"by name: {split}")
    log(f"{label}: kernel == plain, bit for bit, on {'/'.join(dev_bufs)}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, d2d copy {copy_ms:.4f} ms, bound "
        f"{max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, int32 ops {ops_ms:.4f})")
    return res


def phase_kernels(torch, np, cw, rng, rate):
    """B1 against its plain version at 32 MiB geometry, bit for bit."""
    sets = dict(LITERAL_SETS)
    sets["k16-mixed"] = k16_literals(rng)
    results = []
    for name, lits in sets.items():
        t = cw.CoreWordTests(lits)
        # least integer work: per (phase, literal) pair and word, one
        # 3-input logic op (LOP3: (x ^ v) & m, or OR-ing in the second
        # word's term) per tested word plus one compare-accumulate per
        # word when masked (2W), one compare per word when not (W)
        per_pair = 2 * t.n_words if t.masked else t.n_words
        results.append(word_kernel_case(
            torch, f"core words {name} (K={t.k}, W={t.n_words}, masked={t.masked})",
            kernel_buffers(np, rng, lits),
            lambda w: cw.core_word_flags(w, t.tab, t.k, t.n_words, t.masked),
            lambda w: cw.core_word_bitmap_torch(w, t.tab, t.k, t.n_words, t.masked),
            4 * t.k * per_pair * ROWS * 128, rate,
            {"set": name, "literals": len(lits), "k": t.k, "n_words": t.n_words,
             "masked": t.masked}))
    return results


def write_corpus(np, root: str, rng):
    """Seeded corpus: big.txt (64 MiB) beside tree/ (several thousand
    files, log-uniform 1 KiB-1 MiB, plus 40-100 MiB files). Returns
    (big file path, tree path, planted needle count)."""
    base = rng.integers(32, 127, size=128 << 20, dtype=np.uint8)
    base[::97] = 0x0A
    needles = [b"needleXY", b"linus", b"lmnus", b"lnnus", b"fooqbar", b"fooabcbar"]
    planted = 0

    def put(path, size, extra=()):
        nonlocal planted
        off = int(rng.integers(0, base.size - size))
        data = base[off : off + size].copy()
        pos = list(extra)
        if size > 64:
            pos += rng.integers(0, size - 16, size=1 + size // (4 << 20)).tolist()
        for p in pos:
            lit = needles[int(rng.integers(0, len(needles)))]
            p = min(int(p), size - len(lit))
            data[p : p + len(lit)] = np.frombuffer(lit, dtype=np.uint8)
            planted += 1
        with open(path, "wb") as f:
            f.write(data.tobytes())

    big = os.path.join(root, "big.txt")
    put(big, 64 << 20, extra=[0, 512 * 1000 - 3, (64 << 20) - 20])
    tree = os.path.join(root, "tree")
    sizes = np.exp(rng.uniform(np.log(1 << 10), np.log(1 << 20), size=3600))
    for i, s in enumerate(sizes.astype(np.int64)):
        d = os.path.join(tree, f"d{i % 48:02d}", f"e{i % 5}")
        os.makedirs(d, exist_ok=True)
        put(os.path.join(d, f"f{i:05d}.txt"), int(s))
    for i, mib in enumerate((40, 57, 73, 100)):
        put(os.path.join(tree, f"d{i:02d}", f"large{i}.log"), (mib << 20) + 1234 * i)
    return big, tree, planted


def plant_in_halos(np, tree: str, buf_size: int) -> int:
    """Plant needles inside the 4 KiB halos where the packer splits
    large files across batches (the continuation segments' heads)."""
    from grab_tpu_torch.ingest.packer import BatchPacker
    from grab_tpu_torch.ingest.walker import walk_files
    from grab_tpu_torch.scan_pipeline import HALO

    # the CLI walks in this order and packs with these parameters
    entries = [(e.path, e.size) for e in walk_files(tree)]
    packer = BatchPacker(buf_size, 512, HALO)
    segs = []
    for idx, (_path, size) in enumerate(entries):
        for batch in packer.feed_size(idx, size):
            segs += batch.segments
    final = packer.finish()
    if final is not None:
        segs += final.segments
    conts = [(entries[s.file_idx][0], s.file_off) for s in segs if s.file_off > 0]
    check(len(conts) >= 4, f"only {len(conts)} files span batches")
    n = 0
    for path, off in conts:
        fd = os.open(path, os.O_WRONLY)
        try:
            os.pwrite(fd, b"needleXY", off + 100)
            os.pwrite(fd, b"linus", off + HALO - 3)  # straddles the halo end
        finally:
            os.close(fd)
        n += 2
    return n


def run_cli(cli, argv, factory=None):
    out, err = io.BytesIO(), io.StringIO()
    rc = cli.main(list(argv), out=out, err=err, engine_factory=factory)
    return rc, out.getvalue(), err.getvalue()


def phase_main_path(torch, np, rng, tmp):
    from grab_tpu_torch import cli
    from grab_tpu_torch.engine import Engine

    t0 = time.time()
    big, tree, planted = write_corpus(np, tmp, rng)
    planted += plant_in_halos(np, tree, BUF)
    tree_bytes = sum(
        os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tree) for f in fs
    )
    n_files = sum(len(fs) for _, _, fs in os.walk(tree))
    log(f"corpus: {n_files} files, {tree_bytes} bytes in the tree + 64 MiB file, "
        f"{planted} needles planted, written in {time.time() - t0:.1f}s")
    check(tree_bytes >= 512 << 20, "tree smaller than 512 MiB")

    def host(pats, cfg):
        return Engine(pats, dataclasses.replace(cfg, device="none"))

    commands = [
        ["-S", "needleXY", big],
        ["-r", "-S", "needleXY", tree],
        ["-r", "linus", tree],
        ["-r", "-O", "foo[a-z]+bar", tree],
        ["-r", "l[imn]nus", tree],
        ["-r", "-l", "-O", "linus", tree],
        ["-r", "zQx##missing##", tree],
    ]
    runs, launches = [], 0
    for argv in commands:
        reset_counters()
        t1 = time.time()
        rc, out, err = run_cli(cli, argv)
        dev_s = time.time() - t1
        n = read_counters()["corewords"]
        t1 = time.time()
        rc_h, out_h, err_h = run_cli(cli, argv, factory=host)
        host_s = time.time() - t1
        shown = " ".join(a if not a.startswith(tmp) else os.path.relpath(a, tmp) for a in argv)
        check(rc == 0 and rc_h == 0, f"{shown}: rc {rc} / host rc {rc_h}: {err}{err_h}")
        check(out == out_h, f"{shown}: device stdout ({len(out)} B) != host stdout ({len(out_h)} B)")
        check(n > 0, f"{shown}: the core-word kernel was never launched")
        if "zQx##missing##" in argv:
            check(out == b"", "miss scan printed matches")
        else:
            check(len(out) > 0, f"{shown}: no matches printed for planted needles")
        launches += n
        runs.append({"argv": shown, "stdout_bytes": len(out), "launches": n,
                     "device_s": dev_s, "host_s": host_s})
        log(f"stdout == host scan: {shown} ({len(out)} B, {n} launches, "
            f"device run {dev_s:.2f}s, host run {host_s:.2f}s)")
    return tree, tree_bytes, n_files, runs, launches


def phase_e2e(torch, np, tree, argv=None, counter="corewords"):
    """A miss (or near-miss) scan over the tree: end-to-end rate, then a
    profiled run for the device's busy and idle share. ``counter``: the
    kernel (or kernels, space-separated) that the scan must launch. The
    Engine's construction (pattern compile, tables) is timed apart: it
    is part of every wall. The engines record their spans, so the logged
    stats split the scan by host stage."""
    from grab_tpu_torch import cli
    from grab_tpu_torch.engine import Engine

    engines, build_s = [], []

    def keep(pats, cfg):
        cfg.record = True
        t0 = time.perf_counter()
        e = Engine(pats, cfg)
        build_s.append(time.perf_counter() - t0)
        engines.append(e)
        return e

    argv = argv or ["-r", "zQx##missing##", tree]
    reset_counters()
    rc, warm_out, _ = run_cli(cli, argv, factory=keep)  # warm: page cache, build
    check(rc == 0 and all(read_counters()[c] > 0 for c in counter.split()),
          f"{argv[:-1]}: rc {rc}, the {counter} kernel was never launched")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        rc, out, _ = run_cli(cli, argv, factory=keep)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(rc == 0 and out == warm_out, f"{argv[:-1]}: scan failed or changed output")
    st = engines[-1].stats
    nbytes = st.bytes_scanned
    gbps = [nbytes / w / 1e9 for w in walls]
    log(f"scan {argv[:-1]}: {nbytes} bytes, {len(out)} B of output, walls {walls} s (Engine "
        f"built in {build_s[1:4]} s of them) → {gbps} GB/s; batches={st.device_batches}, stats: {st.summary()}")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_cli(cli, argv, factory=keep)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if t:
            by_name[e.key] = {"ms": t / 1e3, "count": e.count}
    # the stream operations beside the kernels: memsets, and the copies
    # to the card split at 0.05 ms into batch uploads and small ones
    # (a descriptor)
    stream_ops = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name.startswith(("Memset", "Memcpy")):
            dur = (e.time_range.end - e.time_range.start) / 1e3
            key = e.name if e.name.startswith("Memset") or dur >= 0.05 else e.name + " < 0.05 ms"
            op = stream_ops.setdefault(key, {"count": 0, "ms": 0.0})
            op["count"] += 1
            op["ms"] += dur
    kernel_ms = {k: v for k, v in by_name.items() if any(c in k for c in counter.split())}
    idle = None if not spans else max(0.0, 1.0 - busy / wall_us)
    log(f"profiled scan: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms, idle share "
        f"{'not measured (no device events)' if idle is None else f'{idle:.4f}'}")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[:8]:
        log(f"  device ms {v['ms']:.3f} over {v['count']} calls  {k}")
    log(f"  the {counter} kernels per scan: {kernel_ms}; stream copies and memsets: {stream_ops}")
    return {
        "argv": [a if a != tree else os.path.basename(tree) for a in argv],
        "stdout_bytes": len(out), "bytes": nbytes, "walls_s": walls, "gbps": gbps,
        "engine_build_s": build_s[1:4],
        "device_batches": st.device_batches, "stats": st.summary(),
        "profiled_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "idle_share": idle, "device_ms_by_name": by_name,
        "kernel_ms": kernel_ms, "stream_ops": stream_ops,
    }


# -- B4: class sequences ------------------------------------------------------

HIGH = sum(1 << b for b in range(0x80, 0xC0)) | (1 << 0xFF)
DIGIT = sum(1 << b for b in range(48, 58))


def seq_sets(np, rng):
    """{name: compiled sequences}: the main path's 1-sequence set
    (\\t[0-9]+\\t), 8 sequences and 32 random ones, with classes of
    bytes >= 0x80."""
    from grab_tpu_torch.ops.classseq import compile_sequences
    from grab_tpu_torch.regex.compiler import compile_multi

    many = []
    for i in range(32):
        seq = []
        for j in range(1 + i % 8):
            lo = int(rng.integers(0, 250))
            m = sum(1 << b for b in range(lo, lo + 1 + int(rng.integers(0, 6))))
            seq.append(m | (HIGH if (i + j) % 5 == 0 else 0))
        many.append(tuple(seq))
    eight = [tuple([DIGIT] * (1 + i)) for i in range(7)] + [(HIGH, DIGIT, HIGH)]
    return {
        "\\t[0-9]+\\t": compile_sequences(compile_multi([rb"\t[0-9]+\t"]).class_seqs),
        "8 seqs": compile_sequences(eight),
        "32 seqs": compile_sequences(many),
    }


def seq_needle(seq, rng) -> bytes:
    """One byte string in the sequence's classes."""
    out = []
    for ranges in seq:
        lo, hi = ranges[int(rng.integers(0, len(ranges)))]
        out.append(int(rng.integers(lo, hi + 1)))
    return bytes(out)


def b4_ops(torch, w, seqs) -> int:
    """Integer operations the SWAR form (1-8 sequences) needs on these
    words: per
    sequence evaluated before the word's first hit, the classes tested
    (all 4 phases at once) until no phase is left or the sequence ends,
    each 4 ops (funnel shift, 7-bit mask, high-bit mask, AND into the
    live phases) plus 5 per range (two 4-byte compares of an add and a
    3-input logic op each, one 3-input AND-NOT-OR)."""
    rows = w.shape[0] - 8
    n = rows * 128
    data = w.view(torch.uint8).reshape(-1)
    alive = torch.ones(n, dtype=torch.bool, device=w.device)
    ops = 0
    for seq in seqs:
        live = alive.unsqueeze(1).repeat(1, 4)  # [word, phase]
        for j, ranges in enumerate(seq):
            tested = live.any(dim=1)
            ops += int(tested.sum()) * (4 + 5 * len(ranges))
            b = torch.stack([data[p + j : p + j + 4 * n : 4] for p in range(4)], dim=1)
            member = torch.zeros_like(live)
            for lo, hi in ranges:
                member |= (b >= lo) & (b <= hi)
            live &= member
        alive &= ~live.any(dim=1)
    return ops


def b4_table_ops(torch, w, seqs) -> int:
    """Integer operations the table form needs on these words (9-32
    sequences, csrc/classseq.cu): per start byte, the classes read until
    the AND of their sequence bits is zero or the longest sequence ends,
    each 4 ops (byte extract, address, shared-memory read, AND)."""
    import numpy as np

    from grab_tpu_torch.ops import classseq as cq

    raw = cq.seq_tables(seqs)
    span = int(raw[:4].view("<i4")[0])
    t = torch.from_numpy(raw[8:].view("<u4").astype(np.int64).reshape(8, 256)).to(w.device)
    n = (w.shape[0] - 8) * 128 * 4
    data = w.view(torch.uint8).reshape(-1).to(torch.int64)
    alive = t[0][data[:n]]
    ops = 4 * n
    for j in range(1, span):
        ops += 4 * int((alive != 0).sum())
        alive &= t[j][data[j : n + j]]
    return ops


def phase_classseq(torch, np, rng, rate):
    """B4 against its plain version at 32 MiB geometry, bit for bit."""
    from grab_tpu_torch.ops import classseq as cs

    results = []
    for name, seqs in seq_sets(np, rng).items():
        needles = [seq_needle(s, rng) for s in seqs]
        results.append(word_kernel_case(
            torch, f"class sequences {name} ({len(seqs)} sequences)",
            kernel_buffers(np, rng, needles),
            lambda w: cs.classseq_flags(w, seqs), lambda w: cs.classseq_bitmap_torch(w, seqs),
            (lambda w: b4_table_ops(torch, w, seqs)) if len(seqs) >= cs.TABLE_MIN_SEQS
            else (lambda w: b4_ops(torch, w, seqs)), rate, {"set": name, "seqs": len(seqs)},
            shapes=True))
    return results


# -- B2: the strided-DFA walk -----------------------------------------------

STRIDE_PLANS = [  # (pattern, expected plan)
    (rb".{0,2}(?:[0-9a-zA-Z]{4})+", ("run", 2)),  # the gdfa main path's
    (rb"[0-9]{5}", ("run", 4)),
    (rb"needle|[a-z]{3}[0-9]{3}", ("run", 1)),
    (rb"[acegikmoqsuwy]{3}", ("runp", 2)),
    (rb"[adgjmpsvy]{3}", ("cls", 4)),
    (rb".{0,2}[a-z ]{11,}", ("cls", 2)),
    (rb".{0,2}[a-y]{200}", ("run16", 1)),
    (rb"[0-9]{200}", ("cls16", 2)),
    (rb"[0-9]{1500}", ("cls16", 1)),
]
STRIDE_ALPHABET = b"0123456789abcdefgxyz acegikmoqsuwy \n-AZ\x80\xff"
# an automaton that never synchronises inside a segment: after a Q the
# state carries the parity of the letters since, which a guess walked
# from the start state never has
NOSYNC = (rb"Q(?:[a-z]{2})*Q", ("run", 2))


def nosync_words(np, rng, s_w: int):
    """Stream-major words of one Q per stream followed by lowercase
    letters only."""
    raw = rng.choice(np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8), size=(16384, 4 * s_w))
    raw[:, 0] = ord("Q")
    lin = np.ascontiguousarray(raw).reshape(-1).view("<i4").reshape(16384, s_w)
    return np.ascontiguousarray(lin.T).reshape(s_w * 128, 128)


def phase_stride(torch, np, rng, sm_count, sm_clock_mhz, rng5):
    """B2 against its plain walk at the 32 MiB stream-major geometry,
    bit for bit (bitmap and exit states), every plan family, start and
    random entries, and the words its fix-up re-walked; an automaton
    that never synchronises (every segment's guess wrong) at 32 MiB and
    at word-step counts that are not a multiple of the segment count;
    then times and bounds. The non-synchronising case draws from rng5,
    so the other cases' and later phases' data stay what they were."""
    from grab_tpu_torch.ops import stridedfa as sd
    from grab_tpu_torch.regex.compiler import compile_multi

    dev = torch.device("cuda")
    s_w = BUF // sd.N_STREAMS // 4  # 512 word steps
    alpha = np.frombuffer(STRIDE_ALPHABET, np.uint8)
    text = rng.choice(alpha, size=BUF).view("<i4").reshape(s_w * 128, 128)
    binary = rng.integers(0, 256, size=BUF, dtype=np.uint8).view("<i4").reshape(s_w * 128, 128)
    dev_bufs = {"text": torch.from_numpy(text).to(dev), "binary": torch.from_numpy(binary).to(dev)}
    ring = [dev_bufs["text"]] + [dev_bufs["text"].clone() for _ in range(3)]
    dst = torch.empty_like(ring[0])
    copy_ms = time_cuda(torch, lambda i: dst.copy_(ring[i % 4]), 40)
    cycles = sd.link_cycles(dev)
    int32_ops_per_s = sm_count * INT32_LANES_PER_SM * sm_clock_mhz * 1e6
    log(f"walk link latency: {cycles:.1f} SM cycles (dependent IMAD + shared load + AND)")
    def held(t, label, bufs, rand):
        """The walk against the plain walk on every buffer, start and
        random entries → {(buffer, entries): words the fix-up re-walked}."""
        starts = torch.full((128, 128), t.start, dtype=torch.int32, device=dev)
        rewalked = {}
        for dname, w in bufs.items():
            for ename, e in (("start", starts), ("random", rand)):
                sd.fixup_words(dev, reset=True)
                bm, ex = sd.stride_dfa_scan(w, t, e)
                torch.cuda.synchronize()
                rewalked[f"{dname}/{ename}"] = sd.fixup_words(dev, reset=True)
                bm_p, ex_p = sd.stride_dfa_scan_torch(w, t, e)
                torch.cuda.synchronize()
                check(torch.equal(bm, bm_p) and torch.equal(ex, ex_p),
                      f"strided-DFA kernel != plain for {label} ({t.mode}, k={t.k}) "
                      f"on {dname} data, {ename} entries")
        log(f"walk == plain, bit for bit: {label} ({t.mode}, k={t.k}) on {'/'.join(bufs)}, "
            f"start/random entries; words re-walked by the fix-up: {rewalked}")
        return starts, rewalked

    results = []
    for pat, plan in STRIDE_PLANS + [NOSYNC]:
        dfa = compile_multi([pat]).dfa
        got_plan = sd.stride_plan(dfa)
        check(got_plan == plan, f"{pat!r}: plan {got_plan}, expected {plan}")
        t = sd.StrideDfaTables(dfa, plan)
        nosync = (pat, plan) == NOSYNC
        rand = torch.from_numpy(
            (rng5 if nosync else rng).integers(0, t.n_states, (128, 128), dtype=np.int32)).to(dev)
        bufs = dev_bufs
        if nosync:
            bufs = {"Q + lowercase": torch.from_numpy(nosync_words(np, rng5, s_w)).to(dev)}
            # word-step counts that are not a multiple of the segment count
            for sw in (77, 5):
                held(t, f"{pat!r} at s_w={sw}", {f"Q + lowercase, s_w={sw}":
                     torch.from_numpy(nosync_words(np, rng5, sw)).to(dev),
                     f"text, s_w={sw}": dev_bufs["text"][: sw * 128]}, rand)
        starts, rewalked = held(t, repr(pat), bufs, rand)
        name = pat.decode("latin-1")
        ring_p = [bufs[next(iter(bufs))]] * 4 if nosync else ring
        ms = time_cuda(torch, lambda i: sd.stride_dfa_scan(ring_p[i % 4], t, starts), 20)
        plain_ms = time_cuda(torch, lambda i: sd.stride_dfa_scan_torch(ring_p[i % 4], t, starts),
                             2, warmup=1)
        in_bytes = BUF + 128 * 128 * 4
        out_bytes = (s_w * 128 // 16) * 128 * 4 + 128 * 128 * 4
        bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        # integer work per word: 4 byte extractions, 4 - 4/k index adds,
        # per link one multiply-add, an OR and an AND, and 2 to fold the
        # word's hit into its mask (the shared loads are not counted)
        links = 4 // t.k
        ops = s_w * sd.N_STREAMS * (4 + (4 - links) + 3 * links + 2)
        ops_ms = ops / int32_ops_per_s * 1e3
        # the longest dependent chain: a segment and its warm-up (with
        # one thread per stream it would be the whole stream)
        chain_links = sd.chain_links(s_w, t.k)
        chain_ms = chain_links * cycles / (sm_clock_mhz * 1e6) * 1e3
        stream_chain_ms = s_w * links * cycles / (sm_clock_mhz * 1e6) * 1e3
        results.append({
            "pattern": name, "mode": t.mode, "k": t.k, "states": t.n_states, "m": t.m,
            "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "copy_ms": copy_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms, "chain_ms": chain_ms,
            "stream_chain_ms": stream_chain_ms, "link_cycles": cycles,
            "links_per_chain": chain_links, "links_per_stream": s_w * links,
            "rewalked_words": rewalked,
        })
        log(f"walk {name} ({t.mode}, k={t.k}, {t.n_states} states): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms, d2d copy {copy_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} "
            f"ms, chain {chain_ms:.4f} ms ({chain_links} links; a whole stream "
            f"{stream_chain_ms:.4f} ms)")
    del ring, dev_bufs, dst
    return results


def punct_bytes(np, rng, n: int):
    """Punctuation-heavy bytes: alnum runs of 4+ (the threading
    pattern's matches) occur only where planted."""
    return rng.choice(np.frombuffer(b" -_=+()\n", dtype=np.uint8), size=n)


def plant_run(buf, pos: int, span: int):
    import numpy as np

    span = min(span, buf.shape[0] - pos)
    buf[pos : pos + span] = np.frombuffer((b"a1B2" * (span // 4 + 1))[:span], np.uint8)


def phase_stride_scanner(torch, np, rng, rng5):
    """StrideDfaScanner on the card against the plain path (the same
    scanner on the CPU, whose fixpoint is stride_fixpoint_torch): window
    pass (two walk launches), the threading fixpoint (ONE launch of the
    fixpoint kernel whatever MAX_ROUNDS is; its later walks re-walk only
    the streams whose entry changed) for (bm, walks, converged), also
    with the grid capped below 256 blocks (each block then walks several
    stream tiles), the never-synchronising automaton, the round cap;
    with the words the kernel's fix-up re-walked, and each fixpoint
    case's time beside its plain version on the card and its bound.
    → (results by case, the fixpoint cases' rows)."""
    from grab_tpu_torch.ops import stridedfa as sd
    from grab_tpu_torch.regex.compiler import compile_multi

    dev = torch.device("cuda")
    out, rows = {}, []

    def compare(label, pat, buf, rounds=None, plain_on_card=False, max_blocks=0):
        cp = compile_multi([pat])
        sc = sd.StrideDfaScanner(cp.dfa, cp.max_len, buf.size)
        w = sc.prep_t(buf)
        wd = torch.from_numpy(w).to(dev)

        def run():  # run_t, or its fixpoint with the grid capped at max_blocks
            if max_blocks:
                return sd.stride_dfa_fixpoint(wd, sc.tables, max_blocks=max_blocks)
            return sc.run_t(wd)

        sd.fixup_words(dev, reset=True)
        fix0, walk0 = sd.stride_dfa_fixpoint.launches, sd.stride_dfa_scan.launches
        bm, n, conv = run()
        launched = (sd.stride_dfa_fixpoint.launches - fix0, sd.stride_dfa_scan.launches - walk0)
        torch.cuda.synchronize()
        rewalked = sd.fixup_words(dev, reset=True)
        check(launched == ((0, 2) if sc.window_mode else (1, 0)),
              f"{label}: (fixpoint, walk) launches {launched}")
        bm_p, n_p, conv_p = sc.run_t(torch.from_numpy(w))
        check(torch.equal(bm.cpu(), bm_p), f"{label}: bitmap on the card != plain path")
        check((int(n), bool(conv)) == (int(n_p), bool(conv_p)),
              f"{label}: walks/converged {int(n)}/{bool(conv)} != plain {n_p}/{conv_p}")
        if rounds is not None:
            check(rounds(int(n), bool(conv)), f"{label}: unexpected walks {int(n)}, {bool(conv)}")
        nb = buf.size // 512
        flags = sc.flags_np(bm.cpu().numpy(), nb)
        check(np.array_equal(flags, sc.flags_np(bm_p.numpy(), nb)), f"{label}: flags differ")
        grid = None if sc.window_mode else sd.stride_dfa_fixpoint.grid
        ms = time_cuda(torch, lambda i: run(), 10)
        out[label] = {"walks": int(n), "converged": bool(conv), "ms": ms,
                      "flagged_blocks": int(flags.sum()), "window_mode": sc.window_mode,
                      "rewalked_words": rewalked, "launches": launched, "grid": grid,
                      "cap": max_blocks}
        if not sc.window_mode:
            # the function reads the buffer once and writes the bitmap
            # once, however many walks it takes
            bytes_ms = (wd.numel() + bm.numel()) * 4 / HBM_BYTES_PER_S * 1e3
            plain_ms = None
            if plain_on_card:
                plain_ms = time_cuda(
                    torch, lambda i: sd.stride_fixpoint_torch(wd, sc.tables, sd.MAX_ROUNDS), 1,
                    warmup=0)
            copy = torch.empty_like(wd)
            rows.append({"case": label, "walks": int(n), "converged": bool(conv), "grid": grid,
                         "rewalked_words": rewalked, "max_abs_err": 0, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bytes_ms, "bound_by": "bytes",
                         "copy_ms": time_cuda(torch, lambda i: copy.copy_(wd), 10)})
            del copy
        log(f"scanner on the card == plain path: {label} (walks {int(n)}, converged "
            f"{bool(conv)}, {int(flags.sum())} flagged blocks, {rewalked} words re-walked "
            f"by the fix-up, (fixpoint, walk) launches {launched}, grid {grid}, {ms:.4f} ms "
            f"per {buf.size >> 20} MiB"
            + (f", plain {rows[-1]['plain_ms']:.1f} ms" if rows and rows[-1]["case"] == label
               and rows[-1]["plain_ms"] else "") + ")")
        return flags

    text = rng.integers(33, 127, size=BUF, dtype=np.uint8)
    for s in range(1, 16384, 97):  # "hello world" across stream boundaries
        pos = s * 2048 - 5
        text[pos : pos + 11] = np.frombuffer(b"hello world", np.uint8)
    flags = compare("window pass, .{0,2}[a-z ]{11}", rb".{0,2}[a-z ]{11}", text,
                    rounds=lambda n, c: n == 1 and c)
    check(flags[(98 * 2048 - 5) // 512] == 1, "window pass missed a boundary hit")

    punct = punct_bytes(np, rng, BUF)
    for s in range(3, 16000, 211):  # runs across stream boundaries
        plant_run(punct, s * 2048 - 9, 30)
    plant_run(punct, 5 * 2048 + 100, 6000)  # longer than a whole stride
    compare("fixpoint, .{0,2}(?:[0-9a-zA-Z]{4})+", rb".{0,2}(?:[0-9a-zA-Z]{4})+", punct,
            rounds=lambda n, c: c and n >= 2, plain_on_card=True)
    # a[0-9]*b: the in-digits state crosses one stream per walk, so a
    # digit run over 3 strides needs 4+ walks
    digits = np.full(BUF, ord(" "), dtype=np.uint8)
    for pos, span in ((9 * 2048 + 100, 7000), (4000 * 2048 - 30, 50), (BUF - 3000, 2990)):
        digits[pos] = ord("a")
        digits[pos + 1 : pos + span] = ord("7")
        digits[pos + span] = ord("b")
    compare("fixpoint, a[0-9]*b", rb"a[0-9]*b", digits, rounds=lambda n, c: c and n >= 4,
            plain_on_card=True)
    check(out["fixpoint, a[0-9]*b"]["grid"] >= 132,
          f"the fixpoint's grid holds {out['fixpoint, a[0-9]*b']['grid']} blocks")
    # fewer blocks than stream tiles: each block walks tiles b, b + grid, ...
    for cap in (100, 1):
        label = f"fixpoint, a[0-9]*b, grid cap {cap}"
        compare(label, rb"a[0-9]*b", digits, rounds=lambda n, c: c and n >= 4, max_blocks=cap)
        check(out[label]["grid"] == cap, f"{label}: grid {out[label]['grid']}")
    # every segment's guess wrong, in the first walk and the later ones
    # (8 MiB, a stride of 512 B: the plain fixpoint runs on the host)
    qbuf = nosync_words(np, rng5, (8 << 20) // sd.N_STREAMS // 4)
    qlin = np.ascontiguousarray(qbuf.reshape(-1, sd.N_STREAMS).T).reshape(-1).view(np.uint8)
    compare("fixpoint, " + NOSYNC[0].decode(), NOSYNC[0], qlin, rounds=lambda n, c: c)
    keep = sd.MAX_ROUNDS
    try:
        for cap in (2, 1):
            sd.MAX_ROUNDS = cap
            compare(f"round cap {cap}, fallback", rb"a[0-9]*b", digits,
                    rounds=lambda n, c, cap=cap: n == cap and not c)
            check(out[f"round cap {cap}, fallback"]["flagged_blocks"] == BUF // 512,
                  f"round-cap {cap} fallback did not flag every block")
    finally:
        sd.MAX_ROUNDS = keep
    return out, rows


# -- B3, B5, B6 and the last-resort walk ---------------------------------------


def run_buffers(np, rng, ranges):
    """Host word buffers (text of non-member bytes, binary, zeros) with
    runs of member bytes of many lengths at every alignment, across row,
    32-row group and buffer-end boundaries."""
    pool = np.concatenate([np.arange(lo, hi + 1) for lo, hi in ranges]).astype(np.uint8)
    inside = np.zeros(256, bool)
    inside[pool] = True
    outside = np.flatnonzero(~inside).astype(np.uint8)
    n = BUF
    bases = {
        "text": rng.choice(outside if outside.size else pool, size=n),
        "binary": rng.integers(0, 256, size=n, dtype=np.uint8),
        "zeros": np.zeros(n, dtype=np.uint8),
    }
    plants = []
    for i, ln in enumerate((1, 2, 3, 4, 5, 7, 8, 11, 12, 16, 19, 20, 31, 32, 35, 36, 41, 64)):
        plants += [(1000 * (i + 1) + i % 4, ln), (512 * (50 + i) - ln // 2, ln),
                   (32 * 512 * (3 + i) - 1 - ln // 3, ln)]
    plants += [(n - 64, 64), (n - 3, 3), (n - 36, 33), (0, 40)]
    out = {}
    for name, base in bases.items():
        buf = base.copy()
        for pos, ln in plants:
            buf[pos : pos + ln] = rng.choice(pool, size=ln)
        words = np.zeros((ROWS + 8, 128), dtype="<i4")
        words[:ROWS] = buf.view("<i4").reshape(ROWS, 128)
        out[name] = words
    return out


ALPHA_CASES = [  # (label, ranges, [(mode, units), ...])
    ("digits", ((48, 57),), [("coarse", 2), ("coarse", 1), ("coarse", 4), ("coarse", 8),
                             ("fine", 1), ("fine", 2), ("fine", 4)]),
    ("NUL + digits", ((0, 0), (48, 57)), [("coarse", 8), ("fine", 4)]),
    ("bytes >= 0x80", ((0x80, 0xBF), (0xF0, 0xFF)), [("coarse", 4), ("fine", 2)]),
    ("8 ranges", tuple((16 * i + 1, 16 * i + 6) for i in range(8)),
     [("coarse", 2), ("fine", 4)]),
]


def phase_alpharun(torch, np, rng, rate):
    """B3 against its plain version at 32 MiB geometry, bit for bit."""
    from grab_tpu_torch.ops import alpharun as ar

    results = []
    for name, ranges, plans in ALPHA_CASES:
        bufs = run_buffers(np, rng, ranges)
        for mode, units in plans:
            # per word: 5 ops per range for the 4 bytes (two SWAR compares
            # of an add and a 3-input logic op each, one 3-input AND-NOT-OR)
            # and the 7-bit mask, once per word (a run into word w + 1
            # reuses w + 1's own test); then the run: a compare, a funnel
            # shift, AND, compare (coarse), or two shift-ANDs per halving,
            # mask, compare (fine); 2 to fold the hit into the bitmap word
            per_word = 5 * len(ranges) + 1
            per_word += 4 if mode == "coarse" else 2 * (units.bit_length() - 1) + 2
            results.append(word_kernel_case(
                torch, f"alpha-run {name} {mode} {units}", bufs,
                lambda w: ar.alpharun_flags(w, ranges, mode, units),
                lambda w: ar.alpharun_bitmap_torch(w, ranges, mode, units),
                (per_word + 2) * ROWS * 128, rate,
                {"set": name, "ranges": len(ranges), "mode": mode, "units": units},
                shapes=True))
    return results


def long_literals(np, rng, k: int):
    return [bytes(rng.integers(33, 127, size=int(rng.integers(7, 12)), dtype=np.uint8))
            for _ in range(k)]


def xor_ops(tests) -> int:
    """Per word and bank a multiply, a shift and an XOR (the shared read
    is not counted); per group a compare and an OR; 2 for the bitmap."""
    consts = tests.consts()
    return (3 * sum(len(c) for c in consts) + 2 * len(consts) + 2) * ROWS * 128


# literal counts of phase_xor and the bank copies each launch must take
# (ops/xorfilter.py bank_copies): 32 up to 12 bank rows, one copy for
# 1000 literals (43 rows), global memory for 10,000 (418 rows, 211 KiB)
XOR_SIZES = (100, 5, 40, 1000, 10000)
XOR_COPIES = {100: 32, 5: 32, 40: 32, 1000: 1, 10000: 0}


def phase_xor(torch, np, rng, rate):
    """B5 against its plain version at 32 MiB geometry, 2045 groups and
    40 MiB, bit for bit, in the form its host chose for each set."""
    from grab_tpu_torch.ops import xorfilter as xf

    dev = torch.device("cuda")
    results = []
    for k in XOR_SIZES:
        lits = long_literals(np, rng, k)
        tests = xf.XorWordTests(lits)
        bufs = kernel_buffers(np, rng, lits)
        for kind in bufs:  # needles at every phase, all through the set
            flat = bufs[kind][:ROWS].reshape(-1).view(np.uint8)
            for i, lit in enumerate(lits[:64]):
                pos = 700_000 + 37 * i
                flat[pos : pos + len(lit)] = np.frombuffer(lit, np.uint8)
        arities = [len(c) for c in tests.consts()]
        res = word_kernel_case(
            torch, f"XOR filter {k} literals ({len(arities)} groups, {sum(arities)} banks)", bufs,
            lambda w: xf.xor_word_flags(w, tests),
            lambda w: xf.xor_bitmap_torch(w, tests.tables(), tests.consts()),
            xor_ops(tests), rate,
            {"set": f"{k} literals", "literals": k, "keys": tests.n_keys, "banks": sum(arities),
             "groups": len(arities)}, shapes=True)
        nul = torch.zeros((ROWS + 8, 128), dtype=torch.int32, device=dev)
        total, packed, bm = xf.xor_word_flags(nul, tests)
        check(int(total.item()) == 0 and not bool(bm.any()),
              f"XOR filter {k} literals: NUL words pass as members")
        copies, rem = xf.xor_word_flags.form
        check(copies == XOR_COPIES[k] and rem == xf.remainder_arity(tests.consts()),
              f"XOR filter {k} literals: launched with {copies} bank copies and remainder "
              f"arity {rem}, want {XOR_COPIES[k]} and {xf.remainder_arity(tests.consts())}")
        log(f"XOR filter {k} literals: {copies} bank copies "
            f"({'global memory' if copies == 0 else 'shared memory'}), remainder arity {rem}")
        results.append(dict(res, copies=copies, remainder=rem))
    return results


def fused_sets(np, rng):
    """{name: (fused scanner, literals, compiled sequences)}: three
    ensembles of chosen shapes and the `batch4` ensemble as DeviceScanner
    builds it for the 100-literal + 10-regex batch."""
    from grab_tpu_torch.ops.classseq import compile_sequences
    from grab_tpu_torch.ops.fused import FusedEnsembleScanner
    from grab_tpu_torch.regex.compiler import compile_multi
    from grab_tpu_torch.scan_pipeline import DeviceScanner

    lower = sum(1 << b for b in range(97, 123))
    one = compile_sequences([(DIGIT, DIGIT, DIGIT, lower, lower)])
    three = compile_sequences([(DIGIT,) * 5, (HIGH, DIGIT, HIGH), (DIGIT,) * 8])
    shorts = [bytes(rng.integers(97, 123, size=int(rng.integers(3, 7)), dtype=np.uint8))
              for _ in range(60)]
    sets = {
        "100 long + 1 seq": (long_literals(np, rng, 100), one),
        "60 short + 40 long + 3 seqs": (shorts + long_literals(np, rng, 40), three),
        "1 bucket + 3 seqs": ([b"linus", b"lmnus", b"lnnus"], three),
    }
    out = {name: (FusedEnsembleScanner(lits, seqs), lits, seqs)
           for name, (lits, seqs) in sets.items()}
    lits = batch_literals(np)
    sc = DeviceScanner(compile_multi(lits + BATCH_REGEXES), buf_size=1 << 20,
                       devices=["cpu"]).members[0]
    check(type(sc) is FusedEnsembleScanner, f"batch4: member {type(sc).__name__}")
    out["batch4"] = (sc, lits, None)
    return out


def phase_fused(torch, np, rng, rate, rng5):
    """B6 against its plain version at 32 MiB geometry, bit for bit
    (the batch4 ensemble's buffers from rng5, so the older sets' and
    phases' data stay what they were)."""
    from grab_tpu_torch.ops import fused as fu

    results = []
    for name, (sc, lits, seqs) in fused_sets(np, rng).items():
        if seqs is None:  # batch4: its sequences' and regexes' hits
            plants = lits[:10] + BATCH_PLANTS[:10]
            bufs = kernel_buffers(np, rng5, plants)
        else:
            plants = lits[:10] + [seq_needle(s, rng) for s in seqs]
            bufs = kernel_buffers(np, rng, plants)
        seqs = sc.seqs or ()

        def ops(w, sc=sc):
            # the members' counts, as for B1, B5 and B4 alone
            n = sum(4 * t.k * (2 * t.n_words if t.masked else t.n_words)
                    for t in sc.cw_tests) * ROWS * 128
            n += xor_ops(sc.xor) if sc.xor else 0
            return n + (b4_ops(torch, w, sc.seqs) if sc.seqs else 0)

        results.append(word_kernel_case(
            torch, f"fused {name} (buckets {sc.cw_shapes}, banks "
            f"{[len(c) for c in sc.xor_groups]}, {len(seqs)} sequences)", bufs,
            lambda w: fu.fused_word_flags(w, sc), lambda w: fu.fused_bitmap_torch(w, sc),
            ops, rate,
            {"set": name, "buckets": len(sc.cw_tests), "banks": sum(len(c) for c in sc.xor_groups),
             "seqs": len(seqs), "program_bytes": int(sc.program().nbytes)}))
    return results


NO_PLAN = rb".{0,2}(?:[a-f][0-9][g-m][A-F][N-Z]){200}"  # 1001 states, no stride plan
WALK_HIT = b"a1gAN" + b"b2hBO" * 199
WIDE_BODY = bytes(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"[(i * 7) % 62]
                  for i in range(1900))
NON_SYNC = rb"Q(?:[a-z]{2})*Q"  # the parity of the letters since a Q: never synchronises
WALK_CASES = [  # (label, pattern, its planted match, buffer bytes, stream_seg)
    ("NO_PLAN 2 MiB", NO_PLAN, WALK_HIT, 2 << 20, 32768),
    ("NO_PLAN 32 MiB", NO_PLAN, WALK_HIT, BUF, 32768),
    (".{0,2}[a-z ]{11} 512 KiB", rb".{0,2}[a-z ]{11}", b"hello world", 512 << 10, 32768),
    ("NO_PLAN 2064 KiB (33,024-byte segments)", NO_PLAN, WALK_HIT, 2064 << 10, 32768),
    ("NO_PLAN 48 KiB (768-byte segments)", NO_PLAN, WALK_HIT, 48 << 10, 768),
    # 1901 states x 64 classes: a class table of 243,328 bytes, past the
    # kernel's 200 KiB of shared memory (its global-memory form)
    ("wide table 32 MiB", b".{0,2}" + WIDE_BODY, WIDE_BODY, BUF, 32768),
    # lowercase text with one Q near each stream's start: every guess
    # after it in the stream is wrong, so the fix-up re-walks the stream
    ("Q(?:[a-z]{2})*Q 32 MiB (never synchronises)", NON_SYNC, b"QxyQ", BUF, 32768),
]
WALK_SHARED_TABLE = 200 << 10  # csrc/dfa_walk.cu kSharedTable
WALK_OPS_PER_STEP = 4  # byte extract, IMAD, AND, OR of the entry (loads not counted)


def phase_walk(torch, np, rng, sm_count, sm_clock_mhz, link_cycles):
    """The last-resort DFA walk, csrc/dfa_walk.cu, against its plain
    version on the card at every WALK_CASES geometry: the flags entry
    (one launch per buffer through DfaWalkMember.packed) total and packed
    flags, and the counts entry (the sharded step's: the walk and its
    count kernel) block counts, bit for bit; every whole planted match
    (at 100, across stream boundaries ending in the halo, at the
    buffer's end) must be flagged; the bytes the fix-up re-walked. At
    32 MiB: each entry's ms (CUDA events after a sleep kernel, median of
    5) beside the plain version's seconds, a device copy, the bound, the
    longest chain of the segmented walk and the chain that one thread per
    stream could not beat. The first two buffers are the draws of ``rng``
    that earlier versions of this phase made; the others come from a
    stream of their own, so the later phases' trees stay what they were.
    → (flags results, counts results)."""
    import statistics

    from grab_tpu_torch.ops import dfa_scan as ds
    from grab_tpu_torch.ops.stridedfa import stride_plan
    from grab_tpu_torch.regex.compiler import compile_multi

    dev = torch.device("cuda")
    rng10 = np.random.default_rng(SEED + 10)
    rate = sm_count * INT32_LANES_PER_SM * sm_clock_mhz * 1e6
    dfas = {}
    out, counted = [], []
    for i, (label, pattern, hit, size, stream_seg) in enumerate(WALK_CASES):
        if pattern not in dfas:
            dfas[pattern] = compile_multi([pattern]).dfa
        dfa = dfas[pattern]
        if pattern == NO_PLAN:
            check(stride_plan(dfa) is None, "the walk's pattern has a stride plan")
        m = ds.DfaWalkMember(dfa, size, 512, stream_seg, 0x1000)
        seg = size // m.n_streams
        h = min(0x1000, seg)
        table_bytes = m.tables.class_table.nbytes
        check(label.startswith("wide") == (table_bytes > WALK_SHARED_TABLE),
              f"walk {label}: a class table of {table_bytes} bytes")
        if pattern == NON_SYNC:
            buf = rng10.integers(ord("a"), ord("z") + 1, size=size, dtype=np.uint8)
            buf[7::seg] = ord("Q")
        else:
            buf = (rng if i < 2 else rng10).integers(32, 127, size=size, dtype=np.uint8)
        spots = [100, size - len(hit)]
        if len(hit) // 2 < h:  # across a stream boundary, ending in the halo
            spots += [s * seg - len(hit) // 2 for s in range(1, m.n_streams, 3)]
        for pos in spots:
            buf[pos : pos + len(hit)] = np.frombuffer(hit, np.uint8)
        whole = [pos for pos in spots if buf[pos : pos + len(hit)].tobytes() == hit]
        d = torch.from_numpy(buf).to(dev)
        ds.fixup_bytes(dev, reset=True)
        before = ds.dfa_walk_flags.launches
        total, packed = m.packed(d)
        torch.cuda.synchronize()
        check(ds.dfa_walk_flags.launches == before + 1, f"walk {label}: not one launch")
        check(ds.dfa_walk_flags.shared_table == (table_bytes <= WALK_SHARED_TABLE),
              f"walk {label}: the table's place")
        rewalked = ds.fixup_bytes(dev, reset=True)
        before = ds.dfa_walk_counts.launches
        counts = ds.dfa_walk_counts(d, m.tables, m.n_streams, 0x1000, 512)
        torch.cuda.synchronize()
        check(ds.dfa_walk_counts.launches == before + 2, f"walk {label}: counts not 2 launches")
        t0 = time.perf_counter()
        counts_p = ds.dfa_walk_counts_torch(d, m.tables, m.n_streams, 0x1000, 512)
        torch.cuda.synchronize()
        plain_counts_s = time.perf_counter() - t0
        total_p, packed_p = ds.pack_block_flags(counts_p)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        check(torch.equal(total, total_p) and torch.equal(packed, packed_p),
              f"walk {label}: kernel != plain (total {int(total.item())} vs "
              f"{int(total_p.item())})")
        check(torch.equal(counts, counts_p),
              f"walk {label}: counts kernel != plain ({int(counts.sum())} vs "
              f"{int(counts_p.sum())} candidates)")
        flags = m.flags_np(packed.cpu().numpy(), size // 512)
        missed = [p for p in whole if flags[(p + len(hit) - 1) // 512] != 1]
        check(len(whole) >= 2 and not missed, f"walk {label}: planted matches missed at {missed}")
        check(int(total.item()) == int(flags.sum()), f"walk {label}: total != flagged blocks")
        res = {"case": label, "pattern": pattern.decode()[:40], "n_streams": m.n_streams,
               "seg": seg, "halo": h, "states": dfa.n_states, "classes": dfa.n_classes,
               "table": "shared" if table_bytes <= WALK_SHARED_TABLE else "global",
               "table_bytes": table_bytes, "flagged_blocks": int(total.item()),
               "candidates": int(counts.sum()), "planted": len(whole), "max_abs_err": 0,
               "plain_s": plain_s, "rewalked_bytes": rewalked}
        cres = {"case": label, "n_streams": m.n_streams, "seg": seg,
                "candidates": int(counts.sum()), "max_abs_err": 0, "plain_s": plain_counts_s}
        if size == BUF:
            ring = [d] + [d.clone() for _ in range(3)]

            def median_ms(fn):
                return statistics.median(time_cuda(torch, fn, 4, warmup=1) for _ in range(5))

            ms = median_ms(lambda j: m.packed(ring[j % 4]))
            counts_ms = median_ms(
                lambda j: ds.dfa_walk_counts(ring[j % 4], m.tables, m.n_streams, 0x1000, 512))
            dst = torch.empty_like(d)
            copy_ms = time_cuda(torch, lambda j: dst.copy_(ring[j % 4]), 40)
            steps = size + (m.n_streams - 1) * h  # bytes walked, halos included
            geo = ds.walk_geometry(size, m.n_streams, 0x1000, 512)
            link_s = link_cycles / (sm_clock_mhz * 1e6)
            ops_ms = WALK_OPS_PER_STEP * steps / rate * 1e3
            for r, t, out_bytes in ((res, ms, packed.numel() * 4 + 4),
                                    (cres, counts_ms, counts.numel() * 4)):
                bytes_ms = (size + table_bytes + 256 + out_bytes) / HBM_BYTES_PER_S * 1e3
                r.update(ms=t, copy_ms=copy_ms, bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                         bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms, library_ms=None,
                         plain_ms=r["plain_s"] * 1e3,
                         chain_ms=(geo.seg_bytes + ds.WARM) * link_s * 1e3,
                         stream_chain_ms=(seg + h) * link_s * 1e3, link_cycles=link_cycles)
            del ring, dst
        out.append(res)
        counted.append(cres)
        log(f"walk == plain, {label} ({m.n_streams} streams x {seg} + {h} bytes, {res['table']} "
            f"table of {table_bytes} B): {res['flagged_blocks']} flagged blocks, "
            f"{res['candidates']} candidates (counts == plain), {len(whole)} planted matches "
            f"flagged, {rewalked} bytes re-walked by the fix-up; plain {plain_s:.3f} s"
            + (f"; kernel {res['ms']:.4f} ms per 32 MiB (median of 5), counts "
               f"{cres['ms']:.4f} ms, d2d copy {res['copy_ms']:.4f} ms, bound "
               f"{res['bound_ms']:.4f} ms ({res['bound_by']}), longest chain "
               f"{res['chain_ms']:.4f} ms ({geo.seg_bytes + ds.WARM} links at "
               f"{link_cycles:.1f} cycles; a thread per stream: {res['stream_chain_ms']:.4f} ms)"
               if "ms" in res else ""))
    return out, counted


# -- B7: the stride transpose, and B8: the bloom filter -------------------------


def phase_transpose(torch, np, rng):
    """B7 against its plain version, bit for bit, at the three stream
    geometries; its time beside a device copy's, the plain version's
    and one PyTorch call of the same function."""
    from grab_tpu_torch.ops import stridedfa as sd

    dev = torch.device("cuda")
    results = []
    for s_w in (BUF // sd.N_STREAMS // 4, 32, 640):
        host = rng.integers(-(1 << 31), 1 << 31, size=(sd.N_STREAMS, s_w), dtype=np.int32)
        a = torch.from_numpy(host).to(dev)
        got = sd.stride_transpose(a, s_w)
        torch.cuda.synchronize()
        want = sd.stride_transpose_torch(a, s_w)
        check(got.shape == (s_w * 128, 128) and got.is_contiguous() and torch.equal(got, want),
              f"stride transpose [16384, {s_w}]: kernel != plain")
        # the definition, at a few places: out[g*128 + r, c] = a[r*128 + c, g]
        for g, r, c in ((0, 0, 0), (s_w - 1, 127, 127), (s_w // 2, 5, 77), (1, 127, 0)):
            check(int(got[g * 128 + r, c]) == int(host[r * 128 + c, g]),
                  f"stride transpose [16384, {s_w}]: wrong word at {(g, r, c)}")
        ring = [a] + [a + i for i in range(1, 4)]
        ms = time_cuda(torch, lambda i: sd.stride_transpose(ring[i % 4], s_w), 40)
        plain_ms = time_cuda(torch, lambda i: sd.stride_transpose_torch(ring[i % 4], s_w), 40)
        library_ms = time_cuda(torch, lambda i: ring[i % 4].t().contiguous(), 40)
        dst = torch.empty_like(a)
        copy_ms = time_cuda(torch, lambda i: dst.copy_(ring[i % 4]), 40)
        nbytes = 2 * a.numel() * 4  # every word read once and written once
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        results.append({"s_w": s_w, "shape": [sd.N_STREAMS, s_w], "max_abs_err": 0, "ms": ms,
                        "plain_ms": plain_ms, "library_ms": library_ms, "copy_ms": copy_ms,
                        "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes})
        log(f"stride transpose [16384, {s_w}]: kernel == plain, bit for bit; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, a.t().contiguous() {library_ms:.4f} ms, d2d copy "
            f"{copy_ms:.4f} ms, bound {bound:.4f} ms (bytes)")
        del ring, dst
    return results


def phase_transpose_paths(torch, np, rng):
    """The scanner entries that run B7, with the counters set to 0 just
    before: ``StrideDfaScanner.run`` on the linear upload against
    ``run_t`` on the buffer born transposed, ``_StrideSeqMember.packed``
    on the shared linear words against ``packed_t``."""
    from grab_tpu_torch.ops import stridedfa as sd
    from grab_tpu_torch.regex.compiler import compile_multi
    from grab_tpu_torch.scan_pipeline import DeviceScanner, _StrideSeqMember

    dev = torch.device("cuda")
    text = rng.integers(33, 127, size=BUF, dtype=np.uint8)
    for s_ in range(1, 16384, 97):  # "hello world" across stream boundaries
        text[s_ * 2048 - 5 : s_ * 2048 + 6] = np.frombuffer(b"hello world", np.uint8)
    punct = punct_bytes(np, rng, BUF)
    for s_ in range(3, 16000, 211):  # runs across stream boundaries
        plant_run(punct, s_ * 2048 - 9, 30)
    plant_run(punct, 5 * 2048 + 100, 6000)  # longer than a whole stride
    soup = rng.choice(np.frombuffer(SOUP, np.uint8), size=BUF)
    spots = [s_ * 2048 - 3 for s_ in range(2, 16384, 173)] + [777, BUF - 9]
    for i, pos in enumerate(spots):
        lit = (b"12345ab", b"999xy", b"4567q")[i % 3]
        soup[pos : pos + len(lit)] = np.frombuffer(lit, np.uint8)
    out = {}
    reset_counters()
    for label, pat, buf in (("window pass, .{0,2}[a-z ]{11}", rb".{0,2}[a-z ]{11}", text),
                            ("fixpoint, .{0,2}(?:[0-9a-zA-Z]{4})+",
                             rb".{0,2}(?:[0-9a-zA-Z]{4})+", punct)):
        cp = compile_multi([pat])
        sc = sd.StrideDfaScanner(cp.dfa, cp.max_len, BUF)
        words = torch.from_numpy(sc.prep(buf)).to(dev)  # the linear upload
        bm, n, conv = sc.run(words)
        w_t = torch.from_numpy(sc.prep_t(buf)).to(dev)
        bm_t, n_t, conv_t = sc.run_t(w_t)
        torch.cuda.synchronize()
        check(torch.equal(bm, bm_t) and (int(n), bool(conv)) == (int(n_t), bool(conv_t)),
              f"run(words) != run_t(prep_t(buf)): {label}")
        flags = sc.flags_np(bm.cpu().numpy(), BUF // 512)
        check(int(flags.sum()) > 100, f"run(words): planted hits not flagged: {label}")
        out[label] = {"walks": int(n), "flagged_blocks": int(flags.sum())}
        log(f"run(words) on the linear upload == run_t(prep_t(buf)): {label} "
            f"(walks {int(n)}, {int(flags.sum())} flagged blocks)")
    pats = batch_literals(np) + BATCH_SEQS
    ds = DeviceScanner(compile_multi(pats), buf_size=BUF, devices=["cuda"])
    member = ds._stride
    check(isinstance(member, _StrideSeqMember), "the batch's scanner has no stride member")
    words2d = np.zeros((ROWS + 8, 128), dtype="<i4")
    words2d[:ROWS] = soup.view("<i4").reshape(ROWS, 128)
    t_l, pk_l = member.packed(torch.from_numpy(words2d).to(dev))
    w_t = torch.from_numpy(member.prep_t(soup)).to(dev)
    t_t, pk_t = member.packed_t(w_t)
    torch.cuda.synchronize()
    check(int(t_l.item()) == int(t_t.item()) > 0 and torch.equal(pk_l, pk_t),
          "_StrideSeqMember.packed(words2d) != packed_t")
    flags = member.flags_np(pk_l.cpu().numpy(), BUF // 512)
    check(np.array_equal(flags, member.flags_np(pk_t.cpu().numpy(), BUF // 512)),
          "_StrideSeqMember: flags differ")
    missed = [p_ for p_ in spots if not flags[p_ // 512] and not flags[(p_ + 6) // 512]]
    check(not missed, f"_StrideSeqMember.packed missed planted hits at {missed[:5]}")
    launches = read_counters()
    check(launches["transpose"] == 3 and launches["stride"] > 0 and launches["fixpoint"] == 2,
          f"the linear-words entries did not run the transpose kernel: {launches}")
    out["member"] = {"flagged_blocks": int(flags.sum()), "planted": len(spots)}
    log(f"_StrideSeqMember.packed(words2d) == packed_t: {int(flags.sum())} flagged blocks for "
        f"{len(spots)} planted hits; launches {launches}")
    return out, launches["transpose"]


def bloom_buffers(np, rng, lits, n_bufs: int = 3):
    """Text buffers with literals planted at every phase, across row and
    32-row group boundaries and in the last row; → [(host words, planted
    byte positions)]."""
    out = []
    for b in range(n_bufs):
        buf = rng.integers(32, 127, size=BUF, dtype=np.uint8)
        spots = [1000 * (i + 1) + i % 4 + 37 * b for i in range(64)]
        spots += [g * 32 * 512 - 3 - b for g in (1, 9, 1000, ROWS // 32 - 1)]
        spots += [r * 512 + 509 - b for r in (0, 4097, ROWS - 2)] + [BUF - 12 - b]
        planted = []
        for i, pos in enumerate(spots):
            lit = lits[(i + b) % len(lits)]
            pos = min(pos, BUF - len(lit))
            buf[pos : pos + len(lit)] = np.frombuffer(lit, np.uint8)
            planted.append(pos)
        words = np.zeros((ROWS + 8, 128), dtype="<i4")
        words[:ROWS] = buf.view("<i4").reshape(ROWS, 128)
        out.append((words, planted))
    return out


def phase_bloom(torch, np, rng, rate):
    """B8 against its plain version at 32 MiB geometry, bit for bit."""
    from grab_tpu_torch.ops import bloom as bl

    results = []
    for k in (100, 5, 1000):
        lits = long_literals(np, rng, k)
        tests = bl.BloomWordTests(lits)
        bufs = kernel_buffers(np, rng, lits)
        for kind in bufs:  # needles at every phase, all through the set
            flat = bufs[kind][:ROWS].reshape(-1).view(np.uint8)
            for i, lit in enumerate(lits[:64]):
                pos = 700_000 + 37 * i
                flat[pos : pos + len(lit)] = np.frombuffer(lit, np.uint8)
        # per word and level: a multiply, two shifts and a mask for the
        # hash fields, the shift by the bit index, the AND (the shared
        # read is not counted); 2 to fold the hit into the bitmap word
        results.append(word_kernel_case(
            torch, f"bloom {k} literals ({tests.levels} levels, {tests.n_keys} keys)", bufs,
            lambda w: bl.bloom_word_flags(w, tests),
            lambda w: bl.bloom_bitmap_torch(w, tests.tbl, tests.levels),
            (6 * tests.levels + 2) * ROWS * 128, rate,
            {"set": f"{k} literals", "literals": k, "keys": tests.n_keys,
             "levels": tests.levels}))
    return results


def phase_bloom_path(torch, np, rng):
    """``BloomWordScanner`` on the card, the counters set to 0 just
    before: three 32 MiB buffers, every block holding a planted literal
    flagged, few others."""
    from grab_tpu_torch.ops import bloom as bl

    dev = torch.device("cuda")
    lits = long_literals(np, rng, 100)
    sc = bl.BloomWordScanner(lits)
    bufs = bloom_buffers(np, rng, lits)
    reset_counters()
    shares = []
    for words, planted in bufs:
        w = torch.from_numpy(words).to(dev)
        total, packed = sc.packed(w)
        flags = sc.flags_np(packed.cpu().numpy(), ROWS)
        missed = [p_ for p_ in planted if not flags[p_ // 512]]
        check(not missed, f"BloomWordScanner missed planted literals at {missed[:5]}")
        check(int(total.item()) > 0 and flags.mean() < 0.05,
              f"BloomWordScanner flagged {flags.mean():.4f} of the blocks")
        shares.append(float(flags.mean()))
    n = read_counters()["bloom"]
    check(n == len(bufs), f"BloomWordScanner launched the bloom kernel {n} times")
    log(f"BloomWordScanner (100 literals, {sc.tests.levels} levels): every planted block "
        f"flagged in {len(bufs)} buffers; flagged share {shares}; {n} launches")
    return {"flagged_share": shares, "levels": sc.tests.levels}, n


# -- the class_seq and gdfa main paths ---------------------------------------

SEQ_PLANTS = [b"QWERTY123456", b"ABCDEF000001", b"\t4711\t", b"\t9\t", b"\t123456789\t",
              b"hello world", b"abc def ghij",
              # the alpha routes: 11 digits; a doubled 12-hex-digit and 6-digit group
              b"x91827364550x", b"0a1b2c3d4e5f0a1b2c3d4e5f", b"<123456123456>"]

# the literal ensemble's batches: 100 literals of 7-11 lowercase bytes
# with 10 regexes (the reference's multi-pattern configuration), and with
# 10 bounded sequence patterns (served by the union stride member)
BATCH_REGEXES = [
    rb"foo[a-z]{2,6}bar", rb"[0-9]{3}-[0-9]{4}", rb"qu+x", rb"colou?r",
    rb"abc(def|ghi)jkl", rb"w[xyz]{3}w", rb"nee+dle", rb"[A-Z]{5}99",
    rb"zz(?:a|b|c)zz", rb"end\.x",
]
BATCH_SEQS = [("[0-9]{%d}[a-z]{%d}" % (3 + i % 3, 1 + i % 2)).encode() for i in range(10)]
BATCH_PLANTS = [b"fooqqbar", b"555-1234", b"quuux", b"colour", b"abcdefjkl", b"wxyzw",
                b"neeedle", b"QWERT99", b"zzbzz", b"end.x", b"12345ab", b"999xy", b"4567q",
                b"lit07", b"lit19"]
# bytes that start or continue no literal factor and no sequence of the
# batches: in text made of them only planted hits flag a block
SOUP = b"ghijkmprstv .,;:_\n"


def batch_literals(np):
    rng = np.random.default_rng(12)
    return [bytes(rng.integers(97, 123, size=int(rng.integers(7, 12)), dtype=np.uint8))
            for _ in range(100)]


def write_files(np, root: str, base, sizes, plant):
    """Files root/d<i%8>/f<i>.txt cut from ``base`` with ``plant(data,
    i)`` applied; returns their total size."""
    total = 0
    for i, size in enumerate(sizes):
        d = os.path.join(root, f"d{i % 8}")
        os.makedirs(d, exist_ok=True)
        off = (i * 7919 * 4096) % (base.size - size)
        data = base[off : off + size].copy()
        plant(data, i)
        with open(os.path.join(d, f"f{i:04d}.txt"), "wb") as f:
            f.write(data.tobytes())
        total += size
    return total


def write_route_trees(np, rng, tmp):
    """mtree: ~40 MB of printable text in 2 batches, class_seq and
    window-mode hits planted at random places and 4 bytes before 512 B
    multiples (so some cross 2048 B stream boundaries of the buffer);
    gtree: punctuation files with alnum runs across stream boundaries,
    one over 4 KiB, and one 34 MiB file (over one buffer); gbulk:
    ~320 MB of clean punctuation files under 32 MiB each (the threading
    route's miss scan)."""
    text = rng.integers(32, 127, size=64 << 20, dtype=np.uint8)
    text[::97] = 0x0A

    def plant_seq(data, i):
        n = data.size
        spots = rng.integers(0, max(1, n - 16), size=2 + n // (256 << 10)).tolist()
        spots += [k * 512 - 4 for k in range(1, n // 512, 61)]
        for j, p in enumerate(spots):
            s = SEQ_PLANTS[(i + j) % len(SEQ_PLANTS)]
            p = min(int(p), n - len(s))
            data[p : p + len(s)] = np.frombuffer(s, np.uint8)

    mtree = os.path.join(tmp, "mtree")
    sizes = np.exp(rng.uniform(np.log(4 << 10), np.log(2 << 20), size=120)).astype(np.int64)
    m_bytes = write_files(np, mtree, text, [int(x) for x in sizes], plant_seq)

    punct = punct_bytes(np, rng, 64 << 20)

    def plant_runs(data, i):
        n = data.size
        for k in range(1, n // 2048, 13):
            plant_run(data, k * 2048 - 9 - (i % 7), 12 + (k % 40))
        if i == 3:
            plant_run(data, min(n - 7000, 9000), 6000)  # over 4 KiB

    gtree = os.path.join(tmp, "gtree")
    gsizes = [int(x) for x in np.exp(rng.uniform(np.log(8 << 10), np.log(1 << 20), size=24))]
    g_bytes = write_files(np, gtree, punct, gsizes, plant_runs)
    big = punct[: (34 << 20) + 321].copy()
    for pos, span in ((1000, 40), ((32 << 20) - 5000, 9000), ((33 << 20) + 17, 5000)):
        plant_run(big, pos, span)
    with open(os.path.join(gtree, "d7", "big.log"), "wb") as f:
        f.write(big.tobytes())
    g_bytes += big.size

    gbulk = os.path.join(tmp, "gbulk")
    bsizes = [int(x) for x in np.exp(rng.uniform(np.log(64 << 10), np.log(24 << 20), size=90))]
    b_bytes = write_files(np, gbulk, punct, bsizes, lambda data, i: None)

    # ctree: ~36 MB in 2 batches of bytes that trigger nothing of the
    # literal batches, their hits planted at random places and around
    # 512 B multiples; one 3 MiB file lies across the batch boundary
    soup = rng.choice(np.frombuffer(SOUP, np.uint8), size=64 << 20)
    lits = batch_literals(np)
    cplants = BATCH_PLANTS + lits[::9]

    def plant_batch(data, i):
        n = data.size
        spots = rng.integers(0, max(1, n - 16), size=2 + n // (256 << 10)).tolist()
        spots += [k * 512 - 3 for k in range(1, n // 512, 97)]
        for j, p_ in enumerate(spots):
            s_ = cplants[(i + j) % len(cplants)]
            p_ = min(int(p_), n - len(s_))
            data[p_ : p_ + len(s_)] = np.frombuffer(s_, np.uint8)

    ctree = os.path.join(tmp, "ctree")
    csizes = [int(x) for x in np.exp(rng.uniform(np.log(4 << 10), np.log(2 << 20), size=100))]
    csizes = csizes[:92] + [3 << 20] + csizes[92:]
    c_bytes = write_files(np, ctree, soup, csizes, plant_batch)
    with open(os.path.join(tmp, "batch4.txt"), "wb") as f:
        f.write(b"\n".join(lits + BATCH_REGEXES) + b"\n")
    with open(os.path.join(tmp, "batchseq.txt"), "wb") as f:
        f.write(b"\n".join(lits + BATCH_SEQS) + b"\n")
    with open(os.path.join(tmp, "lits100.txt"), "wb") as f:
        f.write(b"\n".join(lits) + b"\n")
    with open(os.path.join(tmp, "lits20.txt"), "wb") as f:
        f.write(b"\n".join(b"lit%02d" % i for i in range(20)) + b"\n")

    # stree: ~7 MB of the same soup in files under 1 MiB for the batch
    # with 10 sequence patterns, whose host-only scan runs 10 ungated
    # regex VMs (~0.1 MB/s); scanned with a 4 MiB buffer (2 batches), at
    # 32 MiB in the miss scan
    stree = os.path.join(tmp, "stree")
    ssizes = [int(x) for x in np.exp(rng.uniform(np.log(4 << 10), np.log(1 << 20), size=30))]
    s_bytes = write_files(np, stree, soup, ssizes + [1 << 20], plant_batch)

    # wtree: ~3 MB of text for the last-resort walk (its host-only scan
    # runs the regex VM at ~1 MB/s)
    def plant_walk(data, i):
        n = data.size
        for pos in (n // 3, n - 1200):
            if n > 3000:
                data[pos : pos + len(WALK_HIT)] = np.frombuffer(WALK_HIT, np.uint8)
        data[100 : 100 + 11] = np.frombuffer(b"hello world", np.uint8)
        if n > 600_000:  # across the 512 KiB buffer's batch boundary
            at = (512 << 10) - 0x1000 - 5
            data[at : at + 11] = np.frombuffer(b"hello world", np.uint8)

    wtree = os.path.join(tmp, "wtree")
    wsizes = [int(x) for x in np.exp(rng.uniform(np.log(8 << 10), np.log(400 << 10), size=22))]
    w_bytes = write_files(np, wtree, text, wsizes + [700 << 10], plant_walk)
    return {"mtree": (mtree, m_bytes), "gtree": (gtree, g_bytes), "gbulk": (gbulk, b_bytes),
            "ctree": (ctree, c_bytes), "stree": (stree, s_bytes), "wtree": (wtree, w_bytes)}


class HostRefs:
    """The port's host-only scan (device "none") of a recursive command,
    run beside the card's work: the tree's files in walk order are cut
    into slices of about equal bytes, each scanned by one CLI subprocess
    given the slice's paths (the CLI prints the ``path:`` prefix for
    several paths as for -r), and the outputs are joined in order."""

    def __init__(self, here: str, workers: int = 7):
        from concurrent.futures import ThreadPoolExecutor

        self.here = here
        self.pool = ThreadPoolExecutor(max_workers=workers)
        self.procs = []
        self.jobs = {}
        self.closed = False

    def _run(self, argv):
        env = dict(os.environ, GRAB_TPU_TORCH_DEVICE="none", PYTHONPATH=self.here)
        if self.closed:
            return -1, b"", b"closed"
        p = subprocess.Popen([sys.executable, "-m", "grab_tpu_torch.cli", *argv],
                             cwd=self.here, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
        self.procs.append(p)
        out, err = p.communicate()
        return p.returncode, out, err

    def start(self, key, flags, pattern, root, slices: int = 6):
        from grab_tpu_torch.ingest.walker import walk_files

        files = [(e.path, e.size) for e in walk_files(root)]
        total = sum(sz for _, sz in files)
        parts, cur, acc = [], [], 0
        for path, size in files:
            cur.append(path)
            acc += size
            if acc >= total / slices and len(cur) >= 2:
                parts.append(cur)
                cur, acc = [], 0
        if cur:
            if len(cur) < 2 and parts:
                parts[-1] += cur
            else:
                parts.append(cur)
        flags = [f for f in flags if f not in ("-r", "-R")]
        self.jobs[key] = [self.pool.submit(self._run, flags + [pattern] + part)
                          for part in parts]

    def result(self, key):
        outs = []
        for fut in self.jobs[key]:
            rc, out, err = fut.result()
            check(rc == 0, f"host-only scan {key}: rc {rc}: {err.decode(errors='replace')}")
            outs.append(out)
        return b"".join(outs)

    def close(self):
        """Stop every subprocess still running and wait for them."""
        self.closed = True
        for p in list(self.procs):
            if p.poll() is None:
                p.kill()
        self.pool.shutdown(wait=True, cancel_futures=True)
        for p in self.procs:
            p.wait()


def route(key, flags, pattern, tree, mode, members, counters, env=None, cfg=None, ref=None):
    """One CLI command and what it must reach: DeviceScanner mode, the
    members' type names in order, the kernels whose counters must move.
    pattern "@name" is the pattern file tmp/name; env is set around the
    run; cfg overrides EngineConfig fields; ref names the route whose
    host-only scan is this one's too (same command, another device plan)."""
    return dict(key=key, flags=flags, pattern=pattern, tree=tree, mode=mode, members=members,
                counters=counters, env=env or {}, cfg=cfg or {}, ref=ref or key)


FUSED = "FusedEnsembleScanner"
ROUTE_COMMANDS = [
    route("seq-stride", ["-r"], "[A-Z]{6}[0-9]{6}", "mtree", "class_seq", ["_StrideSeqMember"],
          ["stride"]),
    route("seq-word", ["-r", "-O"], "\t[0-9]+\t", "mtree", "class_seq", ["ClassSeqScanner"],
          ["classseq"]),
    route("gdfa-window", ["-r"], ".{0,2}[a-z ]{11}", "mtree", "gdfa", ["StrideDfaScanner"],
          ["stride"]),
    route("gdfa-thread", ["-E", "-r"], ".{0,2}(?:[0-9a-zA-Z]{4})+", "gtree", "gdfa",
          ["StrideDfaScanner"], ["fixpoint"]),
    route("alpha-coarse", ["-r", "-O"], ".{0,2}[0-9]{11}", "mtree", "alpha", ["AlphaRunScanner"],
          ["alpharun"]),
    # backreferences: no automaton, the class run is the only device form
    # (-2: the PCRE1 capture quirk would print nothing)
    route("alpha-backref", ["-2", "-r", "-O"], ".{0,2}([0-9a-f]{12})\\1", "mtree", "alpha",
          ["AlphaRunScanner"], ["alpharun"]),
    route("alpha-fine", ["-2", "-r"], ".{0,2}([0-9]{6})\\1", "mtree", "alpha",
          ["AlphaRunScanner"], ["alpharun"]),
    route("walk-noplan", ["-r", "-l", "-O"], NO_PLAN.decode(), "wtree", "dfa", ["DfaWalkMember"],
          ["walk"]),
    route("walk-smallbuf", ["-r"], ".{0,2}[a-z ]{11}", "wtree", "dfa", ["DfaWalkMember"],
          ["walk"], cfg={"scan_buf_size": 512 << 10}),
    route("batch4-fused", ["-r", "-H", "-O"], "@batch4.txt", "ctree", "literal", [FUSED],
          ["fused"]),
    route("batch4-split", ["-r", "-H", "-O"], "@batch4.txt", "ctree", "literal",
          ["XorWordScanner"] + ["CoreWordScanner"] * 3 + ["ClassSeqScanner"],
          ["xor", "corewords", "classseq"], env={"GRAB_TPU_NO_FUSED": "1"}, ref="batch4-fused"),
    route("batchseq-stride", ["-r", "-H", "-O"], "@batchseq.txt", "stree", "literal",
          [FUSED, "_StrideSeqMember"], ["fused", "stride"], cfg={"scan_buf_size": 4 << 20}),
    route("batchseq-inside", ["-r", "-H", "-O"], "@batchseq.txt", "stree", "literal", [FUSED],
          ["fused"], env={"GRAB_TPU_SEQDFA": "0"}, cfg={"scan_buf_size": 4 << 20},
          ref="batchseq-stride"),
    # 100 long literals alone are one member: the split path's filter
    route("lits100", ["-r", "-S", "-H"], "@lits100.txt", "ctree", "literal",
          ["XorWordScanner"], ["xor"]),
    route("lits20", ["-r", "-H", "-O"], "@lits20.txt", "ctree", "literal", [FUSED], ["fused"]),
]


def counters():
    from grab_tpu_torch.bench import kernel_wrappers

    return kernel_wrappers()


def reset_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {k: fn.launches for k, fn in counters().items()}


def route_pattern(r, tmp: str) -> str:
    return os.path.join(tmp, r["pattern"][1:]) if r["pattern"].startswith("@") else r["pattern"]


def phase_routes(torch, np, trees, refs, tmp):
    """Every route's command on the card against its host-only scan;
    mode, members and kernel counters checked per command."""
    from grab_tpu_torch import cli
    from grab_tpu_torch.engine import Engine

    runs, outs = [], {}
    for r in ROUTE_COMMANDS:
        root = trees[r["tree"]][0]
        engines = []

        def keep(pats, cfg, r=r):
            # record: the logged stats' walk= and replay= are the spans
            e = Engine(pats, dataclasses.replace(cfg, record=True, **r["cfg"]))
            engines.append(e)
            return e

        argv = r["flags"] + [route_pattern(r, tmp), root]
        shown = " ".join([f"{k}={v}" for k, v in r["env"].items()] + r["flags"]
                         + [repr(r["pattern"]), r["tree"]]
                         + [f"{k}={v}" for k, v in r["cfg"].items()])
        os.environ.update(r["env"])
        try:
            reset_counters()
            t0 = time.time()
            rc, out, err = run_cli(cli, argv, factory=keep)
            dev_s = time.time() - t0
            launches = read_counters()
        finally:
            for k in r["env"]:
                os.environ.pop(k, None)
        check(rc == 0, f"{shown}: rc {rc}: {err}")
        sc = engines[-1]._get_scanner()
        got = [type(m).__name__ for m in sc.members]
        check(sc.lanes[0].type == "cuda", f"{shown}: the scanner is not on the card")
        check(sc.mode == r["mode"] and got == r["members"],
              f"{shown}: route {sc.mode}/{got}, expected {r['mode']}/{r['members']}")
        for counter in r["counters"]:
            check(launches[counter] > 0, f"{shown}: the {counter} kernel was never launched")
        t0 = time.time()
        want = refs.result(r["ref"])
        wait_s = time.time() - t0
        check(out == want, f"{shown}: device stdout ({len(out)} B) != host stdout "
                           f"({len(want)} B)")
        check(len(out) > 0, f"{shown}: no matches printed for the planted hits")
        outs[r["key"]] = out
        st = engines[-1].stats
        runs.append({"key": r["key"], "argv": shown, "mode": sc.mode, "members": got,
                     "stdout_bytes": len(out), "launches": launches,
                     "device_s": dev_s, "host_wait_s": wait_s,
                     "batches": st.device_batches, "stats": st.summary()})
        log(f"stdout == host scan: {shown} → {sc.mode}/{got} ({len(out)} B, "
            f"launches {launches}, device run {dev_s:.2f}s, waited {wait_s:.2f}s for the "
            f"host scan)")
    return runs, outs


# -- -n N: the group submit, and the scan server ---------------------------------

TWO_LANES = "cuda:0,cuda:0"  # two lanes, two streams, one card: the group path
GROUP_LITERAL = "QWERTY"  # planted in mtree (SEQ_PLANTS)
CLEAN_MISS = "z\x01Q\x02x\x03m\x04i\x05s\x06s"
GROUP_ROUTES = [  # (route key, tree, scan_buf_size of the -n 2 run, counters)
    ("seq-stride", "mtree", 4 << 20, ["stride"]),
    ("gdfa-thread", "ntree", 4 << 20, ["fixpoint"]),
    ("alpha-coarse", "mtree", 4 << 20, ["alpharun"]),
    ("batchseq-stride", "stree", 2 << 20, ["fused", "stride"]),
]


def write_group_tree(np, rng, tmp):
    """ntree: ~16 MB of punctuation in files under 3 MB (none spans a
    4 MiB buffer, so none is replayed whole), alnum runs planted across
    stream boundaries: the threading route's -n 2 run."""
    punct = punct_bytes(np, rng, 32 << 20)

    def plant(data, i):
        for k in range(1, data.size // 2048, 29):
            plant_run(data, k * 2048 - 9 - (i % 7), 12 + (k % 40))

    ntree = os.path.join(tmp, "ntree")
    sizes = [int(x) for x in np.exp(rng.uniform(np.log(300 << 10), np.log(3 << 20), size=14))]
    return ntree, write_files(np, ntree, punct, sizes, plant)


def phase_groups(torch, np, trees, tree, tmp, outs):
    """-n N on the card: the cap at the cards present, then two lanes on
    the one card against what -n 1 printed, one route of each mode; a
    miss scan's groups pull no payload, its rate beside -n 1's.
    → (results, the stdout of ``-r GROUP_LITERAL mtree``)."""
    from grab_tpu_torch import cli
    from grab_tpu_torch.engine import Engine
    from grab_tpu_torch.scan_pipeline import release_lanes, take_lanes

    engines = []

    def keep(**over):
        def factory(pats, cfg):
            e = Engine(pats, dataclasses.replace(cfg, **over))
            engines.append(e)
            return e
        return factory

    def run(argv, **over):
        reset_counters()
        t0 = time.perf_counter()
        rc, out, err = run_cli(cli, argv, factory=keep(**over))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"{argv[:-1]}: rc {rc}: {err}")
        return out, wall, read_counters(), engines[-1]

    res = {"routes": []}
    mtree = trees["mtree"][0]
    one, _, _, eng = run(["-r", GROUP_LITERAL, mtree])
    check(len(one) > 0 and len(eng._get_scanner().lanes) == 1,
          f"-r {GROUP_LITERAL} mtree: no output, or not one lane")
    cards = torch.cuda.device_count()
    four, _, n4, eng = run(["-n", "4", "-r", GROUP_LITERAL, mtree])
    sc = eng._get_scanner()
    check(eng._effective_shards() == min(4, cards) and four == one and n4["corewords"] > 0,
          f"-n 4 on {cards} card(s): {eng._effective_shards()} shards, stdout "
          f"{'equal' if four == one else 'differs'}")
    check(len(sc.lanes) == min(4, cards), f"-n 4: {len(sc.lanes)} lane(s)")
    log(f"-n 4 -r {GROUP_LITERAL} mtree on {cards} card(s): capped to {eng._effective_shards()} "
        f"shard(s), stdout == -n 1 ({len(one)} B)")
    res["cap"] = {"cards": cards, "shards": eng._effective_shards(), "stdout_bytes": len(one)}

    by_key = {r["key"]: r for r in ROUTE_COMMANDS}
    cases = [("literal", ["-r"], GROUP_LITERAL, mtree, 4 << 20, ["corewords"], one)]
    for key, tname, buf, counted in GROUP_ROUTES:
        r = by_key[key]
        root = trees[tname][0]
        want = outs.get(key) if tname == r["tree"] else None
        if want is None:  # another tree than the route's: what -n 1 prints there
            want = run(r["flags"] + [route_pattern(r, tmp), root])[0]
        cases.append((key, r["flags"], route_pattern(r, tmp), root, buf, counted, want))
    for key, flags, pattern, root, buf, counted, want in cases:
        argv = ["-n", "2"] + flags + [pattern, root]
        out, wall, launches, eng = run(argv, device=TWO_LANES, scan_buf_size=buf)
        sc = eng._get_scanner()
        check(len(sc.lanes) == 2, f"-n 2 {key}: {len(sc.lanes)} lane(s)")
        lanes = take_lanes(sc.lanes)  # the lanes the scan ran on, handed back at its end
        release_lanes(lanes)
        check(all(l.device.type == "cuda" for l in lanes)
              and lanes[0].stream is None and lanes[1].stream is not None,
              f"-n 2 {key}: lanes not on the card, or not on two streams")
        check(len(want) > 0 and out == want,
              f"-n 2 {key}: stdout ({len(out)} B) != -n 1 stdout ({len(want)} B)")
        for c in counted:
            check(launches[c] > 0, f"-n 2 {key}: the {c} kernel was never launched")
        st = eng.stats
        check(st.device_batches >= 3, f"-n 2 {key}: only {st.device_batches} batches")
        res["routes"].append({"key": key, "mode": sc.mode,
                              "members": [type(m).__name__ for m in sc.members],
                              "stdout_bytes": len(out), "launches": launches, "wall_s": wall,
                              "batches": st.device_batches, "payload_pulls": sc.payload_pulls})
        log(f"-n 2 on {TWO_LANES}: stdout == -n 1: {key} → {sc.mode}/"
            f"{[type(m).__name__ for m in sc.members]} ({len(out)} B, {st.device_batches} "
            f"batches in groups of 2, {sc.payload_pulls} payload pulls, launches {launches})")

    # a miss scan: every group is clean, so no lane pulls a payload; its
    # rate beside -n 1's in the same call, in turns. Every aligned word
    # of this literal holds a control byte, so no word of the printable
    # tree passes the core-word test by chance (zQx##missing## flags a
    # few dozen blocks of it)
    miss = ["-r", "-S", CLEAN_MISS, tree]
    walls = {1: [], 2: []}
    for turn in range(3):
        for n in ((1, 2) if turn % 2 == 0 else (2, 1)):
            over = {"device": TWO_LANES} if n == 2 else {}
            out, wall, launches, eng = run(["-n", str(n)] + miss, **over)
            check(out == b"", f"-n {n} miss scan printed matches")
            walls[n].append(wall)
            if n == 2:
                sc, st = eng._get_scanner(), eng.stats
                check(len(sc.lanes) == 2 and sc.payload_pulls == 0
                      and launches["corewords"] == st.device_batches >= 4,
                      f"-n 2 miss scan: {sc.payload_pulls} payload pulls, launches "
                      f"{launches['corewords']}, batches {st.device_batches}")
                nbytes = st.bytes_scanned
    res["miss"] = {"bytes": nbytes, "walls_s": {str(k): v for k, v in walls.items()},
                   "gbps": {str(k): [nbytes / w / 1e9 for w in v] for k, v in walls.items()}}
    log(f"miss scan over the tree, {nbytes} bytes: -n 1 walls {walls[1]} s, -n 2 on "
        f"{TWO_LANES} walls {walls[2]} s (clean groups: no payload pulled) → "
        f"{res['miss']['gbps']} GB/s")
    return res, one


@contextlib.contextmanager
def captured_stdio():
    """sys.stdout (with a .buffer) and sys.stderr into memory, for the
    server's client, which writes to them."""
    out, err = io.BytesIO(), io.StringIO()

    class Stdout:
        buffer = out

        @staticmethod
        def flush():
            pass

    old = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = Stdout(), err
    try:
        yield out, err
    finally:
        sys.stdout, sys.stderr = old


def phase_server(torch, np, here, trees, tmp, outs, one_literal):
    """The scan server as a subprocess on the card; requests through the
    --via client against what the direct CLI printed."""
    from grab_tpu_torch import cli
    from grab_tpu_torch.regex.compiler import compile_multi
    from grab_tpu_torch.scan_pipeline import DeviceScanner

    sock = os.path.join(tmp, "tpugrep.sock")
    log_path = os.path.join(tmp, "server.log")
    env = dict(os.environ, PYTHONPATH=here)
    env.pop("GRAB_TPU_TORCH_DEVICE", None)
    t0 = time.perf_counter()
    with open(log_path, "wb") as logf:
        srv = subprocess.Popen([sys.executable, "-m", "grab_tpu_torch.server", sock],
                               cwd=here, env=env, stdout=logf, stderr=logf)
    res = {}
    try:
        while not os.path.exists(sock) and srv.poll() is None:
            check(time.perf_counter() - t0 < 600, "the server's socket did not appear in 600 s")
            time.sleep(0.1)
        with open(log_path, "rb") as f:
            server_log = f.read().decode(errors="replace")
        check(srv.poll() is None, f"the server exited with {srv.returncode}: {server_log[-2000:]}")
        res["start_s"] = time.perf_counter() - t0
        log(f"server started and warmed (kernels loaded, 3 core-word shapes at 32 MiB) in "
            f"{res['start_s']:.1f}s")

        def request(argv):
            t1 = time.perf_counter()
            with captured_stdio() as (out, err):
                rc = cli.main(["--via", sock] + argv)
            return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t1

        mtree, ctree, gbulk = (trees[k][0] for k in ("mtree", "ctree", "gbulk"))
        batch4 = os.path.join(tmp, "batch4.txt")
        rc, out, err, wall = request(["-r", GROUP_LITERAL, mtree])
        check(rc == 0 and out == one_literal, f"server: -r {GROUP_LITERAL} mtree: rc {rc}, stdout differs: {err}")
        res["literal_s"] = wall
        # the -H batch's miss scan: the first request builds the scanner
        # (the filter's peeling, the fused program), the second finds it
        # cached and pays for the patterns' compile alone
        walls, stats = [], []
        for _ in range(2):
            rc, out, err, wall = request(["--stats", "-r", "-H", batch4, gbulk])
            check(rc == 0 and out == b"", f"server: -H batch4 gbulk: rc {rc}: {err}")
            walls.append(wall)
            stats.append(err.strip())
        res["batch4_miss_walls_s"], res["batch4_miss_stats"] = walls, stats
        rc, out, err, wall = request(["-r", "-H", "-O", batch4, ctree])
        check(rc == 0 and out == outs["batch4-fused"],
              f"server: -H batch4 ctree: rc {rc}, stdout ({len(out)} B) differs: {err}")
        res["batch4_hits_wall_s"] = wall
        rc, out, err, _ = request(["-r", "zQx##missing##", mtree])
        check(rc == 0 and out == b"", f"server: miss: rc {rc}, {len(out)} B: {err}")
        rc, out, err, _ = request(["-n", "4", "-r", GROUP_LITERAL, mtree])
        check(rc == 0 and out == one_literal, f"server: -n 4 -r {GROUP_LITERAL} mtree: rc {rc}: {err}")
        nope = os.path.join(tmp, "nonexistent")
        rc, out, err, _ = request(["-S", "x", nope])
        rc_d, out_d, err_d = run_cli(cli, ["-S", "x", nope])
        check((rc, out, err) == (rc_d, out_d, err_d) and rc == 255 and "stat" in err,
              f"server: nonexistent path: rc {rc}, stderr {err!r}; direct rc {rc_d}, {err_d!r}")
        check(srv.poll() is None, "the server died while serving")
        # what the server saves a single-pattern scan: the same command
        # as a process of its own (interpreter, CUDA context, kernel load)
        t1 = time.perf_counter()
        fresh = subprocess.run([sys.executable, "-m", "grab_tpu_torch.cli", "-r", GROUP_LITERAL, mtree],
                               cwd=here, env=env, capture_output=True, timeout=600)
        res["literal_fresh_process_s"] = time.perf_counter() - t1
        check(fresh.returncode == 0 and fresh.stdout == one_literal,
              f"a fresh CLI process: rc {fresh.returncode}: {fresh.stderr.decode()[-500:]}")
        with open(batch4, "rb") as f:
            pats = [ln for ln in f.read().splitlines() if ln]
        t1 = time.perf_counter()
        cp = compile_multi(pats)
        res["compile_multi_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        DeviceScanner(cp, devices=["cuda"])  # what the server's cache saves a request
        res["scanner_build_s"] = time.perf_counter() - t1
        log(f"server: stdout == direct CLI for literal, -H batch4 (miss twice, hits once), miss, -n 4 "
            f"(capped) and a nonexistent path (exit 255)")
        log(f"server: -r -H batch4 gbulk, first request {walls[0]:.3f} s, second {walls[1]:.3f} s "
            f"(in this process: compile_multi of the 110 patterns "
            f"{res['compile_multi_s']:.3f} s, the scanner's build {res['scanner_build_s']:.3f} s); "
            f"stats: {stats}")
        log(f"server: -r -H -O batch4 ctree (hits replayed): {res['batch4_hits_wall_s']:.3f} s; -r {GROUP_LITERAL} mtree "
            f"{res['literal_s']:.3f} s through the server, {res['literal_fresh_process_s']:.3f} s "
            f"as a process of its own")
    finally:
        if srv.poll() is None:
            srv.terminate()
            try:
                srv.wait(timeout=30)
            except subprocess.TimeoutExpired:
                srv.kill()
                srv.wait()
    return res


# -- multi-host, spot, golden and the byte-level step ------------------------


def host_run(counts_path: str, argv) -> int:
    """``chip_smoke.py --host-run COUNTS -- ARGS``: one CLI process
    (``grab_tpu_torch.cli.main(ARGS)``, as ``python -m grab_tpu_torch.cli``
    runs it) with every launch counter set to 0 before and written to
    COUNTS after: the counts of a process the phase does not live in."""
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "grab_tpu_torch")):
        print("chip_smoke: the grab_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from grab_tpu_torch import cli

    reset_counters()
    rc = cli.main(list(argv))
    sys.stdout.flush()
    with open(counts_path, "w") as f:
        json.dump(read_counters(), f)
    return rc


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_procs(here, tmp, argvs, env, timeout=300):
    """CLI processes through ``host_run``, started together; → their
    (rc, stdout, stderr, counters) and the wall from the first start to
    the last exit."""
    procs, paths = [], []
    t0 = time.perf_counter()
    for i, argv in enumerate(argvs):
        paths.append(os.path.join(tmp, f"counts{i}.json"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"), "--host-run", paths[-1], "--"]
            + argv, cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    res = []
    try:
        for p, path in zip(procs, paths):
            out, err = p.communicate(timeout=timeout)
            counts = {}
            if p.returncode == 0:
                with open(path) as f:
                    counts = json.load(f)
            res.append((p.returncode, out, err.decode(errors="replace"), counts))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return res, time.perf_counter() - t0


def phase_multihost(torch, np, here, tree, trees, tmp):
    """Two CLI processes sharing the card (``--hosts 2``, a store on a
    free localhost port, gloo), each GRAB_TPU_TORCH_DEVICE=cuda:0: host
    0's stdout must equal the port's -n 1 run on the card byte for byte,
    host 1's must be empty, and --stats must give -n 1's line count.
    Walls beside -n 1's (each a process of its own); no rate is claimed."""
    env = dict(os.environ, PYTHONPATH=here, GRAB_TPU_TORCH_DEVICE="cuda:0",
               GRAB_TPU_KV_TIMEOUT_MS="240000")
    cases = [
        ("literal miss, tree", ["-r", "zQx##missing##", tree], ["corewords"]),
        ("literal hits -O, mtree", ["-r", "-O", GROUP_LITERAL, trees["mtree"][0]], ["corewords"]),
        ("-H batch4, gbulk", ["-r", "-H", os.path.join(tmp, "batch4.txt"), trees["gbulk"][0]],
         ["fused"]),
    ]
    res = []
    for label, argv, counted in cases:
        (one,), one_s = run_procs(here, tmp, [argv], env)
        check(one[0] == 0, f"multi-host {label}: the -n 1 run: rc {one[0]}: {one[2][-2000:]}")
        addr = f"127.0.0.1:{free_port()}"
        hosts, hosts_s = run_procs(here, tmp, [
            ["--hosts", "2", "--pid", str(pid), "--coordinator", addr, "--stats"] + argv
            for pid in range(2)], env)
        for pid, (rc, _out, err, _c) in enumerate(hosts):
            check(rc == 0, f"multi-host {label}: host {pid}: rc {rc}: {err[-2000:]}")
        check(hosts[0][1] == one[1], f"multi-host {label}: host 0 stdout ({len(hosts[0][1])} B) "
              f"!= -n 1 stdout ({len(one[1])} B)")
        check(hosts[1][1] == b"", f"multi-host {label}: host 1 printed {len(hosts[1][1])} B")
        n_lines = one[1].count(b"\n")
        check(f"tpugrep: {n_lines} match lines across 2 hosts" in hosts[0][2],
              f"multi-host {label}: no '{n_lines} match lines across 2 hosts' on host 0")
        launches = {k: sum(h[3][k] for h in hosts) for k in hosts[0][3]}
        for c in counted:
            check(launches[c] > 0 and all(h[3][c] > 0 for h in hosts),
                  f"multi-host {label}: the {c} kernel was not launched on both hosts")
        res.append({"label": label, "stdout_bytes": len(one[1]), "match_lines": n_lines,
                    "wall_s": {"n1": one_s, "hosts2": hosts_s},
                    "launches": {"n1": one[3], "hosts2": launches}})
        log(f"multi-host, 2 processes on cuda:0: {label}: host 0 stdout == "
            f"-n 1 ({len(one[1])} B, {n_lines} lines), host 1 empty; wall {hosts_s:.3f} s "
            f"(-n 1: {one_s:.3f} s, each a process of its own); launches {launches}")
    return res


def phase_spot(torch, np, here, tree):
    """``python -m grab_tpu_torch.spot -n 8`` equals ``-n 1`` on the tree
    (host only: the native walker built and run on this machine)."""
    from grab_tpu_torch.ingest import native

    check(native.available(), "spot: the native ingest library is not available")
    pattern = r"d1[0-9]/e[24]/f[0-9]*7\.txt$|large"
    env = dict(os.environ, PYTHONPATH=here)
    outs, walls = {}, {}
    for n in (8, 1):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "grab_tpu_torch.spot", "-n", str(n), tree, pattern],
                           cwd=here, env=env, capture_output=True, timeout=300)
        walls[n] = time.perf_counter() - t0
        check(r.returncode == 0, f"spot -n {n}: rc {r.returncode}: {r.stderr.decode()[-1000:]}")
        outs[n] = r.stdout
    n_files = sum(len(fs) for _, _, fs in os.walk(tree))
    lines = outs[1].count(b"\n")
    check(outs[8] == outs[1] and 0 < lines < n_files,
          f"spot: -n 8 ({len(outs[8])} B) != -n 1 ({len(outs[1])} B), or {lines} of {n_files}")
    log(f"spot -n 8 == -n 1 over the tree: {lines} of {n_files} paths ({walls[8]:.2f} s, "
        f"{walls[1]:.2f} s as processes)")
    return {"paths": lines, "files": n_files, "walls_s": {str(k): v for k, v in walls.items()}}


def phase_golden(torch, np, rng):
    """The card's flags against the port's golden scanners: B1 at the
    main path's 32 MiB and B2 over a 2 MiB buffer (dfa_scan_ends_fast is
    a Python loop) flag every block that holds an exact match start (B1)
    or end (B2), ``block_counts`` > 0."""
    from grab_tpu_torch import golden
    from grab_tpu_torch.ops import stridedfa as sd
    from grab_tpu_torch.ops.corewords import CoreWordScanner
    from grab_tpu_torch.regex.compiler import compile_multi

    dev = torch.device("cuda")
    res = {}
    lits = [b"needleXY", b"linus", b"fooqbar"]
    data = rng.integers(32, 127, size=BUF, dtype=np.uint8)
    data[::97] = 0x0A
    spots = rng.integers(0, BUF - 16, size=3000).tolist() + [0, 509, 512 * 64 - 3, BUF - 8]
    for j, p in enumerate(spots):
        lit = lits[j % len(lits)]
        p = min(int(p), BUF - len(lit))
        data[p : p + len(lit)] = np.frombuffer(lit, np.uint8)
    words = np.concatenate([data.view("<i4").reshape(ROWS, 128), np.zeros((8, 128), "<i4")])
    sc = CoreWordScanner(lits)
    _total, packed = sc.packed(torch.from_numpy(words).to(dev))
    flags = sc.flags_np(packed.cpu().numpy(), ROWS)
    want = golden.block_counts(golden.literal_scan_starts(lits, data.tobytes()), 512) > 0
    missed = int((want & (flags == 0)).sum())
    check(want.sum() >= 2000 and missed == 0,
          f"golden: B1 missed {missed} of {int(want.sum())} exact match blocks")
    res["B1"] = {"bytes": BUF, "match_blocks": int(want.sum()), "flagged": int(flags.sum())}

    n = 2 << 20
    pat = rb"[A-Z]{6}[0-9]{6}"
    buf = rng.integers(33, 127, size=n, dtype=np.uint8)
    for k, p in enumerate(rng.integers(0, n - 16, size=200).tolist() + [126, n - 12]):
        buf[p : p + 12] = np.frombuffer(b"QWERTY%06d" % k, np.uint8)
    cp = compile_multi([pat])
    st = sd.StrideDfaScanner(cp.dfa, cp.max_len, n)
    bm, _walks, _conv = st.run_t(torch.from_numpy(st.prep_t(buf)).to(dev))
    flags = st.flags_np(bm.cpu().numpy(), n // 512)
    t0 = time.perf_counter()
    want = golden.block_counts(golden.dfa_scan_ends_fast(cp.dfa, buf), 512) > 0
    golden_s = time.perf_counter() - t0
    missed = int((want & (flags == 0)).sum())
    check(want.sum() >= 150 and missed == 0,
          f"golden: B2 missed {missed} of {int(want.sum())} exact match blocks")
    res["B2"] = {"bytes": n, "pattern": pat.decode(), "match_blocks": int(want.sum()),
                 "flagged": int(flags.sum()), "golden_s": golden_s}
    log(f"golden superset: B1 flags cover all {res['B1']['match_blocks']} exact start blocks of "
        f"32 MiB ({res['B1']['flagged']} flagged); B2 ({pat.decode()}) all "
        f"{res['B2']['match_blocks']} exact end blocks of 2 MiB ({res['B2']['flagged']} flagged)")
    return res


# W2's bound is the function's (w2_bound): the bytes, the shard read once
# and the counts written once. The function needs a few int32 operations
# a position with a perfect filter, which stay under the bytes at the
# card's int32 rate whatever K is. Logged beside it, not used as the
# bound: this design's own operations on these inputs, per position the
# pair test, W2_PAIR_TEST_OPS (per 4 positions a funnel shift and two
# operations for b0 >> 5, then per position a PRMT for the word index, 3
# in 4 a shift for b0, a rotate and a funnel shift into the candidate
# bits: 18 / 4), and per position and key of its pair's bucket
# W2_OPS_PER_KEY, the least a masked 64-bit compare needs (two LOP3s
# (window ^ value) & mask, the OR of the halves, an unsigned-min
# accumulate); and a linear compare of every key at every position,
# BUF * K * W2_OPS_PER_KEY.
W2_PAIR_TEST_OPS = 4.5
W2_OPS_PER_KEY = 4


def w2_literal_sets(np, rng):
    """The literal kernel's cases: K = 1, 16 (1-, 3-, 8- and 11-byte
    literals, a zero-length one and NUL-ending ones) and 300; then, from
    a stream of their own (so the first three stay as they were), 1000
    and "dense": 300 literals that share their first two bytes, ab."""
    def lits(n, lo, hi, r=rng):
        return [bytes(r.integers(33, 127, size=int(r.integers(lo, hi + 1)),
                                 dtype=np.uint8)) for _ in range(n)]

    k16 = [b"q", b"fox", b"abcdefgh", b"needle-in-a", b"", b"ab\x00", b"xyz\x00\x00",
           b"\x00\x00\x00"] + lits(8, 3, 11)
    sets = {"K1": [b"fooxyzzbar"], "K16": k16, "K300": lits(300, 3, 11)}
    r13 = np.random.default_rng(SEED + 13)
    sets["K1000"] = lits(1000, 3, 11, r13)
    sets["dense"] = list(dict.fromkeys(b"ab" + x for x in lits(400, 1, 9, r13)))[:300]
    return sets


def w2_buffer(np, rng, lits, dense=False):
    """32 MiB of printable text with NUL bytes sprinkled, every literal
    planted at random spots and across 512-byte block edges, and the
    shard's last bytes the head of a NUL-ending or short literal (a hit
    against the zero tail). ``dense``: every 4 bytes of the text start
    with ab, so a quarter of the positions reach the shared pair's
    bucket, before the literals are planted."""
    buf = rng.integers(32, 127, size=BUF, dtype=np.uint8)
    buf[rng.integers(0, BUF, size=2000)] = 0
    if dense:
        buf[0::4], buf[1::4] = ord("a"), ord("b")
    for i, lit in enumerate(lits * max(1, 600 // len(lits))):
        if lit:
            pos = int(rng.integers(0, BUF - 16)) if i % 2 else 512 * (i + 1) - len(lit) // 2
            buf[pos : pos + len(lit)] = np.frombuffer(lit, np.uint8)
    tail = next((l.rstrip(b"\x00") for l in lits if l.endswith(b"\x00") and l.strip(b"\x00")),
                lits[0])
    buf[BUF - len(tail) :] = np.frombuffer(tail, np.uint8)
    return buf


def w2_bound(np, buf, keys, n_counts, rate):
    """W2's bound on this buffer (ms): the bytes (the shard read once,
    the counts written once). Beside it, this design's operations on
    these inputs (W2_PAIR_TEST_OPS a position, W2_OPS_PER_KEY a position
    and key of its pair's bucket, counted from the buffer: a position
    whose first byte starts a 0- or 1-byte key is a match outright) and a
    linear compare's. → (bound ms, bucket compares, the design's
    operations ms, the linear compare's operations ms)."""
    long_ = np.array([n >= 2 for n in keys.lengths])
    pairs = (keys.value[long_] & np.uint64(0xFFFF)).astype(np.int64)
    size = np.bincount(pairs, minlength=65536)
    pos = buf.astype(np.int64)
    pos[:-1] |= buf[1:].astype(np.int64) << 8  # the last byte pairs with the zero tail
    short = np.zeros(256, bool)
    short[(keys.value[~long_] & np.uint64(0xFF)).astype(np.int64)] = True
    compares = int(size[pos][~short[buf]].sum())
    bytes_ms = (buf.size + n_counts * 4) / HBM_BYTES_PER_S * 1e3
    design_ms = (buf.size * W2_PAIR_TEST_OPS + compares * W2_OPS_PER_KEY) / rate * 1e3
    linear_ms = buf.size * len(keys.lengths) * W2_OPS_PER_KEY / rate * 1e3
    return bytes_ms, compares, design_ms, linear_ms


def phase_byte_scan(torch, np, rng, rate):
    """make_sharded_scan (the byte-level step: literal scan or DFA walk,
    block counts, their sum) on two lanes of the card at 32 MiB per
    shard equals the same call on two CPU shards, bit for bit, with the
    counters set to 0 just before: the literal pattern launches the
    literal kernel (csrc/literal_scan.cu) once per shard and no walk,
    the pattern without a literal the walk's counts entry
    (csrc/dfa_walk.cu) in two launches per shard and no literal kernel.
    Then the literal kernel alone against its plain version on the
    card, bit for bit, at K = 1, 16, 300, 1000 and dense
    (w2_literal_sets), in the form the host chooses and in each other
    form that takes the keys (forced), and their times beside W2's
    bound, the bytes (w2_bound). → (results, the counts entry's launches, the
    literal kernel's launches, its cases)."""
    from grab_tpu_torch.ops import dfa_scan as ds
    from grab_tpu_torch.ops import literal_scan as ls
    from grab_tpu_torch.parallel.scan_step import make_sharded_scan
    from grab_tpu_torch.regex.compiler import compile_pattern

    res = []
    data = rng.integers(32, 127, size=2 * BUF, dtype=np.uint8)
    data[::97] = 0x0A
    for p in rng.integers(0, 2 * BUF - 16, size=500).tolist() + [BUF - 4, 2 * BUF - 10]:
        data[p : p + 10] = np.frombuffer(b"fooxyzzbar", np.uint8)
    host = torch.from_numpy(data)
    launches = lit_launches = 0
    for pattern in (rb"fooxyzzbar", rb"[f-g][o-p]+[x-z]{4}[a-d]+r"):
        cp = compile_pattern(pattern)
        ds.dfa_walk_counts.launches = 0
        ls.literal_block_counts.launches = 0
        t0 = time.perf_counter()
        counts, total = make_sharded_scan(cp, ["cuda:0", "cuda:0"], BUF)(host.to("cuda:0"))
        counts = [c.cpu() for c in counts]
        total = int(total)
        card_s = time.perf_counter() - t0
        walk_launches = ds.dfa_walk_counts.launches
        w2 = ls.literal_block_counts.launches
        launches += walk_launches
        lit_launches += w2
        check((walk_launches, w2) == ((0, 2) if cp.literals else (2 * 2, 0)),
              f"byte scan {pattern!r}: {walk_launches} walk and {w2} literal kernel launches "
              f"over 2 shards")
        t0 = time.perf_counter()
        want, want_total = make_sharded_scan(cp, ["cpu", "cpu"], BUF)(host)
        cpu_s = time.perf_counter() - t0
        check(all(c.device.type == "cpu" for c in want), "byte scan: the CPU call left the CPU")
        check(all(torch.equal(a, b) for a, b in zip(counts, want)) and total == int(want_total)
              and total >= 500, f"byte scan {pattern!r}: card counts != CPU counts "
              f"({total} vs {int(want_total)})")
        res.append({"pattern": pattern.decode(), "literal": bool(cp.literals), "total": total,
                    "card_s": card_s, "cpu_s": cpu_s, "walk_launches": walk_launches,
                    "literal_launches": w2})
        log(f"make_sharded_scan on cuda:0,cuda:0 == cpu,cpu: {pattern.decode()} "
            f"({'literal' if cp.literals else 'DFA walk'}, {total} candidates, {card_s:.3f} s "
            f"on the card with {walk_launches} walk and {w2} literal kernel launches, "
            f"{cpu_s:.2f} s on the CPU)")

    dev = torch.device("cuda")
    cases = []
    for label, lits in w2_literal_sets(np, rng).items():
        keys = ls.LiteralKeys(lits)
        buf_np = w2_buffer(np, rng, lits, dense=label == "dense")
        buf = torch.from_numpy(buf_np).to(dev)
        want = ls.literal_block_counts_torch(buf, keys, 512)
        ring = [buf] + [buf.clone() for _ in range(3)]
        forms = [keys.form] + [f for f in ls.FORMS if f != keys.form
                               and (f == "table" or len(lits) <= ls.SWAR_MAX)]
        form_ms = {}
        for form in forms:
            got = ls.literal_block_counts(buf, keys, 512, form=form)
            torch.cuda.synchronize()
            check(ls.literal_block_counts.form == form, f"literal kernel {label}: ran "
                  f"{ls.literal_block_counts.form}, not {form}")
            check(got.dtype == torch.int32 and torch.equal(got, want),
                  f"literal kernel {label} ({form}): counts != plain on the card")
            form_ms[form] = time_cuda(
                torch, lambda i: ls.literal_block_counts(ring[i % 4], keys, 512, form=form), 20)
        check(int(want[-1]) > 0, f"literal kernel {label}: no hit in the shard's last block")
        plain_ms = time_cuda(torch, lambda i: ls.literal_block_counts_torch(ring[i % 4], keys,
                                                                             512), 2, warmup=1)
        dst = torch.empty_like(buf)
        copy_ms = time_cuda(torch, lambda i: dst.copy_(ring[i % 4]), 20)
        bound_ms, compares, design_ms, linear_ms = w2_bound(np, buf_np, keys, want.numel(),
                                                            rate)
        ms = form_ms[keys.form]
        cases.append({"case": label, "k": len(lits), "candidates": int(want.sum()),
                      "form": keys.form, "form_ms": form_ms, "bucket_compares": compares,
                      "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "copy_ms": copy_ms,
                      "bound_ms": bound_ms, "bound_by": "bytes", "design_ops_ms": design_ms,
                      "linear_ops_ms": linear_ms, "library_ms": None})
        log(f"literal kernel == plain on the card: {label} ({int(want.sum())} candidates, "
            f"{keys.tables.n_pairs} pairs, {compares} bucket compares): "
            + ", ".join(f"{f} {t:.4f} ms" for f, t in form_ms.items())
            + f" (host's choice {keys.form}), plain {plain_ms:.2f} ms, d2d copy "
            f"{copy_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes; {100 * bound_ms / ms:.1f}%), "
            f"this design's operations {design_ms:.4f} ms, a linear compare's {linear_ms:.4f})")
        del ring, dst
    return res, launches, lit_launches, cases


BENCH_GROUP = 32 * 512  # bytes of one bitmap group (32 rows of 128 words)


def bench_needles(bench):
    """One blob of every needle the bench's word kernels look for: the
    headline literal (B1), a digit run of 14 (B3), the XOR / bloom
    literals (B5, B8), the fused ensemble's literals and its sequences'
    needles (B6), the class sequence's (B4)."""
    sets = bench.bench_sets()
    needles = ([bench.LITERAL, b"01234567890123"] + sets["lits"][:4] + sets["lits100"][:2]
               + sets["lits100"][-4:] + [b"123ab", b"12345ab", b"1234abc"])
    return b"~".join(needles)


def planted_words(torch, bench, size: int, seed: int, blob: bytes):
    """The bench's lowercase corpus of ``size`` bytes (its generator and
    seed, on the card) with ``blob`` planted in the first group, across
    the first group boundary, mid-buffer, past 2^31 bits (byte 2^28) and
    in the last group, ending in the last word. → (words, the spots)."""
    dev = torch.device("cuda")
    w = bench.device_words(size // 512, seed, dev)
    flat = w.view(torch.uint8).view(-1)
    src = torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(dev)
    spots = [0, BENCH_GROUP - 40, 3 * BENCH_GROUP + 1, (size >> 1) + 3, (1 << 28) + 5,
             (1 << 29) + 2, (3 << 28) + 7, size - BENCH_GROUP + 11, size - len(blob)]
    spots = sorted({p for p in spots if p <= size - len(blob)})
    for p in spots:
        flat[p : p + len(blob)] = src
    return w, spots


def stream_digit_runs(torch, np, wt):
    """64 digits planted into streams of a born-transposed [s_w * 128,
    128] buffer (flat word j * 16384 + s is stream s's word j): stream 0
    from word 0, the last stream in its last 16 words, and three streams
    past 2^31 bits. → [(first word, stream)]."""
    s_w = wt.shape[0] // 128
    st = wt.view(s_w, 16384)
    digits = torch.from_numpy(np.frombuffer((b"0123456789" * 7)[:64], "<i4").copy())
    runs = [(0, 0), (s_w - 16, 16383), (s_w // 4 + 4, 5000), (s_w // 2, 9999),
            (3 * s_w // 4 + 3, 77)]
    for j0, s in runs:
        st[j0 : j0 + 16, s] = digits.to(wt.device)
    return runs


def phase_bench_shapes(torch, np):
    """Each kernel wrapper the bench times, once on the card at the
    bench's shapes and tables (B1, B2, B3, B5, B8 over 1 GiB; B4 and B6
    over 256 MiB), on its lowercase corpus with hits planted in the first
    and last groups and past 2^31 bits, against its plain version over
    the whole buffer: bitmap, packed flags and total (B2: bitmap and
    exit states) equal, and every planted spot's groups flagged.
    → {counter key: [case results]}."""
    from grab_tpu_torch import bench
    from grab_tpu_torch.ops import alpharun as ar
    from grab_tpu_torch.ops import bloom as bl
    from grab_tpu_torch.ops import classseq as cs
    from grab_tpu_torch.ops import corewords as cw
    from grab_tpu_torch.ops import fused as fu
    from grab_tpu_torch.ops import stridedfa as sd
    from grab_tpu_torch.ops import xorfilter as xf
    from grab_tpu_torch.regex.compiler import compile_multi

    dev = torch.device("cuda")
    big, n = 1 << 30, 256 << 20
    sets = bench.bench_sets()
    blob = bench_needles(bench)
    res = {}

    def held(key, label, w, spots, kernel, plain):
        total, packed, bm = kernel(w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bm_ref = plain(w)
        total_ref, packed_ref = cw.packed_block_flags(bm_ref)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        check(torch.equal(bm, bm_ref) and torch.equal(packed, packed_ref)
              and torch.equal(total, total_ref),
              f"bench shape {label}: kernel != plain over {w.shape[0] - 8} rows "
              f"(total {int(total)} vs {int(total_ref)})")
        flagged = (packed != 0).cpu()
        missed = [p for p in spots
                  if not flagged[p // BENCH_GROUP : (p + len(blob)) // BENCH_GROUP + 1].any()]
        check(not missed, f"bench shape {label}: planted spots {missed} not flagged")
        res.setdefault(key, []).append({
            "case": label, "bytes": (w.shape[0] - 8) * 512, "groups": int(packed.shape[0]),
            "total": int(total), "planted": len(spots), "equal_plain": True,
            "plain_s": plain_s})

    # 1 GiB linear: the headline's corpus (seed 42) and its kernels
    w, spots = planted_words(torch, bench, big, 42, blob)
    t = cw.CoreWordScanner([bench.LITERAL]).tests
    held("corewords", "B1 headline literal", w, spots,
         lambda x: cw.core_word_flags(x, t.tab, t.k, t.n_words, t.masked),
         lambda x: cw.core_word_bitmap_torch(x, t.tab, t.k, t.n_words, t.masked))
    amode, units = ar.plan_for(bench.ALPHA_MIN)
    held("alpharun", f"B3 digit runs {amode} {units}", w, spots,
         lambda x: ar.alpharun_flags(x, bench.ALPHA_RANGES, amode, units),
         lambda x: ar.alpharun_bitmap_torch(x, bench.ALPHA_RANGES, amode, units))
    xt = xf.XorWordTests(sets["lits"])
    held("xor", "B5 xor100", w, spots, lambda x: xf.xor_word_flags(x, xt),
         lambda x: xf.xor_bitmap_torch(x, xt.tables(), xt.consts()))
    bt = bl.BloomWordTests(sets["lits"])
    held("bloom", "B8 bloom100", w, spots, lambda x: bl.bloom_word_flags(x, bt),
         lambda x: bl.bloom_bitmap_torch(x, bt.tbl, bt.levels))
    del w
    torch.cuda.empty_cache()

    # 256 MiB linear: B4 and the three B6 ensembles
    w, spots = planted_words(torch, bench, n, 700, blob)
    seqs1 = cs.compile_sequences([bench.CLASSSEQ])
    held("classseq", "B4 classseq", w, spots, lambda x: cs.classseq_flags(x, seqs1),
         lambda x: cs.classseq_bitmap_torch(x, seqs1))
    for label, seqs in (("lits100", None), ("lits100_seq2", bench.seq_masks(2)),
                        ("allinone", bench.seq_masks(10))):
        sc = fu.FusedEnsembleScanner(sets["lits100"],
                                     cs.compile_sequences(seqs) if seqs else None)
        held("fused", f"B6 fused_{label}", w, spots, lambda x, sc=sc: fu.fused_word_flags(x, sc),
             lambda x, sc=sc: fu.fused_bitmap_torch(x, sc))
    del w
    torch.cuda.empty_cache()

    # 1 GiB born transposed (16384 word steps): the walk of each plan
    wt = bench.device_words(big // 512, 900, dev)[: big // 512]
    runs = stream_digit_runs(torch, np, wt)
    for name, pat, plan in bench.WALKS:
        cp = compile_multi([pat])
        check(sd.stride_plan(cp.dfa) == plan, f"bench shape {pat!r}: not the {plan} plan")
        tb = sd.StrideDfaTables(cp.dfa, plan)
        entries = torch.full((sd.STREAM_ROWS, 128), tb.start, dtype=torch.int32, device=dev)
        bm, ex = sd.stride_dfa_scan(wt, tb, entries)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bm_ref, ex_ref = sd.stride_dfa_scan_torch(wt, tb, entries)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        check(torch.equal(bm, bm_ref) and torch.equal(ex, ex_ref),
              f"bench shape B2 {pat!r} ({plan}): kernel != plain over 1 GiB")
        if pat.startswith(rb"[0-9]"):  # the planted runs are the only digits
            missed = [(j0, s) for j0, s in runs if not bool(
                bm[(j0 * 128 + s // 128) // 16 : ((j0 + 16) * 128 + s // 128) // 16 + 1,
                   s % 128].any())]
            check(not missed, f"bench shape B2 {pat!r}: planted runs {missed} not flagged")
        res.setdefault("stride", []).append({
            "case": f"B2 {name[:-14]} {pat.decode()}", "bytes": big, "word_steps":
            wt.shape[0] // 128, "mode": plan[0], "k": plan[1],
            "flagged_words": int(torch.count_nonzero(bm)), "equal_plain": True,
            "plain_s": plain_s})
    del wt, bm, bm_ref
    torch.cuda.empty_cache()
    log("bench shapes: kernel == plain, bit for bit, with every planted spot flagged: "
        + "; ".join(f"{c['case']} ({c['bytes'] >> 20} MiB, plain {c['plain_s']:.1f}s)"
                    for cases in res.values() for c in cases))
    return res


BENCH_MAX_ROOFLINE = 1.05  # the headline's vs_measured_roofline above this is a timing fault


def phase_bench(torch, here):
    """``python -m grab_tpu_torch.bench`` at full size as a process: exit
    0; stdout's last line the headline (one B1 launch over 1 GiB, at
    most BENCH_MAX_ROOFLINE of this run's measured roofline); every
    secondary metric once on stderr, finite, above 0, not suspect; every
    kernel but B7, W1 and W2 launched. → the values, launches and
    wall."""
    import math

    from grab_tpu_torch.bench import METRIC, SECONDARY_METRICS

    env = {k: v for k, v in os.environ.items()
           if k not in ("GRAB_TPU_TORCH_DEVICE", "GRAB_TPU_BENCH_MB")}
    env["PYTHONPATH"] = here
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "grab_tpu_torch.bench"], cwd=here, env=env,
                       capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"bench: rc {r.returncode}: {r.stderr[-3000:]}")
    head = json.loads(r.stdout.strip().splitlines()[-1])
    check(head["metric"] == METRIC and head["backend"] == "cuda" and head["launches"] == 1
          and head["bytes"] == 1 << 30, f"bench: headline {head}")
    check(head["vs_measured_roofline"] <= BENCH_MAX_ROOFLINE,
          f"bench: headline at {head['vs_measured_roofline']} of the measured roofline")
    lines, launches = [], None
    for raw in r.stderr.splitlines():
        if raw.startswith("{"):
            obj = json.loads(raw)
            if "metric" in obj:
                lines.append(obj)
            elif "bench_launches" in obj:
                launches = obj["bench_launches"]
    names = [l["metric"] for l in lines]
    check(sorted(names) == sorted(SECONDARY_METRICS),
          f"bench: secondary names {names} != {list(SECONDARY_METRICS)}")
    roof = head["measured_roofline_bytes_per_sec"]
    for l in lines:
        check("error" not in l and not l.get("suspect") and math.isfinite(l["value"])
              and l["value"] > 0, f"bench: {l}")
        l["share_of_roofline"] = l["value"] / roof
    check(launches is not None
          and all(launches.get(k, 0) > 0 for k in counters()
                  if k not in ("transpose", "walk", "literal")),
          f"bench: launches {launches}")
    log(f"bench in {wall:.1f}s: {head['value'] / 1e9:.1f} GB/s, "
        f"{head['vs_measured_roofline']} of the measured {roof / 1e9:.1f} GB/s; "
        + ", ".join(f"{l['metric'][:-14]} {l['value'] / 1e9:.1f}" for l in lines))
    return {"headline": head, "secondary": lines, "launches": launches, "wall_s": wall,
            "stderr_notes": [x for x in r.stderr.splitlines() if x.startswith("bench:")]}


def phase_dryrun(torch):
    """grab_tpu_torch.dryrun on the card: ``entry()`` gives (1, 2);
    ``dryrun_multichip`` on two lanes of the card, and over every card
    when there are two or more. → results, launches per run."""
    from grab_tpu_torch import dryrun

    reset_counters()
    fn, args = dryrun.entry("cuda")
    got = tuple(int(x) for x in fn(*args))
    entry_launches = read_counters()
    check(got == (1, 2), f"dryrun entry: {got} != (1, 2)")
    check(entry_launches["fixpoint"] == 1 and entry_launches["stride"] == 0,
          f"dryrun entry: not one fixpoint launch: {entry_launches}")
    runs = []
    specs = [(2, TWO_LANES)]
    if torch.cuda.device_count() >= 2:
        specs.append((torch.cuda.device_count(), "cuda"))
    for n, spec in specs:
        buf = io.StringIO()
        reset_counters()
        t0 = time.perf_counter()
        res = dryrun.dryrun_multichip(n, spec, out=buf)
        wall = time.perf_counter() - t0
        launches = read_counters()
        check(launches["corewords"] > 0 and launches["literal"] == n,
              f"dryrun {n} on {spec}: launches {launches}")
        ratio = json.loads(buf.getvalue().splitlines()[0])
        res["engine"].pop("output")
        runs.append({"n": n, "devices": spec, "ratio": ratio["value"], "parts": res,
                     "launches": launches, "wall_s": wall})
        log(f"dryrun_multichip({n}, {spec!r}): ratio {ratio['value']}, "
            f"{res['engine']['lines']} lines, sums {res['scan_step']['total']} / "
            f"{res['word_scan']['total']}, B1 {launches['corewords']} launches, {wall:.2f} s")
    return {"entry": list(got), "entry_launches": entry_launches, "runs": runs}


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs one CUDA card",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "grab_tpu_torch")):
        print("chip_smoke: the grab_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    os.environ.pop("GRAB_TPU_TORCH_DEVICE", None)  # the main path runs on the card
    t_start = time.time()

    # 1. environment
    card = smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)
    sm_clock = float(smi("clocks.max.sm").split()[0])
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, {props.multi_processor_count} SMs, "
        f"max SM clock {sm_clock} MHz; nvidia-smi: {card}")

    # 2. build every kernel, and the ingest library
    from grab_tpu_torch import _build
    from grab_tpu_torch.ingest import native
    from grab_tpu_torch.ops import corewords as cw

    t0 = time.time()
    libs = _build.build_cuda(
        ["corewords", "classseq", "stridedfa", "alpharun", "xorfilter", "fused",
         "transpose", "bloom", "dfa_walk", "literal_scan"])
    t_cuda = time.time() - t0
    t0 = time.time()
    native_ok = native.available()
    t_ingest = time.time() - t0
    log(f"built {list(libs.values())} in {t_cuda:.1f}s (nvcc); native ingest "
        f"library {'used' if native_ok else 'NOT available: Python fallbacks'} "
        f"({t_ingest:.1f}s)")

    rng = np.random.default_rng(SEED)
    # the phases added later draw from a stream of their own, so the
    # earlier phases' trees and buffers stay what they were
    rng4 = np.random.default_rng(SEED + 4)
    rng5 = np.random.default_rng(SEED + 5)
    rng8 = np.random.default_rng(SEED + 8)
    sms = props.multi_processor_count
    refs = HostRefs(here)
    try:
        with tempfile.TemporaryDirectory(prefix="grab_smoke_") as tmp:
            # the new routes' trees, and their host-only scans started
            # in subprocesses beside everything below
            t0 = time.time()
            trees = write_route_trees(np, rng, tmp)
            trees["ntree"] = write_group_tree(np, rng4, tmp)
            for r in sorted(ROUTE_COMMANDS, key=lambda r: r["tree"] != "gtree"):
                if r["ref"] == r["key"]:
                    refs.start(r["key"], r["flags"], route_pattern(r, tmp), trees[r["tree"]][0])
            log(f"route trees written in {time.time() - t0:.1f}s: "
                f"{ {k: v[1] for k, v in trees.items()} } bytes")

            # 3 + 5a. kernels vs plain at full geometry, then their times
            rate = sms * INT32_LANES_PER_SM * sm_clock * 1e6  # int32 operations per second
            kres = phase_kernels(torch, np, cw, rng, rate)
            cres = phase_classseq(torch, np, rng, rate)
            sres = phase_stride(torch, np, rng, sms, sm_clock, rng5)
            scres, fixres = phase_stride_scanner(torch, np, rng, rng5)
            ares = phase_alpharun(torch, np, rng, rate)
            xres = phase_xor(torch, np, rng, rate)
            fres = phase_fused(torch, np, rng, rate, rng5)
            wres, wcres = phase_walk(torch, np, rng, sms, sm_clock, sres[0]["link_cycles"])
            tres = phase_transpose(torch, np, rng4)
            tpaths, t_launches = phase_transpose_paths(torch, np, rng4)
            bres = phase_bloom(torch, np, rng4, rate)
            bpath, b_launches = phase_bloom_path(torch, np, rng4)

            # 4. the main paths, then 5b. their miss / near-miss scans
            tree, tree_bytes, n_files, runs, launches = phase_main_path(torch, np, rng, tmp)
            route_runs, outs = phase_routes(torch, np, trees, refs, tmp)
            refs.close()
            e2e = phase_e2e(torch, np, tree)
            gbulk = trees["gbulk"][0]
            route_e2e = [
                phase_e2e(torch, np, tree, ["-r", "[A-Z]{6}[0-9]{6}", tree], "stride"),
                phase_e2e(torch, np, tree, ["-r", "\t[0-9]+\t", tree], "classseq"),
                phase_e2e(torch, np, tree, ["-r", ".{0,2}[a-z ]{11}", tree], "stride"),
                phase_e2e(torch, np, gbulk, ["-E", "-r", ".{0,2}(?:[0-9a-zA-Z]{4})+", gbulk],
                          "fixpoint"),
                phase_e2e(torch, np, tree, ["-r", ".{0,2}[0-9]{11}", tree], "alpharun"),
                # the last-resort walk: an automaton without a stride plan
                phase_e2e(torch, np, tree, ["-r", NO_PLAN.decode(), tree], "walk"),
                # 100 long literals alone: the split path's one XOR filter
                phase_e2e(torch, np, tree,
                          ["-r", "-S", "-H", os.path.join(tmp, "lits100.txt"), tree], "xor"),
                # the batches' digit and capital sequences flag nearly every
                # block of printable text, so their miss scan runs over the
                # punctuation tree
                phase_e2e(torch, np, gbulk,
                          ["-r", "-H", os.path.join(tmp, "batch4.txt"), gbulk], "fused"),
                phase_e2e(torch, np, gbulk,
                          ["-r", "-H", os.path.join(tmp, "batchseq.txt"), gbulk],
                          "fused stride"),
            ]
            gres, one_literal = phase_groups(torch, np, trees, tree, tmp, outs)
            vres = phase_server(torch, np, here, trees, tmp, outs, one_literal)
            mres = phase_multihost(torch, np, here, tree, trees, tmp)
            spres = phase_spot(torch, np, here, tree)
            gdres = phase_golden(torch, np, rng8)
            byres, walk_count_launches, lit_launches, litres = phase_byte_scan(
                torch, np, rng8, rate)
            bsres = phase_bench_shapes(torch, np)
            torch.cuda.empty_cache()  # the bench process takes ~6 GiB of the card
            bnres = phase_bench(torch, here)
            dres = phase_dryrun(torch)
    finally:
        refs.close()

    def row(name, source, replaces, n_launches, res, head, keys):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launches, "equal_plain": True,
            "max_abs_err": max(r["max_abs_err"] for r in res),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head.get("library_ms"),
            "copy_ms": head["copy_ms"],
            "by_case": [{k: r.get(k) for k in keys} for r in res],
        }

    common = ("ms", "plain_ms", "copy_ms", "bound_ms", "bound_by")
    by_key = {  # by the counters' short names
        "corewords": row("core_word_bitmap", "grab_tpu_torch/csrc/corewords.cu",
            "grab_tpu/ops/pallas_corewords.py:259", launches, kres,
            next(r for r in kres if r["set"] == "linus"),
            ("set", "k", "n_words", "masked") + common),
        "classseq": row("classseq_word_bitmap", "grab_tpu_torch/csrc/classseq.cu",
            "grab_tpu/ops/pallas_classseq.py:122",
            sum(r["launches"]["classseq"] for r in route_runs), cres, cres[0],
            ("set", "seqs") + common),
        "stride": row("stride_dfa_scan", "grab_tpu_torch/csrc/stridedfa.cu",
            "grab_tpu/ops/pallas_stridedfa.py:521",
            sum(r["launches"]["stride"] for r in route_runs), sres, sres[0],
            ("pattern", "mode", "k") + common + ("chain_ms",)),
        "alpharun": row("alpharun_word_bitmap", "grab_tpu_torch/csrc/alpharun.cu",
            "grab_tpu/ops/pallas_alpharun.py:212",
            sum(r["launches"]["alpharun"] for r in route_runs), ares, ares[0],
            ("set", "mode", "units") + common),
        "xor": row("xor_word_bitmap", "grab_tpu_torch/csrc/xorfilter.cu",
            "grab_tpu/ops/pallas_xorfilter.py:256",
            sum(r["launches"]["xor"] for r in route_runs), xres, xres[0],
            ("set", "banks", "groups", "copies", "remainder") + common),
        "fused": row("fused_word_bitmap", "grab_tpu_torch/csrc/fused.cu",
            "grab_tpu/ops/pallas_fused.py:182",
            sum(r["launches"]["fused"] for r in route_runs), fres, fres[0],
            ("set", "buckets", "banks", "seqs") + common),
        "transpose": row("stride_transpose", "grab_tpu_torch/csrc/transpose.cu",
            "grab_tpu/ops/pallas_stridedfa.py:631", t_launches, tres, tres[0],
            ("s_w",) + common + ("library_ms",)),
        "bloom": row("bloom_word_bitmap", "grab_tpu_torch/csrc/bloom.cu",
            "grab_tpu/ops/pallas_bloom.py:129", b_launches, bres, bres[0],
            ("set", "levels", "keys") + common),
        # B2's threading fixpoint: its own kernel in the same source, one
        # launch per run_t of an unbounded pattern
        "fixpoint": row("stride_dfa_fixpoint", "grab_tpu_torch/csrc/stridedfa.cu",
            "grab_tpu/ops/pallas_stridedfa.py:775",
            sum(r["launches"]["fixpoint"] for r in route_runs), fixres, fixres[0],
            ("case", "walks", "converged", "grid", "rewalked_words") + common),
        # the sharded literal byte step: launched by make_sharded_scan in
        # phase_byte_scan (and the dry run), not by a CLI route
        "literal": row("literal_block_counts", "grab_tpu_torch/csrc/literal_scan.cu",
            "grab_tpu/ops/literal_scan.py:40", lit_launches, litres, litres[0],
            ("case", "k", "candidates", "form", "form_ms", "bucket_compares") + common
            + ("design_ops_ms", "linear_ops_ms")),
        "walk": row("dfa_scan_bitmap", "grab_tpu_torch/csrc/dfa_walk.cu",
            "grab_tpu/ops/dfa_scan.py:46",
            sum(r["launches"]["walk"] for r in route_runs), wres, wres[1],
            ("case", "n_streams", "seg", "table", "flagged_blocks", "rewalked_bytes", "plain_s")
            + common + ("chain_ms", "stream_chain_ms")),
    }
    # the walk's counts entry (the sharded byte step): launched by
    # make_sharded_scan in phase_byte_scan, not by a CLI route
    walk_counts = row("bitmap_block_counts", "grab_tpu_torch/csrc/dfa_walk.cu",
                      "grab_tpu/ops/dfa_scan.py:94", walk_count_launches, wcres, wcres[1],
                      ("case", "n_streams", "seg", "candidates", "plain_s") + common
                      + ("chain_ms",))
    kernels = list(by_key.values()) + [walk_counts]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']}: never launched on a main path")
    # the multi-host path's launches, summed over its two host processes
    for key in ("corewords", "fused"):
        k = by_key[key]
        k["launches_multihost"] = sum(r["launches"]["hosts2"][key] for r in mres)
        check(k["launches_multihost"] > 0, f"{k['name']}: never launched on the multi-host path")
    # the bench's process (every kernel but B7) and the dry run's (entry:
    # B2; B1); the bench's shapes held against the plain versions
    for key, k in by_key.items():
        k["launches_bench"] = bnres["launches"][key]
        k["bench_shapes"] = bsres.get(key, [])
        k["launches_dryrun"] = dres["entry_launches"][key] + sum(
            r["launches"][key] for r in dres["runs"])
    detail = {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "sm_count": sms, "max_sm_clock_mhz": sm_clock,
        "build_s": {"nvcc": t_cuda, "ingest": t_ingest}, "native_ingest": native_ok,
        "buf_size": BUF, "kernel_sets": kres, "classseq_sets": cres, "stride_plans": sres,
        "stride_scanner": scres, "stride_fixpoint": fixres, "literal_scan": litres,
        "alpharun_sets": ares, "xor_sets": xres, "fused_sets": fres,
        "dfa_walk": wres, "dfa_walk_counts": wcres, "transpose_shapes": tres,
        "transpose_paths": tpaths,
        "bloom_sets": bres, "bloom_path": bpath, "groups": gres, "server": vres,
        "multihost": mres, "spot": spres, "golden": gdres, "byte_scan": byres,
        "bench_shapes": bsres, "bench": bnres, "dryrun": dres,
        "main_path": runs, "route_paths": route_runs,
        "tree": {"bytes": tree_bytes, "files": n_files},
        "route_trees": {k: v[1] for k, v in trees.items()},
        "miss_scan": e2e, "route_scans": route_e2e,
        "seconds": time.time() - t_start,
    }
    os.makedirs(os.path.join(here, "smoke_out"), exist_ok=True)
    with open(os.path.join(here, "smoke_out", "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)
    log(f"done in {time.time() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--host-run"] and sys.argv[3:4] == ["--"]:
        sys.exit(host_run(sys.argv[2], sys.argv[4:]))
    sys.exit(main())
