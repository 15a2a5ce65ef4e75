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
         hit placements;
       - B2 strided-DFA walk (stream-major [512 * 128, 128], stride
         2048 B) for a plan of every family the planner emits (run k=4,
         k=2, k=1, runp, cls k=4 and k=2, 16-bit run and cls), start and
         random entries, bitmap and exit states; then the scanner on the
         card against the plain path: the boundary-window pass, the
         threading fixpoint (runs across stream boundaries, one longer
         than a stride; the same number of walks) and the round-cap
         fallback;
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
     the host-only scans of the new routes (a Python regex VM, ~1 MB/s)
     run beside the card's work in subprocesses, each on a slice of the
     tree in walk order, and their outputs are joined in that order;
  5. times from CUDA events after warm-up: each kernel, its plain
     version, a device-to-device copy of the same bytes and the kernel's
     bound; then a miss or near-miss scan per route over the full-size
     trees: end-to-end rate, device idle share and the profiler's
     kernel times;
  6. the card's name and power limit, a ``{"kernels": [...]}`` line and,
     last, ``{"ok": true, "device": {...}}``.

Details go to smoke_out/chip_smoke.json. The script imports nothing
of JAX (``jax`` is blocked in sys.modules) and nothing of grab_tpu.
"""

from __future__ import annotations

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
SLEEP_CYCLES = 40_000_000  # ~20 ms at 2 GHz: covers queueing 40 launches

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


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


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


def phase_kernels(torch, np, cw, rng, sm_count, sm_clock_mhz):
    """Kernel vs plain at 32 MiB geometry, bit for bit; then times."""
    sets = dict(LITERAL_SETS)
    sets["k16-mixed"] = k16_literals(rng)
    dev = torch.device("cuda")
    int32_ops_per_s = sm_count * INT32_LANES_PER_SM * sm_clock_mhz * 1e6
    results = []
    for name, lits in sets.items():
        t = cw.CoreWordTests(lits)
        bufs = kernel_buffers(np, rng, lits)
        dev_bufs = {k: torch.from_numpy(v).to(dev) for k, v in bufs.items()}
        max_err = 0
        for dname, w in dev_bufs.items():
            check(w.is_cuda, f"{dname} buffer is not on the card")
            total, packed, bm = cw.core_word_flags(w, t.tab, t.k, t.n_words, t.masked)
            torch.cuda.synchronize()
            bm_ref = cw.core_word_bitmap_torch(w, t.tab, t.k, t.n_words, t.masked)
            total_ref, packed_ref = cw.packed_block_flags(bm_ref)
            torch.cuda.synchronize()
            err = max(
                int((bm.long() - bm_ref.long()).abs().max()),
                int((packed.long() - packed_ref.long()).abs().max()),
                abs(int(total.item()) - int(total_ref.item())),
            )
            check(
                torch.equal(bm, bm_ref) and torch.equal(packed, packed_ref)
                and torch.equal(total, total_ref),
                f"kernel != plain for {name} on {dname} data "
                f"(total {int(total.item())} vs {int(total_ref.item())})",
            )
            check(int(total.item()) > 0, f"planted {name} needles not flagged on {dname}")
            max_err = max(max_err, err)
        log(f"kernel == plain, bit for bit: {name} (K={t.k}, W={t.n_words}, "
            f"masked={t.masked}) on text/binary/zeros")

        # times: rotate over 4 distinct 32 MiB buffers (128 MiB > L2)
        ring = [dev_bufs["text"]] + [dev_bufs["text"].clone() for _ in range(3)]
        ms = time_cuda(
            torch, lambda i: cw.core_word_flags(ring[i % 4], t.tab, t.k, t.n_words, t.masked), 40)
        plain_ms = time_cuda(
            torch,
            lambda i: cw.packed_block_flags(cw.core_word_bitmap_torch(
                ring[i % 4], t.tab, t.k, t.n_words, t.masked)),
            5, warmup=1)
        dst = torch.empty_like(ring[0])
        copy_ms = time_cuda(torch, lambda i: dst.copy_(ring[i % 4]), 40)
        in_bytes = ring[0].numel() * 4
        out_bytes = (ROWS // 32) * 128 * 4 + (ROWS // 32) * 4 + 4
        bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        # least integer work: per (phase, literal) pair and word, one
        # 3-input logic op (LOP3: (x ^ v) & m, or OR-ing in the second
        # word's term) per tested word plus one compare-accumulate per
        # word when masked (2W), one compare per word when not (W)
        per_pair = 2 * t.n_words if t.masked else t.n_words
        ops = 4 * t.k * per_pair * ROWS * 128
        ops_ms = ops / int32_ops_per_s * 1e3
        results.append({
            "set": name, "literals": len(lits), "k": t.k, "n_words": t.n_words,
            "masked": t.masked, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "copy_ms": copy_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
            "bytes": in_bytes + out_bytes, "int32_ops": ops,
        })
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, d2d copy "
            f"{copy_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
            f"(bytes {bytes_ms:.4f}, int32 ops {ops_ms:.4f})")
        del ring, dev_bufs, dst
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


def phase_e2e(torch, np, tree, argv=None, counter="corewords", breakdown=True):
    """A miss (or near-miss) scan over the tree: end-to-end rate, then a
    profiled run for the device's busy and idle share."""
    from grab_tpu_torch import cli
    from grab_tpu_torch.engine import Engine

    engines = []

    def keep(pats, cfg):
        e = Engine(pats, cfg)
        engines.append(e)
        return e

    argv = argv or ["-r", "zQx##missing##", tree]
    reset_counters()
    rc, warm_out, _ = run_cli(cli, argv, factory=keep)  # warm: page cache, build
    check(rc == 0 and read_counters()[counter] > 0,
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
    log(f"scan {argv[:-1]}: {nbytes} bytes, {len(out)} B of output, walls {walls} s → "
        f"{gbps} GB/s; batches={st.device_batches}, stats: {st.summary()}")

    host = host_breakdown(np, tree, st.device_batches) if breakdown else None

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
    idle = None if not spans else max(0.0, 1.0 - busy / wall_us)
    log(f"profiled scan: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms, idle share "
        f"{'not measured (no device events)' if idle is None else f'{idle:.4f}'}")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[:8]:
        log(f"  device ms {v['ms']:.3f} over {v['count']} calls  {k}")
    return {
        "argv": [a if a != tree else os.path.basename(tree) for a in argv],
        "stdout_bytes": len(out), "bytes": nbytes, "walls_s": walls, "gbps": gbps,
        "device_batches": st.device_batches, "stats": st.summary(),
        "profiled_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "idle_share": idle, "device_ms_by_name": by_name, "host": host,
    }


def host_breakdown(np, tree: str, batches: int):
    """Host stages of the miss scan, each timed alone: the parallel walk,
    packing plus the pread fill of every batch, and the copy of each
    batch into pinned staging memory."""
    import torch

    from grab_tpu_torch.engine import Engine, EngineConfig
    from grab_tpu_torch.ingest.native import fill_segments
    from grab_tpu_torch.ingest.packer import BatchPacker
    from grab_tpu_torch.scan_pipeline import HALO

    eng = Engine(b"zQx##missing##", EngineConfig(device="none"))
    t0 = time.perf_counter()
    entries = list(eng._walk_iter(tree))
    walk_s = time.perf_counter() - t0
    packer = BatchPacker(BUF, 512, HALO)

    def fill(batch):
        jobs = [(entries[s.file_idx][0].encode(), s.file_off, s.buf_off, s.length)
                for s in batch.segments]
        fill_segments(batch.buf, jobs, 8)

    t0 = time.perf_counter()
    n = 0
    for idx, (_path, size) in enumerate(entries):
        for batch in packer.feed_size(idx, size):
            fill(batch)
            n += 1
    final = packer.finish()
    if final is not None:
        fill(final)
        n += 1
    fill_s = time.perf_counter() - t0
    src = np.ones(BUF + 4096, dtype=np.uint8)
    pinned = torch.empty(BUF + 4096, dtype=torch.uint8, pin_memory=True)
    t0 = time.perf_counter()
    for _ in range(batches):
        np.copyto(pinned.numpy(), src)
    stage_s = time.perf_counter() - t0
    out = {"walk_s": walk_s, "entries": len(entries), "pack_fill_s": fill_s,
           "batches": n, "stage_copy_s": stage_s, "stage_batches": batches}
    log(f"host stages alone: walk {walk_s:.3f}s ({len(entries)} files), pack+fill "
        f"{fill_s:.3f}s ({n} batches), pinned staging copies {stage_s:.3f}s "
        f"({batches} x 32 MiB)")
    return out


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
    """Integer operations the kernel's test needs on these words: per
    sequence evaluated before the word's first hit, the classes tested
    (all 4 phases at once) until no phase is left or the sequence ends,
    each 4 ops (funnel shift, 7-bit mask, high-bit mask, AND into the
    live phases) plus 6 per range (two 4-byte compares of an add and a
    3-input logic op each, AND-NOT, OR)."""
    rows = w.shape[0] - 8
    n = rows * 128
    data = w.view(torch.uint8).reshape(-1)
    alive = torch.ones(n, dtype=torch.bool, device=w.device)
    ops = 0
    for seq in seqs:
        live = alive.unsqueeze(1).repeat(1, 4)  # [word, phase]
        for j, ranges in enumerate(seq):
            tested = live.any(dim=1)
            ops += int(tested.sum()) * (4 + 6 * len(ranges))
            b = torch.stack([data[p + j : p + j + 4 * n : 4] for p in range(4)], dim=1)
            member = torch.zeros_like(live)
            for lo, hi in ranges:
                member |= (b >= lo) & (b <= hi)
            live &= member
        alive &= ~live.any(dim=1)
    return ops


def phase_classseq(torch, np, rng, sm_count, sm_clock_mhz):
    """B4 against its plain version at 32 MiB geometry, bit for bit."""
    from grab_tpu_torch.ops import classseq as cs
    from grab_tpu_torch.ops import corewords as cw

    dev = torch.device("cuda")
    int32_ops_per_s = sm_count * INT32_LANES_PER_SM * sm_clock_mhz * 1e6
    results = []
    for name, seqs in seq_sets(np, rng).items():
        needles = [seq_needle(s, rng) for s in seqs]
        bufs = kernel_buffers(np, rng, needles)
        dev_bufs = {k: torch.from_numpy(v).to(dev) for k, v in bufs.items()}
        for dname, w in dev_bufs.items():
            check(w.is_cuda, f"{dname} buffer is not on the card")
            total, packed, bm = cs.classseq_flags(w, seqs)
            torch.cuda.synchronize()
            bm_ref = cs.classseq_bitmap_torch(w, seqs)
            total_ref, packed_ref = cw.packed_block_flags(bm_ref)
            torch.cuda.synchronize()
            check(
                torch.equal(bm, bm_ref) and torch.equal(packed, packed_ref)
                and torch.equal(total, total_ref),
                f"class-seq kernel != plain for {name} on {dname} data "
                f"(total {int(total.item())} vs {int(total_ref.item())})",
            )
            check(int(total.item()) > 0, f"planted {name} sequences not flagged on {dname}")
        log(f"class-seq kernel == plain, bit for bit: {name} ({len(seqs)} sequences) "
            f"on text/binary/zeros")
        ring = [dev_bufs["text"]] + [dev_bufs["text"].clone() for _ in range(3)]
        ms = time_cuda(torch, lambda i: cs.classseq_flags(ring[i % 4], seqs), 40)
        plain_ms = time_cuda(
            torch, lambda i: cw.packed_block_flags(cs.classseq_bitmap_torch(ring[i % 4], seqs)),
            3, warmup=1)
        dst = torch.empty_like(ring[0])
        copy_ms = time_cuda(torch, lambda i: dst.copy_(ring[i % 4]), 40)
        in_bytes = ring[0].numel() * 4
        out_bytes = (ROWS // 32) * 128 * 4 + (ROWS // 32) * 4 + 4
        bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        ops = b4_ops(torch, ring[0], seqs)
        ops_ms = ops / int32_ops_per_s * 1e3
        results.append({
            "set": name, "seqs": len(seqs), "max_abs_err": 0, "ms": ms,
            "plain_ms": plain_ms, "copy_ms": copy_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
            "bytes": in_bytes + out_bytes, "int32_ops": ops,
        })
        log(f"{name}: class-seq kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, d2d copy "
            f"{copy_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, "
            f"int32 ops {ops_ms:.4f}: {ops} ops on the text buffer)")
        del ring, dev_bufs, dst
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


def phase_stride(torch, np, rng, sm_count, sm_clock_mhz):
    """B2 against its plain walk at the 32 MiB stream-major geometry,
    bit for bit (bitmap and exit states), every plan family, start and
    random entries; then times and bounds."""
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
    results = []
    for pat, plan in STRIDE_PLANS:
        dfa = compile_multi([pat]).dfa
        got_plan = sd.stride_plan(dfa)
        check(got_plan == plan, f"{pat!r}: plan {got_plan}, expected {plan}")
        t = sd.StrideDfaTables(dfa, plan)
        starts = torch.full((128, 128), t.start, dtype=torch.int32, device=dev)
        rand = torch.from_numpy(
            rng.integers(0, t.n_states, (128, 128), dtype=np.int32)).to(dev)
        for dname, w in dev_bufs.items():
            for ename, e in (("start", starts), ("random", rand)):
                bm, ex = sd.stride_dfa_scan(w, t, e)
                torch.cuda.synchronize()
                bm_p, ex_p = sd.stride_dfa_scan_torch(w, t, e)
                torch.cuda.synchronize()
                check(torch.equal(bm, bm_p) and torch.equal(ex, ex_p),
                      f"strided-DFA kernel != plain for {pat!r} ({t.mode}, k={t.k}) "
                      f"on {dname} data, {ename} entries")
        name = pat.decode("latin-1")
        ms = time_cuda(torch, lambda i: sd.stride_dfa_scan(ring[i % 4], t, starts), 20)
        plain_ms = time_cuda(torch, lambda i: sd.stride_dfa_scan_torch(ring[i % 4], t, starts),
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
        chain_ms = s_w * links * cycles / (sm_clock_mhz * 1e6) * 1e3
        results.append({
            "pattern": name, "mode": t.mode, "k": t.k, "states": t.n_states, "m": t.m,
            "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "copy_ms": copy_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms, "chain_ms": chain_ms,
            "link_cycles": cycles, "links_per_stream": s_w * links,
        })
        log(f"walk == plain, bit for bit: {name} ({t.mode}, k={t.k}, {t.n_states} states) "
            f"on text/binary, start/random entries; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms, d2d copy {copy_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} "
            f"ms, chain {chain_ms:.4f} ms ({s_w * links} links)")
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


def phase_stride_scanner(torch, np, rng):
    """StrideDfaScanner on the card against the plain path (the same
    scanner on the CPU): window pass, threading fixpoint, round cap."""
    from grab_tpu_torch.ops import stridedfa as sd
    from grab_tpu_torch.regex.compiler import compile_multi

    dev = torch.device("cuda")
    out = {}

    def compare(label, pat, buf, rounds=None):
        cp = compile_multi([pat])
        sc = sd.StrideDfaScanner(cp.dfa, cp.max_len, BUF)
        w = sc.prep_t(buf)
        wd = torch.from_numpy(w).to(dev)
        bm, n, conv = sc.run_t(wd)
        torch.cuda.synchronize()
        bm_p, n_p, conv_p = sc.run_t(torch.from_numpy(w))
        check(torch.equal(bm.cpu(), bm_p), f"{label}: bitmap on the card != plain path")
        check((int(n), bool(conv)) == (int(n_p), bool(conv_p)),
              f"{label}: walks/converged {int(n)}/{bool(conv)} != plain {n_p}/{conv_p}")
        if rounds is not None:
            check(rounds(int(n), bool(conv)), f"{label}: unexpected walks {int(n)}, {bool(conv)}")
        nb = BUF // 512
        flags = sc.flags_np(bm.cpu().numpy(), nb)
        check(np.array_equal(flags, sc.flags_np(bm_p.numpy(), nb)), f"{label}: flags differ")
        ms = time_cuda(torch, lambda i: sc.run_t(wd), 10)
        out[label] = {"walks": int(n), "converged": bool(conv), "ms": ms,
                      "flagged_blocks": int(flags.sum()), "window_mode": sc.window_mode}
        log(f"scanner on the card == plain path: {label} (walks {int(n)}, converged "
            f"{bool(conv)}, {int(flags.sum())} flagged blocks, {ms:.4f} ms per 32 MiB)")
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
            rounds=lambda n, c: c and n >= 2)
    # a[0-9]*b: the in-digits state crosses one stream per walk, so a
    # digit run over 3 strides needs 4+ walks
    digits = np.full(BUF, ord(" "), dtype=np.uint8)
    for pos, span in ((9 * 2048 + 100, 7000), (4000 * 2048 - 30, 50), (BUF - 3000, 2990)):
        digits[pos] = ord("a")
        digits[pos + 1 : pos + span] = ord("7")
        digits[pos + span] = ord("b")
    compare("fixpoint, a[0-9]*b", rb"a[0-9]*b", digits, rounds=lambda n, c: c and n >= 4)
    keep = sd.MAX_ROUNDS
    sd.MAX_ROUNDS = 2
    try:
        compare("round cap 2, fallback", rb"a[0-9]*b", digits,
                rounds=lambda n, c: n == 2 and not c)
    finally:
        sd.MAX_ROUNDS = keep
    check(out["round cap 2, fallback"]["flagged_blocks"] == BUF // 512,
          "round-cap fallback did not flag every block")
    return out


# -- the class_seq and gdfa main paths ---------------------------------------

SEQ_PLANTS = [b"QWERTY123456", b"ABCDEF000001", b"\t4711\t", b"\t9\t", b"\t123456789\t",
              b"hello world", b"abc def ghij"]


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
    return {"mtree": (mtree, m_bytes), "gtree": (gtree, g_bytes), "gbulk": (gbulk, b_bytes)}


class HostRefs:
    """The port's host-only scan (device "none") of a recursive command,
    run beside the card's work: the tree's files in walk order are cut
    into slices of about equal bytes, each scanned by one CLI subprocess
    given the slice's paths (the CLI prints the ``path:`` prefix for
    several paths as for -r), and the outputs are joined in order."""

    def __init__(self, here: str, workers: int = 6):
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


ROUTE_COMMANDS = [
    # (key, argv flags, pattern, tree, mode, member type, counter)
    ("seq-stride", ["-r"], "[A-Z]{6}[0-9]{6}", "mtree", "class_seq", "_StrideSeqMember",
     "stride"),
    ("seq-word", ["-r", "-O"], "\t[0-9]+\t", "mtree", "class_seq", "ClassSeqScanner",
     "classseq"),
    ("gdfa-window", ["-r"], ".{0,2}[a-z ]{11}", "mtree", "gdfa", "StrideDfaScanner",
     "stride"),
    ("gdfa-thread", ["-E", "-r"], ".{0,2}(?:[0-9a-zA-Z]{4})+", "gtree", "gdfa",
     "StrideDfaScanner", "stride"),
]


def counters():
    from grab_tpu_torch.ops import classseq as cs
    from grab_tpu_torch.ops import corewords as cw
    from grab_tpu_torch.ops import stridedfa as sd

    return {"corewords": cw.core_word_flags, "classseq": cs.classseq_flags,
            "stride": sd.stride_dfa_scan}


def reset_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {k: fn.launches for k, fn in counters().items()}


def phase_routes(torch, np, trees, refs):
    """The class_seq and gdfa commands on the card, each against its
    host-only scan; route and kernel counter checked per command."""
    from grab_tpu_torch import cli
    from grab_tpu_torch.engine import Engine

    runs = []
    for key, flags, pattern, tree, mode, member, counter in ROUTE_COMMANDS:
        root = trees[tree][0]
        engines = []

        def keep(pats, cfg):
            e = Engine(pats, cfg)
            engines.append(e)
            return e

        argv = flags + [pattern, root]
        reset_counters()
        t0 = time.time()
        rc, out, err = run_cli(cli, argv, factory=keep)
        dev_s = time.time() - t0
        launches = read_counters()
        shown = " ".join(flags + [repr(pattern), tree])
        check(rc == 0, f"{shown}: rc {rc}: {err}")
        sc = engines[-1]._get_scanner()
        got_member = type(sc.members[0]).__name__
        check(sc.mode == mode and got_member == member,
              f"{shown}: route {sc.mode}/{got_member}, expected {mode}/{member}")
        check(launches[counter] > 0, f"{shown}: the {counter} kernel was never launched")
        t0 = time.time()
        want = refs.result(key)
        wait_s = time.time() - t0
        check(out == want, f"{shown}: device stdout ({len(out)} B) != host stdout "
                           f"({len(want)} B)")
        check(len(out) > 0, f"{shown}: no matches printed for the planted hits")
        st = engines[-1].stats
        runs.append({"argv": shown, "mode": sc.mode, "member": got_member,
                     "stdout_bytes": len(out), "launches": launches,
                     "device_s": dev_s, "host_wait_s": wait_s,
                     "batches": st.device_batches, "stats": st.summary()})
        log(f"stdout == host scan: {shown} → {sc.mode}/{got_member} ({len(out)} B, "
            f"launches {launches}, device run {dev_s:.2f}s, waited {wait_s:.2f}s for the "
            f"host scan)")
    return runs


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
    libs = _build.build_cuda(["corewords", "classseq", "stridedfa"])
    t_cuda = time.time() - t0
    t0 = time.time()
    native_ok = native.available()
    t_ingest = time.time() - t0
    log(f"built {list(libs.values())} in {t_cuda:.1f}s (nvcc); native ingest "
        f"library {'used' if native_ok else 'NOT available: Python fallbacks'} "
        f"({t_ingest:.1f}s)")

    rng = np.random.default_rng(SEED)
    sms = props.multi_processor_count
    refs = HostRefs(here)
    try:
        with tempfile.TemporaryDirectory(prefix="grab_smoke_") as tmp:
            # the new routes' trees, and their host-only scans started
            # in subprocesses beside everything below
            t0 = time.time()
            trees = write_route_trees(np, rng, tmp)
            for key, flags, pattern, tree, *_ in sorted(
                    ROUTE_COMMANDS, key=lambda c: c[3] != "gtree"):
                refs.start(key, flags, pattern, trees[tree][0])
            log(f"route trees written in {time.time() - t0:.1f}s: "
                f"{ {k: v[1] for k, v in trees.items()} } bytes")

            # 3 + 5a. kernels vs plain at full geometry, then their times
            kres = phase_kernels(torch, np, cw, rng, sms, sm_clock)
            cres = phase_classseq(torch, np, rng, sms, sm_clock)
            sres = phase_stride(torch, np, rng, sms, sm_clock)
            scres = phase_stride_scanner(torch, np, rng)

            # 4. the main paths, then 5b. their miss / near-miss scans
            tree, tree_bytes, n_files, runs, launches = phase_main_path(torch, np, rng, tmp)
            route_runs = phase_routes(torch, np, trees, refs)
            refs.close()
            e2e = phase_e2e(torch, np, tree)
            gbulk = trees["gbulk"][0]
            route_e2e = [
                phase_e2e(torch, np, tree, ["-r", "[A-Z]{6}[0-9]{6}", tree], "stride", False),
                phase_e2e(torch, np, tree, ["-r", "\t[0-9]+\t", tree], "classseq", False),
                phase_e2e(torch, np, tree, ["-r", ".{0,2}[a-z ]{11}", tree], "stride", False),
                phase_e2e(torch, np, gbulk, ["-E", "-r", ".{0,2}(?:[0-9a-zA-Z]{4})+", gbulk],
                          "stride", False),
            ]
    finally:
        refs.close()

    def row(name, source, replaces, n_launches, res, head, keys):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launches, "equal_plain": True,
            "max_abs_err": max(r["max_abs_err"] for r in res),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None, "copy_ms": head["copy_ms"],
            "by_case": [{k: r[k] for k in keys} for r in res],
        }

    common = ("ms", "plain_ms", "copy_ms", "bound_ms", "bound_by")
    kernels = [
        row("core_word_bitmap", "grab_tpu_torch/csrc/corewords.cu",
            "grab_tpu/ops/pallas_corewords.py:259", launches, kres,
            next(r for r in kres if r["set"] == "linus"),
            ("set", "k", "n_words", "masked") + common),
        row("classseq_word_bitmap", "grab_tpu_torch/csrc/classseq.cu",
            "grab_tpu/ops/pallas_classseq.py:122",
            sum(r["launches"]["classseq"] for r in route_runs), cres, cres[0],
            ("set", "seqs") + common),
        row("stride_dfa_scan", "grab_tpu_torch/csrc/stridedfa.cu",
            "grab_tpu/ops/pallas_stridedfa.py:521",
            sum(r["launches"]["stride"] for r in route_runs), sres, sres[0],
            ("pattern", "mode", "k") + common + ("chain_ms",)),
    ]
    detail = {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "sm_count": sms, "max_sm_clock_mhz": sm_clock,
        "build_s": {"nvcc": t_cuda, "ingest": t_ingest}, "native_ingest": native_ok,
        "buf_size": BUF, "kernel_sets": kres, "classseq_sets": cres, "stride_plans": sres,
        "stride_scanner": scres, "main_path": runs, "route_paths": route_runs,
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
    sys.exit(main())
