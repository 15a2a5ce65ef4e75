"""Benchmark: per-card literal-scan throughput beside the card's HBM roofline.

    python -m grab_tpu_torch.bench [--device cpu]

Prints ONE JSON line on stdout, the headline (the JAX package's
``bench.py`` metric name and keys, plus ``backend`` and ``device``):

  {"metric": "literal_scan_bytes_per_sec_per_chip", "value": N,
   "unit": "bytes/s", "vs_baseline": N,
   "measured_roofline_bytes_per_sec": N, "vs_measured_roofline": N,
   "vs_measured_target": N, "backend": "cuda", "device": "<card>", ...}

then, on the card, the secondary metrics on stderr, one JSON object per
line, under the reference's names (``secondary_metrics``).

Protocol:
  * a miss-only literal (``qZx9kWv3`` over lowercase bytes; the zero
    total is asserted) forces the full-corpus scan;
  * the corpus is generated on the device from a seeded generator
    (GRAB_TPU_BENCH_MB MiB, default 1024 on the card, 8 on the CPU), so
    the scan kernel is measured, not the upload;
  * the headline is ONE core-word kernel launch over the whole corpus;
  * times come from CUDA events around launches over distinct buffers
    (or one buffer larger than the H100's 50 MiB L2), after a sleep
    kernel queued ahead of the start event, ten times as long as the
    host's queueing of one pass, so that its launch cost leaves no gaps;
    each value is the median of REPS such runs;
  * ``vs_baseline`` is against 0.80 x the card's spec HBM rate (looked up
    by ``torch.cuda.get_device_name``; left out, with a note on stderr,
    for a card the table does not know); the measured roofline is a
    read-only int32 reduction over the same words, timed the same way.

A metric that raises prints ``{"metric": name, "error": ...}`` on stderr
and the process exits 1 after the headline. Without a CUDA card the
bench exits 2 unless ``--device cpu`` or GRAB_TPU_TORCH_DEVICE=cpu asks
for the CPU, where the headline runs on the kernel's plain PyTorch
version, timed with ``time.perf_counter``, and the secondary metrics
are skipped.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from grab_tpu_torch.ops.corewords import LANES, PAD_ROWS

METRIC = "literal_scan_bytes_per_sec_per_chip"
LITERAL = b"qZx9kWv3"
# NVIDIA's data sheet HBM rate, by torch.cuda.get_device_name()
HBM_SPEC = {"NVIDIA H100 80GB HBM3": 3.35e12}
REPS = 5  # timed runs per value; the value is their median
DEPTH = 4  # distinct buffers per stack (each >= 256 MiB, far past L2)
SLEEP_CYCLES = 100_000_000  # ~50 ms at 2 GHz, the least sleep ahead of the start event
SLEEP_CAP = 4_000_000_000  # ~2 s
SUSPECT = 1.05  # x this run's measured roofline: a timing artefact
KERNELS = ("corewords", "classseq", "stridedfa", "alpharun", "xorfilter", "fused", "bloom")
# the reference's secondary metrics, in the order secondary_metrics emits them
SECONDARY_METRICS = (
    "hbm_roofline_measured_bytes_per_sec", "classseq_bytes_per_sec",
    "fused_ensemble_bytes_per_sec", "fused_lits100_bytes_per_sec",
    "fused_lits100_seq2_bytes_per_sec", "fused_allinone_bytes_per_sec",
    "seqdfa10_bytes_per_sec", "seqdfa2_bytes_per_sec", "stridedfa_e2e_bytes_per_sec",
    "stridedfa_e2e_unbounded_bytes_per_sec", "stridedfa_quad_bytes_per_sec",
    "stridedfa_pair_bytes_per_sec", "stridedfa_runp_bytes_per_sec",
    "stridedfa_cls_bytes_per_sec", "xor100_bytes_per_sec", "bloom100_bytes_per_sec",
    "alpharun_bytes_per_sec", "host_transpose_bytes_per_sec",
)
DIGIT = sum(1 << b for b in range(48, 58))
LOWER = sum(1 << b for b in range(97, 123))
CLASSSEQ = (DIGIT, DIGIT, DIGIT, LOWER, LOWER)  # classseq_bytes_per_sec's one sequence
ALPHA_RANGES, ALPHA_MIN = ((48, 57),), 11  # alpharun_bytes_per_sec: digit runs of 11+
WALKS = (  # (metric, pattern, the stride plan it must take) over the 1 GiB stack
    ("stridedfa_quad_bytes_per_sec", rb"[0-9]{5}", ("run", 4)),
    ("stridedfa_pair_bytes_per_sec", rb"[0-9]{50}", ("run", 2)),
    # fragmented class maps: parity-refined runs, and a map parity
    # cannot rescue
    ("stridedfa_runp_bytes_per_sec", rb"[acegikmoqsuwy]{3}", ("runp", 2)),
    ("stridedfa_cls_bytes_per_sec", rb"[adgjmpsvy]{3}", ("cls", 4)),
)


def kernel_wrappers() -> dict:
    """The port's kernel wrappers, by the short name their launch counts
    go under (``launch_counters``, ``chip_smoke.py``): the nine kernels
    with a word or walk entry, B2's threading fixpoint (``fixpoint``, a
    kernel of its own) and the sharded literal byte step (``literal``).
    The bench launches all but the last-resort walk (``walk``), B7 and
    the literal byte step, which have no metric."""
    from grab_tpu_torch.ops.alpharun import alpharun_flags
    from grab_tpu_torch.ops.bloom import bloom_word_flags
    from grab_tpu_torch.ops.classseq import classseq_flags
    from grab_tpu_torch.ops.corewords import core_word_flags
    from grab_tpu_torch.ops.dfa_scan import dfa_walk_flags
    from grab_tpu_torch.ops.fused import fused_word_flags
    from grab_tpu_torch.ops.literal_scan import literal_block_counts
    from grab_tpu_torch.ops.stridedfa import (
        stride_dfa_fixpoint, stride_dfa_scan, stride_transpose)
    from grab_tpu_torch.ops.xorfilter import xor_word_flags

    return {"corewords": core_word_flags, "classseq": classseq_flags,
            "stride": stride_dfa_scan, "fixpoint": stride_dfa_fixpoint,
            "alpharun": alpharun_flags, "xor": xor_word_flags,
            "fused": fused_word_flags, "transpose": stride_transpose,
            "bloom": bloom_word_flags, "walk": dfa_walk_flags,
            "literal": literal_block_counts}


def launch_counters() -> dict:
    """The kernel wrappers' launch counts, by short name."""
    return {k: f.launches for k, f in kernel_wrappers().items()}


def bench_sets() -> dict:
    """The reference's literal and pattern sets, drawn in its order from
    a host generator seeded 7: ``lits`` (100 of 9 bytes: B5, B8),
    ``lits100`` (96 of 9 bytes and 4 short ones: B6) and ``regex10``
    (the seqdfa patterns)."""
    rng = np.random.default_rng(7)
    lits = [bytes(rng.integers(33, 127, 9, np.uint8).tobytes()) for _ in range(100)]
    lits100 = [bytes(rng.integers(33, 127, 9, np.uint8).tobytes()) for _ in range(96)] + [
        b"qZxW", b"kV9#p", b"a_Qz", b"T4$u"]
    regex10 = [("[0-9]{%d}[a-z]{%d}" % (3 + i % 3, 1 + i % 2)).encode() for i in range(10)]
    return {"lits": lits, "lits100": lits100, "regex10": regex10}


def seq_masks(k: int) -> list:
    """The first k of regex10's class sequences, as byte-class masks."""
    return [tuple([DIGIT] * (3 + i % 3) + [LOWER] * (1 + i % 2)) for i in range(k)]


def device_words(rows: int, seed: int, device: torch.device, pad_rows: int = PAD_ROWS):
    """int32 [rows + pad_rows, 128] words of lowercase bytes (the pad
    rows zero), generated on ``device`` by a generator seeded ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    b = torch.zeros((rows + pad_rows) * LANES * 4, dtype=torch.uint8, device=device)
    b[: rows * LANES * 4].random_(97, 123, generator=gen)
    return b.view(torch.int32).view(rows + pad_rows, LANES)


def seconds_per_call(fn: Callable, stack: Sequence, reps: int = REPS) -> float:
    """Median seconds per ``fn(x)`` over the entries ``x`` of ``stack``.

    On the card: one warm pass, then ``reps`` runs of one pass each,
    each between two CUDA events after a sleep kernel ten times as long
    as the warm pass took the host to queue (at 2 GHz; at least 50 ms,
    at most 2 s): the host queues a pass of thousands of launches ahead
    of the card, so its launch cost leaves no gaps between them. On the
    CPU: the same passes timed with ``time.perf_counter``."""
    t0 = time.perf_counter()
    for x in stack:
        fn(x)
    queued = time.perf_counter() - t0
    cuda = _on_cuda(stack[0])
    times = []
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sleep = min(SLEEP_CAP, max(SLEEP_CYCLES, int(10 * queued * 2e9)))
        for _ in range(reps):
            torch.cuda._sleep(sleep)
            start.record()
            for x in stack:
                fn(x)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / len(stack))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            for x in stack:
                fn(x)
            times.append((time.perf_counter() - t0) / len(stack))
    return statistics.median(times)


def _on_cuda(entry) -> bool:
    while isinstance(entry, (tuple, list)):
        entry = entry[0]
    return entry.device.type == "cuda"


def int32_sum(x: torch.Tensor) -> torch.Tensor:
    """The measured roofline's read-only reduction."""
    return x.sum(dtype=torch.int32)


def headline(device: torch.device, n_mb: int, reps: int = REPS) -> dict:
    """The headline line: one core-word launch over an n_mb MiB corpus,
    beside the measured roofline over the same words."""
    from grab_tpu_torch.ops.corewords import CoreWordScanner, core_word_flags

    n = n_mb << 20
    rows = n // (4 * LANES)
    if rows <= 0 or rows % 32:
        raise ValueError(f"GRAB_TPU_BENCH_MB={n_mb}: the corpus must be a multiple of 16 KiB")
    t = CoreWordScanner([LITERAL]).tests
    words = device_words(rows, 42, device)

    def scan(w):
        return core_word_flags(w, t.tab, t.k, t.n_words, t.masked)[0]

    before = core_word_flags.launches
    total = int(scan(words))
    if core_word_flags.launches - before != int(device.type == "cuda"):
        raise RuntimeError("the headline scan is not one kernel launch")
    if total != 0:
        raise RuntimeError(f"miss pattern produced {total} candidate groups")
    # on the card each launch reads the whole corpus (1 GiB > L2), so
    # repeated launches on one buffer find none of it cached
    dt = seconds_per_call(scan, [words] * DEPTH, reps)
    roof = words.numel() * 4 / seconds_per_call(int32_sum, [words] * DEPTH, reps)
    value = n / dt
    line = {"metric": METRIC, "value": round(value, 1), "unit": "bytes/s"}
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    spec = HBM_SPEC.get(name)
    if spec is not None:
        line["vs_baseline"] = round(value / (0.80 * spec), 4)
    else:
        print(f"bench: no spec HBM rate for {name!r}: vs_baseline left out", file=sys.stderr)
    line["measured_roofline_bytes_per_sec"] = round(roof, 1)
    line["vs_measured_roofline"] = round(value / roof, 4)
    line["vs_measured_target"] = round(value / (0.80 * roof), 4)
    line.update(backend=device.type, device=name, bytes=n, launches=1)
    return line


class _Emitter:
    """Prints one metric line per value and keeps the failures."""

    def __init__(self, out, roofline: Optional[float]):
        self.out, self.roofline = out, roofline
        self.failed: List[str] = []

    def __call__(self, name: str, measure: Callable[[], tuple], device: torch.device) -> None:
        """measure() → (bytes, seconds[, extra keys])."""
        try:
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            nbytes, dt, *extra = measure()
            line = {"metric": name, "value": round(nbytes / dt, 1), "unit": "bytes/s"}
            if extra:
                line.update(extra[0])
            if device.type == "cuda":
                line["peak_bytes"] = torch.cuda.max_memory_allocated(device)
            if self.roofline is not None and nbytes / dt > SUSPECT * self.roofline:
                line["suspect"] = True
        except Exception as e:  # reported, and the bench exits 1
            self.failed.append(name)
            line = {"metric": name, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(line), file=self.out, flush=True)


def _free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def secondary_metrics(
    device: torch.device,
    roofline: Optional[float] = None,
    *,
    n: int = 256 << 20,
    big: int = 1 << 30,
    mbuf: int = 32 << 20,
    depth: int = DEPTH,
    reps: int = REPS,
    out=None,
) -> List[str]:
    """The reference's secondary metrics (its ``bench.py``
    ``secondary_metrics``), one JSON line each on ``out`` (default
    stderr): the kernel rates off the headline's best case, at the
    reference's corpus sizes (``n`` = 256 MiB stacks, ``big`` = 1 GiB,
    ``mbuf`` = the 32 MiB production buffer) with its literal and
    pattern sets and plan asserts. The e2e metrics come right after the
    seqdfa ones, which share their born-transposed stack. A value above
    SUSPECT x ``roofline`` is marked ``suspect``. → the names of the
    metrics that failed."""
    from grab_tpu_torch.ops.alpharun import alpharun_flags, plan_for
    from grab_tpu_torch.ops.bloom import BloomWordTests, bloom_word_flags
    from grab_tpu_torch.ops.classseq import classseq_flags, compile_sequences
    from grab_tpu_torch.ops.fused import FusedEnsembleScanner, fused_word_flags
    from grab_tpu_torch.ops.stridedfa import (
        STREAM_ROWS,
        W,
        StrideDfaScanner,
        StrideDfaTables,
        stride_dfa_scan,
        stride_plan,
    )
    from grab_tpu_torch.ops.xorfilter import XorWordTests, xor_word_flags
    from grab_tpu_torch.regex.compiler import compile_multi
    from grab_tpu_torch.scan_pipeline import _StrideSeqMember

    if n % mbuf or big % mbuf or big % (STREAM_ROWS * W * 4 * LANES) or mbuf < (2 << 20):
        raise ValueError(f"sizes n={n} big={big} mbuf={mbuf} do not fit the geometry")
    emit = _Emitter(out or sys.stderr, roofline)
    rows = n // (4 * LANES)
    sets = bench_sets()
    lits, lits100, regex10 = sets["lits"], sets["lits100"], sets["regex10"]

    # scanners and tables first: every compile stays outside the timed region
    seqs1 = compile_sequences([CLASSSEQ])
    cpseq = compile_multi(regex10)
    assert cpseq.seq_dfa is not None and cpseq.seq_max_len is not None
    member = _StrideSeqMember(cpseq.seq_dfa, cpseq.seq_max_len, mbuf)
    cp2 = compile_multi(regex10[:2])
    member2 = _StrideSeqMember(cp2.seq_dfa, cp2.seq_max_len, mbuf)
    fsc = FusedEnsembleScanner(lits100, None)
    fsc2 = FusedEnsembleScanner(lits100, compile_sequences(seq_masks(2)))
    fsc_all = FusedEnsembleScanner(lits100, compile_sequences(seq_masks(10)))
    rows_t = member.s_w * STREAM_ROWS  # born-transposed rows per mbuf buffer
    n_bufs = big // mbuf

    def count_t(run_t, bufs):
        # each mbuf buffer is its own tensor, as production submits them
        acc = None
        for b in bufs:
            c = torch.count_nonzero(run_t(b)[0])
            acc = c if acc is None else acc + c
        return acc

    # -- 256 MiB linear stack, with 1 GiB of born-transposed buffers per entry
    stack = [device_words(rows, 700 + j, device) for j in range(depth)]
    stack_t = [
        tuple(device_words(rows_t, 800 + j * n_bufs + i, device, 0) for i in range(n_bufs))
        for j in range(depth)
    ]
    emit("hbm_roofline_measured_bytes_per_sec",
         lambda: (n, seconds_per_call(int32_sum, stack, reps)), device)
    emit("classseq_bytes_per_sec",
         lambda: (n, seconds_per_call(lambda x: classseq_flags(x, seqs1)[0], stack, reps)), device)
    # the production ensemble: B6 on the linear buffer, then the union
    # stride member's walk on the born-transposed mbuf buffers of the
    # same bytes, chained as DeviceScanner.submit chains them
    n_mb_bufs = n // mbuf
    pairs = [(stack[j], stack_t[j][:n_mb_bufs]) for j in range(depth)]
    emit("fused_ensemble_bytes_per_sec", lambda: (n, seconds_per_call(
        lambda ab: fsc.packed(ab[0])[0] + count_t(member.sc.run_t, ab[1]), pairs, reps)), device)
    emit("fused_lits100_bytes_per_sec",
         lambda: (n, seconds_per_call(lambda x: fused_word_flags(x, fsc)[0], stack, reps)), device)
    emit("fused_lits100_seq2_bytes_per_sec",
         lambda: (n, seconds_per_call(lambda x: fused_word_flags(x, fsc2)[0], stack, reps)), device)
    emit("fused_allinone_bytes_per_sec",
         lambda: (n, seconds_per_call(lambda x: fused_word_flags(x, fsc_all)[0], stack, reps)),
         device)
    del stack, pairs
    emit("seqdfa10_bytes_per_sec", lambda: (n_bufs * mbuf, seconds_per_call(
        lambda bufs: count_t(member.sc.run_t, bufs), stack_t, reps)), device)
    emit("seqdfa2_bytes_per_sec", lambda: (n_bufs * mbuf, seconds_per_call(
        lambda bufs: count_t(member2.sc.run_t, bufs), stack_t, reps)), device)

    # the factor-less tier end to end at the production buffer size: a
    # StrideDfaScanner's run_t per mbuf buffer born transposed, with the
    # boundary-window pass ([0-9]{5}) or the threading fixpoint (the
    # engine-reachable unbounded pattern)
    def e2e(pat):
        cpx = compile_multi([pat])
        scx = StrideDfaScanner(cpx.dfa, cpx.max_len, mbuf)
        assert scx.s_w * STREAM_ROWS == rows_t, (pat, scx.s_w)
        return n_bufs * mbuf, seconds_per_call(lambda bufs: count_t(scx.run_t, bufs),
                                               stack_t, reps)

    emit("stridedfa_e2e_bytes_per_sec", lambda: e2e(rb"[0-9]{5}"), device)
    emit("stridedfa_e2e_unbounded_bytes_per_sec", lambda: e2e(rb".{0,2}(?:[0-9a-zA-Z]{4})+"),
         device)
    del stack_t
    _free(device)

    # -- 1 GiB stack: the walk kernel alone on its geometry, and the
    # word kernels of the literal members and the class-run tier
    g_rows = big // (4 * LANES)
    gstack = [device_words(g_rows, 900 + j, device) for j in range(depth)]
    walk_in = [x[:g_rows] for x in gstack]  # contiguous leading rows
    g_bytes = g_rows * 4 * LANES

    def walk(pat, want):  # the walk kernel alone, from the start state
        cp = compile_multi([pat])
        plan = stride_plan(cp.dfa)
        assert plan == want, (pat, plan)
        t = StrideDfaTables(cp.dfa, plan)
        entries = torch.full((STREAM_ROWS, LANES), t.start, dtype=torch.int32, device=device)
        return g_bytes, seconds_per_call(lambda x: stride_dfa_scan(x, t, entries)[0],
                                         walk_in, reps)

    for name, pat, plan in WALKS:
        emit(name, lambda pat=pat, plan=plan: walk(pat, plan), device)
    xt = XorWordTests(lits)
    emit("xor100_bytes_per_sec", lambda: (g_bytes, seconds_per_call(
        lambda x: xor_word_flags(x, xt)[0], gstack, reps)), device)
    bt = BloomWordTests(lits)
    emit("bloom100_bytes_per_sec", lambda: (g_bytes, seconds_per_call(
        lambda x: bloom_word_flags(x, bt)[0], gstack, reps)), device)
    amode, units = plan_for(ALPHA_MIN)
    emit("alpharun_bytes_per_sec", lambda: (g_bytes, seconds_per_call(
        lambda x: alpharun_flags(x, ALPHA_RANGES, amode, units)[0], gstack, reps)), device)
    del gstack, walk_in
    _free(device)
    emit("host_transpose_bytes_per_sec", lambda: host_transpose(mbuf, reps), device)
    return emit.failed


def host_transpose(mbuf: int, reps: int = REPS) -> tuple:
    """The host's price of the born layout: the blocked multithreaded
    transpose (ingest gt_transpose32) of one mbuf buffer, all cores; →
    (bytes, median seconds, extra keys). Without the native library it
    raises: the numpy fallback is not what production runs."""
    from grab_tpu_torch.ingest import native
    from grab_tpu_torch.ops.stridedfa import N_STREAMS

    if not native.available():
        raise RuntimeError("the native ingest library did not build")
    s_w = mbuf // 4 // N_STREAMS
    a2 = np.random.default_rng(3).integers(0, 2**31, size=(N_STREAMS, s_w),
                                           dtype=np.int64).astype(np.int32)
    out = np.empty((s_w, N_STREAMS), dtype=np.int32)
    nt = os.cpu_count() or 2
    native.transpose_stream_rows(a2, nthreads=nt, out=out)  # warm
    times = []
    for _ in range(max(reps, 5)):
        t0 = time.perf_counter()
        native.transpose_stream_rows(a2, nthreads=nt, out=out)
        times.append(time.perf_counter() - t0)
    return a2.nbytes, statistics.median(times), {"host_threads": nt}


def bench_device(argv: Optional[Sequence[str]] = None) -> torch.device:
    """The bench's device: the card, unless ``--device cpu`` or
    GRAB_TPU_TORCH_DEVICE=cpu asks for the CPU; a CUDA device without a
    card raises (scan_pipeline.DeviceUnavailable)."""
    from grab_tpu_torch.scan_pipeline import resolve_devices

    p = argparse.ArgumentParser(prog="python -m grab_tpu_torch.bench")
    p.add_argument("--device", default=os.environ.get("GRAB_TPU_TORCH_DEVICE", "cuda"),
                   help="cuda (default), cuda:N or cpu")
    return resolve_devices(p.parse_args(argv).device)[0]


def main(argv: Optional[Sequence[str]] = None) -> int:
    from grab_tpu_torch.scan_pipeline import DeviceUnavailable

    try:
        device = bench_device(argv)
    except DeviceUnavailable as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    on_card = device.type == "cuda"
    if on_card:
        from grab_tpu_torch import _build

        t0 = time.time()
        _build.build_cuda(KERNELS)
        print(f"bench: kernels built in {time.time() - t0:.1f}s", file=sys.stderr)
    n_mb = int(os.environ.get("GRAB_TPU_BENCH_MB", "1024" if on_card else "8"))
    print(f"bench: device={device} n={n_mb}MB", file=sys.stderr)
    line = headline(device, n_mb)
    print(json.dumps(line), flush=True)
    if not on_card:
        return 0
    failed = secondary_metrics(device, line["measured_roofline_bytes_per_sec"])
    print(json.dumps({"bench_launches": launch_counters()}), file=sys.stderr)
    if failed:
        print(f"bench: {len(failed)} metric(s) failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
