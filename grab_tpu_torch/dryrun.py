"""Entry points: the single-device scan step and the multi-device dry run.

    python -m grab_tpu_torch.dryrun [N] [--device SPEC]

entry(device)          → (fn, example_args): the flagship regex's scan
                         step (the strided-DFA walk with its threading
                         fixpoint) on a 1 MiB buffer born transposed.
dryrun_multichip(n, device) → runs, on the first n devices the setting
                         names, (a) the Engine with n shards against
                         one shard (same stdout, and the orchestration
                         overhead ratio), (b) the byte-level sharded scan
                         step and (c) the core-word kernel per shard.

The device setting is ``GRAB_TPU_TORCH_DEVICE`` or "cuda" (every
visible card); a comma-separated list names the devices one by one and
may repeat one (``cuda:0,cuda:0`` is two lanes on one card,
``cpu,cpu,cpu,cpu`` four on the CPU). Asking for more shards than the
setting names raises; nothing is capped silently.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

FLAGSHIP = rb"foo[a-z]+bar"
ENTRY_BUF = 1 << 20
SHARD_BYTES = 64 << 10  # per device, parts (a) and (b)
NEEDLE = b"fooxyzzbar"


def _spec(device: Optional[str]) -> str:
    from grab_tpu_torch.engine import _default_device

    return device if device is not None else _default_device()


def entry(device: Optional[str] = None) -> Tuple[Callable, tuple]:
    """The flagship regex's scan step on the first device the setting
    names: ``fn(w2d_t)`` → (nonzero bitmap words, walks run) of
    ``StrideDfaScanner.run_t``, and its example argument, a seeded 1 MiB
    buffer with ``fooqqqqbar`` at 5000, born transposed (``prep_t``)."""
    from grab_tpu_torch.ops.stridedfa import StrideDfaScanner
    from grab_tpu_torch.regex.compiler import compile_pattern
    from grab_tpu_torch.scan_pipeline import resolve_devices

    dev = resolve_devices(_spec(device))[0]
    cp = compile_pattern(FLAGSHIP)
    sc = StrideDfaScanner(cp.dfa, cp.max_len, ENTRY_BUF)

    def scan_step(w2d_t):
        bm, n_rounds, _converged = sc.run_t(w2d_t)
        return torch.count_nonzero(bm), n_rounds

    rng = np.random.default_rng(0)
    buf = rng.integers(32, 127, size=ENTRY_BUF, dtype=np.uint8)
    buf[5000:5010] = np.frombuffer(b"fooqqqqbar", dtype=np.uint8)
    return scan_step, (torch.from_numpy(sc.prep_t(buf)).to(dev),)


def dryrun_corpus(n: int) -> List[Tuple[str, bytes]]:
    """2n in-memory files of 150,000 lowercase bytes (seed 3), a newline
    every 101 bytes, ``fooqqqqbar`` at 777."""
    rng = np.random.default_rng(3)
    corpus = []
    for i in range(2 * n):
        data = bytearray(rng.integers(97, 123, size=150_000, dtype=np.uint8))
        for p in range(0, len(data), 101):
            data[p] = 0x0A
        data[777:787] = b"fooqqqqbar"
        corpus.append((f"mem://f{i}", bytes(data)))
    return corpus


def make_engine(n_shards: int, device: str):
    """The flagship pattern's Engine, recursive output, 64 KiB buffers."""
    from grab_tpu_torch.engine import Engine, EngineConfig
    from grab_tpu_torch.format.emitter import OutputConfig

    cfg = EngineConfig(output=OutputConfig(recursive=True), device=device,
                       scan_buf_size=SHARD_BYTES, n_shards=n_shards)
    return Engine([FLAGSHIP], cfg)


def run_engine(eng, corpus) -> bytes:
    out = bytearray()
    eng.scan_corpus(iter(corpus), out.extend)
    return bytes(out)


def engine_part(n: int, device: str) -> dict:
    """(a): the Engine over n shards against one shard on the same
    corpus; stdout must be identical and nonempty, and the n-shard
    engine must run n lanes (Engine caps -n N at the devices named,
    which would compare one lane with one lane). Both engines warm,
    the ratio of their walls is the min over two runs each."""
    corpus = dryrun_corpus(n)
    eng_n, eng_1 = make_engine(n, device), make_engine(1, device)
    lanes = len(eng_n._get_scanner().lanes)
    if lanes != n:
        raise RuntimeError(f"-n {n} built {lanes} lane(s) on {device!r}")
    sharded_out = run_engine(eng_n, corpus)  # warm
    single_out = run_engine(eng_1, corpus)
    if not sharded_out:
        raise RuntimeError("the dry-run corpus printed no match")
    if sharded_out != single_out:
        raise RuntimeError(f"-n {n} output differs from -n 1")
    t_sharded = t_single = float("inf")
    for _ in range(2):
        t0 = time.monotonic()
        out_n = run_engine(eng_n, corpus)
        t_sharded = min(t_sharded, time.monotonic() - t0)
        t0 = time.monotonic()
        out_1 = run_engine(eng_1, corpus)
        t_single = min(t_single, time.monotonic() - t0)
        if out_n != sharded_out or out_1 != single_out:
            raise RuntimeError("a warm run printed other output")
    return {"output": sharded_out, "lines": sharded_out.count(b"\n"),
            "ratio": round(t_sharded / max(t_single, 1e-9), 4),
            "wall_sharded_s": t_sharded, "wall_single_s": t_single}


def needle_buffer(n: int) -> np.ndarray:
    """n * SHARD_BYTES printable bytes (seed 1), one needle per shard at
    100 + shard index."""
    rng = np.random.default_rng(1)
    buf = rng.integers(32, 127, size=n * SHARD_BYTES, dtype=np.uint8)
    for d in range(n):
        pos = d * SHARD_BYTES + 100 + d
        buf[pos : pos + len(NEEDLE)] = np.frombuffer(NEEDLE, dtype=np.uint8)
    return buf


def scan_step_part(devs: Sequence[torch.device]) -> dict:
    """(b): the byte-level sharded scan step (``make_sharded_scan``);
    every shard holds a needle, so the summed count is at least n."""
    from grab_tpu_torch.parallel.scan_step import make_sharded_scan
    from grab_tpu_torch.regex.compiler import compile_pattern

    n = len(devs)
    buf = needle_buffer(n)
    fn = make_sharded_scan(compile_pattern(FLAGSHIP), devs, SHARD_BYTES)
    counts, total = fn(torch.from_numpy(buf))
    total = int(total)
    if total < n:
        raise RuntimeError(f"summed candidate count {total} < {n}")
    if [tuple(c.shape) for c in counts] != [(SHARD_BYTES // 512,)] * n:
        raise RuntimeError(f"count shapes {[tuple(c.shape) for c in counts]}")
    flagged = sum(int((c > 0).sum()) for c in counts)
    return {"total": total, "flagged_blocks": flagged}


def word_scan_part(devs: Sequence[torch.device]) -> dict:
    """(c): the core-word kernel per device on the padded shards
    (``make_sharded_word_scan``); shard 0's block of its needle is
    flagged. → the summed count and shard 0's flagged blocks."""
    from grab_tpu_torch.ops.corewords import BLOCK, LANES, PAD_ROWS, decode_packed_flags
    from grab_tpu_torch.parallel.scan_step import make_sharded_word_scan

    n = len(devs)
    buf = needle_buffer(n)
    shard_rows = SHARD_BYTES // BLOCK
    wfn = make_sharded_word_scan([NEEDLE], devs)
    shards = []
    for d, dev in enumerate(devs):
        w = buf[d * SHARD_BYTES : (d + 1) * SHARD_BYTES].view("<i4").reshape(shard_rows, LANES)
        padded = np.concatenate([w, np.zeros((PAD_ROWS, LANES), "<i4")])
        shards.append(torch.from_numpy(padded).to(dev))
    packed, total = wfn(shards)
    total = int(total)
    if total < n:
        raise RuntimeError(f"summed flagged groups {total} < {n}")
    t = wfn.tests
    flags0 = decode_packed_flags(packed[0].cpu().numpy(), shard_rows, t.probe_back, t.probe_fwd)
    if flags0[100 // BLOCK] != 1:
        raise RuntimeError("shard 0's needle block is not flagged")
    return {"total": total, "flagged0": np.flatnonzero(flags0).tolist()}


def dryrun_multichip(n: int, device: Optional[str] = None, out=None) -> dict:
    """Parts (a)-(c) on the first n devices ``device`` names (default:
    GRAB_TPU_TORCH_DEVICE or every visible card); each part raises on a
    failure. Prints the ``shard_orchestration_overhead_ratio`` line and
    one line per part on ``out`` (default stdout); → the parts' results."""
    from grab_tpu_torch.parallel.scan_step import shard_devices

    out = out or sys.stdout
    spec = _spec(device)
    devs = shard_devices(n, spec)
    a = engine_part(n, spec)
    print(json.dumps({"metric": "shard_orchestration_overhead_ratio", "value": a["ratio"],
                      "unit": "ratio", "n_shards": n, "devices": spec}), file=out)
    print(f"dryrun_multichip OK (Engine, {n} lanes): {n} shards, {a['lines']} output "
          f"lines, identical to -n 1", file=out)
    b = scan_step_part(devs)
    print(f"dryrun_multichip OK: {n} shards, summed candidates = {b['total']}, "
          f"flagged blocks = {b['flagged_blocks']}", file=out)
    c = word_scan_part(devs)
    print(f"dryrun_multichip OK (core-word kernel per device): summed flagged groups = "
          f"{c['total']}", file=out, flush=True)
    return {"engine": a, "scan_step": b, "word_scan": c}


def main(argv: Optional[Sequence[str]] = None) -> int:
    from grab_tpu_torch.scan_pipeline import DeviceUnavailable, resolve_devices

    p = argparse.ArgumentParser(prog="python -m grab_tpu_torch.dryrun")
    p.add_argument("n", nargs="?", type=int, help="shards (default: every device named)")
    p.add_argument("--device", help="device setting (default: GRAB_TPU_TORCH_DEVICE or cuda)")
    args = p.parse_args(argv)
    try:
        spec = _spec(args.device)
        n = args.n if args.n is not None else len(resolve_devices(spec))
        fn, ex = entry(spec)
        count, rounds = fn(*ex)
        print(f"entry OK: {int(count)} nonzero bitmap words, {int(rounds)} walks", flush=True)
        dryrun_multichip(n, spec)
    except DeviceUnavailable as e:
        print(f"dryrun: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
