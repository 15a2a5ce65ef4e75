"""Sharded device scan step: data parallelism over a list of devices.

The reference's only multi-worker axis is data parallelism over files
with one compiled pattern per worker (greppin src/main.cc:86-100,
195-216: round-robin file striding + a private FileGrep per pinned
thread). The JAX package maps it onto a 1-D device mesh with one
shard_map program; the port keeps the contract and drops the program:

  * the shard devices are a plain list (``shard_devices``), the first n
    the device setting names;
  * the compiled tables are REPLICATED: uploaded once per device at
    first use, the analog of each thread compiling its own pattern copy;
  * each device scans one padded buffer with the same fixed-shape
    kernel, queued without waiting for the others;
  * per-shard packed flags stay on their device, while the global
    candidate count is the sum of the per-shard counts (the collective
    that replaces the reference's stdout mutex, grab.cc:56, 218-226);
  * ordering is restored on the host by the deterministic
    (file_index, offset) merge of the pipeline.

``make_sharded_word_scan`` is the production step (the core-word
kernel per device); ``make_sharded_scan`` keeps the reference's
byte-granular step: per shard, the per-block counts of the last-resort
walk (ops/dfa_scan.py ``dfa_walk_counts``: on a card the csrc/dfa_walk.cu
walk and its count kernel, on the CPU the plain walk) or of the literal
scan (ops/literal_scan.py ``literal_block_counts``: on a card one launch
of csrc/literal_scan.cu, on the CPU the plain scan and block counts).
No CLI route runs it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from grab_tpu_torch.scan_pipeline import resolve_devices


def shard_devices(n_devices: Optional[int] = None, device: str = "cuda") -> List[torch.device]:
    """The first ``n_devices`` shard devices that the device setting
    names (``scan_pipeline.resolve_devices``: 'cuda' is every visible
    card, a comma-separated list names them one by one); all of them
    when ``n_devices`` is None. Asking for more than there are raises."""
    devs = resolve_devices(device)
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"{n_devices} shard devices asked for, {device!r} names {len(devs)}"
            )
        devs = devs[:n_devices]
    return devs


def make_sharded_word_scan(literals, devices: Sequence[torch.device]):
    """Multi-device literal scan: the core-word kernel per device.

    Each device owns one padded scan buffer (the packer's natural unit).
    Returns ``fn(shards) -> (packed, total)``: ``shards`` holds one
    int32 [shard_rows + PAD_ROWS, 128] tensor per device, each on its
    device; ``packed`` is the per-shard packed per-block flag bits
    (int32 [shard_rows/32], left on their devices) and ``total`` the
    summed count of flagged groups, int32 [1] on the first device. The
    launches are queued device by device with no wait in between.
    """
    from grab_tpu_torch.ops.corewords import CoreWordTests, core_word_flags

    tests = CoreWordTests(literals)
    devices = [torch.device(d) for d in devices]

    def fn(shards: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
        if len(shards) != len(devices) or any(
            s.device.type != d.type or (d.index is not None and s.device != d)
            for s, d in zip(shards, devices)
        ):
            raise ValueError("one shard per device, each on its device")
        totals, packed = [], []
        for s in shards:
            t, pk, _bm = core_word_flags(s, tests.tab, tests.k, tests.n_words, tests.masked)
            totals.append(t)
            packed.append(pk)
        first = shards[0].device
        total = totals[0].clone()
        for t in totals[1:]:
            total += t.to(first, non_blocking=True)
        return packed, total

    fn.tests = tests
    return fn


def make_sharded_scan(compiled, devices: Sequence[torch.device], shard_bytes: int):
    """The byte-granular sharded scan step.

    Returns ``fn(data) -> (counts, total)``: ``data`` is uint8
    [n_shards * shard_bytes] on any device; shard i is scanned on
    ``devices[i]`` by the byte-level literal scan (on a card: one launch
    of the literal kernel) or, for a pattern with no literal factor, the
    multi-stream DFA walk with the HALO overlap (on a card: the walk
    kernel and its count kernel, two launches).
    ``counts`` holds each shard's int32 [shard_bytes / CANDIDATE_BLOCK]
    per-block candidate counts, on its device, and ``total`` their sum,
    int32 [1] on the first device (the reference's psum).
    """
    from grab_tpu_torch.ops.dfa_scan import WalkTables, dfa_walk_counts
    from grab_tpu_torch.ops.literal_scan import LiteralKeys, literal_block_counts
    from grab_tpu_torch.scan_pipeline import CANDIDATE_BLOCK, HALO

    devices = [torch.device(d) for d in devices]
    use_dfa = not compiled.literals and compiled.dfa is not None
    n_streams = max(1, shard_bytes // 32768)
    if use_dfa:
        tables = WalkTables(compiled.dfa)  # uploaded once per device at first use

        def block_counts(shard):
            return dfa_walk_counts(shard, tables, n_streams, HALO, CANDIDATE_BLOCK)
    else:
        keys = LiteralKeys(compiled.literals)  # uploaded once per device at first use

        def block_counts(shard):
            return literal_block_counts(shard, keys, CANDIDATE_BLOCK)

    def fn(data: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
        if data.shape != (len(devices) * shard_bytes,) or data.dtype != torch.uint8:
            raise ValueError(
                f"want uint8 [{len(devices)} * {shard_bytes}], got {data.dtype} {tuple(data.shape)}"
            )
        counts = []
        for i, d in enumerate(devices):
            shard = data[i * shard_bytes : (i + 1) * shard_bytes].to(d, non_blocking=True)
            counts.append(block_counts(shard))
        first = devices[0]
        total = torch.zeros(1, dtype=torch.int32, device=first)
        for c in counts:
            total += c.sum(dtype=torch.int32).to(first, non_blocking=True)
        return counts, total

    return fn
