"""Parallel recursive scan runner: the -n N entry of the CLI.

The tree is walked once and its files go, in walk order, through the
engine's CorpusPipeline, which submits N packer buffers per group to the
scanner's N lanes (one per shard device, scan_pipeline.DeviceScanner).
The packer layout is the single-device one, so per-file output is emitted in
walk order and is byte-identical to -n 1. The function returns the bytes
the walk handed to the scan, for the --stats rate.
"""

from __future__ import annotations

from typing import Callable


def run_parallel(
    engine,
    root: str,
    emit: Callable[[bytes], None],
    n_shards: int,
) -> int:
    """Scan ``root`` recursively over ``n_shards`` shard devices (capped
    at the devices the engine's device setting names).

    Returns total bytes scanned (for --stats)."""
    want = max(1, n_shards)
    if engine.cfg.n_shards != want:
        engine.cfg.n_shards = want
        built = len(engine._scanner.lanes) if engine._scanner else None
        if built is not None and built != engine._effective_shards():
            # a cached scanner built for another shard count must not
            # serve this scan
            engine._scanner = None
    engine.cfg.output.recursive = True
    total = 0

    def entries():
        nonlocal total
        for path, size in engine._walk_entries(root):
            total += size
            yield path, size

    engine.scan_corpus_paths(entries(), emit)
    return total
