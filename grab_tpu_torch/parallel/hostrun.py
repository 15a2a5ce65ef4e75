"""Multi-host scan entry: BASELINE config 5 as ONE command per host.

The reference's multicore mode is one command (`grab -n N -r pat dir`,
greppin src/main.cc:163-230); greppin's conformance recipe compares
sorted output (README.md:209-216). The multi-host equivalent, runnable
as::

    tpugrep --hosts N --pid P --coordinator HOST:PORT -r <pat> <dir>

on each of N hosts (or with JAX_NUM_PROCESSES / JAX_PROCESS_ID /
JAX_COORDINATOR_ADDRESS set by the launcher), does:

  1. multihost.init_distributed — host 0's TCPStore and the gloo
     process group;
  2. ONE deterministic phase-1 walk (sorted, physical, main.cc:74-83):
     host 0 walks and broadcasts the name list through the store —
     metadata only, no file bytes move;
  3. round-robin host striping of the file list (main.cc:94 parity:
     ``i += nthreads``) — each host stats and scans only files it can
     read locally; bytes never cross hosts;
  4. per-host scan through the standard Engine pipeline (optionally
     over the host's shard devices with -n);
  5. global match count by an all-reduce over gloo — replacing the
     reference's stdout mutex;
  6. output collection WITHOUT a shared filesystem: each host's
     per-file output pieces flow point-to-root through the store
     (multihost.gather_blobs_to_root — non-root hosts receive no
     payload), and host 0 emits the globally ordered merge keyed by
     file index — the deterministic order the reference only achieves
     modulo `sort`.

For output volumes too large for the gather (> ``GATHER_CAP`` bytes per
host), hosts fall back to writing ``{host}.{file_index}.out`` pieces
into --outdir (a shared directory, merged by host 0 via
merge_host_outputs).
"""

from __future__ import annotations

import os
import sys
from typing import Callable, List, Optional, Tuple

from grab_tpu_torch.ingest.walker import walk_names
from grab_tpu_torch.parallel.multihost import (
    broadcast_blob,
    gather_blobs_to_root,
    init_distributed,
    kv_get_blob,
    kv_put_blob,
    merge_host_outputs,
    next_run_tag,
    psum_total,
)

GATHER_CAP = 2 << 30  # total per-host output bytes before outdir fallback


def _gather_pieces(
    pieces: List[Tuple[int, bytes]], host: int, n_hosts: int
) -> Optional[List[Tuple[int, bytes]]]:
    """Gather (file_index, output_bytes) pieces TO HOST 0 ONLY through
    the store (multihost.gather_blobs_to_root): each host's payload
    crosses the network once, and non-root hosts receive no bytes.
    Returns the merged, file-index-ordered list on host 0; [] on other
    hosts; None on every host when any payload exceeds GATHER_CAP
    (callers fall back to the shared-dir scheme)."""
    # run-unique tag prefix (multihost.next_run_tag; every host calls
    # this in the same sequence, so the prefixes agree cluster-wide)
    tag = next_run_tag()
    # serialize: [ (idx, len, bytes) ... ] with fixed headers
    blob = bytearray()
    for idx, buf in sorted(pieces):
        blob += int(idx).to_bytes(8, "little")
        blob += len(buf).to_bytes(8, "little")
        blob += buf
    # cap check: tiny length exchange first, decision broadcast by root
    kv_put_blob(f"{tag}.len.h{host}", str(len(blob)).encode())
    if host == 0:
        lens = [int(kv_get_blob(f"{tag}.len.h{h}")) for h in range(n_hosts)]
        ok = max(lens) <= GATHER_CAP
        kv_put_blob(f"{tag}.ok", b"1" if ok else b"0")
    else:
        ok = kv_get_blob(f"{tag}.ok") == b"1"
    if not ok:
        return None
    raws = gather_blobs_to_root(bytes(blob), f"{tag}.out", n_hosts)
    if raws is None:  # non-root: nothing received, nothing to emit
        return []
    merged: List[Tuple[int, bytes]] = []
    for raw in raws:
        pos = 0
        while pos < len(raw):
            idx = int.from_bytes(raw[pos : pos + 8], "little")
            n = int.from_bytes(raw[pos + 8 : pos + 16], "little")
            merged.append((idx, raw[pos + 16 : pos + 16 + n]))
            pos += 16 + n
    merged.sort(key=lambda t: t[0])
    return merged


def host_entries(
    root: str, host: int, n_hosts: int, names: Optional[List[str]] = None
) -> Tuple[List[Tuple[int, str, int]], int]:
    """Phase-1 walk ONCE per cluster: host 0 runs the structure-only
    walk (readdir d_type, no per-file lstat) and broadcasts the
    NUL-joined name list through the store — matching the reference's
    single phase-1 walk (main.cc:175-178). Each host then lstat's only
    indices ≡ host (mod n_hosts) — the reference's round-robin stripe
    (main.cc:94) applied to the stat phase, so H hosts do O(total/H)
    stats each. → ([(global_idx, path, size)], n_stats).

    ``names`` injects a prebuilt global list (tests / callers that
    already walked); the walk and broadcast are skipped entirely."""
    # a unique tag per walk broadcast; every host takes the same branch
    # here, so the sequence counters stay in lockstep
    walk_tag = next_run_tag() if names is None and n_hosts > 1 else None
    if names is not None:
        pass
    elif host == 0:
        from grab_tpu_torch.ingest.native import walk_names_native

        names = walk_names_native(root, workers=8)
        if names is None:
            names = list(walk_names(root))
        if n_hosts > 1:
            blob = b"\x00".join(
                p.encode("utf-8", "surrogateescape") for p in names
            )
            broadcast_blob(blob, f"{walk_tag}.walk")
    else:
        blob = broadcast_blob(None, f"{walk_tag}.walk")
        names = [
            p.decode("utf-8", "surrogateescape")
            for p in (blob.split(b"\x00") if blob else [])
        ]
    mine: List[Tuple[int, str, int]] = []
    n_stats = 0
    for gidx, path in enumerate(names):
        if gidx % n_hosts != host:
            continue
        try:
            st = os.lstat(path)
        except OSError as e:
            print(f"{path}: {e.strerror or e}", file=sys.stderr)
            continue
        n_stats += 1
        mine.append((gidx, path, int(st.st_size)))
    return mine, n_stats


def run_multihost(
    engine,
    root: str,
    emit: Callable[[bytes], None],
    err=None,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    outdir: Optional[str] = None,
    stats: bool = False,
) -> int:
    """Distributed-init → host-striped walk → scan → sum → ordered
    merge. Returns the process exit code; only host 0 emits output.

    Collective transports chatter on fd 1, so fd 1 is pointed at stderr
    for the whole distributed phase to keep the parity stream
    byte-clean; results are emitted only after the merge. Every host
    ends with a barrier: host 0 serves the store, and must not leave
    before each peer's last store operation has been answered."""
    err = err or sys.stderr
    saved_fd1 = os.dup(1)
    sys.stdout.flush()
    os.dup2(2, 1)
    try:
        rc = _run_multihost(
            engine, root, emit, err, coordinator, num_processes,
            process_id, outdir, stats, saved_fd1,
        )
        _barrier()
        return rc
    finally:
        sys.stdout.flush()
        os.dup2(saved_fd1, 1)
        os.close(saved_fd1)


def _run_multihost(
    engine, root, emit, err, coordinator, num_processes, process_id,
    outdir, stats, saved_fd1,
) -> int:
    def emit_clean(buf: bytes):
        # restore the real stdout for result emission
        sys.stdout.flush()
        os.dup2(saved_fd1, 1)
        emit(buf)

    host, n_hosts = init_distributed(coordinator, num_processes, process_id)

    engine.cfg.output.recursive = True
    # phase 1 (main.cc:178): host 0 walks once and broadcasts the
    # index list; each host lstat's only its own stripe
    # (host_entries), O(total/n_hosts) stats per host
    mine, _n_stats = host_entries(root, host, n_hosts)

    pieces: List[Tuple[int, bytes]] = []
    match_lines = 0

    gidx_of = {}

    def my_entries():
        for gidx, path, size in mine:
            engine.stats.files_seen += 1
            if engine.compiled.min_len > size:
                engine.stats.files_pruned += 1
                continue
            gidx_of[path] = gidx
            yield path, size

    # scan local files through the standard pipelined path-based scan
    # (native pread-pool fill, double-buffered device batches); capture
    # each file's output as one piece keyed by the GLOBAL file index.
    # scan_corpus_paths emits strictly per file in order and calls
    # on_done(path) as each file's replay completes, so slicing the
    # stream at on_done boundaries is exact.
    cur = bytearray()

    def on_done(path: str):
        nonlocal match_lines
        if cur:
            pieces.append((gidx_of[path], bytes(cur)))
            match_lines += cur.count(b"\n")
            cur.clear()

    engine.scan_corpus_paths(my_entries(), cur.extend, on_done=on_done)

    # global match-line count over the whole cluster
    total = psum_total(match_lines)

    merged = _gather_pieces(pieces, host, n_hosts)
    if merged is None:
        # payload too large for the gather: shared-dir fallback
        if not outdir:
            print(
                "tpugrep: output exceeds the gather cap and no --outdir "
                "given for the shared-directory fallback",
                file=err,
            )
            return 255
        os.makedirs(outdir, exist_ok=True)
        for gidx, buf in pieces:
            with open(os.path.join(outdir, f"{host}.{gidx}.out"), "wb") as f:
                f.write(buf)
        _barrier()
        if host == 0:
            merge_host_outputs(outdir, emit_clean)
    elif host == 0:
        for _, buf in merged:
            emit_clean(buf)
    if stats and host == 0:
        # off the parity path (SURVEY §5): the summed global count
        print(f"tpugrep: {total} match lines across {n_hosts} hosts", file=err)
    return 0


def _barrier():
    import torch.distributed as dist

    dist.barrier()
