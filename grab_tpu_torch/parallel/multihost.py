"""Multi-host scan orchestration over torch.distributed.

Scales BASELINE config 5 (100 GB corpus over N ≥ 2 hosts): each host
walks and ingests ONLY its own corpus shard (no cross-host data
movement — the bytes stay where the disks are), scans it through the
same fixed-shape device pipeline, and the cluster agrees on:

  * global match counts — host scalars summed with an all-reduce over
    the gloo process group,
  * globally ordered output — per-host pieces keyed by (file_index,
    offset); the merge step concatenates in global file order. The
    reference leaves multicore output order unspecified and compares
    modulo sort (README.md:209-216); we define the order.

The control plane is a ``torch.distributed.TCPStore`` that host 0 serves
on the coordinator's HOST:PORT (as jax.distributed's process 0 hosts the
coordinator service) and every other host connects to; the process group
runs on gloo, never NCCL, so that several hosts may share one card.

Host sharding follows the reference's round-robin file striding
(main.cc:94: ``i += nthreads``): host h scans files h, h+H, h+2H, …
of the (deterministic, sorted) global walk.
"""

from __future__ import annotations

import atexit
import os
from datetime import timedelta
from typing import Callable, List, Optional, Tuple

# the process's one distributed session: (args, rank, world, store)
_SESSION = None


def _loopback(host: str) -> bool:
    return host == "localhost" or host.startswith("127.") or host == "::1"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Bring up the store and the gloo process group from args or the
    launcher's env vars (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID, part of the CLI surface). → (rank, world_size).

    Once per process: a second call with the same arguments returns the
    same pair; other arguments raise, as a second
    jax.distributed.initialize does."""
    global _SESSION
    import torch.distributed as dist

    coordinator = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes or os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(num_processes or os.environ["JAX_NUM_PROCESSES"])
    if process_id is not None or os.environ.get("JAX_PROCESS_ID") is not None:
        process_id = int(
            process_id if process_id is not None else os.environ["JAX_PROCESS_ID"]
        )
    args = (coordinator, num_processes, process_id)
    if _SESSION is not None:
        if _SESSION[0] != args:
            raise RuntimeError(
                f"distributed session already initialised as {_SESSION[0]}, not {args}"
            )
        return _SESSION[1], _SESSION[2]
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError(
            "multi-host needs a coordinator address, the number of processes and "
            "this process's id (--coordinator/--hosts/--pid or JAX_COORDINATOR_ADDRESS/"
            "JAX_NUM_PROCESSES/JAX_PROCESS_ID)"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0..{num_processes - 1}")
    host, _, port = coordinator.rpartition(":")
    host = host.strip("[]")
    if _loopback(host) and os.path.isdir("/sys/class/net/lo"):
        # every host on this machine: gloo's pairs on the loopback too,
        # whatever the machine's hostname resolves to
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    timeout = timedelta(milliseconds=_kv_timeout_ms(None))
    store = dist.TCPStore(
        host, int(port), num_processes, process_id == 0, timeout,
        wait_for_workers=False,
    )
    dist.init_process_group(
        "gloo", store=dist.PrefixStore("pg", store), rank=process_id,
        world_size=num_processes, timeout=timeout,
    )
    _SESSION = (args, process_id, num_processes, store)
    atexit.register(_shutdown)
    return process_id, num_processes


def _shutdown() -> None:
    """Destroy the process group and drop the store (at exit; callers
    end their last multi-host operation with a barrier first, so host
    0's store outlives every peer's use of it)."""
    global _SESSION
    import torch.distributed as dist

    if _SESSION is None:
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    _SESSION = None


def _store():
    if _SESSION is None:
        raise RuntimeError("the distributed session is not initialised")
    return _SESSION[3]


def process_index() -> int:
    """This host's rank in the initialised session."""
    _store()
    return _SESSION[1]


def host_shard(entries: List, host: int, n_hosts: int) -> List[Tuple[int, object]]:
    """Round-robin striding over the globally ordered walk
    (main.cc:94 parity). Returns (global_index, entry) pairs."""
    return [(i, entries[i]) for i in range(host, len(entries), n_hosts)]


def psum_total(local_count: int) -> int:
    """All-reduce a host-local scalar over every host (a CPU int64 sum
    over gloo, replacing the reference's stdout mutex aggregation,
    grab.cc:56)."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(local_count)], dtype=torch.int64)
    dist.all_reduce(t)
    return int(t[0])


# ── point-to-root blob transport ──────────────────────────────────────
#
# An all-gather would hand every host every other host's payload — H×
# the traffic the merge needs, since only host 0 emits. The store gives
# point-to-point semantics: host h publishes its blob under a run-unique
# tag, host 0 fetches them — each byte crosses the network once to the
# coordinator and once out at most, and non-root hosts receive NOTHING.
# Payloads are chunked to keep each message bounded.

_KV_CHUNK = 2 << 20

# The store lets a key be overwritten, so a reused tag would not fail:
# it would hand a reader the previous run's value, or a value a slower
# host has not replaced yet. Every multihost operation therefore salts
# its tags with a per-process sequence number; all hosts execute the
# same sequence of tagged operations, so the counters advance in
# lockstep and tags agree cluster-wide.
_run_seq = 0


def next_run_tag(prefix: str = "tg") -> str:
    """→ a run-unique KV tag prefix (see the note above)."""
    global _run_seq
    _run_seq += 1
    return f"{prefix}{_run_seq}"


def _kv_timeout_ms(timeout_ms: Optional[int]) -> int:
    """Blocking-get timeout: explicit arg, else GRAB_TPU_KV_TIMEOUT_MS,
    else 10 min. A very large corpus whose phase-1 walk outlasts the
    default should raise the env var rather than crash non-root hosts."""
    if timeout_ms is not None:
        return timeout_ms
    return int(os.environ.get("GRAB_TPU_KV_TIMEOUT_MS", 600_000))


def _kv_set(key: str, data: bytes) -> None:
    _store().set(key, data)


def _kv_get(key: str, timeout_ms: Optional[int] = None) -> bytes:
    s = _store()
    s.wait([key], timedelta(milliseconds=_kv_timeout_ms(timeout_ms)))
    return s.get(key)


def kv_put_blob(tag: str, data: bytes) -> None:
    """Publish ``data`` under ``tag`` in bounded chunks."""
    n = -(-len(data) // _KV_CHUNK) if data else 0
    _kv_set(f"{tag}.n", str(n).encode())
    for i in range(n):
        _kv_set(f"{tag}.{i}", data[i * _KV_CHUNK : (i + 1) * _KV_CHUNK])


def kv_get_blob(tag: str, timeout_ms: Optional[int] = None) -> bytes:
    n = int(_kv_get(f"{tag}.n", timeout_ms))
    return b"".join(_kv_get(f"{tag}.{i}", timeout_ms) for i in range(n))


def broadcast_blob(data: Optional[bytes], tag: str, root: int = 0) -> bytes:
    """Root publishes once; every other host fetches. (The walk list:
    ONE phase-1 walk total, main.cc:175-178 parity.)"""
    if process_index() == root:
        if data is None:
            raise ValueError("the root must publish a blob")
        kv_put_blob(tag, data)
        return data
    return kv_get_blob(tag)


def gather_blobs_to_root(
    data: bytes, tag: str, n_hosts: int, root: int = 0
) -> Optional[List[bytes]]:
    """Each host publishes its blob; ONLY the root fetches and returns
    the per-host list — non-root hosts return None and receive no
    payload bytes."""
    host = process_index()
    kv_put_blob(f"{tag}.h{host}", data)
    if host != root:
        return None
    return [kv_get_blob(f"{tag}.h{h}") for h in range(n_hosts)]


def merge_host_outputs(output_dir: str, emit: Callable[[bytes], None]) -> int:
    """Merge per-host emit files (written as {host}.{file_index}.out)
    into globally ordered output. Returns number of merged pieces."""
    pieces = []
    for name in os.listdir(output_dir):
        if not name.endswith(".out"):
            continue
        stem = name[: -len(".out")]
        try:
            _host, file_index = stem.split(".", 1)
            pieces.append((int(file_index), name))
        except ValueError:
            continue
    pieces.sort()
    for _, name in pieces:
        with open(os.path.join(output_dir, name), "rb") as f:
            emit(f.read())
    return len(pieces)
