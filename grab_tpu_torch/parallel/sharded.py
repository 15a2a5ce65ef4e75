"""ShardedScanner: the multi-device data-parallel scan step.

This is the -n N path, the GPU equivalent of the reference's multicore
orchestrator (greppin src/main.cc:86-100, 163-230: round-robin file
striding across N pinned threads, one compiled pattern per thread).
The JAX package runs one shard_map program over a device mesh with a
psum for the group's count and zero-padded shards for short groups;
none of that is carried over. Here:

  * one lane per shard device: a ``DeviceScanner`` replica with its own
    pinned upload ring and its own CUDA stream; a device may carry
    several lanes ('cuda:0,cuda:0'); the pipeline fills each lane's
    batch straight into that lane's slot (``claim``);
  * the compiled plan is built once and shared: the members' host
    tables are common, their device tables are uploaded once per device;
  * ``submit_group`` takes up to N packer buffers and queues each
    buffer's uploads and kernels on its lane without waiting; a short
    group (the stream's tail) simply uses fewer lanes;
  * the per-shard counts land in pinned host memory, each behind its
    lane's event, so a clean group (the dominant case on miss-heavy
    scans) is resolved from N counts and pulls no payload; a lane's
    packed flags leave its device only when its own count is nonzero;
  * output order is restored by the pipeline's deterministic per-file
    merge: -n N output is byte-identical to -n 1 because the packer
    layout is untouched; only submission is grouped.

Every mode of DeviceScanner (literal, fused or split, with a stride
member's second upload; class_seq; alpha; gdfa; dfa) shards the same
way, since a lane is a DeviceScanner.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from grab_tpu_torch.parallel.scan_step import shard_devices
from grab_tpu_torch.scan_pipeline import DeviceScanner


class ShardedScanner:
    """DeviceScanner over N shard devices: ``submit_group`` takes up to
    N packer buffers (one per lane), ``resolve_group`` returns their
    flags in submit order."""

    def __init__(self, compiled, n_shards: int, buf_size: Optional[int] = None,
                 devices: str = "cuda", **kw):
        devs = shard_devices(n_shards, devices)
        first = DeviceScanner(compiled, buf_size=buf_size, device=devs[0], **kw)
        self.lanes: List[DeviceScanner] = [first] + [first.replica(d) for d in devs[1:]]
        self.n_shards = self.group_size = len(self.lanes)
        self.buf_size, self.block = first.buf_size, first.block
        self.mode, self.members, self.device = first.mode, first.members, first.device
        self._streams = [
            torch.cuda.Stream(l.device) if l.device.type == "cuda" else None
            for l in self.lanes
        ]
        self._tables_on = set()  # devices whose tables are known uploaded

    @property
    def span(self):
        """The span recorder of the scan in progress, the lanes' own."""
        return self.lanes[0].span

    @span.setter
    def span(self, span) -> None:
        for lane in self.lanes:
            lane.span = span

    @property
    def payload_pulls(self) -> int:
        """Resolves, over all lanes, that pulled the members' payloads."""
        return sum(l.payload_pulls for l in self.lanes)

    def claim(self, lane: int):
        """The slot lane ``lane``'s next batch is filled into, from that
        lane's own ring (``DeviceScanner.claim``)."""
        return self.lanes[lane].claim()

    def submit_group(self, bufs: Sequence[np.ndarray]):
        """Queue up to n_shards packer buffers, one per lane, without
        waiting for any of them; → handles for ``resolve_group``."""
        if not 0 < len(bufs) <= self.n_shards:
            raise ValueError(f"a group holds 1..{self.n_shards} buffers, got {len(bufs)}")
        handles = []
        for lane, stream, buf in zip(self.lanes, self._streams, bufs):
            if stream is None:
                handles.append(lane.submit(buf))
                continue
            with torch.cuda.stream(stream):
                handles.append(lane.submit(buf))
            if lane.device not in self._tables_on:
                # the members upload their tables at first use, on this
                # lane's stream: the device's other lanes must not read
                # them before they have arrived
                with self.span("wait"):
                    stream.synchronize()
                self._tables_on.add(lane.device)
        return handles

    def resolve_group(self, handles) -> List[np.ndarray]:
        """→ per-batch int32 [buf_size/block] candidate flags, in submit
        order. Every lane's count is awaited first (the waits overlap);
        a clean group then costs its counts and no payload pull."""
        with self.span("wait"):
            for _total, _payloads, ready in handles:
                if ready is not None:
                    ready.synchronize()
        return [lane.resolve(h) for lane, h in zip(self.lanes, handles)]
