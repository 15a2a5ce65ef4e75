"""Device scan pipeline on the GPU: fixed-shape batched candidate
generation.

Files are packed into fixed-size scan buffers (ingest/packer.py) and
each buffer is uploaded and scanned by device kernels; only a count and
the candidate flags' compact form come back to the host. This is the
port of the JAX package's scan_pipeline.py. ``DeviceScanner`` routes a
compiled pattern set the way the reference does; ``members`` lists the
scanners that share one uploaded buffer, their totals are summed on the
device and their decoded flags unioned on the host:

  * literal: a covered literal set. The fused ensemble (ops/fused.py,
    csrc/fused.cu: compare buckets, the XOR filter over 7+-byte
    literals, class sequences, in one pass) beside the union strided-DFA
    member for two or more class sequences; or, for a single member and
    with GRAB_TPU_NO_FUSED=1, the split path: XOR filter
    (ops/xorfilter.py), core-word buckets (ops/corewords.py), the
    sequence member last;
  * class_seq: covered class sequences and no literals, served by the
    union strided-DFA member when the sequences' automaton is bounded
    and has a stride plan (``_StrideSeqMember``, csrc/stridedfa.cu),
    else by the class-sequence kernel (ops/classseq.py);
  * alpha: an uncovered pattern with an eligible mandatory class run
    (ops/alpharun.py, csrc/alpharun.cu), taken before any automaton
    walk and also when there is no device-sized automaton;
  * gdfa: an uncovered automaton of at most 2048 states with a stride
    plan, in a buffer of at least 1 MiB (the strided-DFA walk with its
    window pass or threading fixpoint, ops/stridedfa.py);
  * dfa: any other automaton of at most 2048 states, by the last-resort
    multi-stream walk (ops/dfa_scan.py, csrc/dfa_walk.cu).

``resolve_devices`` reads the device setting (one device, every
visible card, or a list of shard devices); a ``DeviceScanner`` runs
its plan over one lane per device it is given (``-n N``). A ``Lane``
carries batches to its device: fill slots, pinned upload slots,
streams. Lanes belong to the process, keyed by (device, lane index),
and every cached plan shares them (``take_lanes``); a stream holds its
lanes until it ends.

``CorpusPipeline`` is the reference's: its one-deep double buffering
overlaps host packing of the next batch with the device's upload and
scan of this one. It pulls the walk a buffer's worth of files at a
time, so that the request's spans (``engine.ScanStats.span``: walk,
pack, fill, stage, launch, wait, pull) open per batch, never per file.
"""

from __future__ import annotations

import os
from collections import deque
from contextlib import nullcontext
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from grab_tpu_torch.ingest.native import fill_segments
from grab_tpu_torch.ingest.packer import BatchPacker, copy_segments
from grab_tpu_torch.ops.alpharun import AlphaRunScanner, alpharun_eligible
from grab_tpu_torch.ops.classseq import ClassSeqScanner, compile_sequences
from grab_tpu_torch.ops.corewords import LANES, PAD_ROWS, CoreWordScanner
from grab_tpu_torch.ops.dfa_scan import DfaWalkMember
from grab_tpu_torch.ops.fused import FusedEnsembleScanner
from grab_tpu_torch.ops.stridedfa import (
    HALO as STRIDE_HALO,
    N_STREAMS,
    STREAM_ROWS,
    StrideDfaScanner,
    stride_plan,
)
from grab_tpu_torch.ops.xorfilter import XorWordScanner
from grab_tpu_torch.regex.compiler import device_class_seqs

CANDIDATE_BLOCK = 512
HALO = 0x1000  # reference overlap (grab.cc:151)
MAX_KERNEL_LITERALS = 16  # one compare bucket of the core-word kernel
MAX_LONG_LITERALS = 4  # more 7+-byte literals go to the XOR filter
MIN_STRIDE_BUF = 1 << 20  # smaller buffers take the last-resort walk
MAX_DEVICE_STATES = 2048  # larger automata have no device form
PULL_MAX = 1 << 14  # files the pipeline takes from the walk at a time, at most

_NO_SPAN = nullcontext()


def no_span(_name: str):
    """The span recorder of a scan that records none: one shared no-op
    context, no clock read, no allocation."""
    return _NO_SPAN


class DeviceUnavailable(RuntimeError):
    """The CUDA device was asked for and torch cannot see one."""


def resolve_device(device) -> torch.device:
    """'cuda', 'cpu' or one indexed device ('cuda:0') → torch.device; a
    CUDA device without a visible card raises instead of running on the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                f"device {str(device)!r} requested but torch.cuda.is_available() is "
                "false (use GRAB_TPU_TORCH_DEVICE=cpu to scan on the CPU)"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise DeviceUnavailable(
                f"device {str(device)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported scan device {device!r}")
    return dev


def resolve_devices(spec: str) -> List[torch.device]:
    """The shard devices a device setting names, in order: 'cuda' is
    every visible CUDA device, 'cpu' is one CPU device, and a
    comma-separated list ('cuda:0,cuda:1', 'cpu,cpu,cpu') names them one
    by one and may repeat a device (several lanes on it). A CUDA entry
    without a visible card raises DeviceUnavailable."""
    parts = [p.strip() for p in str(spec).split(",")]
    if len(parts) == 1:
        dev = resolve_device(parts[0])
        if dev.type == "cuda" and dev.index is None:
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [dev]
    if not all(parts):
        raise ValueError(f"empty entry in the scan device list {spec!r}")
    return [resolve_device(p) for p in parts]


def plan_refusal(cp) -> Optional[str]:
    """Why compiled pattern ``cp`` has no device scan, or None when a
    mode serves it (the reference's DeviceScanner.__init__ chain)."""
    if cp.covered and (cp.literals or cp.class_seqs):
        return None
    if cp.dfa is not None and cp.dfa.n_states <= MAX_DEVICE_STATES:
        return None
    if DeviceScanner._alpha_eligible(cp.alpha_plan):
        return None
    return "pattern has no device-scannable form"


class FillSlot:
    """A host buffer that batch after batch is filled into, and how far
    earlier batches wrote: every byte at and past ``dirty`` is zero. A
    new slot's memory is not zeroed, so it starts dirty to its end."""

    __slots__ = ("buf", "dirty")

    def __init__(self, buf: np.ndarray):
        self.buf = buf
        self.dirty = buf.shape[0]


class Lane:
    """One lane of the scan, on one device: what carries a batch there.
    Lanes belong to the process, not to a plan (``take_lanes``): every
    plan on a device fills and uploads through that device's lanes.

    Its slots are kept by size, two deep; a size is allocated at its first use and
    kept, so memory is bounded by the distinct sizes, not by the plans.
    On the card a slot holds pinned staging buffers beside device
    buffers; on the CPU, and for the linear buffer beside a stride
    member alone, the lane keeps reused host buffers. A slot's
    ``FillSlot.dirty`` mark outlives the plan that wrote it, so the
    next plan on the slot zeroes exactly what that one left.

    Slot i's staging buffers are rewritten only after their previous
    upload has completed (``free``), and its device buffers only after
    the kernels that read them have run (``_consumed``), so a batch in
    flight is never overwritten while the next one is filled. The
    uploads go on a side stream, asynchronous to the host; lane 0 runs
    its kernels on the caller's current stream, lane i > 0 on a stream
    of its own."""

    DEPTH = 2  # CorpusPipeline keeps at most two batches in flight

    def __init__(self, device: torch.device, index: int):
        self.device = device
        self.busy = False  # held by an unfinished stream
        cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if cuda and index else None
        self._copy = torch.cuda.Stream(device) if cuda else None
        # size -> (FillSlot over the pinned buffer, device buffer, pinned tensor)
        self._pinned: List[Dict[int, tuple]] = [{} for _ in range(self.DEPTH)]
        self._host: List[Dict[int, FillSlot]] = [{} for _ in range(self.DEPTH)]
        self._copied: List[Optional[torch.cuda.Event]] = [None] * self.DEPTH
        self._consumed: List[Optional[torch.cuda.Event]] = [None] * self.DEPTH
        self._next = 0  # the pinned slot ``upload`` takes next
        self._host_next = 0  # the host slot ``host`` hands out next

    def free(self, span) -> int:
        """The index of the pinned slot that ``upload`` takes next, once
        its previous upload has completed (waited for under ``wait``):
        its staging buffers may be written from then on."""
        i = self._next
        if self._copied[i] is not None:
            with span("wait"):
                self._copied[i].synchronize()
            self._copied[i] = None
        return i

    def pinned(self, i: int, size: int) -> FillSlot:
        """Pinned slot i's staging buffer of ``size`` bytes."""
        got = self._pinned[i].get(size)
        if got is None:
            host = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            dev = torch.empty(size, dtype=torch.uint8, device=self.device)
            got = self._pinned[i][size] = (FillSlot(host.numpy()), dev, host)
        return got[0]

    def host(self, size: int) -> FillSlot:
        """The next of the two reused host buffers of ``size`` bytes."""
        slots = self._host[self._host_next]
        self._host_next = (self._host_next + 1) % self.DEPTH
        if size not in slots:
            slots[size] = FillSlot(np.empty(size, dtype=np.uint8))
        return slots[size]

    def upload(self, sizes: Sequence[int], fn, span):
        """Upload the pinned slot that ``free`` handed out (its buffers
        of ``sizes``, as the caller wrote them) and launch ``fn(devs)``
        on the current stream after the copies. ``span``: the request's
        recorder."""
        i = self.free(span)
        self._next = (i + 1) % self.DEPTH
        with span("launch"):
            compute = torch.cuda.current_stream(self.device)
            devs = []
            with torch.cuda.stream(self._copy):
                if self._consumed[i] is not None:
                    self._copy.wait_event(self._consumed[i])
                for n in sizes:
                    _slot, dev, host = self._pinned[i][n]
                    dev.copy_(host, non_blocking=True)
                    devs.append(dev)
                copied = torch.cuda.Event()
                copied.record(self._copy)
            self._copied[i] = copied
            compute.wait_event(copied)
            out = fn(devs)
            consumed = torch.cuda.Event()
            consumed.record(compute)
            self._consumed[i] = consumed
        return out


_LANES: Dict[Tuple[torch.device, int], List[Lane]] = {}


def take_lanes(devices: Sequence[torch.device]) -> List[Lane]:
    """A lane for each of ``devices``, lane i from the process's pool
    under (device, i): the first lane there that no unfinished stream
    holds, else a new one, kept from then on. Hand them back with
    ``release_lanes``."""
    lanes = []
    for i, dev in enumerate(devices):
        pool = _LANES.setdefault((dev, i), [])
        lane = next((l for l in pool if not l.busy), None)
        if lane is None:
            lane = Lane(dev, i)
            pool.append(lane)
        lane.busy = True
        lanes.append(lane)
    return lanes


def release_lanes(lanes: Sequence[Lane]) -> None:
    for lane in lanes:
        lane.busy = False


class _StrideSeqMember:
    """The class_seq mode's union strided-DFA member: every sequence
    routed pattern in ONE bounded automaton walk (the compiler's
    seq_dfa), window mode only. Its hits are exact union match ends, a
    tighter candidate set than prefix-sequence starts; the host replay
    is the same. It consumes the buffer born in the walk's stream-major
    layout (``prep_t``): a second upload beside the linear words when
    word members share the batch, the only upload otherwise. A caller
    with the linear words alone uses ``packed``, which relayouts them on
    the device."""

    wants_transposed = True

    def __init__(self, dfa, max_len, buf_size: int):
        self.sc = StrideDfaScanner(dfa, max_len, buf_size)
        assert self.sc.window_mode  # bounded patterns only (single pass)
        self.rows = buf_size // (4 * LANES)
        self.need_w = N_STREAMS * self.sc.stride // 4

    @property
    def s_w(self) -> int:
        return self.sc.s_w

    def prep_t(self, buf: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
        return self.sc.prep_t(buf, out=out)

    def packed_t(self, w2d_t: torch.Tensor):
        return self.sc.packed_t(w2d_t)

    def packed(self, words2d: torch.Tensor):
        """The shared-upload contract, for a caller without a transposed
        buffer: the linear words int32 [rows + PAD_ROWS, 128] on their
        device, cut to the buffer and zero-padded to the walk's
        geometry, relayouted on the device (ops/stridedfa.py
        stride_transpose)."""
        words = words2d[: self.rows].reshape(-1)
        pad = self.need_w - words.shape[0]
        if pad > 0:
            words = torch.cat([words, words.new_zeros(pad)])
        return self.sc.packed(words)

    def flags_np(self, bm, n_blocks: int) -> np.ndarray:
        return self.sc.flags_np(np.asarray(bm).reshape(-1, LANES), n_blocks)


class DeviceScanner:
    """Fixed-shape candidate scan of packer buffers: a compiled plan
    (``mode``, ``members`` and their tables) over one lane per entry of
    ``devices`` (``lanes``: a lane's device; one may repeat).

    With N lanes (``-n N``, the GPU equivalent of the reference's
    multicore orchestrator, greppin src/main.cc:86-100, 163-230: round-
    robin file striding across N pinned threads, one compiled pattern
    per thread) the plan is built once: the members' host tables are
    common, their device tables are uploaded once per device. The JAX
    package runs one shard_map program over a device mesh with a psum
    for the group's count and zero-padded shards for short groups; none
    of that is carried over. Here ``submit`` takes up to N packer
    buffers and queues each buffer's uploads and kernels on its lane
    without waiting; a short group (the stream's tail) simply uses the
    first lanes. Each lane's count lands in pinned host memory behind
    its own event, so a clean group (the dominant case on miss-heavy
    scans) is resolved from N counts and pulls no payload; a lane's
    flags leave its device only when its own count is nonzero. The
    packer layout is untouched, only submission is grouped, so -n N
    output is byte-identical to -n 1; every mode shards the same way."""

    def __init__(
        self,
        compiled,
        buf_size: Optional[int] = None,
        block: int = CANDIDATE_BLOCK,
        stream_seg: int = 32768,
        devices: Sequence = ("cuda",),
    ):
        self.lanes = [resolve_device(d) for d in devices]
        if not self.lanes:
            raise ValueError("a scanner needs at least one device")
        on_gpu = self.lanes[0].type == "cuda"
        if buf_size is None:
            # the reference's sizes: 32 MiB on an accelerator, 2 MiB on
            # the CPU (not yet tuned for the H100)
            buf_size = (32 << 20) if on_gpu else (2 << 20)
        if buf_size % (32 * block) or block != LANES * 4:
            raise ValueError(
                f"buf_size must be a multiple of {32 * block} bytes and "
                f"block {LANES * 4}, got {buf_size}, {block}"
            )
        self.buf_size = buf_size
        self.block = block
        cp = compiled
        why = plan_refusal(cp)
        if why is not None:
            raise ValueError(why)
        self._shorts_absorbed = False
        if cp.covered and cp.literals:
            self.mode = "literal"
            self.members = self._literal_members(cp)
        elif cp.covered and cp.class_seqs:
            self.mode = "class_seq"
            self.members = [self._seq_scanner(cp, standalone=True)]
        elif self._alpha_eligible(cp.alpha_plan):
            # fastest sound tier for a factor-less pattern, and the only
            # device form without a device-sized automaton (backrefs,
            # state blowup): host matchers verify candidates exactly
            self.mode = "alpha"
            self.members = [AlphaRunScanner(*cp.alpha_plan)]
        elif stride_plan(cp.dfa) is not None and buf_size >= MIN_STRIDE_BUF:
            self.mode = "gdfa"
            self._gdfa = StrideDfaScanner(cp.dfa, cp.max_len, buf_size)
            self.members = [self._gdfa]
        else:
            self.mode = "dfa"
            self.members = [DfaWalkMember(cp.dfa, buf_size, block, stream_seg, HALO)]
        # word members read the linear words with their zero pad rows (the
        # last-resort walk their first buf_size bytes); a stride member
        # reads the buffer born transposed, a second upload beside them
        self._stride = next(
            (m for m in self.members if getattr(m, "wants_transposed", False)), None
        )
        # a member reads the linear words: the slot ``claim`` hands out
        # is the buffer the scan reads, filled in place
        self.linear = any(m is not self._stride for m in self.members)
        self._want = buf_size + PAD_ROWS * LANES * 4
        sizes = [self._want] if self.linear else []
        if self._stride is not None:
            sizes.append(self._stride.s_w * N_STREAMS * 4)
        self._sizes = sizes  # the pinned buffers a batch uploads
        self._tables_on = set()  # devices whose tables are known uploaded
        self.payload_pulls = 0  # resolves that pulled the members' payloads
        # the span recorder of the scan in progress (CorpusPipeline sets it)
        self.span = no_span

    @staticmethod
    def _alpha_eligible(plan) -> bool:
        return plan is not None and alpharun_eligible(plan[0], plan[1])

    def _seq_scanner(self, cp, standalone: bool = False, member_seqs=None):
        """The member serving the sequence-routed patterns (the
        reference's ``_seq_scanner``): the union strided-DFA member when
        the sequences' automaton is bounded within the window reach and
        has a stride plan, the buffer is at least 1 MiB and, inside the
        literal ensemble, there are at least two sequences (one AND
        chain rides the fused pass almost free) and GRAB_TPU_SEQDFA is
        not "0"; else the class-sequence word kernel, over
        ``member_seqs`` where given (the ensemble's device sequences),
        else the compiler's. Inside the ensemble the member absorbs the
        < 7-byte literals when their union automaton plans no worse
        (``_shorts_absorbed``)."""

        def eligible(d, ml):
            return (
                d is not None
                and ml is not None
                and ml <= STRIDE_HALO - 8
                and stride_plan(d) is not None
            )

        def score(d):
            # plan quality: k-stride depth dominates, run beats cls, 8-bit
            # beats 16-bit
            mode, k = stride_plan(d)
            return (
                2 * k
                + (2 if mode.startswith("run") else 1)
                - (1 if mode.endswith("16") else 0)
            )

        sd, sml = cp.seq_dfa, cp.seq_max_len
        seqs = compile_sequences(cp.class_seqs)
        self._shorts_absorbed = False
        if (
            eligible(sd, sml)
            and self.buf_size >= MIN_STRIDE_BUF
            and (standalone or len(seqs) >= 2)
            and os.environ.get("GRAB_TPU_SEQDFA") != "0"
        ):
            sds, smls = cp.seq_dfa_shorts, cp.seq_shorts_max_len
            if not standalone and eligible(sds, smls) and score(sds) >= score(sd):
                self._shorts_absorbed = True
                return _StrideSeqMember(sds, smls, self.buf_size)
            return _StrideSeqMember(sd, sml, self.buf_size)
        return ClassSeqScanner(member_seqs or seqs)

    def _literal_members(self, cp) -> list:
        """The literal ensemble (the reference's _build_pallas, literal
        mode): the fused single-pass scanner when it has two members or
        sits beside a stride member, else (and with GRAB_TPU_NO_FUSED=1)
        one scanner per member. Its class sequences are carried past
        each pattern's first repeat (``device_class_seqs``), so that they
        flag only where a longer stretch of a pattern can start; the
        member's kind is chosen from the compiler's, as the reference's."""
        literals = [bytes(l) for l in cp.literals]
        dev_seqs = device_class_seqs(cp)
        seqs = compile_sequences(dev_seqs) if dev_seqs else None
        seq_member = self._seq_scanner(cp, member_seqs=seqs) if seqs else None
        stride_seq = isinstance(seq_member, _StrideSeqMember)
        if os.environ.get("GRAB_TPU_NO_FUSED") != "1":
            fused_lits = (
                [l for l in literals if len(l) >= 7] if self._shorts_absorbed else literals
            )
            fsc = FusedEnsembleScanner(fused_lits, None if stride_seq else seqs)
            if fsc.n_members >= 2 or (fsc.n_members >= 1 and stride_seq):
                return [fsc] + ([seq_member] if stride_seq else [])
        longs = [l for l in literals if len(l) >= 7]
        # shorts absorbed into the stride member ride its union automaton
        shorts = [] if self._shorts_absorbed else [l for l in literals if len(l) < 7]
        members = []
        if len(longs) > MAX_LONG_LITERALS:
            members.append(XorWordScanner(longs))
        else:
            shorts += longs
        for i in range(0, len(shorts), MAX_KERNEL_LITERALS):
            members.append(CoreWordScanner(shorts[i : i + MAX_KERNEL_LITERALS]))
        if seq_member is not None:
            members.append(seq_member)
        return members

    def _scan(self, devs: List[torch.Tensor]):
        """(total int32 [1], payloads) of one batch's uploaded buffers
        (uint8: the linear words when a member reads them, then the
        transposed words beside a stride member)."""
        lin = devs[0] if self.linear else None
        words2d = lin.view(torch.int32).view(-1, LANES) if lin is not None else None
        total, payloads = None, []
        for m in self.members:
            if m is self._stride:
                w2d_t = devs[-1].view(torch.int32).view(m.s_w * STREAM_ROWS, LANES)
                t, pk = m.packed_t(w2d_t)
            elif getattr(m, "wants_bytes", False):
                t, pk = m.packed(lin[: self.buf_size])
            else:
                t, pk = m.packed(words2d)
            total = t if total is None else total + t
            payloads.append(pk)
        return total, payloads

    def claim(self, lane: Lane) -> FillSlot:
        """The slot ``lane``'s next batch is filled into: where a member
        reads the linear words on the card, the lane's free pinned upload
        slot (waited for under ``wait``), which ``submit`` then uploads
        with no host copy; else one of the lane's two reused host
        buffers, which the plain kernels read on the CPU, or which a
        stride member's host transpose reads into the pinned slot."""
        if self.linear and lane.device.type == "cuda":
            return lane.pinned(lane.free(self.span), self._want)
        return lane.host(self._want)

    def submit(self, lanes: Sequence[Lane], bufs: Sequence[np.ndarray]) -> list:
        """Start the scans of 1..len(lanes) filled buffers, buffer k on
        lane k, without waiting for any of them → a handle per buffer
        for ``resolve``. A buffer is a slot's from ``claim``, read where
        it lies, or any other (copied into the pinned slot on the card;
        a shorter one reads as zero-padded). On the GPU the uploads, the
        kernels and the count's copy into pinned host memory are queued
        asynchronously on the lane's stream, so the host goes on filling
        the next batch."""
        if not 0 < len(bufs) <= len(lanes):
            raise ValueError(f"a group holds 1..{len(lanes)} buffers, got {len(bufs)}")
        handles = []
        for lane, buf in zip(lanes, bufs):
            with torch.cuda.stream(lane.stream) if lane.stream is not None else nullcontext():
                handles.append(self._submit(lane, buf))
                if len(self.lanes) > 1 and lane.device.type == "cuda" and (
                    lane.device not in self._tables_on
                ):
                    # the members upload their tables at first use, on this
                    # lane's stream: the plan's lanes on other streams must
                    # not read them before they have arrived
                    with self.span("wait"):
                        torch.cuda.current_stream(lane.device).synchronize()
                    self._tables_on.add(lane.device)
        return handles

    def _submit(self, lane: Lane, buf: np.ndarray):
        """(lane, total, payloads, ready) of one buffer's scan; ``ready``
        marks the count's arrival (None on the CPU)."""
        span = self.span
        want = self._want
        stride = self._stride
        if lane.device.type != "cuda":
            with span("stage"):
                if buf.shape[0] < want:  # caller without the pad rows
                    buf = np.concatenate([buf, np.zeros(want - buf.shape[0], dtype=np.uint8)])
                buf = buf[:want]
                raws = [torch.from_numpy(buf)] if self.linear else []
                if stride is not None:
                    lin = buf[: self.buf_size]
                    raws.append(torch.from_numpy(stride.prep_t(lin).reshape(-1).view(np.uint8)))
            with span("launch"):  # the plain kernels run here
                total, payloads = self._scan(raws)
            return lane, total, payloads, None
        i = lane.free(span)
        with span("stage"):
            if self.linear:
                slot = lane.pinned(i, want)
                if buf is not slot.buf:
                    n = min(buf.shape[0], want)
                    np.copyto(slot.buf[:n], buf[:n])
                    slot.buf[n:] = 0
                    slot.dirty = n
                    buf = slot.buf
            if stride is not None:
                # the host transpose writes straight into the pinned slot
                t = lane.pinned(i, self._sizes[-1])
                stride.prep_t(buf[: self.buf_size], out=t.buf.view(np.int32).reshape(
                    stride.s_w, N_STREAMS))
                t.dirty = t.buf.shape[0]
        total, payloads = lane.upload(self._sizes, self._scan, span)
        with span("launch"):
            host_total = torch.empty(total.shape, dtype=total.dtype, pin_memory=True)
            host_total.copy_(total, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(lane.device))
        return lane, host_total, payloads, ready

    def resolve(self, handle) -> np.ndarray:
        """Wait for a submitted scan → int32 [buf_size/block] 0/1 flags.
        A clean batch costs one 4-byte pull, waited for by its own
        event, not by a sync of the batches queued after it; the
        members' payloads (packed flags, or the strided-DFA bitmap)
        leave the device only when the summed count is nonzero, and
        their decoded flags are unioned."""
        nb = self.buf_size // self.block
        _lane, total, payloads, ready = handle
        span = self.span
        if ready is not None:
            with span("wait"):
                ready.synchronize()
        with span("pull"):
            flags = np.zeros(nb, dtype=np.int32)
            if int(total) == 0:
                return flags
            self.payload_pulls += 1
            for m, pk in zip(self.members, payloads):
                np.maximum(flags, m.flags_np(pk.cpu().numpy(), nb), out=flags)
        return flags

    def scan(self, buf: np.ndarray) -> np.ndarray:
        """One buffer's flags, on a lane of the first device held for
        the call."""
        lanes = take_lanes(self.lanes[:1])
        try:
            return self.resolve(self.submit(lanes, [buf])[0])
        finally:
            release_lanes(lanes)


class CorpusPipeline:
    """Streams (path, data) pairs through the packer + device scanner,
    yielding (path, data, counts) in input order with bounded memory.
    ``span``: the request's span recorder (``engine.ScanStats.span``),
    lent to the scanner while a stream runs. A stream holds a lane per
    device of the scanner from its first item to its end."""

    def __init__(
        self, scanner: DeviceScanner, halo: int = HALO, no_split: bool = False,
        span=no_span,
    ):
        self.scanner = scanner
        self.halo = halo
        self.no_split = no_split
        self.span = span
        self.batches_run = 0
        self.batches_inplace = 0  # filled straight into the buffer the scan reads

    def run(
        self, files: Iterable[Tuple[str, object]]
    ) -> Iterator[Tuple[str, object, np.ndarray]]:
        """(path, data) pairs → (path, data, counts), input order; each
        batch's segments are copied from the data into a lane's
        slot (``DeviceScanner.claim``)."""
        for path, data, counts, _err in self._stream(files, by_size=False):
            yield path, data, counts

    def run_paths(
        self, entries: Iterable[Tuple[str, int]], fill_threads: int = 8
    ) -> Iterator[Tuple[str, int, np.ndarray, int]]:
        """(path, size) pairs → (path, size, counts, errno), input
        order. Each batch is filled by the native pread pool (gt_fill2)
        — parallel, GIL-free — or the Python fallback, straight into the
        lane's slot (``DeviceScanner.claim``); files are never opened
        on the Python side, so a clean file costs a stat + N preads and
        nothing else. errno != 0 marks a file that could
        not be read (reference behavior: report and continue,
        grab.cc:267-268)."""
        self._fill_threads = fill_threads
        return self._stream(entries, by_size=True)

    def _stream(
        self, items: Iterable[Tuple[str, object]], by_size: bool
    ) -> Iterator[Tuple[str, object, np.ndarray, int]]:
        span = self.span
        scanner = self.scanner
        block = scanner.block
        buf_size = scanner.buf_size
        with span("pack"):
            packer = BatchPacker(buf_size, block, self.halo, no_split=self.no_split)
        # in-flight bookkeeping, keyed by file index
        inflight: Dict[int, list] = {}  # idx -> [path, payload, counts, final, errno]
        packed_done: set = set()  # fully packed, awaiting their last flush
        # double buffering: submitted batches resolve one flush later,
        # so device upload+scan overlap host packing of the next batch
        submitted = deque()  # (batches, handles, files_done_before_group)
        pending: List = []  # batches awaiting a full group, one per lane
        emitted = 0
        total = 0
        walk = iter(items)

        def pull():
            """The walk's next files: at least a buffer's bytes, at most
            PULL_MAX files, fewer at the walk's end (none: it ended). No
            batch closes before a buffer's bytes are packed, so pulling
            them first delays no upload."""
            got, nbytes = [], 0
            for item in walk:
                got.append(item)
                nbytes += item[1] if by_size else len(item[1])
                if nbytes >= buf_size or len(got) >= PULL_MAX:
                    break
            return got

        def pack(got):
            """Pack the pulled files in order; yields batches as they close."""
            nonlocal total
            for path, payload in got:
                idx = total
                total += 1
                size = payload if by_size else len(payload)
                nblocks = -(-size // block)
                inflight[idx] = [
                    path, payload, np.zeros(nblocks, dtype=np.int32), False, 0,
                ]
                yield from packer.feed_size(idx, size)
                packed_done.add(idx)

        def fill_batch(batch, slot):
            """Fill a batch into ``slot``: from disk by the pread pool
            (read failures mark the owning files) or from the files'
            data. Both write each segment's whole extent; what earlier
            batches left past the batch's end is zeroed (``stage``), so
            the slot reads as a buffer zeroed for this batch alone."""
            buf = slot.buf
            slot.dirty = max(slot.dirty, batch.end)
            with span("fill"):
                if by_size:
                    jobs = [
                        (
                            inflight[s.file_idx][0].encode("utf-8", "surrogateescape"),
                            s.file_off,
                            s.buf_off,
                            s.length,
                        )
                        for s in batch.segments
                    ]
                    errs = fill_segments(buf, jobs, block, self._fill_threads)
                    for seg, e in zip(batch.segments, errs):
                        if e:
                            st = inflight[seg.file_idx]
                            st[4] = st[4] or int(e)
                else:
                    copy_segments(buf, batch.segments, lambda i: inflight[i][1], block)
            with span("stage"):
                buf[batch.end : slot.dirty] = 0
                slot.dirty = batch.end

        def submit_batch(batch):
            """Queue one packer batch; the scanner consumes a batch per
            lane per device step (the data-parallel axis of
            main.cc:86-100), so a one-lane scanner submits at once."""
            pending.append(batch)
            if len(pending) >= len(lanes):
                flush_group()

        def flush_group():
            if not pending:
                return
            self.batches_run += len(pending)
            bufs = []
            for lane, b in zip(lanes, pending):
                slot = scanner.claim(lane)
                fill_batch(b, slot)
                bufs.append(slot.buf)
            if scanner.linear:
                self.batches_inplace += len(bufs)
            handles = scanner.submit(lanes, bufs)
            submitted.append((list(pending), handles, frozenset(packed_done)))
            pending.clear()
            packed_done.clear()
            while len(submitted) > 1:
                apply_one()

        def apply_one():
            """Resolve the oldest submitted group and fold its flags
            into the owning files; files fully packed before that group
            became final once it is applied."""
            batches, handles, done_set = submitted.popleft()
            counts_list = [scanner.resolve(h) for h in handles]
            with span("pull"):
                for batch, counts in zip(batches, counts_list):
                    for seg in batch.segments:
                        st = inflight[seg.file_idx]
                        b0 = seg.buf_off // block
                        nb = -(-seg.length // block)
                        f0 = seg.file_off // block
                        fc = st[2]
                        lim = min(f0 + nb, fc.shape[0])
                        np.maximum(
                            fc[f0:lim], counts[b0 : b0 + (lim - f0)], out=fc[f0:lim]
                        )
                for i in done_set:
                    inflight[i][3] = True

        def drain():
            """The files that became final, in input order."""
            nonlocal emitted
            with span("pack"):
                done = []
                while emitted < total and emitted in inflight and inflight[emitted][3]:
                    st = inflight.pop(emitted)
                    done.append((st[0], st[1], st[2], st[4]))
                    emitted += 1
            return done

        lanes = take_lanes(scanner.lanes)
        scanner.span = span
        try:
            while True:
                with span("walk"):
                    got = pull()
                if not got:
                    break
                batches = pack(got)
                while True:
                    with span("pack"):
                        batch = next(batches, None)
                    if batch is None:
                        break
                    submit_batch(batch)
                    yield from drain()
            with span("pack"):
                final = packer.finish()
            if final is not None:
                submit_batch(final)
            flush_group()
            while submitted:
                apply_one()
            for i in packed_done:
                inflight[i][3] = True
            packed_done.clear()
            yield from drain()
        finally:
            release_lanes(lanes)
            scanner.span = no_span
