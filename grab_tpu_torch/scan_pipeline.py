"""Device scan pipeline on the GPU: fixed-shape batched candidate
generation.

Files are packed into fixed-size scan buffers (ingest/packer.py) and
each buffer is uploaded and scanned by a device kernel; only a count
and the candidate flags' compact form come back to the host. This is
the port of the JAX package's scan_pipeline.py. ``DeviceScanner``
routes a compiled pattern set the way the reference does and serves
three device modes:

  * literal: a covered literal set, one core-word scanner
    (ops/corewords.py, kernel csrc/corewords.cu);
  * class_seq: covered class sequences and no literals, served by the
    union strided-DFA member when the sequences' automaton is bounded
    and has a stride plan (``_StrideSeqMember``, csrc/stridedfa.cu),
    else by the class-sequence kernel (ops/classseq.py,
    csrc/classseq.cu);
  * gdfa: uncovered patterns with an automaton of at most 2048 states
    and a stride plan, including unbounded ``-E`` patterns (the
    strided-DFA walk with its window pass or threading fixpoint,
    ops/stridedfa.py).

Every other plan is refused with its tier and ROADMAP item
(``NotPortedError``), never quietly replayed on the host.
``CorpusPipeline`` is the reference's, unchanged: its one-deep double
buffering overlaps host packing of the next batch with the device's
upload and scan of this one.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from grab_tpu_torch.ops.classseq import ClassSeqScanner, compile_sequences
from grab_tpu_torch.ops.corewords import LANES, PAD_ROWS, CoreWordScanner
from grab_tpu_torch.ops.stridedfa import (
    HALO as STRIDE_HALO,
    N_STREAMS,
    STREAM_ROWS,
    StrideDfaScanner,
    stride_plan,
)

CANDIDATE_BLOCK = 512
HALO = 0x1000  # reference overlap (grab.cc:151)
MAX_KERNEL_LITERALS = 16  # one compare bucket of the core-word kernel
MAX_LONG_LITERALS = 4  # more 7+-byte literals go to the XOR filter
MIN_STRIDE_BUF = 1 << 20  # smaller buffers take the reference's jnp walk


class NotPortedError(ValueError):
    """The pattern's device plan (or a requested mode) needs a part of
    the system that is not ported to the GPU yet."""


class DeviceUnavailable(RuntimeError):
    """The CUDA device was asked for and torch cannot see one."""


def resolve_device(device: str) -> torch.device:
    """'cuda' or 'cpu' → torch.device; 'cuda' without a visible card
    raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "false (use GRAB_TPU_TORCH_DEVICE=cpu to scan on the CPU)"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported scan device {device!r}")
    return dev


def plan_refusal(cp, buf_size: int) -> Optional[str]:
    """Why the device plan of compiled pattern ``cp`` at scan buffer
    ``buf_size`` is outside the port, or None when a ported mode serves
    it. Mirrors the reference routing (scan_pipeline.py
    DeviceScanner.__init__ and _build_pallas): a covered literal plan
    with at most 16 literals, at most 4 of them 7+ bytes long, and no
    class sequences gives a fused ensemble of one member, which the
    reference replaces by its split path's single CoreWordScanner; a
    covered class-sequence plan is the class_seq mode; an uncovered
    automaton of at most 2048 states whose alphabet-run plan is not
    eligible is the gdfa mode when it has a stride plan and the buffer
    is at least 1 MiB."""
    if cp.covered and cp.literals:
        if cp.class_seqs:
            return (
                "literal plan with class sequences needs the fused ensemble "
                "and its class-seq member (ROADMAP A8, A9)"
            )
        if sum(len(l) >= 7 for l in cp.literals) > MAX_LONG_LITERALS:
            return (
                f"more than {MAX_LONG_LITERALS} literals of 7+ bytes need the "
                "XOR-filter member of the fused ensemble (ROADMAP A9)"
            )
        if len(cp.literals) > MAX_KERNEL_LITERALS:
            return (
                f"more than {MAX_KERNEL_LITERALS} literals need the fused "
                "ensemble (ROADMAP A9)"
            )
        return None
    if cp.covered and cp.class_seqs:
        return None
    # uncovered: the reference scans a class-run plan with the
    # alphabet-run kernel first, else walks the automaton
    if DeviceScanner._alpha_eligible(cp.alpha_plan):
        return "class-run plan needs the alphabet-run tier (ROADMAP A7)"
    if cp.dfa is not None and cp.dfa.n_states <= 2048:
        if stride_plan(cp.dfa) is None:
            return (
                "automaton without a strided-DFA plan needs the last-resort "
                "DFA walk (ROADMAP A6)"
            )
        if buf_size < MIN_STRIDE_BUF:
            return (
                f"a scan buffer under {MIN_STRIDE_BUF} bytes needs the "
                "last-resort DFA walk (ROADMAP A6)"
            )
        return None
    return "pattern has no device-scannable form"


class _PinnedUploader:
    """Host → device uploads through a ring of pinned staging buffers,
    copied on a side stream so the copy is asynchronous to the host.

    Slot i's staging buffer is rewritten only after its previous copy
    has completed (``_copied``), and its device buffer only after the
    kernel that read it has run (``_consumed``), so a batch in flight is
    never overwritten while CorpusPipeline packs the next one."""

    DEPTH = 2  # CorpusPipeline keeps at most two batches in flight

    def __init__(self, nbytes: int, device: torch.device):
        self.device = device
        self._host = [
            torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            for _ in range(self.DEPTH)
        ]
        self._dev = [
            torch.empty(nbytes, dtype=torch.uint8, device=device)
            for _ in range(self.DEPTH)
        ]
        self._copied: List[Optional[torch.cuda.Event]] = [None] * self.DEPTH
        self._consumed: List[Optional[torch.cuda.Event]] = [None] * self.DEPTH
        self._stream = torch.cuda.Stream(device)
        self._next = 0

    def run(self, fill, fn):
        """``fill(staging)`` writes the batch into the free slot's pinned
        uint8 numpy buffer; it is uploaded and ``fn(dev)`` launched on
        the current stream after the copy."""
        i = self._next
        self._next = (i + 1) % self.DEPTH
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        fill(self._host[i].numpy())
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            if self._consumed[i] is not None:
                self._stream.wait_event(self._consumed[i])
            self._dev[i].copy_(self._host[i], non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._stream)
        self._copied[i] = copied
        compute.wait_event(copied)
        out = fn(self._dev[i])
        consumed = torch.cuda.Event()
        consumed.record(compute)
        self._consumed[i] = consumed
        return out


class _StrideSeqMember:
    """The class_seq mode's union strided-DFA member: every sequence
    routed pattern in ONE bounded automaton walk (the compiler's
    seq_dfa), window mode only. Its hits are exact union match ends, a
    tighter candidate set than prefix-sequence starts; the host replay
    is the same. It consumes the buffer born in the walk's stream-major
    layout (``prep_t``), so no linear upload is made for it."""

    def __init__(self, dfa, max_len, buf_size: int):
        self.sc = StrideDfaScanner(dfa, max_len, buf_size)
        assert self.sc.window_mode  # bounded patterns only (single pass)

    @property
    def s_w(self) -> int:
        return self.sc.s_w

    def prep_t(self, buf: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
        return self.sc.prep_t(buf, out=out)

    def packed_t(self, w2d_t: torch.Tensor):
        return self.sc.packed_t(w2d_t)

    def flags_np(self, bm, n_blocks: int) -> np.ndarray:
        return self.sc.flags_np(np.asarray(bm).reshape(-1, LANES), n_blocks)


class DeviceScanner:
    """Fixed-shape candidate scan of packer buffers on one device."""

    group_size = 1  # batches consumed per submit

    def __init__(
        self,
        compiled,
        buf_size: Optional[int] = None,
        block: int = CANDIDATE_BLOCK,
        device: str = "cuda",
    ):
        self.device = resolve_device(device)
        on_gpu = self.device.type == "cuda"
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
        why = plan_refusal(cp, buf_size)
        if why is not None:
            raise NotPortedError(f"{why}: not ported to the GPU yet")
        if cp.covered and cp.literals:
            self.mode = "literal"
            member = CoreWordScanner(cp.literals)
        elif cp.covered and cp.class_seqs:
            self.mode = "class_seq"
            member = self._seq_scanner(cp)
        else:
            self.mode = "gdfa"
            member = self._gdfa = StrideDfaScanner(cp.dfa, cp.max_len, buf_size)
        self.members = [member]
        # stride routes upload the buffer born transposed, the word
        # kernels the linear words with their zero pad rows
        self._transposed = isinstance(member, (_StrideSeqMember, StrideDfaScanner))
        self._want = buf_size + PAD_ROWS * LANES * 4
        nbytes = member.s_w * N_STREAMS * 4 if self._transposed else self._want
        self._uploader = _PinnedUploader(nbytes, self.device) if on_gpu else None

    @staticmethod
    def _alpha_eligible(plan) -> bool:
        from grab_tpu_torch.ops.alpharun import alpharun_eligible

        return plan is not None and alpharun_eligible(plan[0], plan[1])

    def _seq_scanner(self, cp):
        """The class_seq mode's member (the reference's
        ``_seq_scanner(standalone=True)``): the union strided-DFA member
        when the sequences' automaton is bounded within the window reach
        and has a stride plan, and the buffer is at least 1 MiB; else
        the class-sequence word kernel."""
        sd, sml = cp.seq_dfa, cp.seq_max_len
        if (
            sd is not None
            and sml is not None
            and sml <= STRIDE_HALO - 8
            and stride_plan(sd) is not None
            and self.buf_size >= MIN_STRIDE_BUF
        ):
            return _StrideSeqMember(sd, sml, self.buf_size)
        return ClassSeqScanner(compile_sequences(cp.class_seqs))

    def _scan(self, member, dev_buf: torch.Tensor):
        """(total int32 [1], payload) of one uploaded buffer (uint8)."""
        if self._transposed:
            w2d = dev_buf.view(torch.int32).view(member.s_w * STREAM_ROWS, LANES)
            return member.packed_t(w2d)
        return member.packed(dev_buf.view(torch.int32).view(-1, LANES))

    def submit(self, buf: np.ndarray):
        """Start the scan of one packer buffer; returns (total, payload,
        ready). On the GPU the upload, the kernel and the count's copy
        into pinned host memory are queued asynchronously, so the host
        goes on packing the next batch; ``ready`` marks the count's
        arrival (None on the CPU)."""
        want = self._want
        if buf.shape[0] < want:  # caller without the packer's tail
            buf = np.concatenate([buf, np.zeros(want - buf.shape[0], dtype=np.uint8)])
        buf = buf[:want]
        member = self.members[0]
        lin = buf[: self.buf_size]
        if self._uploader is None:
            if self._transposed:
                raw = torch.from_numpy(member.prep_t(lin).reshape(-1).view(np.uint8))
            else:
                raw = torch.from_numpy(buf)
            total, payload = self._scan(member, raw)
            return total, payload, None
        if self._transposed:
            # the host transpose writes straight into the pinned slot

            def fill(staging):
                member.prep_t(lin, out=staging.view(np.int32).reshape(member.s_w, N_STREAMS))
        else:

            def fill(staging):
                np.copyto(staging, buf)

        total, payload = self._uploader.run(fill, lambda dev: self._scan(member, dev))
        host_total = torch.empty(total.shape, dtype=total.dtype, pin_memory=True)
        host_total.copy_(total, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host_total, payload, ready

    def resolve(self, handles) -> np.ndarray:
        """Wait for a submitted scan → int32 [buf_size/block] 0/1 flags.
        A clean batch costs one 4-byte pull, waited for by its own
        event, not by a sync of the batches queued after it; the
        payload (packed flags or the strided-DFA bitmap) leaves the
        device only when the count is nonzero."""
        nb = self.buf_size // self.block
        total, payload, ready = handles
        if ready is not None:
            ready.synchronize()
        if int(total) == 0:
            return np.zeros(nb, dtype=np.int32)
        return self.members[0].flags_np(payload.cpu().numpy(), nb)


class CorpusPipeline:
    """Streams (path, data) pairs through the packer + device scanner,
    yielding (path, data, counts) in input order with bounded memory."""

    def __init__(
        self, scanner: DeviceScanner, halo: int = HALO, no_split: bool = False
    ):
        self.scanner = scanner
        self.halo = halo
        self.no_split = no_split
        self.batches_run = 0

    def run(
        self, files: Iterable[Tuple[str, object]]
    ) -> Iterator[Tuple[str, object, np.ndarray]]:
        """(path, data) pairs → (path, data, counts), input order."""
        for path, data, counts, _err in self._stream(files, by_size=False):
            yield path, data, counts

    def run_paths(
        self, entries: Iterable[Tuple[str, int]], fill_threads: int = 8
    ) -> Iterator[Tuple[str, int, np.ndarray, int]]:
        """(path, size) pairs → (path, size, counts, errno), input
        order. Buffers are filled by the native pread pool (gt_fill2)
        — parallel, GIL-free — or the Python fallback; files are never
        opened on the Python side, so a clean file costs a stat + N
        preads and nothing else. errno != 0 marks a file that could
        not be read (reference behavior: report and continue,
        grab.cc:267-268)."""
        self._fill_threads = fill_threads
        yield from self._stream(entries, by_size=True)

    def _stream(
        self, items: Iterable[Tuple[str, object]], by_size: bool
    ) -> Iterator[Tuple[str, object, np.ndarray, int]]:
        from collections import deque

        from grab_tpu_torch.ingest.packer import BatchPacker

        block = self.scanner.block
        group_size = getattr(self.scanner, "group_size", 1)
        packer = BatchPacker(
            self.scanner.buf_size, block, self.halo, no_split=self.no_split
        )
        # in-flight bookkeeping, keyed by file index
        inflight: Dict[int, list] = {}  # idx -> [path, payload, counts, final, errno]
        packed_done: set = set()  # fully packed, awaiting their last flush
        # double buffering: submitted batches resolve one flush later,
        # so device upload+scan overlap host packing of the next batch
        submitted = deque()  # (batches, handles, files_done_before_group)
        pending: List = []  # batches awaiting a full shard group
        emitted = 0
        total = 0

        def fill_batch(batch):
            """Populate an unfilled (descriptor-only) batch via the
            pread pool; read failures mark the owning files."""
            from grab_tpu_torch.ingest.native import fill_segments

            jobs = [
                (
                    inflight[s.file_idx][0].encode("utf-8", "surrogateescape"),
                    s.file_off,
                    s.buf_off,
                    s.length,
                )
                for s in batch.segments
            ]
            errs = fill_segments(
                batch.buf, jobs, getattr(self, "_fill_threads", 8)
            )
            for seg, e in zip(batch.segments, errs):
                if e:
                    st = inflight[seg.file_idx]
                    st[4] = st[4] or int(e)
            batch.filled = True

        def submit_batch(batch):
            """Queue one packer batch; a sharded scanner consumes
            group_size batches per device step (one per mesh shard —
            the data-parallel axis of main.cc:86-100), a single-device
            scanner submits immediately."""
            pending.append(batch)
            if len(pending) >= group_size:
                flush_group()

        def flush_group():
            if not pending:
                return
            self.batches_run += len(pending)
            for b in pending:
                if not b.filled:
                    fill_batch(b)
            if group_size == 1:
                handles = self.scanner.submit(pending[0].buf)
            else:
                handles = self.scanner.submit_group([b.buf for b in pending])
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
            if group_size == 1:
                counts_list = [self.scanner.resolve(handles)]
            else:
                counts_list = self.scanner.resolve_group(handles)
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
            nonlocal emitted
            while emitted < total and emitted in inflight and inflight[emitted][3]:
                st = inflight.pop(emitted)
                yield (st[0], st[1], st[2], st[4])
                emitted += 1

        for path, payload in items:
            idx = total
            total += 1
            size = payload if by_size else len(payload)
            nblocks = -(-size // block)
            inflight[idx] = [
                path, payload, np.zeros(nblocks, dtype=np.int32), False, 0,
            ]
            feed = (
                packer.feed_size(idx, size)
                if by_size
                else packer.feed(idx, payload)
            )
            for batch in feed:
                submit_batch(batch)
                yield from drain()
            packed_done.add(idx)
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
