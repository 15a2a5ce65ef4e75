"""Strided DFA scan: the exact-automaton tier (gdfa) and the class_seq
tier's union stride member on the GPU.

The corpus buffer is laid out as 16384 streams (stream s = linear bytes
[s*stride, (s+1)*stride)), stream-major: word g of stream s = r*128 + c
at row g*128 + r, lane c. Every stream walks the pattern's search
automaton k bytes per table lookup (k in {4, 2, 1}): a k-step transition
table indexed by (state, the k bytes' run/class indices) whose entries
carry a sticky accept bit, so a word is a hit when the automaton accepted
during any of its 4 bytes. Outputs: a hit bitmap int32 [rows/16, 128]
(bit R % 16 of [R // 16, c] = hit at row R = g*128 + r) and the per-stream
exit states int32 [128, 128].

Two ways across stream boundaries, as in the JAX package
(grab_tpu/ops/pallas_stridedfa.py, which this module ports):

  * bounded patterns (max_len <= HALO - 8): one walk from the start
    state plus a walk over the boundary windows (``windows_t``): every
    match crossing a boundary lies inside [boundary - 4*wb,
    boundary + 4*wb) and is found from the start state;
  * unbounded patterns: the threading fixpoint. Entries^0 = start
    everywhere, entries^(r+1) = exits^r shifted by one stream (stream 0
    gets start), stop when they no longer change; at most MAX_ROUNDS
    walks, after which the bitmap is all ones (sound: the host replay
    verifies every candidate).

The host planner (class_runs, class_runs_parity, stride_plan) and the
tables (StrideDfaTables) are copies of the reference's, bit for bit.
``stride_dfa_scan`` and ``stride_dfa_fixpoint`` are the entry points:
on CUDA tensors they launch the hand-written kernel csrc/stridedfa.cu
(the fixpoint is one cooperative launch that loops on the card), on
CPU tensors they run the plain PyTorch walk below, which the tests hold
against the reference's kernel in interpret mode and its numpy oracle.

``stride_transpose`` is the relayout in front of the walk for a buffer
that arrives in linear layout (stream rows [16384, s_w]): on a CUDA
tensor the hand-written kernel csrc/transpose.cu, on a CPU tensor a
plain transposed copy. The scanner's ``run`` / ``run2d`` / ``packed``
go through it; ``run_t`` / ``packed_t`` take the buffer born transposed
on the host (``prep_t``), which is what DeviceScanner uploads.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

LANES = 128
BLOCK = 512  # candidate block bytes
STREAM_ROWS = 128
N_STREAMS = STREAM_ROWS * LANES  # 16384
HALO = 128  # boundary-window reach in bytes (window-mode eligibility)
W = 32  # the reference's words per grid step: strides are multiples of 4*W
WIN_W = 64  # max boundary-window words per stream (128 B either side)
CAPACITY = 512  # pack4: 128 lanes x 4 8-bit entries
MAX_STATES = 128  # 7-bit state ids + sticky accept bit
# 16-bit wide-table modes: 2 entries/lane x multiple table rows with
# 15-bit state ids, up to 4096 entries / 2048 states
CAPACITY16 = 4096
MAX_STATES16 = 2048
ROW16 = 2 * LANES  # entries per 16-bit table row
MAX_RUNS = 16  # SWAR membership cost per threshold per word
MAX_ROUNDS = 24  # threading fixpoint cap (walks, the first included)


def class_runs(class_map: np.ndarray):
    """Decompose the byte→class map into maximal runs of constant
    class. → (thresholds, run_classes): run i covers
    [thresholds[i-1], thresholds[i]) with class run_classes[i]
    (thresholds[-1] exclusive end omitted; run 0 starts at 0)."""
    cm = np.asarray(class_map, dtype=np.int64)
    starts = [0]
    for b in range(1, 256):
        if cm[b] != cm[b - 1]:
            starts.append(b)
    thresholds = tuple(starts[1:])
    run_classes = tuple(int(cm[s]) for s in starts)
    return thresholds, run_classes


def class_runs_parity(class_map: np.ndarray):
    """Parity-refined run decomposition: maximal runs where the class
    depends only on the byte's PARITY within the run (an alternating
    set like ``[acegikmoqsuwy]`` is three parity-runs instead of ~26
    plain runs). → (thresholds, pair_classes) where pair_classes[i] =
    (class of even bytes, class of odd bytes) for run i; callers bound
    len(thresholds) by MAX_RUNS."""
    cm = np.asarray(class_map, dtype=np.int64)

    def pair(b):  # the (even, odd) class pair governing byte b's run
        base = b & ~1
        return (int(cm[base]), int(cm[base + 1]) if base + 1 < 256 else int(cm[base]))

    starts = [0]
    for b in range(2, 256, 2):
        if pair(b) != pair(b - 2):
            starts.append(b)
    thresholds = tuple(starts[1:])
    pair_classes = tuple(pair(s) for s in starts)
    return thresholds, pair_classes


def stride_plan(dfa):
    """→ ("run", k) with k in {4, 2, 1} (SWAR run indices, one gather
    per k bytes), ("runp", k) (parity-refined runs), ("cls", k)
    (fragmented class maps: packed class-table gathers plus ONE
    transition gather per k bytes), their 16-bit wide variants
    ("run16"/"runp16"/"cls16", k) for automata up to 2048 states, or
    None (host scan: > 2048 states or capacity blown). Preference
    order per width: run > runp > cls."""
    if dfa is None or dfa.n_states > MAX_STATES16:
        return None
    thresholds, _ = class_runs(dfa.class_map)
    m = len(thresholds) + 1
    tp, _ = class_runs_parity(dfa.class_map)
    mp = 2 * (len(tp) + 1)  # refined index space: run*2 + parity
    C = dfa.n_classes
    S = dfa.n_states

    def ok(kind, k, cap):
        if kind.startswith("cls"):
            return C <= 256 and S * (C ** k) <= cap
        mm, thr = (mp, len(tp)) if "runp" in kind else (m, m - 1)
        if thr > MAX_RUNS:
            return False
        if k == 4 and mm ** 4 > 256:
            return False  # SWAR dot byte-3 must hold q < 256
        if k == 2 and mm * (mm - 1) > 255:
            return False  # k=2 byte extraction: r*m must fit a byte
        return S * (mm ** k) <= cap

    # the reference's cost ladder: chained transition gathers dominate,
    # per-byte class gathers add ~1 gather each, the parity refinement
    # adds ~2 SWAR ops (run > runp at equal k)
    pref = [
        ("run", 4), ("runp", 4), ("run", 2), ("runp", 2),
        ("cls", 4), ("cls", 2), ("run", 1), ("runp", 1), ("cls", 1),
    ]
    if S <= MAX_STATES:
        for kind, k in pref:
            if ok(kind, k, CAPACITY):
                return (kind, k)
    # 16-bit plans: each table row costs one gather + select per link,
    # so pick by estimated gathers/word = links_per_word * rows (+4
    # chain-independent class extracts for cls); ties break to deeper
    # k, then run > runp > cls
    best = None
    for rank, (kind, k) in enumerate(pref):
        kind16 = kind + "16"
        if not ok(kind16, k, CAPACITY16):
            continue
        if kind == "cls":
            entries = S * (C ** k)
        else:
            mm = mp if kind == "runp" else m
            entries = S * (mm ** k)
        rows = -(-entries // ROW16)
        cost = (4 // k) * rows + (4 if kind == "cls" else 0)
        key = (cost, -k, rank)
        if best is None or key < best[0]:
            best = (key, (kind16, k))
    return best[1] if best else None


def _pack4(flat: np.ndarray) -> np.ndarray:
    pk = np.zeros(4 * LANES, dtype=np.int64)
    pk[: flat.shape[0]] = flat
    return (
        pk[0::4] | (pk[1::4] << 8) | (pk[2::4] << 16) | (pk[3::4] << 24)
    ).astype(np.int32)


def _pack2(flat: np.ndarray) -> np.ndarray:
    """16-bit entries, 2 per lane, row-major: entry i lives at row
    i >> 8, lane (i >> 1) & 127, half i & 1 → int32 [R, 128]."""
    n_rows = -(-flat.shape[0] // ROW16)
    pk = np.zeros(n_rows * ROW16, dtype=np.int64)
    pk[: flat.shape[0]] = flat
    pk = pk.reshape(n_rows, LANES, 2)
    return (
        (pk[:, :, 0] | (pk[:, :, 1] << 16)) & 0xFFFFFFFF
    ).astype(np.uint32).view(np.int32)


class StrideDfaTables:
    """k-step transition tables with sticky accept (the reference's,
    bit for bit: tab, flat, m, k, mode, thresholds, acc_bit, start).

    flat[s * m^k + q] = next state | (any intermediate or landing state
    accepting) * acc_bit, with q the k bytes' run (run modes), refined
    run*2 + parity (runp) or class (cls) indices in base m, earliest
    byte most significant. ``tab`` is the TPU kernel's packed layout
    (4x8-bit or 2x16-bit per lane; the cls modes append a row holding
    the byte→class map), kept for parity with the reference; the port's
    kernel reads ``flat`` and ``byte_index`` (the per-byte index the TPU
    kernel derived from thresholds or the class row). State ids are the
    automaton's own, so exit vectors and threading stay in raw id space.
    """

    def __init__(self, dfa, plan):
        mode, k = plan
        self.mode = mode
        self.k = k
        wide = mode in ("run16", "runp16", "cls16")
        self.acc_bit = 1 << 15 if wide else 1 << 7
        S = self.n_states = dfa.n_states
        self.start = int(dfa.start)
        told = np.asarray(dfa.table)
        acc = np.asarray(dfa.accept_mask, dtype=bool)
        is_cls = mode in ("cls", "cls16")
        cap = CAPACITY16 if wide else CAPACITY
        byte = np.arange(256, dtype=np.int64)
        if is_cls:
            m = self.m = int(dfa.n_classes)
            self.thresholds = ()
            assert m <= 256
            t1 = told  # [S, C]: per-byte step indexed by class directly
        elif mode in ("runp", "runp16"):
            # parity-refined runs: index q = run*2 + (b & 1)
            thresholds, pair_classes = class_runs_parity(dfa.class_map)
            m = self.m = 2 * (len(thresholds) + 1)
            self.thresholds = thresholds
            order = [c for even, odd in pair_classes for c in (even, odd)]
            t1 = told[:, order]  # [S, 2*runs]
        else:
            thresholds, run_classes = class_runs(dfa.class_map)
            m = self.m = len(thresholds) + 1
            self.thresholds = thresholds
            t1 = told[:, list(run_classes)]  # [S, m]
        assert S * (m ** k) <= cap, (S, m, k)
        # k-step composition: q' = q * m + r appends one byte's
        # run/class index to the prefix; accept is sticky over the path
        a1 = acc[t1]  # accept of landing state
        tk, ak = t1, a1
        for _ in range(k - 1):
            tk2 = t1[tk.reshape(-1)].reshape(S, -1)  # [S, q*m+r]
            ak2 = np.repeat(ak, m, axis=1) | a1[tk.reshape(-1)].reshape(S, -1)
            tk, ak = tk2, ak2
        flat = (
            tk.astype(np.int64) | (ak.astype(np.int64) * self.acc_bit)
        ).reshape(-1)
        self.flat = flat
        body = _pack2(flat) if wide else _pack4(flat).reshape(1, LANES)
        self.n_rows = body.shape[0]
        if is_cls:
            # final row: the packed byte->class map (2 x 8-bit per lane)
            cm = np.asarray(dfa.class_map, dtype=np.int64)
            cls_pk = np.zeros(LANES, dtype=np.int32)
            cls_pk[:] = (cm[:128] | (cm[128:] << 8)).astype(np.int32)
            self.tab = np.concatenate([body, cls_pk.reshape(1, LANES)])
            pkv = self.tab[-1].astype(np.int64)[byte & 127]
            idx = (pkv >> ((byte >> 7) << 3)) & 0xFF
        else:
            self.tab = body
            idx = np.zeros(256, dtype=np.int64)
            for t in self.thresholds:
                idx += byte >= t
            if mode in ("runp", "runp16"):
                idx = idx * 2 + (byte & 1)
        self.byte_index = idx  # int64 [256]: byte → run/class index
        self._dev = {}  # device → (flat int32, byte index int32 [256])

    def device_tables(self, device: torch.device):
        """The kernel's inputs on ``device``: flat int32 [S*m^k] and
        byte_index int32 [256]. Uploaded once per device."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (
                torch.from_numpy(self.flat.astype(np.int32)).to(device),
                torch.from_numpy(self.byte_index.astype(np.int32)).to(device),
            )
        return self._dev[key]


# -- the walk: plain PyTorch version --------------------------------------


def stride_dfa_scan_torch(
    words2d_t: torch.Tensor, tables: StrideDfaTables, entries: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch walk, the same function as the kernel and the
    reference's np_stride_scan: a Python loop over word steps,
    vectorised over the 16384 streams. → (bm int32 [rows/16, 128],
    exits int32 [128, 128])."""
    dev = words2d_t.device
    rows = words2d_t.shape[0]
    x = words2d_t.view(rows // STREAM_ROWS, STREAM_ROWS, LANES)
    flat = torch.from_numpy(tables.flat).to(dev)
    idx = torch.from_numpy(tables.byte_index).to(dev)
    m, k, abit = tables.m, tables.k, tables.acc_bit
    mk, smask = m ** k, abit - 1
    state = entries.to(torch.int64).reshape(STREAM_ROWS, LANES)
    hit = torch.empty((rows, LANES), dtype=torch.bool, device=dev)
    for g in range(x.shape[0]):
        wv = x[g]
        runs = [idx[((wv >> (8 * kk)) & 0xFF).long()] for kk in range(4)]
        h = torch.zeros((STREAM_ROWS, LANES), dtype=torch.bool, device=dev)
        for j in range(0, 4, k):
            q = runs[j]
            for rr in runs[j + 1 : j + k]:
                q = q * m + rr
            e = flat[state * mk + q]
            h |= (e & abit) != 0
            state = e & smask
        hit[g * STREAM_ROWS : (g + 1) * STREAM_ROWS] = h
    h16 = hit.view(rows // 16, 16, LANES).to(torch.int32)
    bm = torch.zeros((rows // 16, LANES), dtype=torch.int32, device=dev)
    for i in range(16):
        bm |= h16[:, i] << i
    return bm, state.to(torch.int32)


def thread_entries(exits: torch.Tensor, start: int) -> torch.Tensor:
    """Stream i's next entry is stream i-1's exit; stream 0 gets start."""
    flat = exits.reshape(-1)
    return torch.cat([flat.new_full((1,), start), flat[:-1]]).reshape(
        STREAM_ROWS, LANES
    )


def stride_fixpoint_torch(
    words2d_t: torch.Tensor, tables: StrideDfaTables, max_rounds: int
) -> Tuple[torch.Tensor, int, bool]:
    """Plain PyTorch threading fixpoint, the reference's while_loop:
    → (bm, walks run, converged); bm is all ones (-1) when the entries
    still changed after ``max_rounds`` walks."""
    start = tables.start
    e0 = torch.full(
        (STREAM_ROWS, LANES), start, dtype=torch.int32, device=words2d_t.device
    )
    bm, exits = stride_dfa_scan_torch(words2d_t, tables, e0)
    e_prev, e_cur, n = e0, thread_entries(exits, start), 1
    while n < max_rounds and bool((e_prev != e_cur).any()):
        bm, exits = stride_dfa_scan_torch(words2d_t, tables, e_cur)
        e_prev, e_cur, n = e_cur, thread_entries(exits, start), n + 1
    converged = bool((e_prev == e_cur).all())
    if not converged:
        bm = torch.full_like(bm, -1)
    return bm, n, converged


# -- the walk: CUDA kernel --------------------------------------------------

# The kernel's segmented walk (csrc/stridedfa.cu): a stream's word steps
# in tiles of SEGMENTS segments of at most SEG_MAX words, one thread per
# segment, a checkpoint every CKPT words, a guess from the WARM words
# before a segment.
SEGMENTS = 8
SEG_MAX = 64
CKPT = 8
WARM = 8


def segment_geometry(s_w: int) -> Tuple[int, int, int, int]:
    """The kernel's segment geometry for s_w word steps → (words per
    segment, tiles, checkpoints per segment, int32 words of the
    fixpoint's checkpoint scratch); csrc/stridedfa.cu geometry() and
    gt_stride_ckpt_words compute the same."""
    if s_w <= 0:
        raise ValueError(f"s_w must be positive, got {s_w}")
    seg = min(SEG_MAX, -(-s_w // SEGMENTS))
    tiles = -(-s_w // (SEGMENTS * seg))
    n_ck = -(-seg // CKPT)
    return seg, tiles, n_ck, tiles * SEGMENTS * n_ck * N_STREAMS


def chain_links(s_w: int, k: int) -> int:
    """Dependent links of the longest chain of one walk when every guess
    is right: per tile, one segment plus a guess's warm-up, 4/k links a
    word."""
    seg, tiles, _, _ = segment_geometry(s_w)
    return tiles * (seg + min(WARM, s_w)) * (4 // k)


_FIXUP = {}  # device index → counter: words the kernel's fix-up re-walked


def _fixup_counter(dev: torch.device) -> torch.Tensor:
    key = _dev_tail(dev)[0]
    if key not in _FIXUP:
        _FIXUP[key] = torch.zeros(1, dtype=torch.int64, device=dev)
    return _FIXUP[key]


def fixup_words(dev: torch.device, reset: bool = False) -> int:
    """Words re-walked by the kernel's fix-up on ``dev`` since the last
    reset (synchronises the device); ``reset`` zeroes the count. The
    plain walk on the CPU re-walks nothing: 0."""
    if torch.device(dev).type != "cuda":
        return 0
    cnt = _fixup_counter(dev)
    n = int(cnt.item())
    if reset:
        cnt.zero_()
    return n


def _kernel_lib():
    from grab_tpu_torch import _build

    lib = _build.cuda_library("stridedfa")
    if lib.gt_stride_walk.argtypes is None:
        common = [
            ctypes.c_void_p,  # words (stream-major int32)
            ctypes.c_int64,  # word steps
            ctypes.c_void_p,  # flat table (device int32)
            ctypes.c_int,  # flat entries
            ctypes.c_void_p,  # byte index (device int32 [256])
            ctypes.c_int,  # k
            ctypes.c_int,  # m (runs or classes)
            ctypes.c_int,  # acc_bit
            ctypes.c_int,  # start state
        ]
        tail = [ctypes.c_int, ctypes.c_void_p]  # device index, stream
        lib.gt_stride_walk.restype = ctypes.c_int
        lib.gt_stride_walk.argtypes = common + [
            ctypes.c_void_p,  # entries
            ctypes.c_void_p,  # bm
            ctypes.c_void_p,  # exits
            ctypes.c_void_p,  # re-walked word counter
        ] + tail
        lib.gt_stride_fixpoint.restype = ctypes.c_int
        lib.gt_stride_fixpoint.argtypes = common + [
            ctypes.c_int,  # max rounds
            ctypes.c_void_p,  # entries scratch
            ctypes.c_void_p,  # checkpoint scratch
            ctypes.c_int64,  # its int32 words
            ctypes.c_void_p,  # bm
            ctypes.c_void_p,  # exits
            ctypes.c_void_p,  # state: [converged, walks run, 2 words of the kernel's]
            ctypes.c_void_p,  # re-walked word counter
            ctypes.c_int,  # grid cap (0: as many blocks as fit the card)
            ctypes.POINTER(ctypes.c_int),  # out: the grid launched
        ] + tail
        lib.gt_stride_ckpt_words.restype = ctypes.c_int64
        lib.gt_stride_ckpt_words.argtypes = [ctypes.c_int64]
        lib.gt_stride_link_cycles.restype = ctypes.c_int
        lib.gt_stride_link_cycles.argtypes = [ctypes.c_int, ctypes.c_void_p] + tail
    return lib


def link_cycles(device: torch.device, n_links: int = 1 << 16) -> float:
    """Measured SM clock cycles of one walk link (index arithmetic +
    dependent shared-memory load) on the card: the latency that bounds
    a stream's chain of S_w * 4/k links."""
    out = torch.zeros(2, dtype=torch.int64, device=device)
    err = _kernel_lib().gt_stride_link_cycles(n_links, out.data_ptr(), *_dev_tail(device))
    if err != 0:
        raise RuntimeError(f"link latency kernel launch failed: CUDA error {err}")
    return int(out[0].item()) / n_links


def _check_words(words2d_t: torch.Tensor) -> int:
    if words2d_t.dtype != torch.int32 or words2d_t.dim() != 2:
        raise ValueError(f"words must be 2-D int32, got {words2d_t.dtype} "
                         f"{tuple(words2d_t.shape)}")
    rows = words2d_t.shape[0]
    if words2d_t.shape[1] != LANES or rows <= 0 or rows % STREAM_ROWS:
        raise ValueError(f"words must be [S_w*{STREAM_ROWS}, {LANES}], "
                         f"got {tuple(words2d_t.shape)}")
    if words2d_t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {words2d_t.device}")
    if words2d_t.device.type == "cuda" and not words2d_t.is_contiguous():
        raise ValueError("words must be contiguous")
    return rows // STREAM_ROWS


def _launch_args(words2d_t, tables, s_w):
    flat, idx = tables.device_tables(words2d_t.device)
    return (
        words2d_t.data_ptr(), s_w, flat.data_ptr(), flat.numel(),
        idx.data_ptr(), tables.k, tables.m, tables.acc_bit, tables.start,
    )


def _dev_tail(dev: torch.device):
    return (
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )


def stride_dfa_scan(
    words2d_t: torch.Tensor, tables: StrideDfaTables, entries: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One walk → (bm int32 [rows/16, 128], exits int32 [128, 128]).

    CUDA tensors: one launch of csrc/stridedfa.cu on the current stream
    (counted in ``stride_dfa_scan.launches``); a refused launch raises.
    CPU tensors: the plain PyTorch walk."""
    s_w = _check_words(words2d_t)
    if (entries.dtype != torch.int32 or tuple(entries.shape) != (STREAM_ROWS, LANES)
            or entries.device != words2d_t.device):
        raise ValueError(f"entries must be int32 [{STREAM_ROWS}, {LANES}] on "
                         f"{words2d_t.device}")
    if words2d_t.device.type == "cpu":
        return stride_dfa_scan_torch(words2d_t, tables, entries)
    dev = words2d_t.device
    entries = entries.contiguous()
    bm = torch.empty((s_w * STREAM_ROWS // 16, LANES), dtype=torch.int32, device=dev)
    exits = torch.empty((STREAM_ROWS, LANES), dtype=torch.int32, device=dev)
    err = _kernel_lib().gt_stride_walk(
        *_launch_args(words2d_t, tables, s_w),
        entries.data_ptr(), bm.data_ptr(), exits.data_ptr(),
        _fixup_counter(dev).data_ptr(), *_dev_tail(dev),
    )
    if err != 0:
        raise RuntimeError(f"strided-DFA kernel launch failed: CUDA error {err}")
    stride_dfa_scan.launches += 1
    return bm, exits


stride_dfa_scan.launches = 0


def stride_dfa_fixpoint(words2d_t: torch.Tensor, tables: StrideDfaTables, *,
                        max_blocks: int = 0):
    """The threading fixpoint → (bm, walks run, converged), at most
    MAX_ROUNDS walks (read at call time).

    CUDA tensors: ONE cooperative launch of csrc/stridedfa.cu's
    fixpoint kernel on the current stream, with no stream operation
    before it and no host sync (counted in
    ``stride_dfa_fixpoint.launches``; ``stride_dfa_fixpoint.grid``: the
    last launch's blocks). Its grid walks, threads the exits into the
    next entries and stops on the card when they no longer change or
    after MAX_ROUNDS walks, then fills the bitmap with -1 if they still
    changed. The first walk keeps its checkpoints in a device scratch
    (``segment_geometry``), so a later walk re-walks only the streams
    whose entry changed, and only until they meet the last walk. The
    grid is as many walk blocks (at most 256) as the card holds at once,
    capped by ``max_blocks`` when that is positive (the card checks use
    it to drive the tile split: fewer blocks each walk more stream
    tiles); a card that holds none, or a refused launch, raises. Walks
    run and converged come back as device int32 scalars. CPU tensors:
    stride_fixpoint_torch."""
    s_w = _check_words(words2d_t)
    if words2d_t.device.type == "cpu":
        return stride_fixpoint_torch(words2d_t, tables, MAX_ROUNDS)
    dev = words2d_t.device
    bm = torch.empty((s_w * STREAM_ROWS // 16, LANES), dtype=torch.int32, device=dev)
    exits = torch.empty((STREAM_ROWS, LANES), dtype=torch.int32, device=dev)
    ent = torch.empty((STREAM_ROWS, LANES), dtype=torch.int32, device=dev)
    ckpt = torch.empty(segment_geometry(s_w)[3], dtype=torch.int32, device=dev)
    state = torch.empty(4, dtype=torch.int32, device=dev)
    grid = ctypes.c_int(0)
    err = _kernel_lib().gt_stride_fixpoint(
        *_launch_args(words2d_t, tables, s_w), MAX_ROUNDS,
        ent.data_ptr(), ckpt.data_ptr(), ckpt.numel(), bm.data_ptr(), exits.data_ptr(),
        state.data_ptr(), _fixup_counter(dev).data_ptr(), max_blocks,
        ctypes.byref(grid), *_dev_tail(dev),
    )
    if err != 0:
        raise RuntimeError(f"strided-DFA fixpoint launch failed: CUDA error {err}")
    stride_dfa_fixpoint.launches += 1
    stride_dfa_fixpoint.grid = grid.value
    return bm, state[1], state[0]


stride_dfa_fixpoint.launches = 0
stride_dfa_fixpoint.grid = None


# -- the relayout: stream rows → the walk's stream-major geometry -----------


def stride_transpose_torch(a: torch.Tensor, s_w: int) -> torch.Tensor:
    """Plain PyTorch relayout: int32 [N_STREAMS, s_w] → [s_w*128, 128]."""
    return a.t().contiguous().view(s_w * STREAM_ROWS, LANES)


def stride_transpose(a: torch.Tensor, s_w: int) -> torch.Tensor:
    """Stream-row words int32 [N_STREAMS, s_w] → the walk's geometry
    int32 [s_w*128, 128]: word g of stream (r, c) at row g*128 + r,
    lane c (s = r*128 + c). s_w must be a multiple of 32 (the scanner's
    strides give 32 or a multiple of 128).

    CUDA tensor: one launch of csrc/transpose.cu on the current stream
    (counted in ``stride_transpose.launches``); a refused launch raises.
    CPU tensor: the plain PyTorch version."""
    if a.dtype != torch.int32 or tuple(a.shape) != (N_STREAMS, s_w):
        raise ValueError(f"stream rows must be int32 [{N_STREAMS}, {s_w}], got "
                         f"{a.dtype} {tuple(a.shape)}")
    if s_w <= 0 or s_w % 32:
        raise ValueError(f"s_w must be a positive multiple of 32, got {s_w}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    if a.device.type == "cpu":
        return stride_transpose_torch(a, s_w)
    if not a.is_contiguous():
        raise ValueError("stream rows must be contiguous")
    out = torch.empty((s_w * STREAM_ROWS, LANES), dtype=torch.int32, device=a.device)
    err = _transpose_lib()(a.data_ptr(), out.data_ptr(), N_STREAMS, s_w, *_dev_tail(a.device))
    if err != 0:
        raise RuntimeError(f"stride transpose kernel launch failed: CUDA error {err}")
    stride_transpose.launches += 1
    return out


stride_transpose.launches = 0


def _transpose_lib():
    from grab_tpu_torch import _build

    fn = _build.cuda_library("transpose").gt_stride_transpose
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # stream rows
            ctypes.c_void_p,  # out
            ctypes.c_int,  # streams
            ctypes.c_int,  # s_w
            ctypes.c_int,  # device index
            ctypes.c_void_p,  # stream
        ]
    return fn


# -- the scanner ------------------------------------------------------------


class StrideDfaScanner:
    """A DFA over linear scan buffers: the buffer uploads born in the
    walk's stream-major layout (``prep_t``, the host's blocked
    transpose), the device runs the walk plus the window pass or the
    threading fixpoint (``run_t``), and the host decodes the bitmap into
    linear candidate block flags (``flags_np``)."""

    wants_transposed = True  # DeviceScanner uploads prep_t's layout for it

    def __init__(self, dfa, max_len, buf_size: int):
        plan = stride_plan(dfa)
        assert plan is not None
        self.tables = StrideDfaTables(dfa, plan)
        self.buf_size = buf_size
        self.max_len = max_len
        # window mode needs the match to cross at most one boundary and
        # the window to cover it: max_len <= HALO - 8 <= stride - 8
        self.window_mode = max_len is not None and max_len <= HALO - 8
        # stream geometry (the reference's): strides are multiples of
        # 4*W bytes, and strides above 128 bytes round to 512-byte
        # multiples
        unit = 4 * W
        per = (buf_size + N_STREAMS - 1) // N_STREAMS  # ceil: no tail loss
        stride = max(unit, (per + unit - 1) // unit * unit)
        if stride > 128:
            stride = (stride + 511) // 512 * 512
        self.stride = stride
        self.probe_back = 8
        self.probe_fwd = 8
        # boundary-window half-width in words: covers max_len + word
        # slop (wb*4 >= max_len + 4 is needed; +8 leaves margin)
        wb = 2
        if max_len is not None:
            while wb * 4 < min(max_len + 8, HALO) and wb < WIN_W // 2:
                wb *= 2
        self.win_wb = wb
        self._e0 = {}  # device → start entries

    @property
    def s_w(self) -> int:
        return self.stride // 4

    # -- host prep -------------------------------------------------------

    def prep(self, buf: np.ndarray) -> np.ndarray:
        """Linear uint8 buffer → int32 word vector of the walk's geometry
        (N_STREAMS * stride bytes: truncated or zero-padded)."""
        need = N_STREAMS * self.stride
        buf = np.asarray(buf)
        if buf.shape[0] < need:
            buf = np.concatenate([buf, np.zeros(need - buf.shape[0], dtype=np.uint8)])
        return buf[:need].view("<i4")

    def prep_t(self, buf: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
        """Linear uint8 buffer → int32 [S_w*128, 128], word g of stream
        (r, c) at row g*128 + r (stream s = r*128 + c = linear bytes
        [s*stride, (s+1)*stride)), by the blocked multithreaded host
        transpose. ``out`` (int32 [S_w, N_STREAMS], e.g. a pinned
        staging buffer) receives the result in place."""
        from grab_tpu_torch.ingest.native import transpose_stream_rows

        a2 = self.prep(buf).reshape(N_STREAMS, self.s_w)
        return transpose_stream_rows(a2, out=out).reshape(self.s_w * STREAM_ROWS, LANES)

    # -- device ------------------------------------------------------------

    def _start_entries(self, device: torch.device) -> torch.Tensor:
        key = str(device)
        if key not in self._e0:
            self._e0[key] = torch.full(
                (STREAM_ROWS, LANES), self.tables.start, dtype=torch.int32,
                device=device,
            )
        return self._e0[key]

    def windows_t(self, w2d: torch.Tensor) -> torch.Tensor:
        """Boundary windows straight from the transposed buffer: window s
        = linear bytes [(s+1)*stride - 4*wb, (s+1)*stride + 4*wb)
        (zero past the buffer end). The last wb words of every stream
        are the trailing wb*128 rows; the first wb words are the leading
        wb*128 rows shifted down one stream."""
        wb = self.win_wb
        w1 = w2d[(self.s_w - wb) * STREAM_ROWS :]
        head = w2d[: wb * STREAM_ROWS].reshape(wb, N_STREAMS)
        w2 = torch.cat([head[:, 1:], head.new_zeros((wb, 1))], dim=1)
        return torch.cat([w1, w2.reshape(wb * STREAM_ROWS, LANES)], dim=0)

    def run_t(self, w2d: torch.Tensor):
        """w2d: int32 [S_w*128, 128] in the walk's geometry, on its
        device → (bm, walks run, converged). In window mode bm is the
        main bitmap with the window pass's rows below it (flags_np
        splits them)."""
        if w2d.shape != (self.s_w * STREAM_ROWS, LANES):
            raise ValueError(f"expected [{self.s_w * STREAM_ROWS}, {LANES}] words, "
                             f"got {tuple(w2d.shape)}")
        if self.window_mode:
            e0 = self._start_entries(w2d.device)
            bm, _ = stride_dfa_scan(w2d, self.tables, e0)
            bmw, _ = stride_dfa_scan(self.windows_t(w2d), self.tables, e0)
            return torch.cat([bm, bmw], dim=0), 1, True
        return stride_dfa_fixpoint(w2d, self.tables)

    def run2d(self, a: torch.Tensor):
        """a: int32 [N_STREAMS, S_w] stream rows on their device: the
        device-side relayout entry, for a buffer that shares its upload
        with word-kernel members and so arrives in linear layout."""
        return self.run_t(stride_transpose(a, self.s_w))

    def run(self, words: torch.Tensor):
        """words: 1-D int32, the linear buffer's first N_STREAMS * S_w
        words (``prep``'s geometry) on their device → as ``run_t``."""
        need = N_STREAMS * self.s_w
        if words.dim() != 1 or words.shape[0] < need:
            raise ValueError(f"expected at least {need} linear words, got "
                             f"{tuple(words.shape)}")
        return self.run2d(words[:need].reshape(N_STREAMS, self.s_w))

    @staticmethod
    def _counted(bm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return torch.count_nonzero(bm).to(torch.int32).reshape(1), bm

    def packed_t(self, w2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (total int32 [1]: nonzero bitmap words, bm) on w2d's device."""
        return self._counted(self.run_t(w2d)[0])

    def packed(self, words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``packed_t`` for linear words (see ``run``)."""
        return self._counted(self.run(words)[0])

    # -- host decode -------------------------------------------------------

    def _decode(self, bm, n_blocks, pos_of) -> np.ndarray:
        """Bitmap → block flags; ``pos_of(g, r, lane)`` maps a transposed
        hit row to its linear byte position."""
        flags = np.zeros(n_blocks, dtype=np.int32)
        gr, c = np.nonzero(bm)
        if gr.size == 0:
            return flags
        bits = bm[gr, c]  # [K] uint32
        sel = ((bits[:, None] >> np.arange(16, dtype=np.uint32)) & 1) != 0
        rows = (gr[:, None] * 16 + np.arange(16))[sel]  # g*128 + r
        lanes = np.broadcast_to(c[:, None], sel.shape)[sel]
        g, r = np.divmod(rows, STREAM_ROWS)
        pos = pos_of(g, r, lanes)
        lo = np.maximum(0, (pos - self.probe_back) // BLOCK)
        hi = np.minimum(n_blocks - 1, (pos + 4 + self.probe_fwd) // BLOCK)
        keep = (lo < n_blocks) & (hi >= 0)
        lo, hi = lo[keep], hi[keep]
        span = int((hi - lo).max(initial=0))
        for s_ in range(span + 1):
            idx = lo + s_
            flags[idx[idx <= hi]] = 1
        return flags

    def flags_np(self, bm, n_blocks: int) -> np.ndarray:
        """Transposed hit bitmap → linear candidate block flags (the
        window pass's rows, if present, decode through their boundary
        map and union in)."""
        bm = np.asarray(bm).view(np.uint32)
        main_rows = self.s_w * STREAM_ROWS // 16
        stride = self.stride
        flags = self._decode(
            bm[:main_rows],
            n_blocks,
            lambda g, r, lanes: (r * LANES + lanes) * stride + 4 * g,
        )
        if bm.shape[0] > main_rows:
            wb4 = self.win_wb * 4
            wflags = self._decode(
                bm[main_rows:],
                n_blocks,
                lambda g, r, lanes: (r * LANES + lanes + 1) * stride - wb4 + 4 * g,
            )
            np.maximum(flags, wflags, out=flags)
        return flags
