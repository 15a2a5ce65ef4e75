"""Class-sequence prefilter: the standalone class_seq tier's word kernel.

A pattern's matches must begin with one of a small set of byte-class
sequences (the compiler's ``class_seqs``); byte position i is a
candidate when, for some sequence, byte i + j lies in class j for
every j. Classes are unions of inclusive byte ranges. The scan marks
the aligned int32 word holding each candidate start and reports which
512-byte blocks hold one, with the same output geometry and host decode
as the core-word prefilter (ops/corewords.py): row bitmap bm int32
[rows/32, 128], packed int32 [rows/32] and total int32 [1].

``classseq_flags`` is the entry point: on a CUDA tensor it launches the
hand-written kernel csrc/classseq.cu (or raises); on a CPU tensor it
runs the plain PyTorch version below, which the tests hold against the
JAX package's kernel (grab_tpu/ops/pallas_classseq.py) and its numpy
oracle.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from grab_tpu_torch.ops.corewords import (
    LANES,
    PAD_ROWS,
    bitmap_rows_torch,
    check_words,
    counted_launch_args,
    decode_packed_flags,
    packed_block_flags,
)
from grab_tpu_torch.regex.ast import mask_to_ranges

PREFIX_CAP = 8  # classes per sequence
MAX_SEQS = 32  # the compiler drops larger sequence sets
MAX_RANGES = 8  # mask_to_ranges' cap per class

# A compiled sequence set: tuple of sequences; each sequence is a tuple
# of classes; each class is a tuple of (lo, hi) inclusive byte ranges.
CompiledSeqs = Tuple[Tuple[Tuple[Tuple[int, int], ...], ...], ...]


def compile_sequences(mask_seqs: Sequence[Sequence[int]]) -> CompiledSeqs:
    """256-bit mask sequences → hashable range-test structure (capped at
    PREFIX_CAP classes)."""
    out = []
    for seq in mask_seqs:
        atoms = []
        for mask in list(seq)[:PREFIX_CAP]:
            atoms.append(tuple(mask_to_ranges(mask)))
        out.append(tuple(atoms))
    return tuple(out)


def seq_span(seqs: CompiledSeqs) -> int:
    return max(len(s) for s in seqs)


def _check_seqs(seqs: CompiledSeqs) -> None:
    if not seqs or len(seqs) > MAX_SEQS:
        raise ValueError(f"need 1..{MAX_SEQS} sequences, got {len(seqs)}")
    for seq in seqs:
        if not seq or len(seq) > PREFIX_CAP:
            raise ValueError(f"sequence of {len(seq)} classes (1..{PREFIX_CAP})")
        for ranges in seq:
            if not ranges or len(ranges) > MAX_RANGES:
                raise ValueError(f"class of {len(ranges)} ranges (1..{MAX_RANGES})")


def classseq_bitmap_torch(words2d: torch.Tensor, seqs: CompiledSeqs) -> torch.Tensor:
    """Plain PyTorch version of the kernel's row bitmap: int32
    [rows + PAD_ROWS, 128] words → int32 [rows/32, 128]. Per byte start
    position, AND over the sequence's classes of the range tests on the
    following bytes (reading into the zero pad rows past the end), OR
    over sequences; a word hits when any of its 4 start bytes does."""
    rows = words2d.shape[0] - PAD_ROWS
    n = rows * LANES * 4
    data = words2d.contiguous().view(torch.uint8).reshape(-1)  # little-endian
    hit_b = torch.zeros(n, dtype=torch.bool, device=words2d.device)
    for seq in seqs:
        eq = torch.ones(n, dtype=torch.bool, device=words2d.device)
        for j, ranges in enumerate(seq):
            b = data[j : n + j]
            t = torch.zeros(n, dtype=torch.bool, device=words2d.device)
            for lo, hi in ranges:
                t |= (b >= lo) & (b <= hi)
            eq &= t
        hit_b |= eq
    hit_w = hit_b.view(rows * LANES, 4).any(dim=1)
    return bitmap_rows_torch(hit_w.view(rows, LANES))


def swar_bound(b: int) -> Tuple[int, int]:
    """The kernels' 4-byte compare constants for "byte >= b" (0 <= b <=
    256, csrc/swar.cuh Bound): (add, keep) with add = (128 - b) *
    0x01010101, keep = ~0 for b <= 128, else add = (256 - b) *
    0x01010101, keep = 0."""
    if b <= 128:
        return (128 - b) * 0x01010101, 0xFFFFFFFF
    return (256 - b) * 0x01010101, 0


def swar_bounds(b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """swar_bound for an array of bounds at once: → (add uint32, keep
    bool)."""
    b = np.asarray(b, dtype=np.int64)
    keep = b <= 128
    add = np.where(keep, 128 - b, 256 - b) * 0x01010101
    return add.astype(np.uint32), keep


PARAM_CAPS = (1, 8)  # sequence counts of the SWAR form csrc/classseq.cu is built for


def _params_layout(cap: int):
    """(field, dtype, shape) of csrc/classseq.cu SeqParams<cap>, in order."""
    return [
        ("head", "<i4", (2,)),  # n_seqs, span
        ("add", "<u4", (cap, PREFIX_CAP, MAX_RANGES, 2)),
        ("keep", "<u2", (cap, PREFIX_CAP)),
        ("n_ranges", "u1", (cap, PREFIX_CAP)),
        ("len", "u1", (cap,)),
    ]


def params_bytes(cap: int) -> int:
    n = sum(np.dtype(dt).itemsize * int(np.prod(shape)) for _, dt, shape in _params_layout(cap))
    return (n + 3) & ~3


def params_fields(params: np.ndarray) -> dict:
    """Views of the fields of SeqParams bytes, by name."""
    cap = next(c for c in PARAM_CAPS if params_bytes(c) == params.size)
    out, off = {}, 0
    for name, dt, shape in _params_layout(cap):
        n = np.dtype(dt).itemsize * int(np.prod(shape))
        out[name] = params[off : off + n].view(dt).reshape(shape)
        off += n
    return out


@functools.lru_cache(maxsize=64)
def seq_params(seqs: CompiledSeqs) -> np.ndarray:
    """The B4 SWAR kernel's descriptor (csrc/classseq.cu SeqParams<cap>,
    cap 1 or 8, the least that holds the set), as uint8 bytes handed to
    the launch as a kernel parameter. The SWAR constants of every range's
    bounds lo and hi + 1 are made here: add words, and keep flags as bits
    2t and 2t + 1 of a per-class mask."""
    _check_seqs(seqs)
    if len(seqs) > PARAM_CAPS[-1]:
        raise ValueError(f"the SWAR form takes 1..{PARAM_CAPS[-1]} sequences, got {len(seqs)}")
    cap = next(c for c in PARAM_CAPS if len(seqs) <= c)
    out = np.zeros(params_bytes(cap), np.uint8)
    f = params_fields(out)
    f["head"][:] = (len(seqs), seq_span(seqs))
    for s, seq in enumerate(seqs):
        f["len"][s] = len(seq)
        for j, ranges in enumerate(seq):
            f["n_ranges"][s, j] = len(ranges)
            bounds = np.array(ranges, dtype=np.int64) + (0, 1)  # lo, hi + 1
            add, keep = swar_bounds(bounds)
            f["add"][s, j, : len(ranges)] = add
            f["keep"][s, j] = int((keep.reshape(-1).astype(np.int64) << np.arange(keep.size)).sum())
    out.flags.writeable = False
    return out


TABLE_MIN_SEQS = PARAM_CAPS[-1] + 1  # larger sets go to the table kernel


@functools.lru_cache(maxsize=64)
def seq_tables(seqs: CompiledSeqs) -> np.ndarray:
    """The B4 kernel's table form (csrc/classseq.cu SeqTables) as uint8
    bytes handed to the launch as a kernel parameter: int32 span, int32
    n_seqs, then uint32 t[8][256], where bit s of t[j][b] is set when byte
    b lies in class j of sequence s or j is past the sequence's end."""
    _check_seqs(seqs)
    t = np.zeros((PREFIX_CAP, 256), np.uint32)
    for s, seq in enumerate(seqs):
        bit = np.uint32(1 << s)
        t[len(seq) :] |= bit
        for j, ranges in enumerate(seq):
            for lo, hi in ranges:
                t[j, lo : hi + 1] |= bit
    head = np.array([seq_span(seqs), len(seqs)], dtype="<i4").view(np.uint8)
    out = np.concatenate([head, t.astype("<u4").reshape(-1).view(np.uint8)])
    out.flags.writeable = False
    return out


def kernel_descriptor(seqs: CompiledSeqs) -> np.ndarray:
    """What classseq_flags hands the kernel: the table form for
    TABLE_MIN_SEQS sequences or more, else the SWAR constants."""
    return seq_tables(seqs) if len(seqs) >= TABLE_MIN_SEQS else seq_params(seqs)


def classseq_bitmap_kernel(words2d: torch.Tensor, seqs: CompiledSeqs) -> torch.Tensor:
    """The arithmetic of the form the kernel runs for ``seqs`` (the
    tables from TABLE_MIN_SEQS sequences, else the SWAR compares)."""
    if len(seqs) >= TABLE_MIN_SEQS:
        return classseq_bitmap_tables(words2d, seqs)
    return classseq_bitmap_swar(words2d, seqs)


def classseq_bitmap_tables(words2d: torch.Tensor, seqs: CompiledSeqs) -> torch.Tensor:
    """The table kernel's arithmetic in PyTorch, reading seq_tables'
    bytes: per start byte, the AND over the classes of the table entries
    of the bytes that follow, a hit when any sequence bit is left →
    int32 [rows/32, 128]."""
    raw = seq_tables(seqs)
    span = int(raw[:4].view("<i4")[0])
    t = torch.from_numpy(raw[8:].view("<u4").astype(np.int64).reshape(PREFIX_CAP, 256))
    t = t.to(words2d.device)
    rows = words2d.shape[0] - PAD_ROWS
    n = rows * LANES * 4
    data = words2d.contiguous().view(torch.uint8).reshape(-1).to(torch.int64)
    alive = t[0][data[:n]]
    for j in range(1, span):
        alive &= t[j][data[j : n + j]]
    hit_w = (alive != 0).view(rows * LANES, 4).any(dim=1)
    return bitmap_rows_torch(hit_w.view(rows, LANES))


def seq_descriptor(seqs: CompiledSeqs) -> np.ndarray:
    """The fused kernel's SeqDesc bytes (csrc/classseq_test.cuh): int32
    n_seqs, int32 span, then uint8 len[32], n_ranges[32][8],
    lo[32][8][8], hi[32][8][8]."""
    _check_seqs(seqs)
    lens = np.zeros(MAX_SEQS, np.uint8)
    n_rng = np.zeros((MAX_SEQS, PREFIX_CAP), np.uint8)
    lo = np.zeros((MAX_SEQS, PREFIX_CAP, MAX_RANGES), np.uint8)
    hi = np.zeros((MAX_SEQS, PREFIX_CAP, MAX_RANGES), np.uint8)
    for s, seq in enumerate(seqs):
        lens[s] = len(seq)
        for j, ranges in enumerate(seq):
            n_rng[s, j] = len(ranges)
            for t, (a, b) in enumerate(ranges):
                lo[s, j, t], hi[s, j, t] = a, b
    head = np.array([len(seqs), seq_span(seqs)], dtype="<i4").view(np.uint8)
    return np.concatenate(
        [head, lens, n_rng.reshape(-1), lo.reshape(-1), hi.reshape(-1)]
    )


def classseq_bitmap_swar(words2d: torch.Tensor, seqs: CompiledSeqs) -> torch.Tensor:
    """The kernel's own arithmetic in PyTorch (4 phases per int32, the
    SWAR compares with the constants read back from seq_params' bytes,
    early exits dropped as they change no result), for the tests to hold
    it to the byte-wise plain version on the CPU: → int32 [rows/32, 128]."""
    f = params_fields(seq_params(seqs))
    rows = words2d.shape[0] - PAD_ROWS
    flat = words2d.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    n = rows * LANES
    w = [flat[k : n + k] for k in range(3)]
    hit = torch.zeros(n, dtype=torch.bool, device=words2d.device)
    for s in range(int(f["head"][0])):
        alive = torch.full((n,), 0x80808080, dtype=torch.int64, device=words2d.device)
        for j in range(int(f["len"][s])):
            lo_w, hi_w = (w[0], w[1]) if j < 4 else (w[1], w[2])
            sh = 8 * (j & 3)
            x = ((lo_w >> sh) | (hi_w << (32 - sh))) & 0xFFFFFFFF if sh else lo_w
            xl = x & 0x7F7F7F7F
            m = torch.zeros_like(x)
            keep_bits = int(f["keep"][s, j])
            for t in range(int(f["n_ranges"][s, j])):
                ge = []
                for e in range(2):  # lo, hi + 1
                    add = int(f["add"][s, j, t, e])
                    keep = 0xFFFFFFFF if (keep_bits >> (2 * t + e)) & 1 else 0
                    u = (xl + add) & 0xFFFFFFFF
                    ge.append((u & (x | keep)) | (x & keep))
                m |= ge[0] & ~ge[1]
            alive &= m & 0x80808080
        hit |= alive != 0
    return bitmap_rows_torch(hit.view(rows, LANES))


@functools.lru_cache(maxsize=64)
def _pinned_descriptor(seqs: CompiledSeqs) -> torch.Tensor:
    """Pinned host copy of the fused kernel's descriptor, so its copy into
    __constant__ memory is asynchronous; kept for the process's life."""
    return torch.from_numpy(seq_descriptor(seqs)).pin_memory()


def _kernel_lib():
    from grab_tpu_torch import _build

    lib = _build.cuda_library("classseq")
    fn = lib.gt_classseq_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # words
            ctypes.c_void_p,  # host SeqParams or SeqTables bytes
            ctypes.c_int64,  # their size
            ctypes.c_int64,  # groups
            ctypes.c_void_p,  # bm
            ctypes.c_void_p,  # packed
            ctypes.c_void_p,  # total
            ctypes.c_void_p,  # count scratch of the stream
            ctypes.c_int,  # device index
            ctypes.c_void_p,  # stream
        ]
    return fn


def classseq_flags(
    words2d: torch.Tensor, seqs: CompiledSeqs
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (total int32 [1], packed int32 [rows/32], bm int32 [rows/32, 128]).

    CUDA tensor: one launch of csrc/classseq.cu on the current stream
    (counted in ``classseq_flags.launches``); a refused launch raises.
    CPU tensor: the plain PyTorch version."""
    rows = check_words(words2d)
    _check_seqs(seqs)
    if words2d.device.type == "cpu":
        bm = classseq_bitmap_torch(words2d, seqs)
        total, packed = packed_block_flags(bm)
        return total, packed, bm
    if words2d.data_ptr() % 16:
        raise ValueError("words2d must be 16-byte aligned on the card")
    desc = kernel_descriptor(seqs)
    outs, tail = counted_launch_args(rows, words2d.device)
    err = _kernel_lib()(words2d.data_ptr(), desc.ctypes.data, desc.size, *tail)
    if err != 0:
        raise RuntimeError(f"class-sequence kernel launch failed: CUDA error {err}")
    classseq_flags.launches += 1
    return outs


classseq_flags.launches = 0


class ClassSeqScanner:
    """Sequences → per-buffer (total, packed block flags) on the tensor's
    device + host decode, the same contract as CoreWordScanner. The
    reference's VMEM tile guard (pick_tile_rows) has no counterpart:
    the kernel keeps no tile in fast memory."""

    def __init__(self, seqs: CompiledSeqs):
        _check_seqs(seqs)
        self.seqs = seqs
        self.probe_back = 4  # the start byte is inside the flagged word
        self.probe_fwd = seq_span(seqs) + 8

    def packed(self, words2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        total, packed, _bm = classseq_flags(words2d, self.seqs)
        return total, packed

    def flags_np(self, packed, n_blocks: int) -> np.ndarray:
        return decode_packed_flags(
            packed, n_blocks, self.probe_back, self.probe_fwd
        )
