"""Fused literal/class-sequence ensemble: every word member's test in
ONE pass over the scan buffer.

A ``-H`` batch of literals and regexes compiles to an ensemble: compare
buckets of up to 16 literals each (ops/corewords.py), an XOR filter over
the 7+-byte literals once there are more than 4 of them
(ops/xorfilter.py), and class sequences (ops/classseq.py). Run one by
one, every member reads the whole buffer again; the fused scan reads it
once and ORs the members' tests into one row bitmap. The union is sound:
the members' decoded flags are unioned on the host anyway, and the
fused scanner decodes with the largest probe slack of its members.

``FusedEnsembleScanner`` splits the literals as the JAX package's does
(grab_tpu/ops/pallas_fused.py), so the compare tables, the filter and
the probes equal the reference's. Output geometry and decode are the
core-word prefilter's.

``fused_word_flags`` is the entry point: on a CUDA tensor it launches
the hand-written kernel csrc/fused.cu (or raises); on a CPU tensor it
runs the plain PyTorch version below (the OR of the members' plain
versions), which the tests hold against the reference's kernel and its
numpy oracle.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from grab_tpu_torch.ops.classseq import (
    CompiledSeqs,
    _check_seqs,
    _pinned_descriptor,
    classseq_bitmap_torch,
    seq_span,
)
from grab_tpu_torch.ops.corewords import (
    CoreWordTests,
    check_words,
    core_word_bitmap_torch,
    decode_packed_flags,
    launch_args,
    packed_block_flags,
)
from grab_tpu_torch.ops.xorfilter import XorWordTests, xor_bitmap_torch

HEADER_WORDS = 4  # csrc/fused.cu kHeader


def fused_program(
    cw_tests: Sequence[CoreWordTests], xor: Optional[XorWordTests],
    seqs: Optional[CompiledSeqs],
) -> np.ndarray:
    """The kernel's input (csrc/fused.cu), int32: [n_buckets, offset of
    the XOR program or 0, word planes read, 1 with class sequences],
    then per bucket [k, n_words, masked, offset of its table], the
    tables [2, 4, k, n_words] and the XOR program."""
    planes = max([t.n_words for t in cw_tests] + [1])
    if seqs:
        planes = max(planes, (3 + seq_span(seqs) + 3) // 4)
    heads, tabs = [], []
    pos = HEADER_WORDS + 4 * len(cw_tests)
    for t in cw_tests:
        heads += [t.k, t.n_words, int(t.masked), pos]
        tab = np.ascontiguousarray(t.tab, dtype=np.int32).reshape(-1)
        tabs.append(tab)
        pos += tab.size
    parts = [np.array([len(cw_tests), pos if xor else 0, planes, int(bool(seqs))]
                      + heads, dtype=np.int32)] + tabs
    if xor:
        parts.append(xor.program())
    return np.concatenate(parts)


class FusedEnsembleScanner:
    """The whole literal/class-sequence ensemble as one single-pass
    scan, with the member scanners' packed/flags_np contract, so
    DeviceScanner treats it as one member."""

    MAX_BUCKET = 16  # compare-bucket width (ops cost is K-linear)

    def __init__(self, literals: Sequence[bytes], seqs: Optional[CompiledSeqs] = None):
        lits = [bytes(l) for l in literals]
        longs = [l for l in lits if len(l) >= 7]
        shorts = [l for l in lits if len(l) < 7]
        self.xor: Optional[XorWordTests] = None
        if len(longs) > 4:
            self.xor = XorWordTests(longs)
        else:
            shorts += longs
        self.cw_tests: List[CoreWordTests] = []
        for i in range(0, len(shorts), self.MAX_BUCKET):
            self.cw_tests.append(CoreWordTests(shorts[i : i + self.MAX_BUCKET]))
        self.seqs = seqs if seqs else None
        if self.seqs:
            _check_seqs(self.seqs)
        self.cw_shapes = tuple((t.k, t.n_words, t.masked) for t in self.cw_tests)
        self.xor_groups = self.xor.consts() if self.xor else ()
        self.probe_back = max(
            [t.probe_back for t in self.cw_tests]
            + ([self.xor.probe_back] if self.xor else [])
            + ([4] if self.seqs else [0])
        )
        self.probe_fwd = max(
            [t.probe_fwd for t in self.cw_tests]
            + ([self.xor.probe_fwd] if self.xor else [])
            + ([seq_span(self.seqs) + 8] if self.seqs else [0])
        )
        self._program = None  # the kernel's input, built at first use
        self._dev = {}  # device → program tensor

    @property
    def n_members(self) -> int:
        return (
            len(self.cw_tests) + (1 if self.xor else 0) + (1 if self.seqs else 0)
        )

    def program(self) -> np.ndarray:
        if self._program is None:
            self._program = fused_program(self.cw_tests, self.xor, self.seqs)
        return self._program

    def device_program(self, device: torch.device) -> torch.Tensor:
        """``program()`` on ``device``, uploaded once per device."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(self.program()).to(device)
        return self._dev[key]

    def packed(self, words2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        total, packed, _bm = fused_word_flags(words2d, self)
        return total, packed

    def flags_np(self, packed, n_blocks: int) -> np.ndarray:
        return decode_packed_flags(
            packed, n_blocks, self.probe_back, self.probe_fwd
        )


def fused_bitmap_torch(words2d: torch.Tensor, sc: FusedEnsembleScanner) -> torch.Tensor:
    """Plain PyTorch version of the kernel's row bitmap: the OR of the
    members' plain bitmaps (identical geometry) → int32 [rows/32, 128]."""
    parts = [
        core_word_bitmap_torch(words2d, t.tab, t.k, t.n_words, t.masked)
        for t in sc.cw_tests
    ]
    if sc.xor:
        parts.append(xor_bitmap_torch(words2d, sc.xor.tables(), sc.xor.consts()))
    if sc.seqs:
        parts.append(classseq_bitmap_torch(words2d, sc.seqs))
    if not parts:
        raise ValueError("fused ensemble without a member")
    bm = parts[0]
    for b in parts[1:]:
        bm = bm | b
    return bm


def _kernel_lib():
    from grab_tpu_torch import _build

    lib = _build.cuda_library("fused")
    fn = lib.gt_fused_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # words
            ctypes.c_void_p,  # device program
            ctypes.c_void_p,  # the same program on the host
            ctypes.c_int64,  # program words
            ctypes.c_void_p,  # pinned host SeqDesc, or null
            ctypes.c_int64,  # descriptor bytes
            ctypes.c_int64,  # groups
            ctypes.c_void_p,  # bm
            ctypes.c_void_p,  # packed
            ctypes.c_void_p,  # total
            ctypes.c_int,  # device index
            ctypes.c_void_p,  # stream
        ]
    return fn


def fused_word_flags(
    words2d: torch.Tensor, sc: FusedEnsembleScanner
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (total int32 [1], packed int32 [rows/32], bm int32 [rows/32, 128]).

    CUDA tensor: one launch of csrc/fused.cu on the current stream
    (counted in ``fused_word_flags.launches``); a refused launch raises.
    CPU tensor: the plain PyTorch version."""
    rows = check_words(words2d)
    if sc.n_members < 1:
        raise ValueError("fused ensemble without a member")
    if words2d.device.type == "cpu":
        bm = fused_bitmap_torch(words2d, sc)
        total, packed = packed_block_flags(bm)
        return total, packed, bm
    host = sc.program()
    prog = sc.device_program(words2d.device)
    desc = _pinned_descriptor(sc.seqs) if sc.seqs else None
    outs, tail = launch_args(rows, words2d.device)
    err = _kernel_lib()(
        words2d.data_ptr(), prog.data_ptr(), host.ctypes.data, host.size,
        desc.data_ptr() if desc is not None else None,
        desc.numel() if desc is not None else 0, *tail
    )
    if err != 0:
        raise RuntimeError(f"fused ensemble kernel launch failed: CUDA error {err}")
    fused_word_flags.launches += 1
    return outs


fused_word_flags.launches = 0
