"""Bloom core-word prefilter: a multi-pattern literal scan whose cost
per word does not grow with the number of literals.

Every literal of 7+ bytes contributes, for each of the 4 byte phases,
one aligned int32 word that lies wholly inside it (``_phase_words``).
Each such key sets one bit in each of L independent 4096-bit tables
(128 words of 32 bits); a buffer word x passes when every level's bit
is set:

    per level:  h = x * C_l mod 2^32
                bit = (tbl[l][h >> 25] >> ((h >> 20) & 31)) & 1
    hit(x) = AND over levels

L is chosen from the key count so that the false-positive rate per word
stays near 1e-5 (3 / 5 / 6 levels for 5 / 100 / 1000 literals; at 1000
literals the tables are nearly full and most words pass). The host
verifier restores exactness, as for the compare kernel.

The construction is the JAX package's (grab_tpu/ops/pallas_bloom.py),
unchanged in every step that decides the table: ``BloomWordTests``
fields equal the reference's bit for bit. Output geometry and decode
are the core-word prefilter's (ops/corewords.py).

``bloom_word_flags`` is the entry point: on a CUDA tensor it launches
the hand-written kernel csrc/bloom.cu (or raises); on a CPU tensor it
runs the plain PyTorch version below, which the tests hold against the
reference's kernel and its numpy oracle.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from grab_tpu_torch.ops.corewords import (
    LANES,
    PAD_ROWS,
    bitmap_rows_torch,
    check_words,
    decode_packed_flags,
    launch_args,
    packed_block_flags,
)

# independent odd multipliers (Knuth/golden-ratio family)
_HASH_CONSTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1, 0x9E3779B9)
MAX_LEVELS = len(_HASH_CONSTS)
TBL_BITS = 4096  # 128 lanes x 32 bits per level


def _hashes(word: int, level: int) -> Tuple[int, int]:
    x = (word * _HASH_CONSTS[level]) & 0xFFFFFFFF
    return (x >> 25) & 127, (x >> 20) & 31


def _phase_words(lit: bytes) -> list:
    """One full aligned core word per phase (requires len >= 7)."""
    assert len(lit) >= 7
    out = []
    for p in range(4):
        # word j=1 covers literal bytes [4-p, 8-p) for p>0; j=0 covers
        # [0,4) for p=0 — both fully inside for len >= 7
        j = 0 if p == 0 else 1
        lo = 4 * j - p
        out.append((j, int.from_bytes(lit[lo : lo + 4], "little")))
    return out


class BloomWordTests:
    """K literals -> bloom tables + decode slack."""

    def __init__(self, literals: Sequence[bytes], fp_word: float = 1e-5):
        lits = [bytes(l) for l in literals]
        assert lits and all(len(l) >= 7 for l in lits), "bloom needs len>=7"
        self.literals = lits
        keys = set()
        max_back = 0
        maxlen = max(len(l) for l in lits)
        for lit in lits:
            for j, w in _phase_words(lit):
                keys.add(w)
                max_back = max(max_back, 4 * j + 3)
        # levels: fp ~= (|keys|/TBL_BITS)^L  (independent hashes)
        per = max(len(keys) / TBL_BITS, 1e-9)
        levels = 1
        while per**levels > fp_word and levels < MAX_LEVELS:
            levels += 1
        self.levels = levels
        tbl = np.zeros((levels, LANES), dtype=np.uint32)
        for w in keys:
            for l in range(levels):
                h1, h2 = _hashes(w, l)
                tbl[l, h1] |= np.uint32(1) << np.uint32(h2)
        self.tbl = tbl.view(np.int32)
        self.n_keys = len(keys)
        self.probe_back = max_back + maxlen
        self.probe_fwd = maxlen + 8
        self._dev = {}  # device → table tensor

    def device_table(self, device: torch.device) -> torch.Tensor:
        """``tbl`` on ``device``, uploaded once per device."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(self.tbl).to(device)
        return self._dev[key]


def bloom_member_torch(x: torch.Tensor, tbl: torch.Tensor, levels: int) -> torch.Tensor:
    """bool, shape of x: the filter's test on int32 words. An int32
    multiply wraps to the same low 32 bits as the unsigned one; the
    arithmetic shifts are made logical by masking to 7 and 5 bits, and
    only bit 0 of the shifted table word is kept."""
    hit = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    for l in range(levels):
        c = _HASH_CONSTS[l]
        c32 = c - (1 << 32) if c >= 1 << 31 else c  # the same bits, signed
        h = x * c32
        slot = (h >> 25) & 0x7F
        bit = (h >> 20) & 31
        hit &= ((tbl[l][slot.long()] >> bit) & 1) != 0
    return hit


def bloom_bitmap_torch(words2d: torch.Tensor, tbl: np.ndarray, levels: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's row bitmap: int32
    [rows + PAD_ROWS, 128] words (the pad rows are not read) → int32
    [rows/32, 128]."""
    rows = words2d.shape[0] - PAD_ROWS
    t = torch.from_numpy(np.ascontiguousarray(tbl, dtype=np.int32)).to(words2d.device)
    return bitmap_rows_torch(bloom_member_torch(words2d[:rows], t, levels))


def _kernel_lib():
    from grab_tpu_torch import _build

    lib = _build.cuda_library("bloom")
    fn = lib.gt_bloom_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # words
            ctypes.c_void_p,  # device table
            ctypes.c_int,  # levels
            ctypes.c_int64,  # groups
            ctypes.c_void_p,  # bm
            ctypes.c_void_p,  # packed
            ctypes.c_void_p,  # total
            ctypes.c_int,  # device index
            ctypes.c_void_p,  # stream
        ]
    return fn


def bloom_word_flags(
    words2d: torch.Tensor, tests: BloomWordTests
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (total int32 [1], packed int32 [rows/32], bm int32 [rows/32, 128]).

    CUDA tensor: one launch of csrc/bloom.cu on the current stream
    (counted in ``bloom_word_flags.launches``); a refused launch raises.
    CPU tensor: the plain PyTorch version."""
    rows = check_words(words2d)
    if words2d.device.type == "cpu":
        bm = bloom_bitmap_torch(words2d, tests.tbl, tests.levels)
        total, packed = packed_block_flags(bm)
        return total, packed, bm
    tbl = tests.device_table(words2d.device)
    outs, tail = launch_args(rows, words2d.device)
    err = _kernel_lib()(words2d.data_ptr(), tbl.data_ptr(), tests.levels, *tail)
    if err != 0:
        raise RuntimeError(f"bloom kernel launch failed: CUDA error {err}")
    bloom_word_flags.launches += 1
    return outs


bloom_word_flags.launches = 0


class BloomWordScanner:
    """Long literals → per-buffer (total, packed block flags) on the
    tensor's device + host decode, the same contract as CoreWordScanner."""

    def __init__(self, literals: Sequence[bytes]):
        self.tests = BloomWordTests(literals)

    def bitmap(self, words2d: torch.Tensor) -> torch.Tensor:
        """The row bitmap int32 [rows/32, 128] on the tensor's device."""
        return bloom_word_flags(words2d, self.tests)[2]

    def packed(self, words2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        total, packed, _bm = bloom_word_flags(words2d, self.tests)
        return total, packed

    def flags_np(self, packed, n_blocks: int) -> np.ndarray:
        return decode_packed_flags(
            packed, n_blocks, self.tests.probe_back, self.tests.probe_fwd
        )
