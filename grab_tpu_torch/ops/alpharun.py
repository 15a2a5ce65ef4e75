"""Alphabet-run prefilter: the device tier for factor-less patterns
that carry a mandatory class run.

A match of byte length >= L consists of L consecutive bytes that all
belong to the pattern's match alphabet (regex/alphabet.py derives the
class and the guaranteed run length), so candidate match starts are the
starts of in-alphabet runs: range compares and a few shifted ANDs, no
table lookups. Two shapes, chosen by the minimum length (``plan_for``):

  * coarse (L >= 7): a run of L bytes holds (L - 3) // 4 aligned words
    wholly in the alphabet; the scan looks for W' = pow2floor(min(that,
    8)) consecutive such words and marks the first;
  * fine (L < 7): byte runs of L' = pow2floor(min(L, 4)) starting in
    the word, carried into the next word.

W' and L' are floored, so the condition is implied by "a match starts
here"; the host replay restores exactness. The planner half
(``plan_for``, the text prior, ``flag_density``, ``alpharun_eligible``)
is the reference's, bit for bit: the compiler asks it whether a class
run is selective enough. Output geometry and decode are the core-word
prefilter's (ops/corewords.py).

``alpharun_flags`` is the entry point: on a CUDA tensor it launches the
hand-written kernel csrc/alpharun.cu (or raises); on a CPU tensor it
runs the plain PyTorch version below, which the tests hold against the
JAX package's kernel (grab_tpu/ops/pallas_alpharun.py) and its numpy
oracle.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

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

MAX_RANGES = 8  # membership cost is ~3 ops per range per byte position
MAX_WORDS = 8  # coarse word-run cap (3 doubling steps)
DENSITY_CAP = 0.02  # flag-density prior above which the plan is refused


def _pow2floor(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


def plan_for(min_len: int) -> Tuple[str, int]:
    """→ (mode, units): ("coarse", W') full-word run or ("fine", L')
    byte run. Sound for any match length >= min_len."""
    L = max(1, int(min_len))
    if L >= 7:
        return "coarse", _pow2floor(min((L - 3) // 4, MAX_WORDS))
    return "fine", _pow2floor(min(L, 4))


def _text_freq() -> np.ndarray:
    """Rough byte-frequency prior for text/code corpora (used only to
    estimate filter selectivity; never affects correctness)."""
    f = np.full(256, 2e-4)
    letters = {
        "e": 0.090, "t": 0.066, "a": 0.060, "o": 0.055, "i": 0.052,
        "n": 0.050, "s": 0.047, "r": 0.044, "h": 0.038, "l": 0.030,
        "d": 0.028, "c": 0.022, "u": 0.020, "m": 0.018, "f": 0.016,
        "p": 0.014, "g": 0.014, "w": 0.012, "y": 0.012, "b": 0.010,
        "v": 0.007, "k": 0.006, "x": 0.0015, "j": 0.001, "q": 0.0008,
        "z": 0.0008,
    }
    for ch, p in letters.items():
        f[ord(ch)] = p
        f[ord(ch) - 32] = 0.0035  # uppercase
    f[ord(" ")] = 0.150
    f[ord("\n")] = 0.020
    f[ord("\t")] = 0.008
    for d in b"0123456789":
        f[d] = 0.004
    for ch in ".,;:'\"-_=/*#(){}<>[]+!?&|\\@%^~$`":
        f[ord(ch)] = 0.002
    return f / f.sum()


_FREQ = _text_freq()


def flag_density(ranges: Sequence[Tuple[int, int]], min_len: int) -> float:
    """Expected per-word flag probability under the text prior."""
    p = 0.0
    for lo, hi in ranges:
        p += float(_FREQ[lo : hi + 1].sum())
    p = min(p, 1.0)
    mode, units = plan_for(min_len)
    if mode == "coarse":
        return p ** (4 * units)
    return min(1.0, 4 * p**units)


def alpharun_eligible(
    ranges: Optional[Sequence[Tuple[int, int]]], min_len: int
) -> bool:
    if not ranges or len(ranges) > MAX_RANGES:
        return False
    if min_len < 1:
        return False
    return flag_density(ranges, min_len) <= DENSITY_CAP


def ranges_of(alpha: np.ndarray) -> Tuple[Tuple[int, int], ...]:
    """bool[256] → sorted (lo, hi) runs."""
    out = []
    b = 0
    while b < 256:
        if alpha[b]:
            lo = b
            while b + 1 < 256 and alpha[b + 1]:
                b += 1
            out.append((lo, b))
        b += 1
    return tuple(out)


def _shift_and(s: torch.Tensor, j: int) -> torch.Tensor:
    """s[i] & s[i + j], False past the end."""
    out = torch.zeros_like(s)
    out[: s.shape[0] - j] = s[: s.shape[0] - j] & s[j:]
    return out


def alpharun_bitmap_torch(
    words2d: torch.Tensor, ranges: Sequence[Tuple[int, int]], mode: str, units: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's row bitmap: int32
    [rows + PAD_ROWS, 128] words → int32 [rows/32, 128], over the linear
    byte view with the pad rows taking part in the runs (a range that
    holds byte 0 makes them members)."""
    rows = words2d.shape[0] - PAD_ROWS
    data = words2d.contiguous().view(torch.uint8).reshape(-1)  # little-endian
    member = torch.zeros(data.shape[0], dtype=torch.bool, device=words2d.device)
    for lo, hi in ranges:
        member |= (data >= lo) & (data <= hi)
    s = member.view(-1, 4).all(dim=1) if mode == "coarse" else member
    j = 1
    while j < units:
        s = _shift_and(s, j)
        j *= 2
    hit_w = s if mode == "coarse" else s.view(-1, 4).any(dim=1)
    return bitmap_rows_torch(hit_w[: rows * LANES].view(rows, LANES))


def alpharun_bitmap_swar(
    words2d: torch.Tensor, ranges: Sequence[Tuple[int, int]], mode: str, units: int
) -> torch.Tensor:
    """The kernel's own arithmetic in PyTorch (csrc/alpharun.cu), for the
    tests to hold it to the plain version on the CPU: membership of the 4
    bytes of a word by the SWAR compares of the bounds' constants, one
    code per lane of 4 words and row (coarse: a bit per word wholly in
    the alphabet; fine: a bit per member byte), and the codes past a
    lane's last word taken as the warp's shuffles take them (lane l + 1,
    lane l + 2; lanes 30 and 31 from the next row) → int32 [rows/32, 128]."""
    from grab_tpu_torch.ops.classseq import swar_bound

    rows = words2d.shape[0] - PAD_ROWS
    x = words2d.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    xl = x & 0x7F7F7F7F
    m = torch.zeros_like(x)
    for lo, hi in ranges:
        ge = []
        for bound in (lo, hi + 1):
            add, keep = swar_bound(bound)
            t = (xl + add) & 0xFFFFFFFF
            ge.append((t & (x | keep)) | (x & keep))
        m |= ge[0] & ~ge[1]
    m = (m & 0x80808080).view(-1, 32, 4)  # [row, lane, word of the lane]
    if mode == "coarse":
        per_word = (m == 0x80808080).to(torch.int64)  # wholly in the alphabet
        shifts = torch.arange(4)
    elif units == 1:
        per_word = (m != 0).to(torch.int64)  # a member byte
        shifts = torch.arange(4)
    else:
        per_word = ((m * 0x00204081) & 0xFFFFFFFF) >> 28  # the byte bits
        shifts = 4 * torch.arange(4)
    code = (per_word << shifts).sum(dim=2)  # [row, lane]
    cur = code[:rows]
    ks = torch.arange(4)
    if units == 1:  # the code is the hits
        hits = ((cur.unsqueeze(2) >> ks) & 1) != 0
    else:
        lane = torch.arange(32)
        nb = (cur & 15) | (code[1 : rows + 1] & 15) << 4
        s1 = nb.roll(-1, dims=1)
        next1 = torch.where(lane < 31, s1 & 15, s1 >> 4)
        if mode == "coarse":
            win = cur | next1 << 4
            if units > 4:
                s2 = nb.roll(-2, dims=1)
                win |= torch.where(lane < 30, s2 & 15, s2 >> 4) << 8
            want = (1 << units) - 1
            hits = ((win.unsqueeze(2) >> ks) & want) == want
        else:
            r = cur | next1 << 16
            r &= r >> 1
            if units >= 4:
                r &= r >> 2
            hits = ((r.unsqueeze(2) >> (4 * ks)) & 15) != 0
    return bitmap_rows_torch(hits.reshape(rows, LANES))


def _check_plan(ranges, mode: str, units: int) -> None:
    if not ranges or len(ranges) > MAX_RANGES:
        raise ValueError(f"need 1..{MAX_RANGES} ranges, got {len(ranges)}")
    for lo, hi in ranges:
        if not 0 <= lo <= hi <= 255:
            raise ValueError(f"bad byte range ({lo}, {hi})")
    allowed = {"coarse": (1, 2, 4, 8), "fine": (1, 2, 4)}.get(mode)
    if allowed is None or units not in allowed:
        raise ValueError(f"bad alphabet-run plan ({mode!r}, {units})")


def _kernel_lib():
    from grab_tpu_torch import _build

    lib = _build.cuda_library("alpharun")
    fn = lib.gt_alpharun_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # words
            ctypes.c_void_p,  # host lo[n]
            ctypes.c_void_p,  # host hi[n]
            ctypes.c_int,  # n ranges
            ctypes.c_int,  # coarse
            ctypes.c_int,  # units
            ctypes.c_int64,  # groups
            ctypes.c_void_p,  # bm
            ctypes.c_void_p,  # packed
            ctypes.c_void_p,  # total
            ctypes.c_void_p,  # count scratch of the stream
            ctypes.c_int,  # device index
            ctypes.c_void_p,  # stream
        ]
    return fn


def alpharun_flags(
    words2d: torch.Tensor, ranges: Sequence[Tuple[int, int]], mode: str, units: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (total int32 [1], packed int32 [rows/32], bm int32 [rows/32, 128]).

    CUDA tensor: one launch of csrc/alpharun.cu on the current stream
    (counted in ``alpharun_flags.launches``); a refused launch raises.
    CPU tensor: the plain PyTorch version."""
    rows = check_words(words2d)
    _check_plan(ranges, mode, units)
    if words2d.device.type == "cpu":
        bm = alpharun_bitmap_torch(words2d, ranges, mode, units)
        total, packed = packed_block_flags(bm)
        return total, packed, bm
    if words2d.data_ptr() % 16:
        raise ValueError("words2d must be 16-byte aligned on the card")
    lo = np.array([r[0] for r in ranges], dtype=np.int32)
    hi = np.array([r[1] for r in ranges], dtype=np.int32)
    outs, tail = counted_launch_args(rows, words2d.device)
    err = _kernel_lib()(
        words2d.data_ptr(), lo.ctypes.data, hi.ctypes.data, len(ranges),
        int(mode == "coarse"), units, *tail
    )
    if err != 0:
        raise RuntimeError(f"alphabet-run kernel launch failed: CUDA error {err}")
    alpharun_flags.launches += 1
    return outs


alpharun_flags.launches = 0


class AlphaRunScanner:
    """Class run → per-buffer (total, packed block flags) on the tensor's
    device + host decode, the same contract as ClassSeqScanner."""

    def __init__(self, ranges: Sequence[Tuple[int, int]], min_len: int):
        self.ranges = tuple((int(lo), int(hi)) for lo, hi in ranges)
        self.min_len = int(min_len)
        self.mode, self.units = plan_for(min_len)
        _check_plan(self.ranges, self.mode, self.units)
        self.probe_back = 8  # run start may sit up to one word before
        self.probe_fwd = 8

    def packed(self, words2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        total, packed, _bm = alpharun_flags(words2d, self.ranges, self.mode, self.units)
        return total, packed

    def flags_np(self, packed, n_blocks: int) -> np.ndarray:
        return decode_packed_flags(
            packed, n_blocks, self.probe_back, self.probe_fwd
        )
