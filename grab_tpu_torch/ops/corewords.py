"""Core-word literal prefilter: the main path's kernel on the GPU.

A literal occurring at byte offset B (phase p = B mod 4) always fully
covers some aligned int32 word whose value is a constant of (literal,
p): for length >= 7 a whole word, otherwise a masked sub-word ANDed
with a second adjacent word to keep the false-positive rate down. The
scan ORs these compares over phases and literals for every aligned
word of the buffer and reports which 512-byte blocks (rows of the
[rows, 128] word layout) hold a hit; the host replay restores
exactness around the flagged blocks.

Layout contract (unchanged from the JAX package): the scan buffer is
viewed as little-endian int32 words [rows + PAD_ROWS, 128] with
rows % 32 == 0 and the PAD_ROWS tail zero (the packer supplies it), so
the test of word w+1 past the last row reads zeros and can only
over-flag. Outputs: the row bitmap bm int32 [rows/32, 128] (bit r%32
of [r//32, c] = hit at word (r, c)), packed int32 [rows/32] (OR of bm
over lanes: bit b of [g] = block 32g+b) and total int32 [1] (count of
nonzero packed).

``core_word_flags`` is the entry point: on a CUDA tensor it launches
the hand-written kernel csrc/corewords.cu (or raises); on a CPU tensor
it runs the plain PyTorch version below, which the tests hold against
the JAX package's kernel.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

LANES = 128
PAD_ROWS = 8  # zero rows after the buffer (word w+1 of the last row)
BLOCK = 512  # bytes per candidate block == bytes per word row
LIT_BUCKETS = (1, 2, 4, 8, 16)

# Rough per-byte frequency score for text/code corpora: lower = rarer.
# Used to pick the rarest core word when a phase offers several.
_COMMON = b"etaoinshrdlcum \t\nETAOINSHRDLU0123456789_./-=+*(){}[]<>\"';:,#"


def _word_score(val_bytes: bytes, mask_bytes: bytes) -> float:
    """Estimated log2 P(random text word matches); lower (more negative)
    is better. Unmasked bytes contribute ~-5.3 bits for common bytes,
    -8 for rare ones."""
    s = 0.0
    for b, m in zip(val_bytes, mask_bytes):
        if m == 0xFF:
            s -= 5.0 if bytes([b]) in _COMMON else 7.5
    return s


class CoreWordTests:
    """Per-(phase, literal) aligned-word tests.

    tab: int32 [2, 4, K, W]  (vals, masks) — K padded to a bucket, W in
    {1, 2}. Padding literals duplicate literal 0's tests (a redundant
    compare whose union contribution is idempotent — required by the
    xor-accumulate masked test form, which cannot express a
    never-match (val, mask) sentinel); padding words use
    (val=0, mask=0) (always match, neutral in the accumulate).
    probe_back / probe_fwd: byte slack the decoder must add around a
    flagged word to cover every literal occurrence that could have
    fired the test.
    """

    def __init__(self, literals: Sequence[bytes], max_words: int = 2):
        lits = [bytes(l) for l in literals]
        assert lits and all(len(l) >= 3 for l in lits), "core-word needs len>=3"
        self.literals = lits
        k_real = len(lits)
        self.k = next(b for b in LIT_BUCKETS if b >= k_real)
        maxlen = max(len(l) for l in lits)
        minlen = min(len(l) for l in lits)
        # with 2-word tests the tested window spans at most words
        # [j, j+1] where j <= (3 + maxlen)//4; the occurrence start is
        # at most 4*j + 3 bytes before the flagged word.
        # length >= 7 guarantees a FULL aligned word at every phase, so
        # the cheaper 1-word kernel keeps a ~2^-32 per-word FP rate;
        # shorter literals need the 2-word tests (a len-3 literal at
        # phase 2 spans two words — a 1-word test would cover only 2
        # bytes, ~1/65k FP per word: measured 28k junk blocks per 500MB)
        self.n_words = 1 if (max_words == 1 or minlen >= 7) else 2
        tab = np.zeros((2, 4, self.k, self.n_words), dtype=np.uint32)
        max_back = 0
        all_full = True
        for li, lit in enumerate(lits):
            for p in range(4):
                tests = self._phase_tests(lit, p, self.n_words)
                # tests: list of (word_idx_delta_from_first, val, mask),
                # anchored at word j0; flagged word = j0
                j0 = tests[0][0]
                back = 4 * j0 + 3  # occurrence starts at word j0*4 - p
                max_back = max(max_back, back)
                for w in range(self.n_words):
                    if w < len(tests):
                        _, val, mask = tests[w]
                    else:
                        val, mask = 0, 0  # always-true pad word
                    if mask != 0xFFFFFFFF:
                        all_full = False
                    tab[0, p, li, w] = val
                    tab[1, p, li, w] = mask
        # masked=False kernel variant: skip the AND entirely; only
        # sound when every real test is a full-word compare. Padding
        # literals always duplicate literal 0's tests — a redundant
        # compare whose union contribution is idempotent; the
        # xor-accumulate masked form cannot express a never-match
        # (val=1, mask=0) sentinel, since a zero mask contributes
        # nothing to the accumulator.
        self.masked = not all_full
        for li in range(len(lits), self.k):
            tab[:, :, li, :] = tab[:, :, 0, :]
        self.tab = tab.view(np.int32)
        self.probe_back = max_back + maxlen  # generous: covers start slack
        self.probe_fwd = maxlen + 8

    @staticmethod
    def _phase_tests(lit: bytes, p: int, n_words: int):
        """Choose the aligned words to test for occurrences at phase p.

        shifted = p pad bytes + lit; word j covers shifted bytes
        [4j, 4j+4). Greedy: pick the adjacent word pair (or single) with
        the best (most coverage, rarest bytes) score.
        """
        shifted_len = p + len(lit)
        nw = (shifted_len + 3) // 4
        cov = []  # per word j: (val, mask, n_covered)
        for j in range(nw):
            val = bytearray(4)
            mask = bytearray(4)
            n = 0
            for b in range(4):
                pos = 4 * j + b  # position in shifted string
                if p <= pos < p + len(lit):
                    val[b] = lit[pos - p]
                    mask[b] = 0xFF
                    n += 1
            cov.append((bytes(val), bytes(mask), n))

        def le(u: bytes) -> int:
            return int.from_bytes(u, "little")

        if n_words == 1 or nw == 1:
            # best single word by (coverage, rarity)
            best = min(
                range(nw),
                key=lambda j: (-cov[j][2], _word_score(cov[j][0], cov[j][1])),
            )
            v, m, _ = cov[best]
            return [(best, le(v) & le(m), le(m))]
        # best adjacent pair by combined coverage then rarity
        best_j, best_key = 0, None
        for j in range(nw - 1):
            c = cov[j][2] + cov[j + 1][2]
            s = _word_score(cov[j][0], cov[j][1]) + _word_score(
                cov[j + 1][0], cov[j + 1][1]
            )
            key = (-c, s)
            if best_key is None or key < best_key:
                best_j, best_key = j, key
        out = []
        for j in (best_j, best_j + 1):
            v, m, _ = cov[j]
            out.append((j, le(v) & le(m), le(m)))
        return out


def core_word_bitmap_torch(
    words2d: torch.Tensor, tab: np.ndarray, k: int, n_words: int, masked: bool
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's row bitmap: int32
    [rows + PAD_ROWS, 128] words → int32 [rows/32, 128]. All compares
    are on int32 bit patterns (table entries of bytes >= 0x80 are
    negative int32; equality and bitwise ops do not care)."""
    rows = words2d.shape[0] - PAD_ROWS
    n = rows * LANES
    flat = words2d.reshape(-1)
    planes = [flat[w : n + w] for w in range(n_words)]
    t = np.asarray(tab, dtype=np.int32)
    hit = torch.zeros(n, dtype=torch.bool, device=words2d.device)
    for p in range(4):
        for li in range(k):
            vals = [int(t[0, p, li, w]) for w in range(n_words)]
            if masked:
                masks = [int(t[1, p, li, w]) for w in range(n_words)]
                acc = (planes[0] ^ vals[0]) & masks[0]
                for w in range(1, n_words):
                    acc |= (planes[w] ^ vals[w]) & masks[w]
                eq = acc == 0
            else:
                eq = planes[0] == vals[0]
                for w in range(1, n_words):
                    eq &= planes[w] == vals[w]
            hit |= eq
    return bitmap_rows_torch(hit.view(rows, LANES))


def bitmap_rows_torch(hit: torch.Tensor) -> torch.Tensor:
    """bool [rows, 128] → int32 [rows/32, 128]: row r sets bit r % 32 of
    output row r // 32, built with int32 shifts and ORs (bit 31 makes
    the value negative, as on the device)."""
    rows = hit.shape[0]
    h = hit.view(rows // 32, 32, LANES).to(torch.int32)
    bm = torch.zeros((rows // 32, LANES), dtype=torch.int32, device=hit.device)
    for r in range(32):
        bm |= h[:, r, :] << r
    return bm


def packed_block_flags(bm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch lane-OR: row bitmap → (total int32 [1], packed int32
    [rows/32]); packed[g] bit b set iff block 32g+b has any hit, total
    the count of nonzero packed."""
    x = bm
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        x = x[:, :half] | x[:, half:]
    packed = x[:, 0].contiguous()
    total = (packed != 0).sum(dtype=torch.int32).reshape(1)
    return total, packed


def check_words(words2d: torch.Tensor) -> int:
    """Rows of a padded [rows + PAD_ROWS, 128] int32 word buffer on the
    CPU or (contiguous) on a CUDA card, or ValueError."""
    if words2d.dtype != torch.int32 or words2d.dim() != 2:
        raise ValueError(f"words2d must be 2-D int32, got {words2d.dtype} "
                         f"{tuple(words2d.shape)}")
    rows = words2d.shape[0] - PAD_ROWS
    if words2d.shape[1] != LANES or rows <= 0 or rows % 32:
        raise ValueError(f"words2d must be [32*g + {PAD_ROWS}, {LANES}], "
                         f"got {tuple(words2d.shape)}")
    if words2d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {words2d.device}")
    if words2d.device.type == "cuda" and not words2d.is_contiguous():
        raise ValueError("words2d must be contiguous")
    return rows


def launch_args(rows: int, dev: torch.device):
    """What every word kernel's C entry point ends with: the outputs it
    fills (bm int32 [rows/32, 128], packed int32 [rows/32], total int32
    [1], allocated here) and (groups, their pointers, the device index,
    the current stream)."""
    groups = rows // 32
    bm = torch.empty((groups, LANES), dtype=torch.int32, device=dev)
    packed = torch.empty(groups, dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    tail = (
        groups, bm.data_ptr(), packed.data_ptr(), total.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return (total, packed, bm), tail


_COUNT_SCRATCH = {}


def count_scratch(dev: torch.device) -> torch.Tensor:
    """The two-word device scratch (count, blocks done; one 8-byte
    atomic) through which the kernels of csrc/group_count.cuh
    (alpharun.cu, classseq.cu, xorfilter.cu) count ``total`` without a
    memset before each launch: one per (device, current stream), zeroed
    once. Every launch leaves it zero, and the
    launches that share it are ordered by their stream, so two streams
    never share one."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (index, torch.cuda.current_stream(index).cuda_stream)
    scratch = _COUNT_SCRATCH.get(key)
    if scratch is None:
        scratch = _COUNT_SCRATCH.setdefault(
            key, torch.zeros(2, dtype=torch.int32, device=torch.device("cuda", index)))
    return scratch


def counted_launch_args(rows: int, dev: torch.device):
    """launch_args for the kernels that count ``total`` themselves: the
    same outputs, and (groups, bm, packed, total, the stream's count
    scratch, device index, stream)."""
    outs, tail = launch_args(rows, dev)
    return outs, tail[:4] + (count_scratch(dev).data_ptr(),) + tail[4:]


def _kernel_lib():
    from grab_tpu_torch import _build

    lib = _build.cuda_library("corewords")
    fn = lib.gt_core_word_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # words
            ctypes.c_void_p,  # host table
            ctypes.c_int,  # k
            ctypes.c_int,  # n_words
            ctypes.c_int,  # masked
            ctypes.c_int64,  # groups
            ctypes.c_void_p,  # bm
            ctypes.c_void_p,  # packed
            ctypes.c_void_p,  # total
            ctypes.c_int,  # device index
            ctypes.c_void_p,  # stream
        ]
    return fn


def core_word_flags(
    words2d: torch.Tensor, tab: np.ndarray, k: int, n_words: int, masked: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (total int32 [1], packed int32 [rows/32], bm int32 [rows/32, 128]).

    CUDA tensor: one launch of csrc/corewords.cu on the current stream
    (counted in ``core_word_flags.launches``); a refused launch raises.
    CPU tensor: the plain PyTorch version."""
    rows = check_words(words2d)
    tab = np.ascontiguousarray(tab, dtype=np.int32)
    if tab.shape != (2, 4, k, n_words) or k not in LIT_BUCKETS or n_words not in (1, 2):
        raise ValueError(f"table shape {tab.shape} does not match k={k}, "
                         f"n_words={n_words}")
    if words2d.device.type == "cpu":
        bm = core_word_bitmap_torch(words2d, tab, k, n_words, masked)
        total, packed = packed_block_flags(bm)
        return total, packed, bm
    outs, tail = launch_args(rows, words2d.device)
    err = _kernel_lib()(
        words2d.data_ptr(), tab.ctypes.data, k, n_words, int(bool(masked)), *tail
    )
    if err != 0:
        raise RuntimeError(f"core-word kernel launch failed: CUDA error {err}")
    core_word_flags.launches += 1
    return outs


core_word_flags.launches = 0


def decode_packed_flags(
    packed: np.ndarray,  # int32 [rows/32]; bit b of [g] = block g*32+b
    n_blocks: int,
    probe_back: int,
    probe_fwd: int,
) -> np.ndarray:
    """Packed per-block hit bits → 0/1 candidate flags with probe slack.

    A hit marks the block containing the tested core word; the match
    itself may start up to probe_back bytes earlier and extend
    probe_fwd bytes later, so neighbors within that slack are flagged
    too (superset; host verify restores exactness)."""
    packed = np.asarray(packed).view(np.uint32)
    bits = (packed[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    flags = bits.reshape(-1)[:n_blocks].astype(np.int32)
    back = -(-probe_back // BLOCK)
    fwd = -(-probe_fwd // BLOCK)
    out = flags.copy()
    for s in range(1, back + 1):
        out[:-s] |= flags[s:]
    for s in range(1, fwd + 1):
        out[s:] |= flags[:-s]
    return out


class CoreWordScanner:
    """Literals → per-buffer (total, packed block flags) on the tensor's
    device + host decode of the packed flags."""

    def __init__(self, literals: Sequence[bytes]):
        self.tests = CoreWordTests(literals)

    def packed(self, words2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(total int32 [1], packed per-block flag bits) for a padded
        [rows + PAD_ROWS, 128] int32 word buffer, on its device."""
        t = self.tests
        total, packed, _bm = core_word_flags(words2d, t.tab, t.k, t.n_words, t.masked)
        return total, packed

    def flags_np(self, packed, n_blocks: int) -> np.ndarray:
        return decode_packed_flags(
            packed, n_blocks, self.tests.probe_back, self.tests.probe_fwd
        )
