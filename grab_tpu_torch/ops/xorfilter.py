"""XOR-filter core-word prefilter: the literal ensemble's member for
large sets of long literals.

Every literal of 7+ bytes contributes, for each of the 4 byte phases,
one aligned int32 word that lies wholly inside it (``_phase_words``). An
XOR filter (Graf & Lemire 2019) answers exact membership of a buffer
word x in that key set with

    T1[h1(x)] ^ T2[h2(x)] ^ ... ^ Ta[ha(x)] == x,   h_b(x) = (x * c_b mod 2^32) >> 25

over a banks of 128 slots, at a false-positive rate of ~2^-32 per word
(the fingerprint is the whole word), so the cost per word grows with the
number of banks, not of literals. Keys are partitioned greedily into
full 4-bank groups of 384 plus ONE remainder group of the smallest
arity that peels reliably (1 bank <= 24 keys, 2 <= 120, 3 <= 300), so
100 literals (400 keys) are 4 + 1 = 5 banks.

The construction (sorted keys, the partition, the peel order, the
seeded random fill, the salts) is the JAX package's
(grab_tpu/ops/pallas_xorfilter.py), unchanged in every step that
decides the table: ``tables()`` and ``consts()`` equal the reference's
bit for bit. Output geometry and decode are the core-word prefilter's
(ops/corewords.py).

``xor_word_flags`` is the entry point: on a CUDA tensor it launches the
hand-written kernel csrc/xorfilter.cu (or raises); on a CPU tensor it
runs the plain PyTorch version below, which the tests hold against the
reference's kernel and its numpy oracle. The launch's form is chosen
here from the program's shape: how many interleaved copies of each bank
row a block keeps in shared memory (``bank_copies``) and whether the
groups are full 4-bank groups plus one remainder (``remainder_arity``).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

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

N_BANKS = 4
BANK_SLOTS = LANES  # 128 slots per bank
GROUP_KEYS = 384  # reliable 4-ary peeling load: 384/512 = 0.75
# reliable remainder-group capacities by arity (256 salts)
_ARITY_CAP = ((1, 24), (2, 120), (3, 300), (4, GROUP_KEYS))

# base odd multiplicative constants, salted per construction attempt
_BASE_CONSTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)


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


def _salted_consts(salt: int) -> Tuple[int, ...]:
    # xor with an even salt keeps the constants odd (full-period
    # multiplicative hashes)
    return tuple((c ^ (salt * 0x9E3779B9 * 2)) & 0xFFFFFFFF for c in _BASE_CONSTS)


def _hash_slots(x: int, consts) -> List[int]:
    return [((x * c) & 0xFFFFFFFF) >> 25 for c in consts]


def _peel(keys: List[int], consts, n_banks: int = N_BANKS) -> "np.ndarray | None":
    """Assign bank tables so xor of each key's n_banks slots equals the
    key. Returns uint32 [n_banks, 128] or None if peeling fails (a
    1-bank group degenerates to a perfect table: peeling succeeds iff
    the single hash is collision-free over the keys)."""
    consts = consts[:n_banks]
    # slot id = bank * 128 + h_bank(key)
    occ: dict = {}
    key_slots = []
    for k in keys:
        slots = [b * BANK_SLOTS + h for b, h in enumerate(_hash_slots(k, consts))]
        key_slots.append(slots)
        for s in slots:
            occ.setdefault(s, set()).add(len(key_slots) - 1)
    order = []  # (key_idx, owned_slot) in peel order
    ready = [s for s, ks in occ.items() if len(ks) == 1]
    peeled = [False] * len(keys)
    while ready:
        s = ready.pop()
        ks = occ.get(s)
        if not ks:
            continue
        (ki,) = ks
        if peeled[ki]:
            continue
        peeled[ki] = True
        order.append((ki, s))
        for s2 in key_slots[ki]:
            k2 = occ.get(s2)
            if k2 is not None:
                k2.discard(ki)
                if len(k2) == 1:
                    ready.append(s2)
    if not all(peeled):
        return None
    # random-init all slots (so empty slots never xor to a plausible
    # key like 0x00000000 — NUL runs are common in binary corpora),
    # then back-substitute in reverse peel order
    rng = np.random.default_rng(0xF117E4 ^ consts[0])
    tbl = rng.integers(1, 1 << 32, size=n_banks * BANK_SLOTS, dtype=np.uint32)
    for ki, owned in reversed(order):
        acc = np.uint32(keys[ki])
        for s in key_slots[ki]:
            if s != owned:
                acc ^= tbl[s]
        tbl[owned] = acc
    return tbl.reshape(n_banks, BANK_SLOTS)


class XorWordTests:
    """K literals -> XOR filter groups + decode slack.

    ``groups``: list of (consts tuple, uint32 [arity, 128] table); a word
    is a candidate iff ANY group's xor-check passes.
    """

    def __init__(self, literals: Sequence[bytes]):
        lits = [bytes(l) for l in literals]
        assert lits and all(len(l) >= 7 for l in lits), "xor filter needs len>=7"
        self.literals = lits
        keys = set()
        max_back = 0
        maxlen = max(len(l) for l in lits)
        for lit in lits:
            for j, w in _phase_words(lit):
                keys.add(w)
                max_back = max(max_back, 4 * j + 3)
        self.n_keys = len(keys)
        key_list = sorted(keys)
        # greedy partition: full 4-bank groups, then ONE smallest-arity
        # remainder group — the total lookup count per word is the sum
        # of group arities (e.g. 400 keys -> 4+1 = 5 lookups, not 8)
        chunks: List[tuple] = []
        pos = 0
        while len(key_list) - pos > GROUP_KEYS:
            chunks.append((key_list[pos : pos + GROUP_KEYS], 4))
            pos += GROUP_KEYS
        rem = key_list[pos:]
        if rem:
            arity = next(a for a, cap in _ARITY_CAP if len(rem) <= cap)
            chunks.append((rem, arity))
        self.groups: List[tuple] = []
        for chunk, arity in chunks:
            self._build_group(chunk, arity)
        self.probe_back = max_back + maxlen
        self.probe_fwd = maxlen + 8
        self._program = None  # the kernel's input, built at first use
        self._dev = {}  # device → program tensor

    def _build_group(self, chunk: List[int], arity: int) -> None:
        """Peel one group at the given arity; on repeated failure widen
        the arity, and as a last resort split the chunk (each attempt
        retries its own salt sequence)."""
        for nb in range(arity, N_BANKS + 1):
            for salt in range(256):
                consts = _salted_consts(salt)[:nb]
                tbl = _peel(chunk, consts, nb)
                if tbl is not None:
                    self.groups.append((consts, tbl))
                    return
        half = len(chunk) // 2
        if half == 0:
            raise RuntimeError("xor filter construction failed")
        self._build_group(chunk[:half], min(arity, N_BANKS))
        self._build_group(chunk[half:], min(arity, N_BANKS))

    def tables(self) -> np.ndarray:
        """int32 [sum of group arities, 128] stacked bank rows; group g's
        rows start at sum(arities[:g])."""
        return np.concatenate([t for _, t in self.groups]).view(np.int32)

    def consts(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(c for c, _ in self.groups)

    def member_np(self, words: np.ndarray) -> np.ndarray:
        """Oracle membership test for uint32 word array."""
        w = words.astype(np.uint64)
        hit = np.zeros(words.shape, dtype=bool)
        for consts, tbl in self.groups:
            acc = np.zeros(words.shape, dtype=np.uint32)
            for b, c in enumerate(consts):
                h = ((w * c) & 0xFFFFFFFF).astype(np.uint32) >> np.uint32(25)
                acc ^= tbl[b][h.astype(np.int64)]
            hit |= acc == words.astype(np.uint32)
        return hit

    def program(self) -> np.ndarray:
        """The kernel's input (csrc/xor_test.cuh), int32: [n_groups,
        n_rows, arity per group, multiplier per bank row, bank rows
        [n_rows, 128]]."""
        if self._program is None:
            self._program = xor_program(self.tables(), self.consts())
        return self._program

    def device_program(self, device: torch.device) -> torch.Tensor:
        """``program()`` on ``device``, uploaded once per device."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(self.program()).to(device)
        return self._dev[key]


def group_bases(consts_groups) -> Tuple[int, ...]:
    """Row offset of each group within the stacked tables() array."""
    bases, pos = [], 0
    for consts in consts_groups:
        bases.append(pos)
        pos += len(consts)
    return tuple(bases)


def xor_program(tbl: np.ndarray, consts_groups) -> np.ndarray:
    """Stacked bank rows + per-group multipliers → the kernel's int32
    program (see XorWordTests.program)."""
    tbl = np.ascontiguousarray(tbl, dtype=np.int32)
    n_rows = sum(len(c) for c in consts_groups)
    if (not consts_groups or tbl.shape != (n_rows, BANK_SLOTS)
            or any(not 1 <= len(c) <= N_BANKS for c in consts_groups)):
        raise ValueError(
            f"filter table {tbl.shape} does not match groups of arities "
            f"{[len(c) for c in consts_groups]}"
        )
    head = np.array(
        [len(consts_groups), n_rows]
        + [len(c) for c in consts_groups]
        + [k for c in consts_groups for k in c],
        dtype=np.uint32,
    )
    return np.concatenate([head.view(np.int32), tbl.reshape(-1)])


# The kernel's shared memory (csrc/xorfilter.cu): the header (arities
# and multipliers, padded to 16 bytes), then the bank rows, each as C
# interleaved copies: the most of 32, 16 and 1 that fit SHARED_LIMIT
# (on the H100 more copies beat a second block on the SM: `kernel_ab.py
# xor` times every form); a filter larger still stays in global memory.
SHARED_LIMIT = 200 * 1024  # csrc/xorfilter.cu kSharedLimit


def bank_copies(n_groups: int, n_rows: int) -> int:
    """Copies of each bank row that a block of the kernel keeps in
    shared memory for a filter of ``n_groups`` groups and ``n_rows``
    bank rows: 32, 16 or 1; 0 when the rows stay in global memory."""
    head = (n_groups + n_rows + 3) // 4 * 16
    for copies in (32, 16, 1):
        if head + n_rows * BANK_SLOTS * 4 * copies <= SHARED_LIMIT:
            return copies
    return 0


def remainder_arity(consts_groups) -> int:
    """The arity of the last group when every other group has 4 banks
    (the construction's shape: the kernel unrolls it), else 0 (any other
    shape: the kernel dispatches each group's arity)."""
    arities = [len(c) for c in consts_groups]
    return arities[-1] if all(a == N_BANKS for a in arities[:-1]) else 0


def xor_member_torch(x: torch.Tensor, tbl: torch.Tensor, consts_groups) -> torch.Tensor:
    """bool, shape of x: the filter's test on int32 words. An int32
    multiply wraps to the same low 32 bits as the unsigned one; the
    shift is then made logical by masking to 7 bits, and the final
    compare is on bit patterns."""
    hit = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for consts, base in zip(consts_groups, group_bases(consts_groups)):
        acc = torch.zeros_like(x)
        for b, c in enumerate(consts):
            c32 = c - (1 << 32) if c >= 1 << 31 else c  # the same bits, signed
            slot = ((x * c32) >> 25) & 0x7F
            acc ^= tbl[base + b][slot.long()]
        hit |= acc == x
    return hit


def xor_bitmap_torch(words2d: torch.Tensor, tbl: np.ndarray, consts_groups) -> torch.Tensor:
    """Plain PyTorch version of the kernel's row bitmap: int32
    [rows + PAD_ROWS, 128] words (the pad rows are not read) → int32
    [rows/32, 128]."""
    rows = words2d.shape[0] - PAD_ROWS
    t = torch.from_numpy(np.ascontiguousarray(tbl, dtype=np.int32)).to(words2d.device)
    return bitmap_rows_torch(xor_member_torch(words2d[:rows], t, consts_groups))


def _kernel_lib():
    from grab_tpu_torch import _build

    lib = _build.cuda_library("xorfilter")
    fn = lib.gt_xor_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # words
            ctypes.c_void_p,  # device program
            ctypes.c_void_p,  # the same program on the host
            ctypes.c_int64,  # program words
            ctypes.c_int,  # bank copies in shared memory (0: global)
            ctypes.c_int,  # remainder arity (0: any shape)
            ctypes.c_int64,  # groups
            ctypes.c_void_p,  # bm
            ctypes.c_void_p,  # packed
            ctypes.c_void_p,  # total
            ctypes.c_void_p,  # the stream's count scratch
            ctypes.c_int,  # device index
            ctypes.c_void_p,  # stream
        ]
    return fn


def xor_word_flags(
    words2d: torch.Tensor, tests: XorWordTests
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (total int32 [1], packed int32 [rows/32], bm int32 [rows/32, 128]).

    CUDA tensor: one launch of csrc/xorfilter.cu on the current stream
    (counted in ``xor_word_flags.launches``, its form (bank copies,
    remainder arity) kept in ``xor_word_flags.form``); a refused launch
    raises. CPU tensor: the plain PyTorch version."""
    rows = check_words(words2d)
    if words2d.device.type == "cpu":
        bm = xor_bitmap_torch(words2d, tests.tables(), tests.consts())
        total, packed = packed_block_flags(bm)
        return total, packed, bm
    if words2d.data_ptr() % 16:
        raise ValueError("words2d must be 16-byte aligned on the card")
    host = tests.program()
    prog = tests.device_program(words2d.device)
    consts = tests.consts()
    form = (bank_copies(len(consts), sum(len(c) for c in consts)), remainder_arity(consts))
    outs, tail = counted_launch_args(rows, words2d.device)
    err = _kernel_lib()(
        words2d.data_ptr(), prog.data_ptr(), host.ctypes.data, host.size, *form, *tail
    )
    if err != 0:
        raise RuntimeError(f"XOR-filter kernel launch failed: CUDA error {err}")
    xor_word_flags.launches += 1
    xor_word_flags.form = form
    return outs


xor_word_flags.launches = 0
xor_word_flags.form = None


class XorWordScanner:
    """Long literals → per-buffer (total, packed block flags) on the
    tensor's device + host decode, the same contract as CoreWordScanner."""

    def __init__(self, literals: Sequence[bytes]):
        self.tests = XorWordTests(literals)

    def packed(self, words2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        total, packed, _bm = xor_word_flags(words2d, self.tests)
        return total, packed

    def flags_np(self, packed, n_blocks: int) -> np.ndarray:
        return decode_packed_flags(
            packed, n_blocks, self.tests.probe_back, self.tests.probe_fwd
        )
