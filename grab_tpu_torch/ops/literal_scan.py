"""Multi-literal prefilter scan at byte granularity (plain PyTorch).

Finds every position where one of K literal factors begins, with
shifted byte-plane compares: elementwise work with no sequential state,
on whichever device the data lies. For each literal, position i matches
iff data[i+j] == lit[j] for all j. Only the first PREFIX_CAP bytes are
compared (longer literals are confirmed on the host; a prefix hit is
already a candidate, and candidates are a superset by design).

The JAX package computes this with jnp outside any hand-written kernel
(grab_tpu/ops/literal_scan.py), for its byte-level sharded scan
(parallel/scan_step.make_sharded_scan), followed by per-block counts.
``literal_block_counts`` is that step here: on a CUDA tensor one launch
of the hand-written kernel csrc/literal_scan.cu (the scan and the block
counts together), on a CPU tensor the plain ``literal_scan_bitmap`` +
``bitmap_block_counts``, which the tests and chip_smoke.py hold the
kernel to. The port's scan routes use the word kernels instead
(ops/corewords.py); ``literal_scan_bitmap`` is also the byte-granular
oracle of those kernels.

The kernel filters positions before it compares keys, in one of two
forms that ``LiteralKeys`` builds on the host:

  * table (any K): a 65,536-bit bitmap of the byte pairs that can start
    a key, one bit tested per position; only a position whose pair is
    present compares the keys of that pair's bucket (``literal_tables``);
  * SWAR (K <= SWAR_MAX): each key's first two bytes tested at 4
    positions at once with 32-bit word arithmetic, the few candidates
    verified against every key (``swar_params``).

Its bound is the bytes (the shard read once; chip_smoke.py
``w2_bound``): the function needs a few operations a position. The
design adds one masked compare per position and key of its pair's
bucket, which costs nothing on text and nearly all the time on a buffer
that puts most positions into one big bucket.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

PREFIX_CAP = 8


def literal_matrix(literals: List[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Pack literals into a [K, PREFIX_CAP] byte matrix plus length
    vector; bytes past a literal's length are wildcards."""
    k = len(literals)
    mat = np.zeros((k, PREFIX_CAP), dtype=np.uint8)
    lens = np.zeros((k,), dtype=np.int32)
    for i, lit in enumerate(literals):
        p = lit[:PREFIX_CAP]
        mat[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
        lens[i] = len(p)
    return mat, lens


def literal_scan_bitmap(
    lit_mat,  # uint8 [K, PREFIX_CAP] (numpy or tensor)
    lengths: Sequence[int],  # per-literal (capped) lengths
    data: torch.Tensor,  # uint8 [N]
) -> torch.Tensor:
    """bool [N] on data's device: out[i] == True iff some literal's
    (capped) prefix starts at i.

    Built from shifted slices — shifted_j[i] = data[i+j] with a zero
    tail — so the work is K·L elementwise compares, no gathers.
    Zero-padding can only suppress matches that would run past the end
    of the buffer, which are not real matches of in-buffer data."""
    n = data.shape[0]
    cap = max(lengths)
    mat = [[int(b) for b in row] for row in np.asarray(lit_mat, dtype=np.uint8)]
    padded = torch.cat([data, data.new_zeros((cap - 1,))]) if cap > 1 else data
    shifted = [padded[j : j + n] for j in range(max(cap, 1))]
    hit = torch.zeros((n,), dtype=torch.bool, device=data.device)
    for k, length in enumerate(lengths):
        eq = shifted[0] == mat[k][0]
        for j in range(1, length):
            eq &= shifted[j] == mat[k][j]
        hit |= eq
    return hit


def literal_keys(lit_mat, lengths: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's form of the literals: (mask, value) uint64 [K]; literal
    k matches at i when (window & mask[k]) == value[k], window = the 8
    bytes from i as a little-endian uint64 with zeros past the end. The
    mask covers max(L, 1) bytes: a literal of capped length 0 compares
    its first byte with 0, as literal_scan_bitmap does."""
    mat = np.ascontiguousarray(np.asarray(lit_mat, dtype=np.uint8).reshape(-1, PREFIX_CAP))
    n_bytes = np.maximum(np.asarray(lengths, dtype=np.int64), 1)
    if n_bytes.shape != (mat.shape[0],) or (n_bytes > PREFIX_CAP).any():
        raise ValueError(f"lengths {list(lengths)} do not fit a [{mat.shape[0]}, "
                         f"{PREFIX_CAP}] literal matrix")
    ones = np.uint64(0xFFFFFFFFFFFFFFFF)
    mask = np.where(n_bytes >= PREFIX_CAP, ones,
                    (np.uint64(1) << (8 * n_bytes).astype(np.uint64)) - np.uint64(1))
    return mask.astype(np.uint64), mat.view("<u8").reshape(-1) & mask


# -- the kernel's tables (csrc/literal_scan.cu) ---------------------------

PAIR_WORDS = 2048  # the pair bitmap: 65,536 bits
TABLE_HEAD = PAIR_WORDS * 4 + PAIR_WORDS * 2 + 32  # bitmap, ranks, first-byte table
# keys the SWAR form takes (its keys ride in the kernel's parameters), and the
# host chooses it up to there: it beats the table form up to 5 keys and loses
# from 6 (kernel_ab.py literal)
SWAR_MAX = 5
FORMS = ("swar", "table")


def pair_slot(b0, b1):
    """The bit of pair (b0, b1) in the kernel's bitmap → (word, bit): the
    word is b1 | (b0 >> 5) << 8, so the shared-memory bank (word mod 32)
    is b1 & 31 and random text spreads over all 32 banks; the bit is
    (b0 - 1) & 31, so rotating the word right by b0 (mod 32) puts it at
    bit 31."""
    b0 = np.asarray(b0, np.int64)
    b1 = np.asarray(b1, np.int64)
    return b1 | (b0 >> 5) << 8, (b0 + 31) & 31


class LiteralTables:
    """The table form's blob, as the kernel reads it (little-endian):

      [0, 8192)          uint32 [2048]  pair bitmap (``pair_slot``): the
                                        pairs that start a key of capped
                                        length >= 2, and every pair whose
                                        first byte is in the first-byte
                                        table, so one bit test per position
                                        filters both;
      [8192, 12288)      uint16 [2048]  set bits in the words before each;
      [12288, 12320)     uint32 [8]     first-byte table: byte b (bit b & 31
                                        of word b >> 5) starts a key of
                                        capped length 0 or 1 (length 0 is
                                        the byte 0x00), a match outright;
      [off_at, +4 (P+1)) int32          bucket offsets: the keys of the
                                        present pair of rank r are
                                        keys[off[r]:off[r + 1]] (P present
                                        pairs, ranked by word * 32 + bit);
      [keys_at, ...)     uint64 [L, 2]  (mask, value) of the L keys of
                                        capped length >= 2, by bucket.

    off_at and keys_at are 16-byte aligned; the blob is padded to 16."""

    def __init__(self, mask: np.ndarray, value: np.ndarray):
        short = mask == np.uint64(0xFF)  # capped length 0 or 1: one byte compared
        first = np.zeros(256, bool)
        first[(value[short] & np.uint64(0xFF)).astype(np.int64)] = True
        long_ = np.flatnonzero(~short)
        lv = value[long_]
        word, bit = pair_slot(lv & np.uint64(0xFF), (lv >> np.uint64(8)) & np.uint64(0xFF))
        slot = word * 32 + bit
        present = np.zeros(65536, bool)
        present[slot] = True
        fw, fb = pair_slot(np.repeat(np.flatnonzero(first), 256),
                           np.tile(np.arange(256), int(first.sum())))
        present[fw * 32 + fb] = True
        rank_of = np.cumsum(present) - 1  # a present slot's rank
        self.n_pairs = int(present.sum())
        order = np.argsort(slot, kind="stable")
        sizes = np.bincount(rank_of[slot], minlength=self.n_pairs)
        off = np.zeros(self.n_pairs + 1, np.int32)
        off[1:] = np.cumsum(sizes)
        bits = np.packbits(present.reshape(PAIR_WORDS, 32), axis=1, bitorder="little")
        bits = bits.view("<u4").reshape(-1)
        ranks = np.zeros(PAIR_WORDS, np.uint16)
        ranks[1:] = np.cumsum(present.reshape(PAIR_WORDS, 32).sum(axis=1))[:-1]
        first_words = np.packbits(first, bitorder="little").view("<u4")
        self.off_at = TABLE_HEAD
        self.keys_at = -(-(self.off_at + 4 * off.size) // 16) * 16
        keys = np.stack([mask[long_][order], lv[order]], axis=1).astype("<u8")
        blob = np.zeros(self.keys_at + keys.nbytes, np.uint8)
        blob[: PAIR_WORDS * 4] = bits.view(np.uint8)
        blob[PAIR_WORDS * 4 : PAIR_WORDS * 6] = ranks.astype("<u2").view(np.uint8)
        blob[PAIR_WORDS * 6 : TABLE_HEAD] = first_words.view(np.uint8)
        blob[self.off_at : self.off_at + 4 * off.size] = off.astype("<i4").view(np.uint8)
        blob[self.keys_at :] = keys.view(np.uint8).reshape(-1)
        self.blob = blob
        self.long_keys = long_[order]  # literal index of each bucket entry


def swar_params(mask: np.ndarray, value: np.ndarray) -> np.ndarray:
    """The SWAR form's parameters, as csrc/literal_scan.cu's SwarKeys
    (uint8 [144]): c0, c1, m1 (uint32 [5] each): a key's first byte and
    second byte repeated in the 4 bytes of a word, and all ones where the
    second byte is compared (capped length >= 2) else 0; 4 bytes of
    padding; then mask and value (uint64 [5]). Keys past K are zero and
    never read."""
    k = mask.size
    if not 1 <= k <= SWAR_MAX:
        raise ValueError(f"the SWAR form takes 1 to {SWAR_MAX} keys, not {k}")
    rep = np.uint64(0x01010101)
    c = np.zeros((3, SWAR_MAX), "<u4")
    c[0, :k] = (value & np.uint64(0xFF)) * rep
    two = (mask & np.uint64(0xFF00)) != 0
    c[1, :k] = np.where(two, ((value >> np.uint64(8)) & np.uint64(0xFF)) * rep, 0)
    c[2, :k] = np.where(two, 0xFFFFFFFF, 0)
    mv = np.zeros((2, SWAR_MAX), "<u8")
    mv[0, :k], mv[1, :k] = mask, value
    return np.concatenate([c.view(np.uint8).reshape(-1), np.zeros(4, np.uint8),
                           mv.view(np.uint8).reshape(-1)])


class LiteralKeys:
    """K >= 1 literals for the byte step: the plain version's matrix and
    capped lengths, the kernel's (mask, value) keys, its table blob
    (uploaded once per device at first use, ``kernel_on``), its SWAR
    parameters where K <= SWAR_MAX, and the form the host chooses
    (``form``: SWAR wherever it takes the keys)."""

    def __init__(self, literals: List[bytes]):
        if not literals:
            raise ValueError("no literal to scan for")
        self.mat, lens = literal_matrix(literals)
        self.lengths = tuple(int(x) for x in lens)
        self.mask, self.value = literal_keys(self.mat, self.lengths)
        self.tables = LiteralTables(self.mask, self.value)
        self.swar = swar_params(self.mask, self.value) if len(literals) <= SWAR_MAX else None
        self.form = "swar" if self.swar is not None else "table"
        self._dev = {}  # device → uint8 tensor: the table blob

    def kernel_on(self, device: torch.device) -> torch.Tensor:
        key = str(device)
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(self.tables.blob).to(device)
        return self._dev[key]


def literal_block_counts_torch(shard: torch.Tensor, keys: LiteralKeys, block: int) -> torch.Tensor:
    """The plain version on the tensor's device: int32 [N / block], the
    literal-prefix starts in each block."""
    from grab_tpu_torch.ops.dfa_scan import bitmap_block_counts

    return bitmap_block_counts(literal_scan_bitmap(keys.mat, keys.lengths, shard), block)


def _kernel_lib():
    from grab_tpu_torch import _build

    lib = _build.cuda_library("literal_scan")
    if lib.gt_literal_counts_table.argtypes is None:
        lib.gt_literal_counts_swar.restype = ctypes.c_int
        lib.gt_literal_counts_swar.argtypes = [
            ctypes.c_void_p,  # data
            ctypes.c_int64,  # bytes
            ctypes.c_int,  # block
            ctypes.c_void_p,  # SwarKeys (host, 144 bytes)
            ctypes.c_int,  # K
            ctypes.c_void_p,  # counts
            ctypes.c_int,  # device index
            ctypes.c_void_p,  # stream
        ]
        lib.gt_literal_counts_table.restype = ctypes.c_int
        lib.gt_literal_counts_table.argtypes = [
            ctypes.c_void_p,  # data
            ctypes.c_int64,  # bytes
            ctypes.c_int,  # block
            ctypes.c_void_p,  # blob (device)
            ctypes.c_int64,  # blob bytes
            ctypes.c_int,  # offsets' byte offset in the blob
            ctypes.c_int,  # keys' byte offset
            ctypes.c_void_p,  # counts
            ctypes.c_int,  # device index
            ctypes.c_void_p,  # stream
        ]
    return lib


def literal_block_counts(shard: torch.Tensor, keys: LiteralKeys, block: int,
                         form: str = None) -> torch.Tensor:
    """→ int32 [N / block]: per block of uint8 ``shard`` [N], the positions
    at which some literal's capped prefix starts (the reference's
    literal_scan_bitmap, then bitmap_block_counts).

    CUDA tensor: one launch of csrc/literal_scan.cu on the current stream
    (counted in ``literal_block_counts.launches``; the form it ran in
    ``literal_block_counts.form``), in ``form`` ("swar" or "table"; by
    default ``keys.form``); the shard must be contiguous and 16-byte
    aligned and ``block`` a multiple of 512, or it raises, as a refused
    launch does. CPU tensor: the plain version, whatever the form."""
    if shard.dtype != torch.uint8 or shard.dim() != 1:
        raise ValueError(f"shard must be 1-D uint8, got {shard.dtype} {tuple(shard.shape)}")
    n = shard.shape[0]
    if block <= 0 or n == 0 or n % block:
        raise ValueError(f"{n} bytes are not whole blocks of {block}")
    form = keys.form if form is None else form
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, not {form!r}")
    if form == "swar" and keys.swar is None:
        raise ValueError(f"the SWAR form takes at most {SWAR_MAX} keys, not {len(keys.lengths)}")
    if shard.device.type == "cpu":
        return literal_block_counts_torch(shard, keys, block)
    if shard.device.type != "cuda":
        raise ValueError(f"unsupported device {shard.device}")
    if block % 512 or not shard.is_contiguous() or shard.data_ptr() % 16:
        raise ValueError("on the card the shard must be contiguous and 16-byte aligned "
                         f"and the block a multiple of 512 (got {block})")
    dev = shard.device
    counts = torch.empty(n // block, dtype=torch.int32, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _kernel_lib()
    if form == "swar":
        err = lib.gt_literal_counts_swar(shard.data_ptr(), n, block, keys.swar.ctypes.data,
                                         len(keys.lengths), counts.data_ptr(), index, stream)
    else:
        blob, t = keys.kernel_on(dev), keys.tables
        err = lib.gt_literal_counts_table(shard.data_ptr(), n, block, blob.data_ptr(),
                                          blob.numel(), t.off_at, t.keys_at, counts.data_ptr(),
                                          index, stream)
    if err != 0:
        raise RuntimeError(f"literal scan kernel launch failed: CUDA error {err}")
    literal_block_counts.launches += 1
    literal_block_counts.form = form
    return counts


literal_block_counts.launches = 0
literal_block_counts.form = None
