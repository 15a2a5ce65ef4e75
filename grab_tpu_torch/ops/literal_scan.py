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


class LiteralKeys:
    """K >= 1 literals for the byte step: the plain version's matrix and
    capped lengths, the kernel's (mask, value) keys, uploaded once per
    device at first use (``kernel_on``)."""

    def __init__(self, literals: List[bytes]):
        if not literals:
            raise ValueError("no literal to scan for")
        self.mat, lens = literal_matrix(literals)
        self.lengths = tuple(int(x) for x in lens)
        self.mask, self.value = literal_keys(self.mat, self.lengths)
        self._dev = {}  # device → int64 [2, K]: masks, then values

    def kernel_on(self, device: torch.device) -> torch.Tensor:
        key = str(device)
        if key not in self._dev:
            both = np.stack([self.mask, self.value]).view(np.int64)
            self._dev[key] = torch.from_numpy(both).to(device)
        return self._dev[key]


def literal_block_counts_torch(shard: torch.Tensor, keys: LiteralKeys, block: int) -> torch.Tensor:
    """The plain version on the tensor's device: int32 [N / block], the
    literal-prefix starts in each block."""
    from grab_tpu_torch.ops.dfa_scan import bitmap_block_counts

    return bitmap_block_counts(literal_scan_bitmap(keys.mat, keys.lengths, shard), block)


def _kernel_lib():
    from grab_tpu_torch import _build

    lib = _build.cuda_library("literal_scan")
    if lib.gt_literal_block_counts.argtypes is None:
        lib.gt_literal_block_counts.restype = ctypes.c_int
        lib.gt_literal_block_counts.argtypes = [
            ctypes.c_void_p,  # data
            ctypes.c_int64,  # bytes
            ctypes.c_int,  # block
            ctypes.c_void_p,  # masks (device uint64 [K])
            ctypes.c_void_p,  # values
            ctypes.c_int,  # K
            ctypes.c_void_p,  # counts
            ctypes.c_int,  # device index
            ctypes.c_void_p,  # stream
        ]
    return lib


def literal_block_counts(shard: torch.Tensor, keys: LiteralKeys, block: int) -> torch.Tensor:
    """→ int32 [N / block]: per block of uint8 ``shard`` [N], the positions
    at which some literal's capped prefix starts (the reference's
    literal_scan_bitmap, then bitmap_block_counts).

    CUDA tensor: one launch of csrc/literal_scan.cu on the current stream
    (counted in ``literal_block_counts.launches``); the shard must be
    contiguous and 16-byte aligned and ``block`` a multiple of 512, or
    it raises, as a refused launch does. CPU tensor: the plain version."""
    if shard.dtype != torch.uint8 or shard.dim() != 1:
        raise ValueError(f"shard must be 1-D uint8, got {shard.dtype} {tuple(shard.shape)}")
    n = shard.shape[0]
    if block <= 0 or n == 0 or n % block:
        raise ValueError(f"{n} bytes are not whole blocks of {block}")
    if shard.device.type == "cpu":
        return literal_block_counts_torch(shard, keys, block)
    if shard.device.type != "cuda":
        raise ValueError(f"unsupported device {shard.device}")
    if block % 512 or not shard.is_contiguous() or shard.data_ptr() % 16:
        raise ValueError("on the card the shard must be contiguous and 16-byte aligned "
                         f"and the block a multiple of 512 (got {block})")
    dev = shard.device
    tab = keys.kernel_on(dev)
    counts = torch.empty(n // block, dtype=torch.int32, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = _kernel_lib().gt_literal_block_counts(
        shard.data_ptr(), n, block, tab[0].data_ptr(), tab[1].data_ptr(), tab.shape[1],
        counts.data_ptr(), index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"literal scan kernel launch failed: CUDA error {err}")
    literal_block_counts.launches += 1
    return counts


literal_block_counts.launches = 0
