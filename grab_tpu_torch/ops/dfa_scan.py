"""Multi-stream DFA candidate scan: the last-resort device walk.

The exact-automaton tier takes this walk when the automaton has no
strided-DFA plan (ops/stridedfa.stride_plan is None) or the scan buffer
is under 1 MiB. The buffer is split into S independent streams, each
walked from the automaton's start state one byte per step, with an
H-byte halo past its segment end: a match (end) at position p is found
by the stream whose extended window covers p from a start at or before
the match start. Matches longer than H that span a stream boundary are
missed, the documented limit of the 4 KiB chunk overlap.

The JAX package computes the walk outside any Pallas kernel
(grab_tpu/ops/dfa_scan.py: one jitted ``lax.scan`` whose step is one
[S]-wide table gather). ``dfa_walk_flags`` is the port's entry point:
on a CUDA tensor it launches the hand-written kernel csrc/dfa_walk.cu
once per buffer (walk, block flags and their packing in one pass, a
thread per stream over a class-indexed table with the accept bit folded
in); on a CPU tensor it runs the plain PyTorch version below
(``dfa_scan_bitmap`` → ``bitmap_block_counts`` > 0 → packed words), a
Python loop of seg + halo dependent steps that the tests hold against
the JAX package's walk.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from grab_tpu_torch.ops.corewords import decode_packed_flags

DEFAULT_HALO = 0x1000  # 4 KiB, the reference's chunk overlap
ACCEPT_BIT = 1 << 15  # of a class-table entry: the next state accepts
MAX_WALK_STATES = ACCEPT_BIT  # next states fit the entry's low 15 bits


def expand_byte_table(table: np.ndarray, class_map: np.ndarray) -> np.ndarray:
    """[n_states, n_classes] + byte→class map → [n_states, 256] table:
    the scan step then gathers only table[state, byte]."""
    return np.ascontiguousarray(table[:, class_map])


def walk_class_table(dfa) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's host tables: (uint16 [n_states, n_classes], entry =
    next state | ACCEPT_BIT if the next state accepts; uint8 [256], the
    byte → class map)."""
    table = np.asarray(dfa.table, dtype=np.int64)
    if table.shape[0] > MAX_WALK_STATES or table.shape[1] > 256:
        raise ValueError(f"automaton of {table.shape[0]} states and {table.shape[1]} "
                         f"classes: the walk takes at most {MAX_WALK_STATES} and 256")
    accept = np.asarray(dfa.accept_mask, dtype=bool)
    entries = table | np.where(accept[table], ACCEPT_BIT, 0)
    return entries.astype(np.uint16), np.asarray(dfa.class_map).astype(np.uint8)


class WalkTables:
    """One automaton's tables for the walk, built once on the host and
    uploaded once per device (shared by the -n N replicas of a member):
    the plain version's byte table and accept mask, the kernel's class
    table (padded to 16 bytes) and class map."""

    def __init__(self, dfa):
        self.start = int(dfa.start)
        self.byte_table = expand_byte_table(dfa.table, dfa.class_map).astype(np.int32)
        self.accept = np.asarray(dfa.accept_mask, dtype=bool)
        self.class_table, self.class_map = walk_class_table(dfa)
        self._plain = {}  # device → (byte table, accept)
        self._kernel = {}  # device → (class table, class map)

    def plain_on(self, device: torch.device):
        key = str(device)
        if key not in self._plain:
            self._plain[key] = (torch.from_numpy(self.byte_table).to(device),
                                torch.from_numpy(self.accept).to(device))
        return self._plain[key]

    def kernel_on(self, device: torch.device):
        key = str(device)
        if key not in self._kernel:
            flat = self.class_table.reshape(-1)
            padded = np.zeros(-(-flat.size // 8) * 8, dtype=np.uint16)
            padded[: flat.size] = flat
            self._kernel[key] = (torch.from_numpy(padded.view(np.int16)).to(device),
                                 torch.from_numpy(self.class_map).to(device))
        return self._kernel[key]


def dfa_scan_bitmap(
    byte_table: torch.Tensor,  # int32 [n_states, 256]
    accept: torch.Tensor,  # bool [n_states]
    start_state: int,
    data: torch.Tensor,  # uint8 [N], N % n_streams == 0
    n_streams: int = 512,
    halo: int = DEFAULT_HALO,
) -> torch.Tensor:
    """bool [N]: candidate match-end bitmap (superset of true ends)."""
    n = data.shape[0]
    if n % n_streams:
        raise ValueError(f"{n} bytes do not split into {n_streams} streams")
    seg = n // n_streams
    h = min(halo, seg)
    dev = data.device
    main = data.view(n_streams, seg)
    if h > 0:
        # halo: each stream continues into the next stream's head; the
        # final stream pads with zeros (can only add false candidates)
        nxt_head = torch.cat([main[1:, :h], main.new_zeros((1, h))], dim=0)
        win = torch.cat([main, nxt_head], dim=1)  # [S, seg+h]
    else:
        win = main
    steps = win.t().contiguous()  # [seg+h, S] uint8
    # row offsets instead of (state, byte) pairs: entry = next state * 256
    flat = (byte_table.to(torch.int32) * 256).reshape(-1).contiguous()
    rows = torch.empty((seg + h, n_streams), dtype=torch.int32, device=dev)
    row = torch.full((n_streams,), int(start_state) * 256, dtype=torch.int32, device=dev)
    idx = torch.empty_like(row)
    for t in range(seg + h):
        torch.add(row, steps[t], out=idx)
        row = rows[t]
        torch.index_select(flat, 0, idx, out=row)
    bits = accept[(rows >> 8).long()].t()  # [S, seg+h]
    out = bits[:, :seg].clone()
    if h > 0:
        # a stream's tail covers the first h positions of the next
        # stream's segment; OR it in
        out[1:, :h] |= bits[:-1, seg:]
    return out.reshape(n)


def bitmap_block_counts(bitmap: torch.Tensor, block: int) -> torch.Tensor:
    """int32 [N/block]: candidate count per block."""
    return bitmap.view(-1, block).sum(dim=1, dtype=torch.int32)


def _check_walk(data: torch.Tensor, n_streams: int, halo: int, block: int) -> int:
    """Blocks of a walk over uint8 ``data`` [N] on the CPU or (contiguous)
    on a CUDA card, or ValueError."""
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError(f"data must be 1-D uint8, got {data.dtype} {tuple(data.shape)}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    n = data.shape[0]
    if n_streams < 1 or n % n_streams:
        raise ValueError(f"{n} bytes do not split into {n_streams} streams")
    if block < 16 or block & (block - 1) or n == 0 or n % (32 * block):
        raise ValueError(f"{n} bytes are not whole groups of 32 blocks of {block}")
    return n // block


def dfa_walk_flags_torch(
    data: torch.Tensor, tables: WalkTables, n_streams: int, halo: int = DEFAULT_HALO,
    block: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version on the tensor's device: → (total int32 [1]:
    flagged blocks, packed int32 [n_blocks/32]: bit b of [g] = block
    32g+b holds a candidate match end)."""
    _check_walk(data, n_streams, halo, block)
    byte_table, accept = tables.plain_on(data.device)
    bm = dfa_scan_bitmap(byte_table, accept, tables.start, data,
                         n_streams=n_streams, halo=halo)
    flags = (bitmap_block_counts(bm, block) > 0).view(-1, 32).to(torch.int32)
    total = flags.sum(dtype=torch.int32).reshape(1)
    packed = torch.zeros(flags.shape[0], dtype=torch.int32, device=data.device)
    for b in range(32):
        packed |= flags[:, b] << b
    return total, packed


def _kernel_lib():
    from grab_tpu_torch import _build

    lib = _build.cuda_library("dfa_walk")
    fn = lib.gt_dfa_walk
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # data
            ctypes.c_int64,  # n
            ctypes.c_int,  # n_streams
            ctypes.c_int64,  # halo bytes walked, min(halo, seg)
            ctypes.c_void_p,  # class table
            ctypes.c_int,  # n_states
            ctypes.c_int,  # n_classes
            ctypes.c_void_p,  # class map
            ctypes.c_int,  # start state
            ctypes.c_int,  # log2(block)
            ctypes.c_void_p,  # packed
            ctypes.c_void_p,  # total
            ctypes.c_int,  # device index
            ctypes.c_void_p,  # stream
        ]
    return fn


def dfa_walk_flags(
    data: torch.Tensor, tables: WalkTables, n_streams: int, halo: int = DEFAULT_HALO,
    block: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (total int32 [1], packed int32 [n_blocks/32]), as
    ``dfa_walk_flags_torch``.

    CUDA tensor: one launch of csrc/dfa_walk.cu on the current stream
    after one memset of its outputs (counted in
    ``dfa_walk_flags.launches``); a refused launch raises. CPU tensor:
    the plain PyTorch version."""
    n_blocks = _check_walk(data, n_streams, halo, block)
    if data.device.type == "cpu":
        return dfa_walk_flags_torch(data, tables, n_streams, halo, block)
    if not data.is_contiguous() or data.data_ptr() % 16:
        raise ValueError("data must be contiguous and 16-byte aligned on the card")
    dev = data.device
    table, class_map = tables.kernel_on(dev)
    n_words = n_blocks // 32
    out = torch.zeros(n_words + 1, dtype=torch.int32, device=dev)  # packed, then total
    n_states, n_classes = tables.class_table.shape
    err = _kernel_lib()(
        data.data_ptr(), data.shape[0], n_streams, min(halo, data.shape[0] // n_streams),
        table.data_ptr(), n_states, n_classes, class_map.data_ptr(), tables.start,
        block.bit_length() - 1, out.data_ptr(), out[n_words:].data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"DFA walk kernel launch failed: CUDA error {err}")
    dfa_walk_flags.launches += 1
    return out[n_words:], out[:n_words]


dfa_walk_flags.launches = 0


class DfaWalkMember:
    """The walk as a DeviceScanner member: it takes the linear uint8
    buffer (not words), flags a block when it holds a match end, and
    decodes without probe slack, as the reference's byte-granular path
    does (``counts > 0`` per block)."""

    wants_bytes = True

    def __init__(self, dfa, buf_size: int, block: int, stream_seg: int, halo: int):
        self.n_streams = max(1, buf_size // stream_seg)
        self.block = block
        self.halo = halo
        self.tables = WalkTables(dfa)

    def packed(self, data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 [buf_size] on its device → (total int32 [1]: flagged
        blocks, packed int32 [n_blocks/32]: bit b of [g] = block 32g+b)."""
        return dfa_walk_flags(data, self.tables, self.n_streams, self.halo, self.block)

    def flags_np(self, packed, n_blocks: int) -> np.ndarray:
        return decode_packed_flags(packed, n_blocks, 0, 0)
