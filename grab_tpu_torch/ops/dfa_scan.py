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
[S]-wide table gather). The port's entry points, on a CUDA tensor, run
the hand-written kernel csrc/dfa_walk.cu; on a CPU tensor, the plain
PyTorch version below (``dfa_scan_bitmap`` → ``bitmap_block_counts``, a
Python loop of seg + halo dependent steps that the tests hold against
the JAX package's walk):

  * ``dfa_walk_flags`` (the CLI's ``DfaWalkMember``): packed block flags
    and their count, one launch per buffer;
  * ``dfa_walk_counts`` (the sharded byte step): per-block candidate
    counts, two launches (the walk, then the count).

The kernel does not walk a stream as one chain of seg + halo dependent
lookups (36,864 at the CLI's 32 MiB buffer, ~0.73 ms however the chain
is coded): it cuts each stream's window into segments of at most 512
bytes (``walk_geometry``), one thread a segment, starts every segment
but the first from a guessed state (the start state walked over the 32
bytes before it) and repairs wrong guesses in rounds, re-walking a
segment from its predecessor's exit until it meets one of its
checkpoints: exact on any automaton. Its bound is the bytes (0.0100 ms
per 32 MiB on an H100) and the integer work (0.0090 ms); the longest
chain is one segment and its warm-up. ``fixup_bytes`` reads how many
bytes the repairs re-walked.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from grab_tpu_torch.ops.corewords import decode_packed_flags

DEFAULT_HALO = 0x1000  # 4 KiB, the reference's chunk overlap
ACCEPT_BIT = 1 << 15  # of a class-table entry: the next state accepts
MAX_WALK_STATES = ACCEPT_BIT  # next states fit the entry's low 15 bits

# The kernel's segments (csrc/dfa_walk.cu kSegMax, kChunk, kWarm, kTileMax)
SEG_MAX = 512  # bytes of a segment at most
CHUNK = 64  # bytes between two checkpoints at most
WARM = 32  # warm-up bytes of a guess
TILE_MAX = 128  # segments of one stream walked side by side


class WalkGeometry(NamedTuple):
    """How csrc/dfa_walk.cu cuts a walk (its make_geometry): stream s
    walks [s*seg, min(n, (s+1)*seg + h)); its window is cut at the
    multiples of ``seg_bytes`` = min(block, SEG_MAX) into ``p_max``
    segments at most, walked ``tile`` at a time in ``tiles`` tiles, each
    with a checkpoint every ``chunk`` bytes."""

    n: int
    n_streams: int
    seg: int
    h: int
    seg_bytes: int
    chunk: int
    p_max: int
    tile: int
    tiles: int

    def window(self, s: int) -> Tuple[int, int]:
        begin = s * self.seg
        return begin, min(self.n, begin + self.seg + self.h)

    def segments(self, s: int) -> List[Tuple[int, int]]:
        """Stream s's segments, in walk order: [(lo, hi)]."""
        begin, end = self.window(s)
        base = begin - begin % self.seg_bytes
        return [(max(begin, x), min(end, x + self.seg_bytes))
                for x in range(base, end, self.seg_bytes)]

    @property
    def record_words(self) -> int:
        """uint64 words of the counts walk's records: a word per chunk of
        every segment slot."""
        return self.n_streams * self.p_max * (self.seg_bytes // self.chunk)


def walk_geometry(n: int, n_streams: int, halo: int = DEFAULT_HALO,
                  block: int = 512) -> WalkGeometry:
    """The kernel's segments of a walk of n bytes in n_streams streams."""
    seg = n // n_streams
    h = min(halo, seg)
    seg_bytes = min(block, SEG_MAX)
    begins = np.arange(n_streams, dtype=np.int64) * seg
    ends = np.minimum(n, begins + seg + h)
    p_max = int((-((begins - begins % seg_bytes - ends) // seg_bytes)).max())
    tile = min(p_max, TILE_MAX)
    return WalkGeometry(n, n_streams, seg, h, seg_bytes, min(CHUNK, seg_bytes), p_max, tile,
                        -(-p_max // tile))


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
    uploaded once per device (shared by the -n N lanes of a plan):
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


def dfa_walk_counts_torch(
    data: torch.Tensor, tables: WalkTables, n_streams: int, halo: int = DEFAULT_HALO,
    block: int = 512,
) -> torch.Tensor:
    """The plain version on the tensor's device: → int32 [n_blocks], the
    candidate match ends in each block (the previous stream's halo ORed
    in per position)."""
    _check_walk(data, n_streams, halo, block)
    byte_table, accept = tables.plain_on(data.device)
    bm = dfa_scan_bitmap(byte_table, accept, tables.start, data,
                         n_streams=n_streams, halo=halo)
    return bitmap_block_counts(bm, block)


def pack_block_flags(counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 [n_blocks] counts → (total int32 [1]: blocks with a
    candidate, packed int32 [n_blocks/32]: bit b of [g] = block 32g+b)."""
    flags = (counts > 0).view(-1, 32).to(torch.int32)
    total = flags.sum(dtype=torch.int32).reshape(1)
    packed = torch.zeros(flags.shape[0], dtype=torch.int32, device=counts.device)
    for b in range(32):
        packed |= flags[:, b] << b
    return total, packed


def dfa_walk_flags_torch(
    data: torch.Tensor, tables: WalkTables, n_streams: int, halo: int = DEFAULT_HALO,
    block: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version on the tensor's device: → (total int32 [1]:
    flagged blocks, packed int32 [n_blocks/32]: bit b of [g] = block
    32g+b holds a candidate match end)."""
    return pack_block_flags(dfa_walk_counts_torch(data, tables, n_streams, halo, block))


def _kernel_lib():
    from grab_tpu_torch import _build

    lib = _build.cuda_library("dfa_walk")
    if lib.gt_dfa_walk.argtypes is None:
        head = [
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
        ]
        tail = [
            ctypes.c_void_p,  # re-walked byte counter
            ctypes.POINTER(ctypes.c_int),  # out: 1 if the table sits in shared memory
            ctypes.c_int,  # device index
            ctypes.c_void_p,  # stream
        ]
        lib.gt_dfa_walk.restype = ctypes.c_int
        lib.gt_dfa_walk.argtypes = head + [
            ctypes.c_void_p,  # packed
            ctypes.c_void_p,  # total
            ctypes.c_void_p,  # scratch
            ctypes.c_int64,  # its int32 words
        ] + tail
        lib.gt_dfa_walk_counts.restype = ctypes.c_int
        lib.gt_dfa_walk_counts.argtypes = head + [
            ctypes.c_void_p,  # records
            ctypes.c_int64,  # their uint64 words
            ctypes.c_void_p,  # counts
        ] + tail
    return lib


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


_SCRATCH = {}  # (device index, stream) → int32 scratch of gt_dfa_walk
_FIXUP = {}  # device index → int64 [1]: bytes the kernel's fix-up re-walked


def walk_scratch(dev: torch.device, n_words: int) -> torch.Tensor:
    """The int32 device scratch through which csrc/dfa_walk.cu gathers
    the packed words that several blocks reach and counts ``total``
    without a memset before each launch: [2 + 2 * n_words] at least,
    one per (device, current stream), zeroed when made or grown. Every
    launch leaves it zero, and the launches that share it are ordered by
    their stream."""
    index = _device_index(dev)
    key = (index, torch.cuda.current_stream(index).cuda_stream)
    scratch = _SCRATCH.get(key)
    if scratch is None or scratch.numel() < 2 + 2 * n_words:
        scratch = torch.zeros(2 + 2 * n_words, dtype=torch.int32,
                              device=torch.device("cuda", index))
        _SCRATCH[key] = scratch
    return scratch


def _fixup_counter(dev: torch.device) -> torch.Tensor:
    index = _device_index(dev)
    if index not in _FIXUP:
        _FIXUP[index] = torch.zeros(1, dtype=torch.int64, device=torch.device("cuda", index))
    return _FIXUP[index]


def fixup_bytes(dev: torch.device, reset: bool = False) -> int:
    """Bytes re-walked by the kernel's fix-up on ``dev`` since the last
    reset (synchronises the device); ``reset`` zeroes the count. The
    plain walk on the CPU re-walks nothing: 0."""
    if torch.device(dev).type != "cuda":
        return 0
    cnt = _fixup_counter(torch.device(dev))
    n = int(cnt.item())
    if reset:
        cnt.zero_()
    return n


def _kernel_head(data: torch.Tensor, tables: WalkTables, n_streams: int, halo: int,
                 block: int):
    """The arguments both entry points begin with."""
    if not data.is_contiguous() or data.data_ptr() % 16:
        raise ValueError("data must be contiguous and 16-byte aligned on the card")
    table, class_map = tables.kernel_on(data.device)
    n_states, n_classes = tables.class_table.shape
    n = data.shape[0]
    return (data.data_ptr(), n, n_streams, min(halo, n // n_streams), table.data_ptr(),
            n_states, n_classes, class_map.data_ptr(), tables.start, block.bit_length() - 1)


def _kernel_tail(dev: torch.device, shared: ctypes.c_int):
    return (_fixup_counter(dev).data_ptr(), ctypes.byref(shared), _device_index(dev),
            torch.cuda.current_stream(dev).cuda_stream)


def dfa_walk_flags(
    data: torch.Tensor, tables: WalkTables, n_streams: int, halo: int = DEFAULT_HALO,
    block: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (total int32 [1], packed int32 [n_blocks/32]), as
    ``dfa_walk_flags_torch``.

    CUDA tensor: one launch of csrc/dfa_walk.cu on the current stream,
    with no stream operation before it (counted in
    ``dfa_walk_flags.launches``; ``dfa_walk_flags.shared_table``: whether
    the last launch kept the table in shared memory); a refused launch
    raises. CPU tensor: the plain PyTorch version."""
    n_blocks = _check_walk(data, n_streams, halo, block)
    if data.device.type == "cpu":
        return dfa_walk_flags_torch(data, tables, n_streams, halo, block)
    head = _kernel_head(data, tables, n_streams, halo, block)
    dev = data.device
    n_words = n_blocks // 32
    out = torch.empty(n_words + 1, dtype=torch.int32, device=dev)  # packed, then total
    scratch = walk_scratch(dev, n_words)
    shared = ctypes.c_int(0)
    err = _kernel_lib().gt_dfa_walk(
        *head, out.data_ptr(), out[n_words:].data_ptr(), scratch.data_ptr(), scratch.numel(),
        *_kernel_tail(dev, shared))
    if err != 0:
        raise RuntimeError(f"DFA walk kernel launch failed: CUDA error {err}")
    dfa_walk_flags.launches += 1
    dfa_walk_flags.shared_table = bool(shared.value)
    return out[n_words:], out[:n_words]


dfa_walk_flags.launches = 0
dfa_walk_flags.shared_table = None


def dfa_walk_counts(
    data: torch.Tensor, tables: WalkTables, n_streams: int, halo: int = DEFAULT_HALO,
    block: int = 512,
) -> torch.Tensor:
    """→ int32 [n_blocks], as ``dfa_walk_counts_torch``.

    CUDA tensor: the walk of csrc/dfa_walk.cu into a record scratch, then
    its count kernel, on the current stream (two launches, counted in
    ``dfa_walk_counts.launches``); a refused launch raises. CPU tensor:
    the plain PyTorch version."""
    n_blocks = _check_walk(data, n_streams, halo, block)
    if data.device.type == "cpu":
        return dfa_walk_counts_torch(data, tables, n_streams, halo, block)
    head = _kernel_head(data, tables, n_streams, halo, block)
    dev = data.device
    n_records = walk_geometry(data.shape[0], n_streams, halo, block).record_words
    records = torch.empty(n_records, dtype=torch.int64, device=dev)
    counts = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    shared = ctypes.c_int(0)
    err = _kernel_lib().gt_dfa_walk_counts(*head, records.data_ptr(), n_records,
                                           counts.data_ptr(), *_kernel_tail(dev, shared))
    if err != 0:
        raise RuntimeError(f"DFA walk count kernels launch failed: CUDA error {err}")
    dfa_walk_counts.launches += 2
    return counts


dfa_walk_counts.launches = 0


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
