"""Multi-stream DFA candidate scan: the last-resort device walk.

The exact-automaton tier takes this walk when the automaton has no
strided-DFA plan (ops/stridedfa.stride_plan is None) or the scan buffer
is under 1 MiB. The buffer is split into S independent streams, each
walked from the automaton's start state one byte per step, with an
H-byte halo past its segment end: a match (end) at position p is found
by the stream whose extended window covers p from a start at or before
the match start. Matches longer than H that span a stream boundary are
missed, the documented limit of the 4 KiB chunk overlap.

The JAX package computes this outside any hand-written kernel
(grab_tpu/ops/dfa_scan.py: a ``lax.scan`` whose step is one [S]-wide
table gather), so the port is plain PyTorch as well, on either device: a
Python loop of seg + halo dependent steps, each one add and one gather
over the S stream states. It is latency-bound by design and kept only
for automata nothing faster serves.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from grab_tpu_torch.ops.corewords import decode_packed_flags

DEFAULT_HALO = 0x1000  # 4 KiB, the reference's chunk overlap


def expand_byte_table(table: np.ndarray, class_map: np.ndarray) -> np.ndarray:
    """[n_states, n_classes] + byte→class map → [n_states, 256] table:
    the scan step then gathers only table[state, byte]."""
    return np.ascontiguousarray(table[:, class_map])


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
        self.start = int(dfa.start)
        self._table = expand_byte_table(dfa.table, dfa.class_map).astype(np.int32)
        self._accept = np.asarray(dfa.accept_mask, dtype=bool)
        self._dev = {}  # device → (table, accept)

    def _tables(self, device: torch.device):
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (
                torch.from_numpy(self._table).to(device),
                torch.from_numpy(self._accept).to(device),
            )
        return self._dev[key]

    def packed(self, data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 [buf_size] on its device → (total int32 [1]: flagged
        blocks, packed int32 [n_blocks/32]: bit b of [g] = block 32g+b)."""
        table, accept = self._tables(data.device)
        bm = dfa_scan_bitmap(table, accept, self.start, data,
                             n_streams=self.n_streams, halo=self.halo)
        flags = (bitmap_block_counts(bm, self.block) > 0).view(-1, 32).to(torch.int32)
        total = flags.sum(dtype=torch.int32).reshape(1)
        packed = torch.zeros(flags.shape[0], dtype=torch.int32, device=data.device)
        for b in range(32):
            packed |= flags[:, b] << b
        return total, packed

    def flags_np(self, packed, n_blocks: int) -> np.ndarray:
        return decode_packed_flags(packed, n_blocks, 0, 0)
