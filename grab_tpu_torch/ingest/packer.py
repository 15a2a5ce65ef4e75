"""Fixed-shape scan-buffer packing.

The device kernels are compiled ONCE for a fixed buffer shape; files of
arbitrary sizes are packed into that buffer as 512-aligned segments:

  buffer: [ seg(fileA) | seg(fileB) | seg(fileB cont.) | ... | zeros ]

Rules:
  * segment starts are aligned to the candidate block size so every
    candidate block maps to exactly one file;
  * consecutive segments of one file overlap by ``halo`` bytes, so
    matches spanning a segment boundary (≤ halo) are found — the same
    4 KiB-overlap scheme as the reference's chunked mmap loop
    (greppin src/grab.cc:151-154) one level up;
  * the search automaton's state always contains the unanchored start
    state (self-loop), so scanning straight across a file boundary into
    the next segment can only create false candidates in the first
    bytes of a segment, never miss matches — false candidates are
    discarded by host verification.

A batch is a plan: its segments and its fill pointer (``end``), no
bytes. The pipeline fills it into the buffer that the scan reads (the
pinned upload slot on the card), straight from disk by the native pread
pool (ingest/native gt_fill2) or, for in-memory data, by
``copy_segments``. That buffer is reused batch after batch, so both
write each segment's whole extent (its bytes, then zeros up to the next
block) and the pipeline zeroes the rest of what an earlier batch wrote
past ``end``. This replaces the reference's one-mmap-per-chunk I/O
(grab.cc:161) with batch uploads the device can stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional

import numpy as np


@dataclass
class Segment:
    file_idx: int  # index into the pipeline's file order
    file_off: int  # offset of segment start within the file
    buf_off: int  # offset within the scan buffer (block-aligned)
    length: int  # bytes of real data


@dataclass
class Batch:
    segments: List[Segment]
    end: int  # fill pointer: the last segment's extent ends here, zeros after


def copy_segments(
    dst: np.ndarray, segments: List[Segment], data_of: Callable[[int], object], block: int
) -> None:
    """Write in-memory file data into ``dst``: each segment's bytes from
    ``data_of(file_idx)`` (anything with the buffer protocol), then
    zeros up to the next ``block`` boundary."""
    for seg in segments:
        lo, hi = seg.buf_off, seg.buf_off + seg.length
        dst[lo:hi] = np.frombuffer(
            data_of(seg.file_idx), dtype=np.uint8, count=seg.length, offset=seg.file_off
        )
        dst[hi : hi + (-seg.length % block)] = 0


class BatchPacker:
    """Packs a sequence of (file_idx, data) into fixed-size buffers."""

    def __init__(
        self,
        buf_size: int,
        block: int = 512,
        halo: int = 0x1000,
        no_split: bool = False,
    ):
        assert buf_size % block == 0
        assert halo % block == 0
        self.buf_size = buf_size
        self.block = block
        self.halo = halo
        # no_split: a file that fits a whole buffer never spans two
        # batches (flush first instead) — used for unbounded-length
        # patterns, where the halo cannot cover cross-batch matches and
        # the strided-DFA threading makes in-buffer coverage exact
        self.no_split = no_split
        self.min_seg = halo + block  # smallest useful continuation segment
        self._used = 0  # block-aligned fill pointer
        self._segments: List[Segment] = []

    def _flush(self) -> Optional[Batch]:
        if not self._segments:
            return None
        batch = Batch(self._segments, self._used)
        self._used = 0
        self._segments = []
        return batch

    def feed_size(self, file_idx: int, size: int) -> Iterator[Batch]:
        """Plan one file of ``size`` bytes into segments; yields full
        batches as they close. Nothing is read here: the pipeline fills
        a batch when it is submitted, so a clean file is never opened in
        Python at all (the reference's I/O loop IS its scan loop,
        grab.cc:137-169; ours is the fill pass)."""
        pos = 0
        if size == 0:
            return
        while True:
            free = self.buf_size - self._used
            remaining = size - pos
            if (
                self.no_split
                and remaining <= self.buf_size
                and free < remaining + (-remaining % self.block)
                and self._used
            ):
                b = self._flush()
                if b:
                    yield b
                continue
            if free < min(self.min_seg, remaining + (-remaining % self.block)):
                b = self._flush()
                if b:
                    yield b
                continue
            if remaining <= free:
                seg_len = remaining
            else:
                # continuation: keep the next segment's file offset
                # block-aligned (halo is a block multiple)
                seg_len = (free // self.block) * self.block
            self._segments.append(Segment(file_idx, pos, self._used, seg_len))
            self._used += seg_len + (-seg_len % self.block)
            if pos + seg_len >= size:
                return
            pos += seg_len - self.halo  # overlap: spans ≤ halo never lost

    def finish(self) -> Optional[Batch]:
        return self._flush()
