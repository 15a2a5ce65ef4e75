"""Shared pieces of the corpus generators: line pools turned into text
in bulk, where planted strings go, and writing a tree of files.

Text is made in numpy from a pool of distinct lines (built once in
Python) by drawing line indices and gathering their bytes, a few MiB at
a time, so a 1 GiB corpus takes seconds. A file's bytes are then a
slice of that text.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from scanbench.reference import CHUNK, OVERLAP

GATHER = 4 << 20  # bytes of text gathered per numpy pass


def pool_arrays(lines: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(flat bytes, start offsets, lengths) of a line pool."""
    lens = np.fromiter((len(x) for x in lines), dtype=np.int64, count=len(lines))
    starts = np.zeros(len(lines), dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    flat = np.frombuffer(b"".join(lines), dtype=np.uint8)
    return flat, starts, lens


def text_from_pool(rng: np.random.Generator, pool, nbytes: int) -> np.ndarray:
    """``nbytes`` of text: lines drawn uniformly from the pool and
    concatenated."""
    flat, starts, lens = pool
    out = np.empty(nbytes, dtype=np.uint8)
    avg = float(lens.mean())
    pos = 0
    while pos < nbytes:
        want = min(GATHER, nbytes - pos)
        k = int(want / avg * 1.2) + 8
        idx = rng.integers(0, len(lens), size=k)
        ln = lens[idx]
        cum = np.cumsum(ln)
        k = int(np.searchsorted(cum, want)) + 1
        idx, ln, cum = idx[:k], ln[:k], cum[:k]
        total = int(cum[-1])
        src = np.repeat(starts[idx] - (cum - ln), ln) + np.arange(total, dtype=np.int64)
        take = min(want, total)
        out[pos : pos + take] = flat[src[:take]]
        pos += take
    return out


PLACES = ("start", "end", "cross512", "random")
CHUNK_PLACES = ("overlap", "cross_chunk")  # a file over one of grab's chunks


def plant_position(rng: np.random.Generator, size: int, n: int, place: str) -> int:
    """Where a planted string of ``n`` bytes goes in a file of ``size``
    bytes: its first byte, its last bytes (the file then ends in the
    match, with no newline after it), across a 512-byte block boundary,
    anywhere, inside the overlap at the end of grab's first chunk (both
    chunks report it), or across that chunk's end (only the second
    sees it). Clamped to fit the file."""
    if place == "start":
        pos = 0
    elif place == "end":
        pos = size - n
    elif place == "cross512" and size >= 512 + n:
        k = int(rng.integers(1, size // 512 + 1))
        pos = k * 512 - int(rng.integers(1, n))
    elif place == "overlap" and size > CHUNK:
        pos = int(rng.integers(CHUNK - OVERLAP, CHUNK - n + 1))
    elif place == "cross_chunk" and size > CHUNK:
        pos = CHUNK - int(rng.integers(1, n))
    else:
        pos = int(rng.integers(0, max(1, size - n + 1)))
    return max(0, min(pos, size - n))


def write_tree(root: str, files: Iterable[Tuple[str, object]], threads: int = 8) -> None:
    """Write (relative path, bytes-like) pairs under ``root``; the
    directories are made first, the writes spread over a few threads
    (a write releases the interpreter lock)."""
    files = list(files)
    for d in sorted({os.path.dirname(p) for p, _ in files}):
        os.makedirs(os.path.join(root, d), exist_ok=True)

    def put(batch: List[Tuple[str, object]]):
        for rel, data in batch:
            with open(os.path.join(root, rel), "wb") as f:
                f.write(data)

    step = max(1, len(files) // (threads * 8))
    batches = [files[i : i + step] for i in range(0, len(files), step)]
    with ThreadPoolExecutor(max_workers=threads) as ex:
        for fut in [ex.submit(put, b) for b in batches]:
            fut.result()
