"""ctypes loader for the native ingest library (libgtingest.so).

Builds the port's own copy of ``native/ingest.cc`` with g++ at first
use (grab_tpu_torch/_build.py); every entry point has a pure-Python
fallback so the framework runs without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import sys
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from grab_tpu_torch import _build

_lib = None
_load_attempted = False


class _Seg(ctypes.Structure):
    _fields_ = [
        ("path", ctypes.c_char_p),
        ("file_off", ctypes.c_int64),
        ("buf_off", ctypes.c_int64),
        ("length", ctypes.c_int64),
    ]


_WALK_CB = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p)
_ERR_CB = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p)


def _load():
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    try:
        lib = ctypes.CDLL(_build.ingest_library_path())
    except (_build.BuildError, OSError):
        return None
    lib.gt_abi_version.restype = ctypes.c_int
    if lib.gt_abi_version() < 1:
        return None
    lib.gt_walk.restype = ctypes.c_int
    lib.gt_walk.argtypes = [ctypes.c_char_p, _WALK_CB, _ERR_CB, ctypes.c_void_p]
    if lib.gt_abi_version() >= 2:
        lib.gt_pwalk.restype = ctypes.c_int
        lib.gt_pwalk.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            _WALK_CB,
            _ERR_CB,
            ctypes.c_void_p,
        ]
    if lib.gt_abi_version() >= 3:
        lib.gt_swalk.restype = ctypes.c_int
        lib.gt_swalk.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            _WALK_CB,
            _ERR_CB,
            ctypes.c_void_p,
        ]
    if lib.gt_abi_version() >= 4:
        lib.gt_transpose32.restype = ctypes.c_int
        lib.gt_transpose32.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
        ]
    if lib.gt_abi_version() >= 5:
        lib.gt_fill2.restype = ctypes.c_int
        lib.gt_fill2.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(_Seg),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
        ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def walk_native(
    root: str,
    on_error: Optional[Callable[[str, str], None]] = None,
    workers: int = 1,
) -> Optional[List[Tuple[str, int]]]:
    """Native walk; returns None if the library is unavailable.

    ``workers > 1`` uses the parallel thread-pool walk (gt_pwalk —
    greppin's parallel nftw counterpart, README.md:137-139); output
    order is identical to the serial walk by construction."""
    lib = _load()
    if lib is None:
        return None
    out: List[Tuple[str, int]] = []

    @_WALK_CB
    def cb(path, size, _ud):
        out.append((path.decode("utf-8", "surrogateescape"), int(size)))

    @_ERR_CB
    def err(path, msg, _ud):
        p = path.decode("utf-8", "surrogateescape")
        m = msg.decode("utf-8", "replace")
        if on_error:
            on_error(p, m)
        else:
            print(f"{p}: {m}", file=sys.stderr)

    rootb = root.encode("utf-8", "surrogateescape")
    if workers > 1 and hasattr(lib, "gt_pwalk"):
        lib.gt_pwalk(rootb, workers, cb, err, None)
    else:
        lib.gt_walk(rootb, cb, err, None)
    return out


def walk_native_iter(
    root: str,
    on_error: Optional[Callable[[str, str], None]] = None,
    workers: int = 8,
) -> Optional[Iterator[Tuple[str, int]]]:
    """Streaming native walk: gt_pwalk runs on a background thread
    (parallel lstat pool — greppin's overlapped-discovery counterpart,
    README.md:137-139) while the caller consumes (path, size) entries
    from a bounded queue, so scanning starts as soon as the first
    results assemble. Entry and error callbacks ride the same queue so
    their relative order is exactly the serial walker's. Returns None
    if the library is unavailable (callers fall back to the Python
    walker)."""
    lib = _load()
    if lib is None:
        return None
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=1 << 16)

    def runner():
        @_WALK_CB
        def cb(path, size, _ud):
            q.put((path.decode("utf-8", "surrogateescape"), int(size)))

        @_ERR_CB
        def errcb(path, msg, _ud):
            q.put(
                (
                    None,
                    path.decode("utf-8", "surrogateescape"),
                    msg.decode("utf-8", "replace"),
                )
            )

        rootb = root.encode("utf-8", "surrogateescape")
        try:
            if workers > 1 and hasattr(lib, "gt_pwalk"):
                lib.gt_pwalk(rootb, workers, cb, errcb, None)
            else:
                lib.gt_walk(rootb, cb, errcb, None)
        finally:
            q.put(None)

    def gen():
        t = threading.Thread(target=runner, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if item[0] is None:
                    _, p, m = item
                    if on_error:
                        on_error(p, m)
                    else:
                        print(f"{p}: {m}", file=sys.stderr)
                    continue
                yield item
        finally:
            t.join()

    return gen()


def walk_names_native(
    root: str,
    on_error: Optional[Callable[[str, str], None]] = None,
    workers: int = 8,
) -> Optional[List[str]]:
    """Structure-only parallel walk (gt_swalk): regular-file paths in
    exactly the serial walker's order, classified by readdir d_type —
    no per-file lstat. The multi-host phase-1 index walk
    (parallel/hostrun.host_entries). Returns None if unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "gt_swalk"):
        return None
    out: List[str] = []

    @_WALK_CB
    def cb(path, _size, _ud):
        out.append(path.decode("utf-8", "surrogateescape"))

    @_ERR_CB
    def err(path, msg, _ud):
        p = path.decode("utf-8", "surrogateescape")
        m = msg.decode("utf-8", "replace")
        if on_error:
            on_error(p, m)
        else:
            print(f"{p}: {m}", file=sys.stderr)

    lib.gt_swalk(
        root.encode("utf-8", "surrogateescape"), max(1, workers), cb, err, None
    )
    return out


def transpose_stream_rows(
    src: np.ndarray, nthreads: int = 8, out: "np.ndarray | None" = None
) -> np.ndarray:
    """Transpose an int32 [n_rows, row_words] stream-row matrix into
    word-major layout (out flat word g * n_rows + s = src[s, g]) — the
    TPU walk kernel's geometry, produced on the HOST so scan buffers
    upload born-transposed (ops/pallas_stridedfa round 5). Uses the
    blocked multithreaded native transpose (gt_transpose32, ~memory
    bandwidth) when available; numpy fallback otherwise. ``out`` reuses
    a caller-held [row_words, n_rows] int32 buffer (a fresh 32 MiB
    allocation per batch costs kernel page-zeroing)."""
    assert src.dtype == np.int32 and src.ndim == 2
    n_rows, row_words = src.shape
    lib = _load()
    if lib is not None and hasattr(lib, "gt_transpose32"):
        if not src.flags["C_CONTIGUOUS"]:
            src = np.ascontiguousarray(src)
        if out is not None:
            assert out.shape == (row_words, n_rows) and out.dtype == np.int32
            dst = out
        else:
            dst = np.empty((row_words, n_rows), dtype=np.int32)
        lib.gt_transpose32(
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_rows,
            row_words,
            nthreads,
        )
        return dst
    if out is not None:
        assert out.shape == (row_words, n_rows) and out.dtype == np.int32
        np.copyto(out, src.T)
        return out
    return np.ascontiguousarray(src.T)


def fill_segments(
    buf: np.ndarray,
    segments: List[Tuple[bytes, int, int, int]],
    block: int,
    nthreads: int = 8,
) -> List[int]:
    """Fill ``buf`` from (path, file_off, buf_off, length) segments;
    returns a per-segment errno list (0 = ok). Each segment's extent,
    its length rounded up to ``block``, is written whole: what the file
    gives, then zeros (the padding, a short read's tail, what a failed
    open or read left unread), so a reused ``buf`` needs no zeroing
    there first. Uses the native pread pool (GIL-free, parallel — the
    replacement for the reference's mmap streaming, grab.cc:137-169)
    when available, else a Python os.pread fallback with identical
    semantics."""
    n = len(segments)
    lib = _load()
    if lib is not None and hasattr(lib, "gt_fill2"):
        arr = (_Seg * n)()
        for i, (path, foff, boff, length) in enumerate(segments):
            arr[i].path = path
            arr[i].file_off = foff
            arr[i].buf_off = boff
            arr[i].length = length
        failed = (ctypes.c_int32 * n)()
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        lib.gt_fill2(ptr, arr, n, nthreads, failed, block)
        return list(failed)
    # Python fallback: sequential preads, one fd per distinct path run
    errs = [0] * n
    fd, fd_path = -1, None
    try:
        for i, (path, foff, boff, length) in enumerate(segments):
            done = 0
            if path != fd_path:
                if fd >= 0:
                    os.close(fd)
                    fd = -1
                fd_path = path
                try:
                    fd = os.open(path, os.O_RDONLY | os.O_NOCTTY)
                except OSError as e:
                    errs[i] = e.errno or 1
            if fd < 0:
                errs[i] = errs[i] or 1
            while fd >= 0 and done < length:
                try:
                    chunk = os.pread(fd, length - done, foff + done)
                except OSError as e:
                    errs[i] = e.errno or 1
                    break
                if not chunk:
                    break  # file shrank since stat: a short read
                buf[boff + done : boff + done + len(chunk)] = np.frombuffer(
                    chunk, dtype=np.uint8
                )
                done += len(chunk)
            buf[boff + done : boff + length + (-length % block)] = 0
    finally:
        if fd >= 0:
            os.close(fd)
    return errs
