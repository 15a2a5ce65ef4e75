"""Builds the port's native libraries from the package's own sources.

Two kinds, both with a plain C interface loaded through ``ctypes``:

  * CUDA kernels: each ``csrc/<name>.cu`` (with the shared
    ``csrc/*.cuh`` headers) is compiled by ``nvcc`` for Hopper
    (``sm_90a``) into ``lib<name>-<hash>.so``;
  * host ingest: ``ingest/native/ingest.cc`` is compiled by ``g++`` into
    ``libgtingest-<hash>.so``.

A library is built at first use into ``build/`` inside the package (a
directory the repository ignores) and named by the hash of its source
and flags, so an edited source is rebuilt and a stale library is never
loaded. Each build writes a private temporary file and renames it into
place, so concurrent processes may race to build without harm. A failed
build raises with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
INGEST_SRC = os.path.join(PKG_DIR, "ingest", "native", "ingest.cc")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
GXX_FLAGS = ["-std=c++17", "-O2", "-Wall", "-Wextra", "-fPIC", "-shared", "-pthread"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


@dataclass
class KernelLoads:
    """Kernel libraries in this process: seconds ``cuda_library`` spent
    building and loading them, libraries built with nvcc (``build_cuda``),
    libraries loaded (``cuda_library``). ``--stats`` prints a request's
    share as the difference of two ``snapshot()``s."""

    seconds: float = 0.0
    built: int = 0
    loaded: int = 0

    def snapshot(self) -> Tuple[float, int, int]:
        return self.seconds, self.built, self.loaded


kernel_loads = KernelLoads()


class BuildError(RuntimeError):
    """A native source failed to compile; the message holds stderr."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _target(
    name: str, src: str, flags: Sequence[str], deps: Sequence[str] = ()
) -> str:
    h = hashlib.sha256()
    for path in (src, *deps):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update("\0".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(cmd: List[str], out: str) -> "tuple[subprocess.Popen, str]":
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.Popen(
            cmd + ["-o", tmp], stdout=subprocess.PIPE, stderr=subprocess.PIPE
        )
    except OSError as e:
        raise BuildError(f"cannot run {cmd[0]}: {e}") from e
    return proc, tmp


def _finish(proc: subprocess.Popen, tmp: str, out: str, timeout: float) -> None:
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise BuildError(f"build of {out} timed out after {timeout:.0f}s")
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise BuildError(
            f"build of {os.path.basename(out)} failed "
            f"(exit {proc.returncode}):\n{err.decode(errors='replace')}"
        )
    os.replace(tmp, out)


def _cuda_cmd(name: str) -> "tuple[List[str], str]":
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    # the shared headers (csrc/*.cuh) are part of every kernel's key
    headers = sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")
    )
    return [_nvcc(), *NVCC_FLAGS, src], _target(name, src, NVCC_FLAGS, headers)


def build_cuda(names: Sequence[str], timeout: float = 600.0) -> Dict[str, str]:
    """Compile ``csrc/<name>.cu`` for every name not built yet, all
    nvcc processes started together; → {name: library path}."""
    paths, jobs = {}, []
    for name in names:
        cmd, out = _cuda_cmd(name)
        paths[name] = out
        if not os.path.exists(out):
            jobs.append((_start(cmd, out), out))
    for (proc, tmp), out in jobs:
        _finish(proc, tmp, out, timeout)
    kernel_loads.built += len(jobs)
    return paths


def cuda_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(build_cuda([name])[name])
            _loaded[name] = lib
            kernel_loads.loaded += 1
            kernel_loads.seconds += time.perf_counter() - t0
        return lib


def ingest_library_path(timeout: float = 300.0) -> str:
    """Path of the host ingest library, built with g++ if needed.
    Raises BuildError when it cannot be built."""
    cxx = os.environ.get("CXX", "g++")
    out = _target("gtingest", INGEST_SRC, GXX_FLAGS)
    with _lock:
        if not os.path.exists(out):
            proc, tmp = _start([cxx, *GXX_FLAGS, INGEST_SRC], out)
            _finish(proc, tmp, out, timeout)
    return out
