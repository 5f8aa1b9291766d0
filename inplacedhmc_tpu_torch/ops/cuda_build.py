"""Build a hand-written CUDA kernel with ``nvcc`` and bind it with ``ctypes``.

Each source in ``inplacedhmc_tpu_torch/csrc/`` exposes an ``extern "C"``
launcher that takes raw device pointers, sizes and a ``cudaStream_t`` and
returns the launch's ``cudaGetLastError()``.  On first use the source is
compiled for Hopper (``sm_90a``) into a plain shared library under
``inplacedhmc_tpu_torch/_build/``, named by a hash of the flags, the source
and every file it includes with ``#include "..."`` (the whole-tree kernel's
sources share ``tree_kernel.cuh``), so that a stale library is never
loaded; it includes no PyTorch header, so the build takes seconds.  Nothing
is built when a module is imported, and nothing here runs on the CPU path.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Optional, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME``, else from the CUDA
    toolkit's default install prefix.  Raises when there is none: a CUDA
    tensor has no other path."""
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels of inplacedhmc_tpu_torch are built "
                       "from source on first use")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(path: str) -> list:
    """``path`` and every file it includes with ``#include "..."``,
    recursively (paths relative to the including file, as ``nvcc`` resolves
    them), each once, in the order first reached."""
    seen, todo = [], [os.path.abspath(path)]
    while todo:
        p = todo.pop(0)
        if p in seen:
            continue
        seen.append(p)
        with open(p, "rb") as f:
            todo += [os.path.join(os.path.dirname(p), inc.decode())
                     for inc in _INCLUDE.findall(f.read())]
    return seen


class CudaKernel:
    """One ``extern "C"`` launcher in one source file, built on first use.

    ``launches`` counts the launches that returned success; a run resets it
    to 0 and reads it afterwards to show that its path went through the
    kernel.  ``build_seconds`` and ``build_log`` (nvcc's ``-Xptxas -v``
    report) are set by the build."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._fn = None

    @property
    def source_path(self) -> str:
        return os.path.join(CSRC_DIR, self.source)

    def library_path(self) -> str:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in source_files(self.source_path):
            with open(path, "rb") as f:
                digest.update(f.read())
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")

    def build(self) -> str:
        """Compile the source unless its library exists; returns its path.
        The library is written under a temporary name and renamed into
        place, so a concurrent or interrupted build never leaves a partial
        file under the final name."""
        lib = self.library_path()
        t0 = time.perf_counter()
        if not os.path.exists(lib):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source_path]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source} "
                                   f"(exit {proc.returncode}):\n"
                                   f"{self.build_log}")
            os.replace(tmp, lib)
        self.build_seconds = time.perf_counter() - t0
        return lib

    def _function(self):
        if self._fn is None:
            fn = getattr(ctypes.CDLL(self.build()), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def call(self, *args) -> None:
        """Call the C entry point without counting a launch (a query, such
        as an occupancy); raises on a non-zero return."""
        rc = self._function()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} failed with cudaError_t {rc}")

    def launch(self, *args) -> None:
        """Launch through the C entry point; raises on a non-zero
        ``cudaError_t`` (a refused launch never runs, and a later
        synchronise would not report it)."""
        rc = self._function()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} failed with cudaError_t {rc}")
        self.launches += 1


def build_all(kernels: Sequence[CudaKernel]) -> None:
    """Build every kernel's library at once: one ``nvcc`` process per source
    (launchers of one source share its library), all started together, so
    the builds take about as long as the slowest."""
    by_source = {k.source: k for k in kernels}
    with concurrent.futures.ThreadPoolExecutor(max(len(by_source), 1)) as pool:
        for job in [pool.submit(k.build) for k in by_source.values()]:
            job.result()
