"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``hyperopt_tpu_torch/csrc/`` exposes a plain C
entry point.  At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``hyperopt_tpu_torch/_build/``
(named by a hash of the source and flags, so an edited source rebuilds)
and loaded with ``ctypes``.  Only the sources in the package are built;
nothing is fetched.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["CudaKernel", "LaunchTally", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: route (b) of the build: a plain-C shared library, no PyTorch headers.
#: ``-fmad=false`` keeps every multiply and add separately rounded, as
#: the plain PyTorch version (one op per kernel) rounds them.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc():
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the card")


class LaunchTally:
    """The launches one owner made (:meth:`CudaKernel.counting_into`); its
    threads may launch at once (a round and an abandoned watchdog worker)."""

    def __init__(self):
        self.n = 0
        self._lock = threading.Lock()

    def add(self):
        with self._lock:
            self.n += 1


class CudaKernel:
    """One kernel: its source, its C entry point, and its launch count.

    ``launches`` counts the launches made by the kernel's wrapper (a plain
    int the caller may reset), so a run can show that its main path went
    through the kernel.  It counts for the whole process; a launch made
    inside a :meth:`counting_into` block also counts into that block's
    :class:`LaunchTally`, so one of several services in a process can
    count its own rounds' launches.  ``build_seconds`` and ``build_log``
    (nvcc's ``-Xptxas=-v`` report of registers, shared memory and spills)
    are set by the build that produced the loaded library, or stay None
    when it was already built.
    """

    def __init__(self, source, symbol, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_seconds = None
        self.build_log = None
        self._fn = None
        self._local = threading.local()

    def count_launch(self):
        """Count one launch (the wrapper calls it where it launches)."""
        self.launches += 1
        tally = getattr(self._local, "tally", None)
        if tally is not None:
            tally.add()

    @contextlib.contextmanager
    def counting_into(self, tally):
        """Count this thread's launches inside the block into ``tally``."""
        prev = getattr(self._local, "tally", None)
        self._local.tally = tally
        try:
            yield tally
        finally:
            self._local.tally = prev

    def library_path(self):
        src = os.path.join(CSRC_DIR, self.source)
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        stem = os.path.splitext(self.source)[0]
        return src, os.path.join(BUILD_DIR, f"lib{stem}_{digest[:16]}.so")

    def build(self):
        """Compile the source unless its library exists; returns the path."""
        src, out = self.library_path()
        if os.path.isfile(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source}:\n{proc.stderr}")
        os.replace(tmp, out)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stderr
        return out

    def fn(self):
        """The loaded C entry point (built at first use)."""
        if self._fn is None:
            lib = ctypes.CDLL(self.build())
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn
