"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. It is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
the repository's git-ignored ``build/`` directory at first use, and loaded
with ``ctypes``. The library's file name carries a hash of its source and
flags, so an edited source is never served from a stale build. Nothing is
compiled when a module is imported: the CPU tests import every module and
have no ``nvcc``.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


class Kernel:
    """One CUDA source, its built library and its launch count.

    ``signatures`` maps each C entry point to its ``ctypes`` argument types;
    every entry returns ``cudaGetLastError()`` as an int. ``launches`` is
    raised by one at each launch by the Python wrapper, and nowhere else;
    ``entry_launches`` counts the same launches by entry point.
    """

    def __init__(self, name: str, signatures: Dict[str, list]):
        self.name = name
        self.signatures = signatures
        self.launches = 0
        self.entry_launches = collections.Counter()
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._lib = None

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    @property
    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def _start_build(self):
        if self.lib_path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        return (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True),
                tmp, time.perf_counter())

    def _finish_build(self, job) -> None:
        proc, tmp, t0 = job
        out, _ = proc.communicate()
        self.build_seconds = time.perf_counter() - t0
        self.build_log = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
        os.replace(tmp, self.lib_path)  # atomic: no half-written library

    def lib(self):
        """The loaded library, built first if needed."""
        if self._lib is None:
            build([self])
            lib = ctypes.CDLL(str(self.lib_path))
            for fn, argtypes in self.signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args) -> None:
        """Launch through entry ``fn`` and count it; raises on a CUDA error."""
        err = getattr(self.lib(), fn)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}.{fn} failed: CUDA error {err}")
        self.launches += 1
        self.entry_launches[fn] += 1


def build(kernels: Iterable[Kernel]) -> List[Kernel]:
    """Build every kernel whose library is missing, one ``nvcc`` each, all
    started together."""
    kernels = list(kernels)
    jobs = [(k, k._start_build()) for k in kernels]
    errors = []
    for k, job in jobs:  # wait for every nvcc before raising
        if job is not None:
            try:
                k._finish_build(job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return kernels


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def account_meta(kernel: str, flops: float, nbytes: float) -> None:
    """Report the cost of a launch traced on ``meta`` tensors (the
    dry-run), where no kernel runs: every active dispatch mode that has an
    ``account(kernel, flops, nbytes)`` method hears of it."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in _get_current_dispatch_mode_stack():
        if hasattr(mode, "account"):
            mode.account(kernel, flops, nbytes)
