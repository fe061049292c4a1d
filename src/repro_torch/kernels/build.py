"""Build and load the hand-written CUDA kernels.

Every kernel source under ``kernels/<name>/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with :mod:`ctypes`.  The build runs at first use, from the sources in
the package, into ``kernels/_build/`` (git-ignored).  A library's file name
carries a digest of its source, so an edited source is rebuilt and a built
one is reused.

Nothing here runs at import time: the CPU tests import every module and
have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_ROOT = Path(__file__).resolve().parent
BUILD_DIR = _ROOT / "_build"

#: library name -> CUDA source, relative to this package
SOURCES: Dict[str, Path] = {
    "matmul": _ROOT / "matmul" / "csrc" / "matmul.cu",
    "flash_attention": _ROOT / "flash_attention" / "csrc" / "flash_attention.cu",
    "ssd_scan": _ROOT / "ssd_scan" / "csrc" / "ssd_scan.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

#: compiler output (``-Xptxas -v``: registers, shared memory, spills) of the
#: libraries built by this process, by name
BUILD_LOGS: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built on the machine that has the card")
    return found


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> float:
    """Compile the named library unless it is built already; the seconds
    ``nvcc`` took (0 when it was found built).  The compiler's output goes
    to :data:`BUILD_LOGS`.  Raises :class:`KernelBuildError` with that
    output when ``nvcc`` fails."""
    out = library_path(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCES[name])], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    BUILD_LOGS[name] = proc.stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"kernel build failed: {name} (nvcc exit "
                               f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
