"""Build and load the hand-written CUDA kernels.

Every kernel source under ``kernels/<name>/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with :mod:`ctypes`.  A library may have several sources: each is
compiled to an object by its own ``nvcc``, all started together, and the
objects are linked into the library.  The build runs at first use, from
the sources in the package, into ``kernels/_build/`` (git-ignored).  A
library's file name carries a digest of its sources and of the headers
beside them, so an edited source or header is rebuilt and a built one is
reused.

Nothing here runs at import time: the CPU tests import every module and
have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

_ROOT = Path(__file__).resolve().parent
BUILD_DIR = _ROOT / "_build"

#: library name -> its CUDA sources
SOURCES: Dict[str, Tuple[Path, ...]] = {
    "matmul": (_ROOT / "matmul" / "csrc" / "matmul.cu",
               _ROOT / "matmul" / "csrc" / "matmul_wgmma.cu",
               _ROOT / "matmul" / "csrc" / "matmul_narrow.cu"),
    "flash_attention": (
        _ROOT / "flash_attention" / "csrc" / "flash_attention.cu",
        _ROOT / "flash_attention" / "csrc" / "flash_attention_wgmma.cu",
        _ROOT / "flash_attention" / "csrc" / "flash_attention_bwd.cu",
        _ROOT / "flash_attention" / "csrc" / "flash_attention_bwd_wgmma.cu"),
    "ssd_scan": (_ROOT / "ssd_scan" / "csrc" / "ssd_scan.cu",
                 _ROOT / "ssd_scan" / "csrc" / "ssd_scan_wgmma.cu",
                 _ROOT / "ssd_scan" / "csrc" / "ssd_scan_bwd.cu",
                 _ROOT / "ssd_scan" / "csrc" / "ssd_scan_bwd_wgmma.cu",
                 _ROOT / "ssd_scan" / "csrc" / "ssd_scan_bwd_state_wgmma.cu"),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def _inputs(name: str) -> list:
    """A library's sources and the headers (``*.cuh``) beside them."""
    dirs = sorted({src.parent for src in SOURCES[name]})
    return [*SOURCES[name], *(h for d in dirs for h in sorted(d.glob("*.cuh")))]


def library_path(name: str) -> Path:
    digest = hashlib.sha1()
    for src in _inputs(name):
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _run(cmd) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)


def build(name: str) -> float:
    """Compile the named library unless it is built already; the seconds
    the build took (0 when it was found built).  The compiler's output goes
    to :data:`BUILD_LOGS`.  Raises :class:`KernelBuildError` with that
    output when ``nvcc`` fails."""
    out = library_path(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o")
            for src in SOURCES[name]]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(objs)) as pool:
        procs = list(pool.map(
            lambda so: _run([nvcc, *NVCC_FLAGS, "-c", "-o", str(so[1]),
                             str(so[0])]), zip(SOURCES[name], objs)))
    if all(p.returncode == 0 for p in procs):
        procs.append(_run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                           *map(str, objs)]))
    BUILD_LOGS[name] = "".join(p.stdout for p in procs)
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [p for p in procs if p.returncode != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"kernel build failed: {name} (nvcc exit "
                               f"{failed[0].returncode}):\n"
                               f"{BUILD_LOGS[name]}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def sass_count(name: str, opcode: str, function: str = "") -> int:
    """How many instructions of ``opcode`` (e.g. ``HGMMA``) the built
    library's SASS holds (``cuobjdump -sass``, of the CUDA toolkit); with
    ``function``, only in the kernels whose (mangled) names contain it."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    proc = _run([str(tool), "-sass", str(library_path(name))])
    if proc.returncode != 0:
        raise KernelBuildError(f"cuobjdump failed on {name}:\n{proc.stdout}")
    word = re.compile(rf"\b{re.escape(opcode)}\b")
    count, inside = 0, not function
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            inside = function in line.split("Function :", 1)[1]
        elif inside and word.search(line):
            count += 1
    return count


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
