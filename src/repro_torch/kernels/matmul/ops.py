"""Public matmul op: the hand-written CUDA kernel or its plain version.

Counterpart of ``repro.kernels.matmul.ops.matmul``.  ``impl`` selects:

* ``"auto"`` (the main path): the plain version (:mod:`.ref`) for a CPU
  tensor, the CUDA kernel (``csrc/matmul.cu``) for a CUDA tensor;
* ``"kernel"``: always the CUDA kernel — a CPU tensor raises;
* ``"plain"``: always the plain version (tests and the chip smoke run only).

A CUDA tensor never falls back to the plain version: the kernel builds and
launches, or the call raises.  A product whose output has too few tiles for
the card splits K across blocks (:func:`plan_launch`); its partial sums are
then added by a second kernel, launched by :func:`splitk_reduce`.  Deviations from the JAX op: no
``block_m/n/k`` or ``interpret`` arguments, and no padding — the kernel
masks ragged edges itself, so no operand is copied (the JAX wrapper pads
both operands to block multiples, which at the scorer's width would copy
the 640 MB weight on every dispatch).  ``out_dtype`` is exposed as in
``matmul_ref``.

:data:`LAUNCHES` counts launches of the tile kernel (one per :func:`matmul`
call that reaches it) and :data:`REDUCE_LAUNCHES` those of the split-K
reduction, so a run can show that its main path went through both.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.matmul.ref import matmul_ref, splitk_reduce_ref

#: tile-kernel launches made by :func:`matmul` in this process
LAUNCHES = 0
#: split-K reduction launches made by :func:`splitk_reduce` in this process
REDUCE_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: tile configuration id -> (BM, BN, BK), as instantiated in csrc/matmul.cu
TILE_CONFIGS = {0: (8, 128, 32), 1: (64, 64, 16)}

_lib_handle: Optional[ctypes.CDLL] = None
_SM_COUNTS: Dict[int, int] = {}


class KernelLaunchError(RuntimeError):
    """The CUDA runtime refused a launch (``cudaGetLastError() != 0``)."""


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from repro_torch.kernels.build import load
        lib = load("matmul")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_matmul.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                     i32, i32, i32, i32, ptr]
        lib.repro_matmul.restype = i32
        lib.repro_splitk_reduce.argtypes = [ptr, ptr, ctypes.c_longlong, i32,
                                            i32, ptr]
        lib.repro_splitk_reduce.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def plan_launch(m: int, n: int, k: int, num_sms: int) -> Tuple[int, int, int]:
    """``(config, splits, kchunk)`` for an ``(m, k) @ (k, n)`` product.

    Skinny ``a`` (m <= 16, the scorer's buckets) takes 8 x 128 tiles, larger
    products 64 x 64.  When the output has fewer tiles than two per SM, K is
    split across blocks (each split at least four BK steps deep) and
    :func:`splitk_reduce` adds the partial sums in split order —
    deterministic.
    """
    config = 0 if m <= 16 else 1
    bm, bn, bk = TILE_CONFIGS[config]
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    target = 2 * num_sms
    splits = 1
    if tiles < target:
        splits = max(1, min(math.ceil(target / tiles),
                            math.ceil(k / (4 * bk))))
    kchunk = math.ceil(math.ceil(k / splits) / bk) * bk
    splits = math.ceil(k / kchunk)
    return config, splits, kchunk


def _check(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.dtype:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul takes 2-D operands, got {tuple(a.shape)} "
                         f"x {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise TypeError(f"matmul takes two f32 or two bf16 operands, got "
                        f"{a.dtype} and {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    return out_dtype


def _sm_count(device: torch.device) -> int:
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    if dev not in _SM_COUNTS:
        _SM_COUNTS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SM_COUNTS[dev]


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().repro_cuda_error_string(rc).decode()
        raise KernelLaunchError(f"{what}: CUDA error {rc}: {msg}")


def _launch(a: torch.Tensor, b: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    global LAUNCHES
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"the matmul kernel takes operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the matmul kernel takes contiguous row-major "
                         "operands")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"matmul dims must be < 2**31, got {m}, {k}, {n}")
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=out_dtype, device=a.device)
    lib = _lib()
    config, splits, kchunk = plan_launch(m, n, k, _sm_count(a.device))
    bm = TILE_CONFIGS[config][0]
    if math.ceil(m / bm) > 65535:
        raise ValueError(f"matmul: {m} rows exceed the kernel's grid")
    if splits > 1:
        out = torch.empty((splits, m, n), dtype=torch.float32,
                          device=a.device)
    else:
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        rc = lib.repro_matmul(a.data_ptr(), b.data_ptr(),
                              None if splits > 1 else out.data_ptr(),
                              out.data_ptr() if splits > 1 else None,
                              m, n, k, _DTYPE_CODES[a.dtype],
                              _DTYPE_CODES[out_dtype], config, splits, kchunk,
                              stream)
    _raise_on(rc, f"matmul kernel launch failed ({m}x{k} @ {k}x{n}, config "
                  f"{config}, splits {splits})")
    LAUNCHES += 1
    return splitk_reduce(out, out_dtype=out_dtype) if splits > 1 else out


def splitk_reduce(partial: torch.Tensor, *, impl: str = "auto",
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``partial`` (splits, m, n) f32 summed over its first axis in split
    order: the second pass of a split-K :func:`matmul`.  ``impl`` is
    ``"auto"`` (plain version for a CPU tensor, kernel for a CUDA tensor)
    or ``"kernel"``, as in :func:`matmul`."""
    global REDUCE_LAUNCHES
    if impl not in ("auto", "kernel"):
        raise ValueError(f"impl must be auto or kernel, got {impl!r}")
    if partial.dim() != 3 or partial.dtype != torch.float32:
        raise TypeError(f"splitk_reduce takes (splits, m, n) f32 partial "
                        f"sums, got {tuple(partial.shape)} {partial.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    if impl == "auto" and partial.device.type == "cpu":
        return splitk_reduce_ref(partial, out_dtype)
    if partial.device.type != "cuda" or not partial.is_contiguous():
        raise ValueError(f"the split-K reduction kernel takes a contiguous "
                         f"CUDA tensor, got one on {partial.device}")
    splits, m, n = partial.shape
    out = torch.empty((m, n), dtype=out_dtype, device=partial.device)
    if splits == 0 or m * n == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(partial.device).cuda_stream
    with torch.cuda.device(partial.device):
        rc = _lib().repro_splitk_reduce(partial.data_ptr(), out.data_ptr(),
                                        m * n, splits,
                                        _DTYPE_CODES[out_dtype], stream)
    _raise_on(rc, f"split-K reduction launch failed ({splits} x {m}x{n})")
    REDUCE_LAUNCHES += 1
    return out


def matmul(a: torch.Tensor, b: torch.Tensor, *, impl: str = "auto",
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` for 2-D f32 or bf16 operands, summed in f32."""
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"impl must be auto, kernel or plain, got {impl!r}")
    out_dtype = _check(a, b, out_dtype)
    if impl == "plain" or (impl == "auto" and a.device.type == "cpu"
                           and b.device.type == "cpu"):
        return matmul_ref(a, b, out_dtype)
    return _launch(a, b, out_dtype)
