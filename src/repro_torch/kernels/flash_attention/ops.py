"""Public attention op: the hand-written CUDA kernel or its plain version.

Counterpart of ``repro.kernels.flash_attention.ops.attention``.  ``impl``
selects:

* ``"auto"`` (the main path): the plain version (:mod:`.ref`) for CPU
  tensors, the CUDA kernel (``csrc/flash_attention.cu``) for CUDA tensors;
* ``"kernel"``: always the CUDA kernel — a CPU tensor raises;
* ``"plain"``: always the plain version (tests and the chip smoke run only).

A CUDA tensor never falls back to the plain version and is never routed by
shape: the kernel builds and launches, or the call raises.  Deviations
from the JAX op: no ``block_q``/``block_kv``/``interpret`` arguments and no
``jnp_blockwise`` path.  The JAX op sends only ``sq == skv`` calls to its
Pallas kernel, and that kernel raises unless the length divides its block
(``kernel.py:110-111``; ``ops.py`` does not pad, despite the kernel's
message), so a TPU prompt of 200 tokens fails there.  The CUDA kernel
takes any ``sq``/``skv`` (ends aligned, ragged edges masked in the
kernel), any strides (the model's transposed views are read in place) and
a V head dim ``dv`` that differs from ``d`` (both at most 256).  Its output
is a ``(B, Hq, Sq, Dv)`` view of a ``(B, Sq, Hq, Dv)`` buffer, so the
model's ``transpose(1, 2).reshape(B, S, Hq·Dv)`` is free.

:data:`LAUNCHES` counts launches of the kernel, so a run can show that its
main path went through it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

#: kernel launches made by :func:`attention` in this process
LAUNCHES = 0

#: largest q/k and v head dim the kernel takes
MAX_HEAD_DIM = 256

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib_handle: Optional[ctypes.CDLL] = None


class KernelLaunchError(RuntimeError):
    """The CUDA runtime refused a launch (``cudaGetLastError() != 0``)."""


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from repro_torch.kernels.build import load
        lib = load("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.repro_flash_attention.argtypes = [
            ptr, ptr, ptr, ptr, strides, strides, strides, strides,
            i32, i32, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float,
            ctypes.c_float, i32, ptr]
        lib.repro_flash_attention.restype = i32
        lib.repro_flash_error_string.argtypes = [i32]
        lib.repro_flash_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"attention takes 4-D q, k, v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or v.shape[0] != b or k.shape[3] != d \
            or v.shape[1:3] != k.shape[1:3]:
        raise ValueError(f"attention shapes do not fit: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"GQA ratio must be integral: {hq} vs {k.shape[1]}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention takes f32 or bf16 q, k, v of one type, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 4)(*t.stride())


def _launch(q, k, v, causal: bool, window: int, softcap: float,
            scale: float) -> torch.Tensor:
    global LAUNCHES
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"the flash attention kernel takes q, k, v on one "
                         f"CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"the flash attention kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got d={d}, dv={dv}")
    if b > 65535 or hq > 65535:
        raise ValueError(f"batch {b} or heads {hq} exceed the kernel's grid")
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    if skv == 0:                           # no key: every row is masked
        return out.zero_()
    # rows - cols < sq + skv always holds: a wider window masks nothing
    window = max(0, min(int(window), sq + skv))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        lib = _lib()
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _strides(q), _strides(k), _strides(v), _strides(out), b, hq, hkv,
            sq, skv, d, dv, int(causal), window, float(softcap),
            float(scale), _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        msg = lib.repro_flash_error_string(rc).decode()
        raise KernelLaunchError(
            f"flash attention launch failed (q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, {q.dtype}): CUDA error "
            f"{rc}: {msg}")
    LAUNCHES += 1
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              scale: Optional[float] = None,
              impl: str = "auto") -> torch.Tensor:
    """Attention over ``q (B,Hq,Sq,D)``, ``k (B,Hkv,Skv,D)``,
    ``v (B,Hkv,Skv,Dv)`` → ``(B,Hq,Sq,Dv)`` in ``q.dtype``; GQA by ratio,
    ``scale`` defaults to ``D**-0.5``."""
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"impl must be auto, kernel or plain, got {impl!r}")
    _check(q, k, v)
    scale = scale if scale is not None else q.shape[3] ** -0.5
    if impl == "plain" or (impl == "auto" and q.device.type == "cpu"
                           and k.device.type == "cpu"
                           and v.device.type == "cpu"):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    return _launch(q, k, v, causal, window, softcap, scale)
