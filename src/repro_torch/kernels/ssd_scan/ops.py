"""Public SSD op: the hand-written CUDA kernel or its plain version, and the
O(1) decode step.

Counterpart of ``repro.kernels.ssd_scan.ops``.  :func:`ssd_scan`'s
``impl`` selects:

* ``"auto"`` (the main path): the chunked plain version
  (:func:`.ref.ssd_chunked_ref`) for CPU tensors, the CUDA kernel
  (``csrc/ssd_scan.cu``) for CUDA tensors;
* ``"kernel"``: always the CUDA kernel — a CPU tensor raises;
* ``"plain"``: always the chunked plain version (tests and the chip smoke
  run only).

A CUDA tensor never falls back to the plain version: the kernel builds and
launches, or the call raises.  Deviations from the JAX op: no
``interpret`` argument and no ``"jnp"``/``"ref"``/``"pallas"`` impls
(:func:`.ref.ssd_ref` is the sequential oracle).  JAX pads S to a multiple
of the chunk; here the kernel masks the last partial chunk itself and the
plain version takes it short, so nothing is padded or copied — the chunk
boundaries are JAX's, from position 0.  B and C are read by strides, so
the model's slices of one (B, S, 2N) tensor go in as they are.  The
kernel takes states up to :data:`MAX_STATE` and head dims up to
:data:`MAX_HEAD_DIM`, and raises beyond them; a bf16 ``dt`` or ``A`` is
cast to f32 first.  A stated deviation: the kernel's chunks are at most
:data:`MAX_CHUNK` (128) rows, so a larger requested chunk — JAX's
default of 256 among them — runs as the kernel at chunk 128.  The
chunked scan is the same recurrence at any chunk length (the state
carried across a boundary is exact); only the rounding order differs.

:func:`ssd_final_state` and :func:`ssd_decode_step` are plain torch, as
they are jnp in JAX (no Pallas kernel).

:data:`LAUNCHES` counts launches of the kernel, so a run can show that its
main path went through it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

#: kernel launches made by :func:`ssd_scan` in this process
LAUNCHES = 0

#: largest chunk length, state dim N and head dim P the kernel takes
MAX_CHUNK = 128
MAX_STATE = 128
MAX_HEAD_DIM = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib_handle: Optional[ctypes.CDLL] = None


class KernelLaunchError(RuntimeError):
    """The CUDA runtime refused a launch (``cudaGetLastError() != 0``)."""


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from repro_torch.kernels.build import load
        lib = load("ssd_scan")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.repro_ssd_scan.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, strides, strides, i64, strides,
            strides, strides, i32, i32, i32, i32, i32, i32, i32, ptr]
        lib.repro_ssd_scan.restype = i32
        lib.repro_ssd_error_string.argtypes = [i32]
        lib.repro_ssd_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check(x, dt, A, Bm, Cm) -> None:
    if x.dim() != 4:
        raise ValueError(f"ssd_scan takes x (B,S,H,P), got {tuple(x.shape)}")
    b, s, h, _ = x.shape
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) \
            or Bm.dim() != 3 or tuple(Bm.shape[:2]) != (b, s) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan shapes do not fit: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"ssd_scan takes f32 or bf16 x, B, C of one type, "
                        f"got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    for name, t in (("dt", dt), ("A", A)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"ssd_scan takes an f32 or bf16 {name}, got "
                            f"{t.dtype}")


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * t.dim())(*t.stride())


def _launch(x, dt, A, Bm, Cm, chunk: int) -> torch.Tensor:
    global LAUNCHES
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (dt, A, Bm, Cm)):
        raise ValueError(f"the SSD scan kernel takes x, dt, A, B, C on one "
                         f"CUDA device, got {x.device}, {dt.device}, "
                         f"{A.device}, {Bm.device}, {Cm.device}")
    b, s, h, p = x.shape
    n = Bm.shape[2]
    if n > MAX_STATE or p > MAX_HEAD_DIM:
        raise ValueError(f"the SSD scan kernel takes states up to "
                         f"{MAX_STATE} and head dims up to {MAX_HEAD_DIM}, "
                         f"got N={n}, P={p}")
    chunk = min(chunk, MAX_CHUNK)          # the same scan, other rounding
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid")
    dt, A = dt.float(), A.float()          # no copy when already f32
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    if y.numel() == 0:
        return y
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        lib = _lib()
        rc = lib.repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), _strides(x), _strides(dt),
            A.stride(0), _strides(Bm), _strides(Cm), _strides(y), b, s, h,
            p, n, chunk, _DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        msg = lib.repro_ssd_error_string(rc).decode()
        raise KernelLaunchError(
            f"SSD scan launch failed (x {tuple(x.shape)}, N {n}, chunk "
            f"{chunk}, {x.dtype}): CUDA error {rc}: {msg}")
    LAUNCHES += 1
    return y


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256,
             impl: str = "auto") -> torch.Tensor:
    """SSD forward over a full sequence: ``x (B,S,H,P)``, ``dt (B,S,H)``,
    ``A (H,)``, ``B/C (B,S,N)`` → ``y (B,S,H,P)`` in ``x.dtype``, in chunks
    of ``min(chunk, S)`` steps (the kernel's at most :data:`MAX_CHUNK`)."""
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"impl must be auto, kernel or plain, got {impl!r}")
    _check(x, dt, A, Bm, Cm)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    chunk = max(1, min(int(chunk), x.shape[1]))
    on_cpu = all(t.device.type == "cpu" for t in (x, dt, A, Bm, Cm))
    if impl == "plain" or (impl == "auto" and on_cpu):
        return ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
    return _launch(x, dt, A, Bm, Cm, chunk)


def ssd_final_state(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """Final SSM state ``h_S = Σ_j exp(a_S − a_j)·dt_j·(B_j ⊗ x_j)``,
    ``(B,H,N,P)`` f32: it seeds the decode recurrence after a prefill."""
    xf, dtf = x.float(), dt.float()
    a_cs = torch.cumsum(dtf * A.float()[None, None, :], dim=1)  # (B,S,H)
    w = torch.exp(a_cs[:, -1:, :] - a_cs) * dtf
    return torch.einsum("bsn,bshp->bhnp", Bm.float(), xf * w[..., None])


def ssd_decode_step(h: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
                    A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent step: ``h (B,H,N,P)``, ``x_t (B,H,P)``, ``dt_t
    (B,H)``, ``B_t/C_t (B,N)`` → ``(y_t (B,H,P) in x_t.dtype, h_new in
    h.dtype)``."""
    hf = h.float()
    decay = torch.exp(dt_t.float() * A.float()[None])
    upd = torch.einsum("bn,bhp->bhnp", B_t.float(),
                       x_t.float() * dt_t[..., None])
    hnew = hf * decay[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", C_t.float(), hnew)
    return y.to(x_t.dtype), hnew.to(h.dtype)
