"""Public attention op: the hand-written CUDA kernels or their plain version.

Counterpart of ``repro.kernels.flash_attention.ops.attention``.  ``impl``
selects:

* ``"auto"`` (the main path): the plain version (:mod:`.ref`) for CPU
  tensors, a CUDA kernel for CUDA tensors;
* ``"kernel"``: always a CUDA kernel — a CPU tensor raises;
* ``"plain"``: always the plain version (tests and the chip smoke run only).

A CUDA call goes by dtype (:func:`route`), never by shape:

* bf16 → ``csrc/flash_attention_wgmma.cu`` (``flash_attention_kernel_wgmma``),
  the tensor-core kernel: ``wgmma`` for Q·Kᵀ and P·V with f32 accumulators,
  a 2-stage TMA/``mbarrier`` ring of K/V tiles.  It replaces the TPU kernel
  ``src/repro/kernels/flash_attention/kernel.py:96`` for bf16.  The tensor
  cores' bf16 rate bounds it at the gemma2-2b prefill.  P enters P·V as
  three bf16 terms (twice one-term flash attention's tensor work), so P is
  held to f32's precision and the kernel meets the limits the FFMA kernel
  met; ``chip_smoke.py`` holds it to at most twice the plain f32 version's
  count of outputs off the exact ones.  It reads q, k, v through 4-D
  tensor maps (:func:`tma_plan`):
  TMA needs the last dim contiguous, 16-byte-aligned base addresses and
  strides that are multiples of 16 bytes.  The model's ``transpose(1, 2)``
  views meet this; any other bf16 layout is first copied into one that
  does (:data:`COPIES` counts those copies).
* f32 → ``csrc/flash_attention.cu`` (``flash_attention_kernel``), f32 FFMA
  on CUDA cores: the 2e-4 f32 limits are beyond bf16 and TF32 tensor
  cores, and no model runs f32 attention at full width.

A CUDA tensor never falls back to the plain version or to the other
kernel: the kernel builds and launches, or the call raises
(:class:`KernelLaunchError` for a launch the CUDA runtime refuses).
Deviations from the JAX op: no ``block_q``/``block_kv``/``interpret``
arguments and no ``jnp_blockwise`` path.  The JAX op sends only
``sq == skv`` calls to its Pallas kernel, and that kernel raises unless
the length divides its block (``kernel.py:110-111``; ``ops.py`` does not
pad, despite the kernel's message), so a TPU prompt of 200 tokens fails
there.  Both CUDA kernels take any ``sq``/``skv`` (ends aligned, ragged
edges masked in the kernel), the model's transposed views in place, and
a V head dim ``dv`` that differs from ``d`` (both at most 256).  The
output is a ``(B, Hq, Sq, Dv)`` view of a ``(B, Sq, Hq, Dv)`` buffer, so
the model's ``transpose(1, 2).reshape(B, S, Hq·Dv)`` is free.

:data:`LAUNCHES` counts every kernel launch, :data:`TC_LAUNCHES` and
:data:`FFMA_LAUNCHES` those of each kernel, so a run can show that its
main path went through them.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

#: kernel launches made by :func:`attention` in this process: every one,
#: the tensor-core (bf16) kernel's and the FFMA (f32) kernel's
LAUNCHES = 0
TC_LAUNCHES = 0
FFMA_LAUNCHES = 0

#: copies of a bf16 q, k or v that TMA cannot read in place
COPIES = 0

#: largest q/k and v head dim the kernels take
MAX_HEAD_DIM = 256

#: the tensor-core kernel's tiles: a TMA box is 64 bf16 columns (one
#: 128-byte swizzle row) by 128 query rows or 64 keys
BOX_COLS = 64
Q_ROWS = 128
KV_ROWS = 64

_DTYPES = (torch.float32, torch.bfloat16)

_lib_handle: Optional[ctypes.CDLL] = None


class KernelLaunchError(RuntimeError):
    """The CUDA runtime refused a launch (``cudaGetLastError() != 0``)."""


class _MapSpec(ctypes.Structure):
    """``MapSpec`` of ``csrc/flash_attention_wgmma.cu``."""
    _fields_ = [("dims", ctypes.c_longlong * 4),
                ("strides", ctypes.c_longlong * 3),
                ("box", ctypes.c_int * 4), ("perm", ctypes.c_int)]


@dataclass(frozen=True)
class TmaMap:
    """A bf16 tensor ``(B, H, S, D)`` as the 4-D tensor map the kernel
    reads: ``dims`` = (D, then S, H and B in the order of their strides),
    ``strides`` the bytes between steps of dims 1-3, ``box`` the tile one
    copy brings (64 columns, ``rows`` along S), ``perm`` the map dim of S
    (bits 0-1) and of H (bits 2-3)."""
    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]
    perm: int

    def spec(self) -> _MapSpec:
        return _MapSpec(self.dims, self.strides, self.box, self.perm)


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          impl: str = "auto") -> str:
    """Where :func:`attention` sends a call: ``"plain"``, ``"tc"`` (bf16,
    the tensor-core kernel) or ``"ffma"`` (f32, the FFMA kernel)."""
    on_cpu = all(t.device.type == "cpu" for t in (q, k, v))
    if impl == "plain" or (impl == "auto" and on_cpu):
        return "plain"
    return "tc" if q.dtype == torch.bfloat16 else "ffma"


def padded_dim(d: int, dv: int) -> int:
    """The tensor-core kernel's head dim in shared memory: ``max(d, dv)``
    rounded up to a multiple of 64 (64, 128, 192 or 256); TMA fills the
    columns past ``d`` or ``dv`` with zeros."""
    return -(-max(d, dv) // BOX_COLS) * BOX_COLS


def tma_map(shape, strides, data_ptr: int, rows: int,
            itemsize: int = 2) -> Optional[TmaMap]:
    """The tensor map of a ``(B, H, S, D)`` tensor with these element
    ``strides`` at ``data_ptr``, tiled ``rows`` along S; None when TMA
    cannot read it in place (the last dim not contiguous, a base address
    off 16 bytes, or a stride of a dim longer than 1 that is not a
    positive multiple of 16 bytes).  A dim of length 1 is never stepped:
    it gets a stride the map accepts."""
    b, h, s, d = (int(x) for x in shape)
    sb, sh, ss, sd = (int(x) for x in strides)
    if (d > 1 and sd != 1) or data_ptr % 16:
        return None
    named = {"s": (s, ss), "h": (h, sh), "b": (b, sb)}
    stepped = sorted((st, name) for name, (n, st) in named.items() if n > 1)
    if any(st <= 0 or st * itemsize % 16 for st, _ in stepped):
        return None
    order = [name for _, name in stepped]
    order += [name for name in ("s", "h", "b") if named[name][0] == 1]
    step = -(-d * itemsize // 16) * 16           # bytes: a packed row
    dims, byte_strides = [d], []
    for name in order:
        n, st = named[name]
        if n > 1:
            step = st * itemsize
        byte_strides.append(step)
        dims.append(n)
        step *= n
    box = [BOX_COLS, 1, 1, 1]
    box[1 + order.index("s")] = rows
    perm = (1 + order.index("s")) | (1 + order.index("h")) << 2
    return TmaMap(tuple(dims), tuple(byte_strides), tuple(box), perm)


def tma_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> dict:
    """The tensor-core kernel's host-side plan of one call: the padded
    head dim ``dp`` and each of q, k, v's :class:`TmaMap`, None for a
    tensor that needs a copy first (:func:`tma_copy`)."""
    return {"dp": padded_dim(q.shape[3], v.shape[3]),
            **{name: tma_map(t.shape, t.stride(), t.data_ptr(), rows)
               for name, t, rows in (("q", q, Q_ROWS), ("k", k, KV_ROWS),
                                     ("v", v, KV_ROWS))}}


def tma_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a contiguous buffer whose rows are padded to a
    multiple of 16 bytes, as a view of ``t``'s shape: a layout TMA reads."""
    b, h, s, d = t.shape
    buf = torch.empty((b, h, s, -(-d // 8) * 8), dtype=t.dtype,
                      device=t.device)
    view = buf[..., :d]
    view.copy_(t)
    return view


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
            ctypes.c_float, ptr]
        lib.repro_flash_attention.restype = i32
        lib.repro_flash_error_string.argtypes = [i32]
        lib.repro_flash_error_string.restype = ctypes.c_char_p
        spec = ctypes.POINTER(_MapSpec)
        lib.repro_flash_attention_tc.argtypes = [
            ptr, ptr, ptr, ptr, spec, spec, spec, strides,
            i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
            ctypes.c_float, ctypes.c_float, ptr]
        lib.repro_flash_attention_tc.restype = i32
        lib.repro_flash_tc_error_string.argtypes = [i32]
        lib.repro_flash_tc_error_string.restype = ctypes.c_char_p
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
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"attention takes f32 or bf16 q, k, v of one type, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 4)(*t.stride())


def _run_tc(lib, q, k, v, out, causal, window, softcap, scale, stream):
    global COPIES
    plan = tma_plan(q, k, v)
    maps = []
    for name, t, rows in (("q", q, Q_ROWS), ("k", k, KV_ROWS),
                          ("v", v, KV_ROWS)):
        m = plan[name]
        if m is None:                      # a layout TMA cannot read
            t = tma_copy(t)
            COPIES += 1
            m = tma_map(t.shape, t.stride(), t.data_ptr(), rows)
        maps.append((t, m.spec()))
    (q, qm), (k, km), (v, vm) = maps
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    rc = lib.repro_flash_attention_tc(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.byref(qm), ctypes.byref(km), ctypes.byref(vm), _strides(out),
        b, hq, hkv, sq, skv, d, dv, plan["dp"], int(causal), window,
        float(softcap), float(scale), stream)
    return rc, lib.repro_flash_tc_error_string


def _run_ffma(lib, q, k, v, out, causal, window, softcap, scale, stream):
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _strides(q), _strides(k), _strides(v), _strides(out), b, hq, hkv,
        sq, skv, d, dv, int(causal), window, float(softcap), float(scale),
        stream)
    return rc, lib.repro_flash_error_string


def _launch(q, k, v, causal: bool, window: int, softcap: float,
            scale: float, kernel: str) -> torch.Tensor:
    global LAUNCHES, TC_LAUNCHES, FFMA_LAUNCHES
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"the flash attention kernel takes q, k, v on one "
                         f"CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    b, hq, sq, d = q.shape
    skv, dv = k.shape[2], v.shape[3]
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
    run = _run_tc if kernel == "tc" else _run_ffma
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        lib = _lib()
        rc, error_string = run(lib, q, k, v, out, causal, window, softcap,
                               scale, stream)
    if rc != 0:
        raise KernelLaunchError(
            f"flash attention launch failed ({kernel} kernel; q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"{q.dtype}): error {rc}: {error_string(rc).decode()}")
    LAUNCHES += 1
    if kernel == "tc":
        TC_LAUNCHES += 1
    else:
        FFMA_LAUNCHES += 1
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
    where = route(q, k, v, impl)
    if where == "plain":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    return _launch(q, k, v, causal, window, softcap, scale, where)
