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
  tensor maps (:func:`_mapped`, from :func:`tma_map`): TMA needs the last dim contiguous, 16-byte-aligned base addresses and
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

The gradient (the train path).  The kernels write their output through
ctypes, outside autograd.  So a CUDA call whose q, k or v requires grad
(with grad mode on) goes through :class:`_FlashAttention`, a
``torch.autograd.Function``: its forward is the launch above, unchanged,
and it saves q, k and v; its backward is :func:`attention_bwd`, which
launches a dQ kernel (dQ, and each row's log-sum-exp and
D = rowsum(P ⊙ dP)) and then ``flash_attention_bwd_dkdv_kernel`` of
``csrc/flash_attention_bwd.cu`` (dK, dV, from those statistics).  Unlike
the forward, the backward routes its dQ kernel by shape as well as type
(:func:`bwd_route`): bf16 with a padded head dim of at most 128
(:data:`BWD_TC_MAX_DIM`; zamba2-7b's 112) → ``csrc/flash_attention_bwd_
wgmma.cu`` (``flash_attention_bwd_dq_kernel_wgmma``: ``wgmma`` for S, dP
and dQ += dS·K, dS in two bf16 terms, q, k, v and dO read through tensor
maps as the forward reads q, k, v); f32, and bf16 at 192 or 256 columns
(gemma2-2b's 256) → the FFMA ``flash_attention_bwd_dq_kernel``.  The
tensor-core kernel is built for 64 and 128 columns, where dQ's f32
accumulator takes 32 or 64 registers a thread; at 256 it would take 128
beside the 96 of S, dP and dS, at the edge of 255, and at gemma2's train
shapes (S 128) the FFMA pair already beats SDPA's backward.  No kernel
needs a forward output: D is summed from P and dP in f32, where a bf16
output would move it (``flash_attention_bwd.cu``'s header says by how
much).
They replace no TPU kernel — the JAX package differentiates its forward's
route — and give the gradient of the same function: GQA by ratio, scale,
soft-cap, causal and window masks, ragged lengths.  No output element is
summed with atomics, so two runs are bit-equal.  The gradients come back
in the input dtype, as a ``(B, S, H, D)`` buffer's ``(B, H, S, D)`` view.
The plain version is :func:`.ref.attention_bwd_ref` (autograd through
:func:`.ref.attention_ref`), the CPU route of :func:`attention_bwd`;
:func:`.ref.attention_bwd_stats_ref` is that of the statistics.

:data:`LAUNCHES` counts every kernel launch of the library, forward and
backward; :data:`TC_LAUNCHES`, :data:`FFMA_LAUNCHES`,
:data:`BWD_DQ_LAUNCHES` (both dQ kernels), :data:`BWD_DQ_TC_LAUNCHES`,
:data:`BWD_DQ_FFMA_LAUNCHES` and :data:`BWD_DKDV_LAUNCHES` those of each
kernel, so a run can show that its main path went through them.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                      attention_ref)

#: kernel launches made in this process: every one, the tensor-core (bf16)
#: kernel's, the FFMA (f32) kernel's, both dQ kernels', each dQ kernel's
#: (tensor-core, FFMA) and the dK/dV kernel's
LAUNCHES = 0
TC_LAUNCHES = 0
FFMA_LAUNCHES = 0
BWD_DQ_LAUNCHES = 0
BWD_DQ_TC_LAUNCHES = 0
BWD_DQ_FFMA_LAUNCHES = 0
BWD_DKDV_LAUNCHES = 0

#: copies of a bf16 q, k or v that TMA cannot read in place
COPIES = 0

#: largest q/k and v head dim the kernels take
MAX_HEAD_DIM = 256

#: largest padded head dim (:func:`padded_dim`) of the tensor-core dQ kernel
BWD_TC_MAX_DIM = 128

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


def bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              impl: str = "auto") -> str:
    """Where :func:`attention_bwd` sends dQ: :func:`route`'s answer, but
    ``"ffma"`` (the FFMA dQ kernel) for a bf16 call whose
    :func:`padded_dim` is over :data:`BWD_TC_MAX_DIM` (192 or 256
    columns).  ``"tc"`` is the tensor-core dQ kernel.  dK and dV always
    come from the FFMA dK/dV kernel."""
    where = route(q, k, v, impl)
    if where == "tc" and padded_dim(q.shape[3], v.shape[3]) > BWD_TC_MAX_DIM:
        return "ffma"
    return where


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
        for fn in (lib.repro_flash_attention_bwd_dq,
                   lib.repro_flash_attention_bwd_dkdv):
            fn.argtypes = [ptr] * 9 + [strides] + [i32] * 10 + [
                ctypes.c_float, ctypes.c_float, ptr]
            fn.restype = i32
        lib.repro_flash_bwd_error_string.argtypes = [i32]
        lib.repro_flash_bwd_error_string.restype = ctypes.c_char_p
        lib.repro_flash_attention_bwd_dq_tc.argtypes = [
            ptr, ptr, ptr, ptr, spec, spec, spec, spec, ptr, strides, ptr,
            ptr] + [i32] * 10 + [ctypes.c_float, ctypes.c_float, ptr]
        lib.repro_flash_attention_bwd_dq_tc.restype = i32
        lib.repro_flash_bwd_dq_tc_ds_terms.argtypes = []
        lib.repro_flash_bwd_dq_tc_ds_terms.restype = i32
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


def _mapped(t: torch.Tensor, rows: int):
    """``t`` as TMA reads it — itself, or a counted copy
    (:func:`tma_copy`) when its layout has no tensor map — and that
    map's :class:`_MapSpec`."""
    global COPIES
    m = tma_map(t.shape, t.stride(), t.data_ptr(), rows)
    if m is None:                          # a layout TMA cannot read
        t = tma_copy(t)
        COPIES += 1
        m = tma_map(t.shape, t.stride(), t.data_ptr(), rows)
    return t, m.spec()


def _run_tc(lib, q, k, v, out, causal, window, softcap, scale, stream):
    (q, qm), (k, km), (v, vm) = (_mapped(t, rows) for t, rows in (
        (q, Q_ROWS), (k, KV_ROWS), (v, KV_ROWS)))
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    rc = lib.repro_flash_attention_tc(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.byref(qm), ctypes.byref(km), ctypes.byref(vm), _strides(out),
        b, hq, hkv, sq, skv, d, dv, padded_dim(d, dv), int(causal), window,
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


def _window(window: int, sq: int, skv: int) -> int:
    """rows - cols < sq + skv always holds: a wider window masks nothing."""
    return max(0, min(int(window), sq + skv))


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
    window = _window(window, sq, skv)
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


def _heads_view(b: int, h: int, s: int, d: int, like: torch.Tensor
                ) -> torch.Tensor:
    """A ``(B, H, S, D)`` view of a fresh ``(B, S, H, D)`` buffer, the
    layout the model's ``transpose(1, 2)`` views have."""
    return torch.empty((b, s, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _on_one_card(q, k, v, do) -> None:
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, do)):
        raise ValueError(f"the flash attention backward kernels take q, k, "
                         f"v, do on one CUDA device, got {q.device}, "
                         f"{k.device}, {v.device}, {do.device}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


@dataclass(frozen=True)
class _BwdCall:
    """One backward call's launches: the routed dQ kernel's entry point
    and arguments, then the dK/dV kernel's arguments; ``keep`` holds what
    the pointers in them point to (the statistics, a cast or copied
    operand)."""
    dq_entry: str
    dq_args: tuple
    dkdv_args: tuple
    keep: tuple


def _bwd_call(q, k, v, do, causal: bool, window: int, softcap: float,
              scale: float, dq_kernel: str):
    """The backward kernels' outputs ``(dq, dk, dv)``, fresh, and the
    :class:`_BwdCall` that fills them, with ``dq_kernel`` (``"tc"`` or
    ``"ffma"``, :func:`bwd_route`) for dQ — None when there is nothing to
    launch (no query or no key: the gradients are zeros)."""
    dev = q.device
    _on_one_card(q, k, v, do)
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(do.shape) != (b, hq, sq, dv):
        raise ValueError(f"attention backward: do {tuple(do.shape)} must be "
                         f"{(b, hq, sq, dv)}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"the flash attention kernels take head dims up to "
                         f"{MAX_HEAD_DIM}, got d={d}, dv={dv}")
    if b > 65535 or hq > 65535:
        raise ValueError(f"batch {b} or heads {hq} exceed the kernel's grid")
    if dq_kernel == "tc" and (q.dtype != torch.bfloat16
                              or padded_dim(d, dv) > BWD_TC_MAX_DIM):
        raise ValueError(f"the tensor-core dQ kernel takes bf16 with a "
                         f"padded head dim up to {BWD_TC_MAX_DIM}, got "
                         f"{q.dtype}, d={d}, dv={dv}")
    do = do.to(q.dtype)
    outs = (_heads_view(b, hq, sq, d, q), _heads_view(b, hkv, skv, d, q),
            _heads_view(b, hkv, skv, dv, q))
    if outs[0].numel() == 0 or outs[1].numel() == 0:
        return tuple(t.zero_() for t in outs), None
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    delta = torch.empty_like(lse)
    tensors = (q, k, v, do, *outs)
    strides = (ctypes.c_longlong * 28)(*(s for t in tensors
                                         for s in t.stride()))
    stream = _stream(dev)
    window = _window(window, sq, skv)
    args = (*(t.data_ptr() for t in tensors), lse.data_ptr(),
            delta.data_ptr(), strides, b, hq, hkv, sq, skv, d, dv,
            int(q.dtype == torch.bfloat16), int(causal), window,
            float(softcap), float(scale), stream)
    keep = (lse, delta, do)
    if dq_kernel == "ffma":
        return outs, _BwdCall("repro_flash_attention_bwd_dq", args, args,
                              keep)
    mapped = [_mapped(t, rows) for t, rows in (
        (q, Q_ROWS), (k, KV_ROWS), (v, KV_ROWS), (do, Q_ROWS))]
    tc_args = (*(t.data_ptr() for t, _ in mapped),
               *(ctypes.byref(m) for _, m in mapped), outs[0].data_ptr(),
               _strides(outs[0]), lse.data_ptr(), delta.data_ptr(), b, hq,
               hkv, sq, skv, d, dv, padded_dim(d, dv), int(causal), window,
               float(softcap), float(scale), stream)
    return outs, _BwdCall("repro_flash_attention_bwd_dq_tc", tc_args, args,
                          keep + tuple(t for t, _ in mapped))


def _launch_bwd(q, k, v, do, causal: bool, window: int, softcap: float,
                scale: float, dq_kernel: str):
    """dq, dk, dv from two launches: the ``dq_kernel`` dQ kernel, then the
    dK/dV kernel."""
    global LAUNCHES, BWD_DQ_LAUNCHES, BWD_DQ_TC_LAUNCHES, \
        BWD_DQ_FFMA_LAUNCHES, BWD_DKDV_LAUNCHES
    outs, call = _bwd_call(q, k, v, do, causal, window, softcap, scale,
                           dq_kernel)
    if call is None:
        return outs
    with torch.cuda.device(q.device):
        lib = _lib()
        dq_errors = (lib.repro_flash_tc_error_string if dq_kernel == "tc"
                     else lib.repro_flash_bwd_error_string)
        for name, fn, args, errors in (
                (f"dq {dq_kernel}", getattr(lib, call.dq_entry),
                 call.dq_args, dq_errors),
                ("dkdv", lib.repro_flash_attention_bwd_dkdv, call.dkdv_args,
                 lib.repro_flash_bwd_error_string)):
            rc = fn(*args)
            if rc != 0:
                raise KernelLaunchError(
                    f"flash attention backward launch failed ({name} "
                    f"kernel; q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                    f"{tuple(v.shape)}, {q.dtype}): error {rc}: "
                    f"{errors(rc).decode()}")
            LAUNCHES += 1
            if name == "dkdv":
                BWD_DKDV_LAUNCHES += 1
                continue
            BWD_DQ_LAUNCHES += 1
            if dq_kernel == "tc":
                BWD_DQ_TC_LAUNCHES += 1
            else:
                BWD_DQ_FFMA_LAUNCHES += 1
    return outs


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (``kernel`` = ``"tc"`` or ``"ffma"``) with the
    backward kernels as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, kernel):
        ctx.save_for_backward(q, k, v)
        ctx.settings = (causal, window, softcap, scale)
        return _launch(q, k, v, causal, window, softcap, scale, kernel)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq_kernel = bwd_route(q, k, v, impl="kernel")
        dq, dk, dv = _launch_bwd(q, k, v, do, *ctx.settings, dq_kernel)
        return dq, dk, dv, None, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              scale: Optional[float] = None,
              impl: str = "auto") -> torch.Tensor:
    """Attention over ``q (B,Hq,Sq,D)``, ``k (B,Hkv,Skv,D)``,
    ``v (B,Hkv,Skv,Dv)`` → ``(B,Hq,Sq,Dv)`` in ``q.dtype``; GQA by ratio,
    ``scale`` defaults to ``D**-0.5``.  Differentiable on every route: a
    kernel call that needs a gradient runs the backward kernels."""
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"impl must be auto, kernel or plain, got {impl!r}")
    _check(q, k, v)
    scale = scale if scale is not None else q.shape[3] ** -0.5
    where = route(q, k, v, impl)
    if where == "plain":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                     where)
    return _launch(q, k, v, causal, window, softcap, scale, where)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, scale: Optional[float] = None,
                  impl: str = "auto"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`attention` at ``q, k, v`` for the output
    gradient ``do``; routed as :func:`attention` is (the CPU and
    ``impl="plain"`` take :func:`.ref.attention_bwd_ref`, a CUDA tensor the
    dQ kernel :func:`bwd_route` names and then the dK/dV kernel)."""
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"impl must be auto, kernel or plain, got {impl!r}")
    _check(q, k, v)
    scale = scale if scale is not None else q.shape[3] ** -0.5
    where = bwd_route(q, k, v, impl)
    if where == "plain":
        return attention_bwd_ref(q, k, v, do, causal=causal, window=window,
                                 softcap=softcap, scale=scale)
    return _launch_bwd(q, k, v, do, causal, window, softcap, scale, where)
