"""Public SSD op: the hand-written CUDA kernels or their plain version,
and the O(1) decode step.

Counterpart of ``repro.kernels.ssd_scan.ops``.  :func:`ssd_scan`'s
``impl`` selects:

* ``"auto"`` (the main path): the chunked plain version
  (:func:`.ref.ssd_chunked_ref`) for CPU tensors, a CUDA kernel for CUDA
  tensors;
* ``"kernel"``: always a CUDA kernel — a CPU tensor raises;
* ``"plain"``: always the chunked plain version (tests and the chip smoke
  run only).

A CUDA call goes by the type of x, B and C (:func:`route`), never by
shape:

* bf16 → ``csrc/ssd_scan_wgmma.cu`` (``ssd_scan_kernel_wgmma``), the
  tensor-core kernel: all four products of a chunk on ``wgmma`` with f32
  accumulators, C·Bᵀ once per two heads, each f32 operand (the decayed
  scores, the carried state, x scaled by the state update's decay) as
  three bf16 terms, so the products keep f32's precision;
* f32 → ``csrc/ssd_scan.cu`` (``ssd_scan_kernel``, f32 only), f32 FFMA
  on CUDA cores: the f32 limits (1e-4 of the largest output) are beyond
  the tensor cores' bf16 operands.

Both replace the TPU kernel ``src/repro/kernels/ssd_scan/kernel.py:73``
(``ssd_scan_pallas``).  A CUDA tensor never falls back to the plain
version or to the other kernel: the kernel builds and launches, or the
call raises (:class:`KernelLaunchError` for a launch the CUDA runtime
refuses).

Deviations from the JAX op: no ``interpret`` argument and no
``"jnp"``/``"ref"``/``"pallas"`` impls (:func:`.ref.ssd_ref` is the
sequential oracle).  JAX pads S to a multiple of the chunk; here the
kernels mask the last partial chunk themselves and the plain version
takes it short, so nothing is padded or copied — the chunk boundaries are
JAX's, from position 0.  x, B and C are read in place by strides, so the
model's slices of one (B, S, 2N) tensor go in as they are.  The kernels
take states up to :data:`MAX_STATE` and head dims up to
:data:`MAX_HEAD_DIM`, and raise beyond them; a bf16 ``dt`` or ``A`` is
cast to f32 first (:data:`COPIES` counts those casts).  The kernels'
chunks are at most :data:`MAX_CHUNK` (128) rows, so a larger requested
chunk — JAX's default of 256 among them — runs at chunk 128: the same
recurrence (the state carried across a boundary is exact), only the
rounding order differs.  ``return_final_state=True`` also returns the
state after the last step, ``(B,H,N,P)`` f32, from the same launch (the
plain version returns the state its scan carries); JAX computes it apart,
with ``ssd_final_state`` (``src/repro/models/layers.py:532-544``), whose
counterpart :func:`ssd_final_state` stays here as the plain reference
for the state.

The gradient (the train path).  The kernels write y through ctypes,
outside autograd.  So a CUDA call whose x, dt, A, B or C requires grad
(with grad mode on) goes through :class:`_SSDScan`, a
``torch.autograd.Function``: its forward is the launch above, unchanged
(a bf16 ``dt`` or ``A`` cast to f32 before it, the cast counted in
:data:`COPIES` and differentiated by autograd), and it saves x, dt, A, B
and C; its backward is :func:`ssd_scan_bwd`'s kernel route, four
kernels (f32 accumulation), the first three routed by the type of x, B
and C as the forward is: a state pass (the state entering each chunk) and
a reverse state pass (the cotangent of the state leaving each chunk) —
bf16 to ``ssd_scan_bwd_state_kernel_wgmma`` and
``ssd_scan_bwd_dstate_kernel_wgmma`` (``csrc/ssd_scan_bwd_state_wgmma.cu``:
each chunk's state product on ``wgmma``, the decay-scaled x or dy in three
bf16 terms, the state in f32 registers, the next chunk's tiles copied
while this one computes), f32 to the FFMA ``ssd_scan_bwd_state_kernel``
and ``ssd_scan_bwd_dstate_kernel`` (``csrc/ssd_scan_bwd.cu``); a chunk
kernel (dx, ddt and partials of dB, dC and dA) — bf16 to
``ssd_scan_bwd_chunk_kernel_wgmma`` (``csrc/ssd_scan_bwd_wgmma.cu``: every
product on ``wgmma``, C·Bᵀ once per block, the f32 operands in three bf16
terms, dB and dC summed over the heads a block serves, partials of
``(B, S, splits, N)`` with ``splits`` from :func:`plan_splits`), f32 to
``ssd_scan_bwd_chunk_kernel`` (FFMA, C·B and dy·x summed in f64, per-head
partials); and ``ssd_scan_bwd_reduce_kernel`` (the partials summed).
Both routes write the same S_in and G buffers, ``(B, nC, H, N, P)`` f32,
whose plain version is :func:`.ref.ssd_bwd_states_ref`.  They
differentiate ``ssd_scan_pallas``'s function, whatever kernel ran the
forward; the JAX package has no backward kernel (it differentiates its
chunked jnp route).  No output is summed with atomics, so two runs are
bit-equal.  Each gradient comes back in its input's dtype, contiguous.
With ``return_final_state=True`` under grad, y goes through
:class:`_SSDScan` and the state comes from the plain
:func:`ssd_final_state`, as JAX computes it apart.  Without grad the
launches are those above.  The plain version of the gradient is
:func:`.ref.ssd_scan_bwd_ref` (autograd through the chunked plain
version), the CPU route of :func:`ssd_scan_bwd`.  Deviations:
:func:`ssd_scan_bwd` has no JAX counterpart (JAX takes ``jax.vjp``), and
the kernels sum each chunk's cumsum of dt·A in f64 and leave out the terms
of da that cancel exactly, so under strong decay (dt·A near -20 a step)
their dA lies nearer the exact gradient than the f32 plain version's or
JAX's.

:func:`ssd_final_state` and :func:`ssd_decode_step` are plain torch, as
they are jnp in JAX (no Pallas kernel).

:data:`LAUNCHES` counts every kernel launch of the library, forward and
backward; :data:`TC_LAUNCHES` and :data:`FFMA_LAUNCHES` those of each
forward kernel, :data:`BWD_LAUNCHES` those of the backward kernels and
:data:`BWD_STATE_LAUNCHES`, :data:`BWD_DSTATE_LAUNCHES`,
:data:`BWD_CHUNK_LAUNCHES` and :data:`BWD_REDUCE_LAUNCHES` those of each
(the first three on either route), and
``BWD_{STATE,DSTATE,CHUNK}_TC_LAUNCHES`` and
``BWD_{STATE,DSTATE,CHUNK}_FFMA_LAUNCHES`` those of each route's kernel
(:data:`BWD_ROUTED`), so a run can show that its main path went through
them.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan.ref import (ssd_chunked_ref,
                                              ssd_scan_bwd_ref)

#: kernel launches made in this process: every one, the tensor-core (bf16)
#: kernel's, the FFMA (f32) kernel's, the backward kernels' (all four, and
#: each on either route; each route's state passes and chunk kernel)
LAUNCHES = 0
TC_LAUNCHES = 0
FFMA_LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_STATE_LAUNCHES = 0
BWD_DSTATE_LAUNCHES = 0
BWD_CHUNK_LAUNCHES = 0
BWD_REDUCE_LAUNCHES = 0
BWD_STATE_TC_LAUNCHES = 0
BWD_STATE_FFMA_LAUNCHES = 0
BWD_DSTATE_TC_LAUNCHES = 0
BWD_DSTATE_FFMA_LAUNCHES = 0
BWD_CHUNK_TC_LAUNCHES = 0
BWD_CHUNK_FFMA_LAUNCHES = 0

#: casts of a bf16 ``dt`` or ``A`` to f32 before a launch
COPIES = 0

#: largest chunk length, state dim N and head dim P the kernels take
MAX_CHUNK = 128
MAX_STATE = 128
MAX_HEAD_DIM = 64

_DTYPES = (torch.float32, torch.bfloat16)

_lib_handle: Optional[ctypes.CDLL] = None


class KernelLaunchError(RuntimeError):
    """The CUDA runtime refused a launch (``cudaGetLastError() != 0``)."""


def route(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
          Bm: torch.Tensor, Cm: torch.Tensor, impl: str = "auto") -> str:
    """Where :func:`ssd_scan` sends a call: ``"plain"``, ``"tc"`` (bf16
    x, B, C: the tensor-core kernel) or ``"ffma"`` (f32: the FFMA
    kernel)."""
    on_cpu = all(t.device.type == "cpu" for t in (x, dt, A, Bm, Cm))
    if impl == "plain" or (impl == "auto" and on_cpu):
        return "plain"
    return "tc" if x.dtype == torch.bfloat16 else "ffma"


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from repro_torch.kernels.build import load
        lib = load("ssd_scan")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        strides = ctypes.POINTER(ctypes.c_longlong)
        for fn in (lib.repro_ssd_scan, lib.repro_ssd_scan_tc):
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, strides,
                           strides, i64, strides, strides, strides, i32, i32,
                           i32, i32, i32, i32, ptr]
            fn.restype = i32
        for entry in {e for k in ("tc", "ffma")
                      for _, e, _ in bwd_kernels(k)}:
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.POINTER(ptr), strides,
                           ctypes.POINTER(i32), ptr]
            fn.restype = i32
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
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan takes f32 or bf16 x, B, C of one type, "
                        f"got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    for name, t in (("dt", dt), ("A", A)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"ssd_scan takes an f32 or bf16 {name}, got "
                            f"{t.dtype}")


def _on_one_card(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} on one CUDA device, got "
                         f"{', '.join(str(t.device) for t in tensors)}")


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * t.dim())(*t.stride())


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as f32: itself when it is, else a counted cast."""
    global COPIES
    if t.dtype == torch.float32:
        return t
    COPIES += 1
    return t.float()


def _launch(x, dt, A, Bm, Cm, chunk: int, kernel: str,
            final_state: bool = False):
    """One launch of the ``"tc"`` (bf16) or ``"ffma"`` (f32) kernel: ``y``,
    or ``(y, h_S)`` with ``final_state``."""
    global LAUNCHES, TC_LAUNCHES, FFMA_LAUNCHES
    _on_one_card("the SSD scan kernel takes x, dt, A, B, C", x, dt, A, Bm,
                 Cm)
    dev = x.device
    if x.dtype != (torch.bfloat16 if kernel == "tc" else torch.float32):
        takes = "tensor-core SSD kernel takes bf16" if kernel == "tc" \
            else "FFMA SSD kernel takes f32"
        raise TypeError(f"the {takes} x, B, C, got {x.dtype}")
    b, s, h, p = x.shape
    n = Bm.shape[2]
    if n > MAX_STATE or p > MAX_HEAD_DIM:
        raise ValueError(f"the SSD scan kernel takes states up to "
                         f"{MAX_STATE} and head dims up to {MAX_HEAD_DIM}, "
                         f"got N={n}, P={p}")
    chunk = min(chunk, MAX_CHUNK)          # the same scan, other rounding
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the kernel's grid")
    dt, A = _f32(dt), _f32(A)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    hs = torch.zeros((b, h, n, p), dtype=torch.float32, device=dev) \
        if final_state else None
    if y.numel() == 0:
        return (y, hs) if final_state else y
    stream = _stream(dev)
    with torch.cuda.device(dev):
        lib = _lib()
        args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(),
                hs.data_ptr() if final_state else None, _strides(x),
                _strides(dt), A.stride(0), _strides(Bm), _strides(Cm),
                _strides(y), b, s, h, p, n, chunk)
        fn = lib.repro_ssd_scan_tc if kernel == "tc" else lib.repro_ssd_scan
        rc = fn(*args, stream)
    if rc != 0:
        msg = lib.repro_ssd_error_string(rc).decode()
        raise KernelLaunchError(
            f"SSD scan launch failed ({kernel} kernel; x {tuple(x.shape)}, "
            f"N {n}, chunk {chunk}, {x.dtype}): CUDA error {rc}: {msg}")
    LAUNCHES += 1
    if kernel == "tc":
        TC_LAUNCHES += 1
    else:
        FFMA_LAUNCHES += 1
    return (y, hs) if final_state else y


#: the backward kernels in launch order: (name, the counter of either
#: route's kernel)
BWD_KERNELS = (("state", "BWD_STATE_LAUNCHES"),
               ("dstate", "BWD_DSTATE_LAUNCHES"),
               ("chunk", "BWD_CHUNK_LAUNCHES"),
               ("reduce", "BWD_REDUCE_LAUNCHES"))
#: the kernels each route has its own of: {name: {route: (C entry point,
#: its own counter)}}; the reduction takes both types
BWD_ROUTED = {
    "state": {"tc": ("repro_ssd_bwd_state_tc", "BWD_STATE_TC_LAUNCHES"),
              "ffma": ("repro_ssd_bwd_state", "BWD_STATE_FFMA_LAUNCHES")},
    "dstate": {"tc": ("repro_ssd_bwd_dstate_tc", "BWD_DSTATE_TC_LAUNCHES"),
               "ffma": ("repro_ssd_bwd_dstate",
                        "BWD_DSTATE_FFMA_LAUNCHES")},
    "chunk": {"tc": ("repro_ssd_bwd_chunk_tc", "BWD_CHUNK_TC_LAUNCHES"),
              "ffma": ("repro_ssd_bwd_chunk", "BWD_CHUNK_FFMA_LAUNCHES")}}
BWD_REDUCE = "repro_ssd_bwd_reduce"


def bwd_kernels(kernel: str) -> tuple:
    """The backward kernels the ``"tc"`` (bf16) or ``"ffma"`` (f32) route
    launches, in order: ``(name, C entry point, counters)``, the counters
    the kernel's of either route and, where the routes differ, its
    own."""
    out = []
    for name, total in BWD_KERNELS:
        if name in BWD_ROUTED:
            entry, own = BWD_ROUTED[name][kernel]
            out.append((name, entry, (total, own)))
        else:
            out.append((name, BWD_REDUCE, (total,)))
    return tuple(out)


def plan_splits(batch: int, nchunks: int, heads: int, sms: int) -> int:
    """How many blocks share the heads of one (batch row, chunk) in the
    tensor-core chunk kernel: of the splits that leave no block empty, the
    fewest with the least ``waves × heads a block`` (one block an SM), so
    the grid fills the card at a few heads and one block keeps every head
    where there are blocks enough: 1 at mamba2-130m's train layer (8 × 16
    (batch, chunk) blocks on 132 SMs), 4 at zamba2-7b's (4 × 8)."""
    best = None
    for splits in range(1, heads + 1):
        per = -(-heads // splits)
        if -(-heads // per) != splits:
            continue
        cost = -(-(batch * nchunks * splits) // sms) * per
        if best is None or cost < best[0]:
            best = (cost, splits)
    return best[1]


def _bwd_buffers(x: torch.Tensor, n: int, nchunks: int, parts: int):
    """The backward kernels' buffers: each chunk's S_in and G ``(B, nC, H,
    N, P)``, the partials of dB and dC ``(B, S, parts, N)`` and of dA
    ``(B, nC, H)``, all f32 on x's device."""
    b, s, h, p = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty((b, nchunks, h, n, p), **f32),     # S_in
            torch.empty((b, nchunks, h, n, p), **f32),     # G
            torch.empty((b, s, parts, n), **f32),          # dB a part
            torch.empty((b, s, parts, n), **f32),          # dC a part
            torch.empty((b, nchunks, h), **f32))           # dA a chunk


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _bwd_call(x, dt, A, Bm, Cm, dy, chunk: int):
    """The backward kernels' outputs ``(dx, ddt, dA, dB, dC)``, fresh (dt
    and A f32), and the launches: ``(kernels, arguments, buffers)`` with
    the route's kernels (:func:`bwd_kernels`: bf16 the tensor-core state
    passes and chunk kernel, f32 the FFMA ones) and the arguments every C
    entry point takes, the buffers they point to riding along — None when
    there is nothing to launch (an empty input: the gradients are zeros).
    The buffers are ``(S_in, G, the partials of dB, of dC, of dA)``."""
    _on_one_card("the SSD backward kernels take x, dt, A, B, C, dy",
                 x, dt, A, Bm, Cm, dy)
    dev = x.device
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"the SSD backward kernels take f32 dt and A, got "
                        f"{dt.dtype}, {A.dtype}")
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"ssd_scan backward: dy {tuple(dy.shape)} must be "
                         f"{tuple(x.shape)}")
    b, s, h, p = x.shape
    n = Bm.shape[2]
    if n > MAX_STATE or p > MAX_HEAD_DIM:
        raise ValueError(f"the SSD scan kernels take states up to "
                         f"{MAX_STATE} and head dims up to {MAX_HEAD_DIM}, "
                         f"got N={n}, P={p}")
    chunk = min(chunk, MAX_CHUNK)          # the same scan, other rounding
    nc = -(-s // chunk)
    if b > 65535 or h > 65535 or nc > 65535:
        raise ValueError(f"batch {b}, heads {h} or chunks {nc} exceed the "
                         f"kernels' grid")
    dy = dy.to(x.dtype)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = (torch.empty((b, s, h, p), dtype=x.dtype, device=dev),
            torch.empty((b, s, h), **f32), torch.empty((h,), **f32),
            torch.empty((b, s, n), dtype=x.dtype, device=dev),
            torch.empty((b, s, n), dtype=x.dtype, device=dev))
    if x.numel() == 0 or n == 0:
        return tuple(t.zero_() for t in outs), None
    kernel = "tc" if x.dtype == torch.bfloat16 else "ffma"
    parts = plan_splits(b, nc, h, _sms(dev)) if kernel == "tc" else h
    bufs = _bwd_buffers(x, n, nc, parts)
    dx, ddt, dA, dB, dC = outs
    ptrs = (ctypes.c_void_p * 16)(*(t.data_ptr() for t in (
        x, dt, A, Bm, Cm, dy, bufs[0], bufs[1], dx, ddt, bufs[2], bufs[3],
        bufs[4], dB, dC, dA)))
    strides = (ctypes.c_longlong * 18)(*x.stride(), *dt.stride(),
                                       A.stride(0), *Bm.stride(),
                                       *Cm.stride(), *dy.stride())
    dims = (ctypes.c_int * 8)(b, s, h, p, n, chunk,
                              int(x.dtype == torch.bfloat16), parts)
    args = (ptrs, strides, dims, _stream(dev))
    # dy and the buffers ride along: the call keeps them alive
    return outs, (bwd_kernels(kernel), args, (dy, bufs))


def _launch_bwd(x, dt, A, Bm, Cm, dy, chunk: int):
    """``(dx, ddt, dA, dB, dC)`` from the four backward kernels of the
    route, one launch each (dt and A f32)."""
    global LAUNCHES, BWD_LAUNCHES
    outs, call = _bwd_call(x, dt, A, Bm, Cm, dy, chunk)
    if call is None:
        return outs
    kernels, args, _ = call
    with torch.cuda.device(x.device):
        lib = _lib()
        for name, entry, counters in kernels:
            rc = getattr(lib, entry)(*args)
            if rc != 0:
                raise KernelLaunchError(
                    f"SSD scan backward launch failed ({name} kernel, "
                    f"{entry}; x {tuple(x.shape)}, N {Bm.shape[2]}, chunk "
                    f"{min(chunk, MAX_CHUNK)}, {x.dtype}): CUDA error {rc}: "
                    f"{lib.repro_ssd_error_string(rc).decode()}")
            LAUNCHES += 1
            BWD_LAUNCHES += 1
            for counter in counters:
                globals()[counter] += 1
    return outs


class _SSDScan(torch.autograd.Function):
    """The forward kernel (``kernel`` = ``"tc"`` or ``"ffma"``) with the
    backward kernels as its gradient; dt and A come in f32."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, kernel):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return _launch(x, dt, A, Bm, Cm, chunk, kernel)

    @staticmethod
    def backward(ctx, dy):
        grads = _launch_bwd(*ctx.saved_tensors, dy, ctx.chunk)
        return (*grads, None, None)


def _checked(x, dt, A, Bm, Cm, chunk: int, impl: str) -> int:
    """The chunk a call runs at, ``min(chunk, S)``, after the checks every
    call makes."""
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"impl must be auto, kernel or plain, got {impl!r}")
    _check(x, dt, A, Bm, Cm)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return max(1, min(int(chunk), x.shape[1]))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256,
             impl: str = "auto", return_final_state: bool = False):
    """SSD forward over a full sequence: ``x (B,S,H,P)``, ``dt (B,S,H)``,
    ``A (H,)``, ``B/C (B,S,N)`` → ``y (B,S,H,P)`` in ``x.dtype``, in chunks
    of ``min(chunk, S)`` steps (the kernels' at most :data:`MAX_CHUNK`).
    With ``return_final_state``, ``(y, h_S)``: the state after the last
    step, ``(B,H,N,P)`` f32, from the same launch (under grad, from
    :func:`ssd_final_state`).  Differentiable on every route: a kernel call
    that needs a gradient runs the backward kernels."""
    chunk = _checked(x, dt, A, Bm, Cm, chunk, impl)
    where = route(x, dt, A, Bm, Cm, impl)
    if where == "plain":
        return ssd_chunked_ref(x, dt, A, Bm, Cm, chunk, return_final_state)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, Bm, Cm)):
        _on_one_card("the SSD scan kernel takes x, dt, A, B, C", x, dt, A,
                     Bm, Cm)
        y = _SSDScan.apply(x, _f32(dt), _f32(A), Bm, Cm, chunk, where)
        if return_final_state:
            return y, ssd_final_state(x, dt, A, Bm, Cm)
        return y
    return _launch(x, dt, A, Bm, Cm, chunk, where, return_final_state)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int = 256, impl: str = "auto"
                 ) -> Tuple[torch.Tensor, ...]:
    """``(dx, ddt, dA, dB, dC)`` of :func:`ssd_scan` at ``x, dt, A, B, C``
    for the output gradient ``dy``, each in its input's dtype; routed as
    :func:`ssd_scan` is (the CPU and ``impl="plain"`` take
    :func:`.ref.ssd_scan_bwd_ref`, a CUDA tensor the four backward kernels,
    the state passes and the chunk kernel by type: bf16 the tensor-core
    ones, f32 the FFMA ones)."""
    chunk = _checked(x, dt, A, Bm, Cm, chunk, impl)
    if route(x, dt, A, Bm, Cm, impl) == "plain":
        return ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, chunk)
    _on_one_card("the SSD backward kernels take x, dt, A, B, C, dy",
                 x, dt, A, Bm, Cm, dy)
    dx, ddt, dA, dB, dC = _launch_bwd(x, _f32(dt), _f32(A), Bm, Cm, dy,
                                      chunk)
    return dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC


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
