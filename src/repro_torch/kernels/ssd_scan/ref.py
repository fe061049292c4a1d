"""Plain-torch SSD (Mamba2 state-space duality) scan: the kernel's plain
versions.

Per head, with ``x (B,S,H,P)``, ``dt (B,S,H)``, ``A (H,)`` negative decay
rates and ``B/C (B,S,N)`` shared across heads:

    h_t = exp(dt_t·A)·h_{t-1} + dt_t·(B_t ⊗ x_t)     h ∈ R^{N×P}
    y_t = C_t · h_t

* :func:`ssd_ref` — the sequential oracle, a port of
  ``repro.kernels.ssd_scan.ref.ssd_ref``; it also returns the final state.
* :func:`ssd_chunked_ref` — the chunked algorithm of the JAX op's
  ``_ssd_chunked_jnp`` (``repro/kernels/ssd_scan/ops.py:18-62``) as a
  Python loop over chunks in f32, output in ``x.dtype``.  It is the CPU
  path of :func:`repro_torch.kernels.ssd_scan.ops.ssd_scan`.  Deviation: a
  last chunk shorter than ``chunk`` is taken as it is, where JAX pads it
  with zeros; the zero rows add nothing to the rows before them, so the
  result is the same.  With ``final_state`` it also returns the state its
  scan carries out of the last chunk, as the kernels do.  Given f64
  inputs it computes in f64: ``chip_smoke.py`` holds the CUDA kernels
  against that exact result, since the f32 sum of the scores C·Bᵀ (JAX's)
  is off by a few % of an output row where a step's decay erases the
  rest of its chunk (dt·A near -20 a step: the row is C_i·B_i·dt_i·x_i)
  and the dot product C_i·B_i of N terms cancels.
* :func:`ssd_scan_bwd_ref` — the gradient's plain version: autograd through
  :func:`ssd_chunked_ref`, the CPU route of
  :func:`repro_torch.kernels.ssd_scan.ops.ssd_scan_bwd`.  Given f64
  inputs it computes in f64, the exact result ``chip_smoke.py`` holds the
  backward kernels to.
* :func:`ssd_bwd_states_ref` — the plain version of the backward's two
  state passes: each chunk's entering state S_in and the cotangent G of
  its leaving state, in the kernels' ``(B, nC, H, N, P)`` layout.  Tests
  and ``chip_smoke.py`` hold the kernels' buffers to it; the main path
  never calls it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor,
            h0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential recurrence → ``(y (B,S,H,P) in x.dtype, h_S (B,H,N,P)
    f32)``."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = Bm.float(), Cm.float()
    hs = h0.float() if h0 is not None else torch.zeros(
        (b, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af[None, :])               # (b,h)
        upd = torch.einsum("bn,bhp->bhnp", Bf[:, t],
                           xf[:, t] * dtf[:, t, :, None])
        hs = hs * decay[..., None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], hs))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((b, 0, h, p))
    return y.to(x.dtype), hs


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                    final_state: bool = False):
    """Chunked SSD forward → ``y (B,S,H,P)`` in ``x.dtype``; chunks of
    ``chunk`` steps from position 0, the state carried between them.  With
    ``final_state``, ``(y, h_S)``: the carried state after the last step,
    ``(B,H,N,P)`` f32 (f64 from f64 inputs, as all of the arithmetic)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    ct = torch.promote_types(x.dtype, torch.float32)
    Af = A.to(ct)
    hstate = torch.zeros((b, h, n, p), dtype=ct, device=x.device)
    ys = []
    for s0 in range(0, s, chunk):
        sl = slice(s0, min(s0 + chunk, s))
        xc, dtc = x[:, sl].to(ct), dt[:, sl].to(ct)       # (b,L,h,p) (b,L,h)
        bc, cc = Bm[:, sl].to(ct), Cm[:, sl].to(ct)       # (b,L,n)
        L = xc.shape[1]
        a_cs = torch.cumsum(dtc * Af, dim=1)               # (b,L,h) inclusive
        tri = torch.ones((L, L), dtype=torch.bool,
                         device=x.device).tril()[None, :, :, None]
        scores = torch.einsum("bin,bjn->bij", cc, bc)      # (b,L,L)
        # decay from step j to step i (i >= j): exp(a_i - a_j); masked
        # before the exp, so the upper triangle cannot overflow to inf
        diff = torch.where(tri, a_cs[:, :, None, :] - a_cs[:, None, :, :],
                           0.0)
        m = torch.where(tri, torch.exp(diff), 0.0)         # (b,L,L,h)
        xdt = xc * dtc[..., None]                          # (b,L,h,p)
        y = torch.einsum("bijh,bjhp->bihp", scores[..., None] * m, xdt)
        # the carried state's contribution
        y = y + torch.exp(a_cs)[..., None] * torch.einsum(
            "bin,bhnp->bihp", cc, hstate)
        # S_c = Σ_j exp(a_L − a_j) dt_j B_j ⊗ x_j ;  h ← h exp(a_L) + S_c
        wj = torch.exp(a_cs[:, -1:, :] - a_cs) * dtc       # (b,L,h)
        s_c = torch.einsum("bjn,bjhp->bhnp", bc, xc * wj[..., None])
        hstate = hstate * torch.exp(a_cs[:, -1, :])[..., None, None] + s_c
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, dim=1) if ys else torch.empty_like(x)
    return (y, hstate) if final_state else y


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                     chunk: int) -> Tuple[torch.Tensor, ...]:
    """``(dx, ddt, dA, dB, dC)`` of :func:`ssd_chunked_ref` at ``x, dt, A,
    B, C`` for the output gradient ``dy``, each in its input's dtype:
    autograd through the forward, recomputed here."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        y = ssd_chunked_ref(*leaves, chunk)
        return torch.autograd.grad(y, leaves, dy.to(y.dtype))


def ssd_bwd_states_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                       chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(S_in, G)``, each ``(B, nC, H, N, P)`` in f32 (f64 from f64
    inputs), nC = ceil(S / chunk): S_in of chunk c the state entering it
    (0 for the first), carried as :func:`ssd_chunked_ref` carries it; G of
    chunk c the cotangent of the state leaving it for the output gradient
    ``dy`` (0 for the last), G(c-1) = exp(a_{L-1})·G(c) + Σ_i exp(a_i)·C_i
    ⊗ dy_i over chunk c, with a = cumsum(dt·A) from the chunk's start."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    ct = torch.promote_types(x.dtype, torch.float32)
    Af = A.to(ct)
    spans = [slice(s0, min(s0 + chunk, s)) for s0 in range(0, s, chunk)]
    a_of = [torch.cumsum(dt[:, sl].to(ct) * Af, dim=1) for sl in spans]
    state = torch.zeros((b, h, n, p), dtype=ct, device=x.device)
    s_in = []
    for sl, a in zip(spans, a_of):
        s_in.append(state)
        w = torch.exp(a[:, -1:] - a) * dt[:, sl].to(ct)          # (b,L,h)
        state = state * torch.exp(a[:, -1])[..., None, None] + torch.einsum(
            "bjn,bjhp->bhnp", Bm[:, sl].to(ct), x[:, sl].to(ct) * w[..., None])
    cot = torch.zeros((b, h, n, p), dtype=ct, device=x.device)
    g = [cot] * len(spans)
    for k in reversed(range(len(spans))):
        g[k] = cot
        sl, a = spans[k], a_of[k]
        cot = cot * torch.exp(a[:, -1])[..., None, None] + torch.einsum(
            "bin,bihp->bhnp", Cm[:, sl].to(ct),
            dy[:, sl].to(ct) * torch.exp(a)[..., None])
    return torch.stack(s_in, dim=1), torch.stack(g, dim=1)
