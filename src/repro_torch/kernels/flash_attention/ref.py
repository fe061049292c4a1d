"""Plain-torch attention: the flash kernel's plain version.

The CPU path of :func:`repro_torch.kernels.flash_attention.ops.attention`
and the yardstick the CUDA kernel is held against on the card.  A port of
``repro.kernels.flash_attention.ref.attention_ref``: it materializes the
score matrix in f32, applies scale, then the soft-cap, then the mask
(causal with the ends aligned, so query row ``i`` stands at key position
``i + skv - sq``; sliding window ``rows - cols < window``), and gives 0 for
a fully masked row.  V's head dim may differ from Q's and K's.

Deviation: the score matrix is built for a block of query rows at a time,
a multiple of 64 rows whose f32 scores take at most
:data:`SCORE_BLOCK_BYTES` (one block of every row when the whole matrix
fits).  Every row goes through the same operations as unblocked, with all
the keys.  At zamba2-7b's prefill (B 2, 32 heads, S 8192) the whole f32
matrix is 17.2 GB and the mask, softmax and ``nan_to_num`` each make
another: unblocked, the plain version would not fit beside the model on an
80 GB card.  On the CPU the blocks give the unblocked result to the bit
(``tests/test_torch_zamba2.py``); blocks of 1 to 4 rows would not, where
the CPU's matrix product takes another kernel for so few rows.

:func:`attention_bwd_ref` is the plain version of the backward kernels:
autograd through :func:`attention_ref`.  :func:`attention_bwd_stats_ref`
is the plain version of the row statistics (LSE, D) the dQ kernels write
for the dK/dV kernel.
"""
from __future__ import annotations

import torch

#: the largest f32 score block (bytes) the plain version builds at once
SCORE_BLOCK_BYTES = 1 << 30


def _block_rows(b: int, hq: int, skv: int) -> int:
    """The most multiples of 64 query rows whose f32 scores
    :data:`SCORE_BLOCK_BYTES` holds, at least 64."""
    fit = SCORE_BLOCK_BYTES // max(1, b * hq * skv * 4)
    return max(64, fit // 64 * 64)


def _masked_scores(q, kf, r0: int, r1: int, causal: bool, window: int,
                   softcap: float, scale: float) -> torch.Tensor:
    """The f32 scores of query rows ``[r0, r1)`` against every key of
    ``kf`` (f32, one head a query head): scale, then the soft-cap, then
    the mask (-inf)."""
    sq, skv = q.shape[2], kf.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:r1].float(), kf) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(r0, r1, device=q.device)[:, None] + (skv - sq)
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((r1 - r0, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (rows >= cols)
    if window > 0:
        mask = mask & (rows - cols < window)
    return s.masked_fill(~mask, float("-inf"))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  scale: float | None = None) -> torch.Tensor:
    """``q (B,Hq,Sq,D)``, ``k (B,Hkv,Skv,D)``, ``v (B,Hkv,Skv,Dv)`` →
    ``(B,Hq,Sq,Dv)`` in ``q.dtype``; GQA by ratio ``Hq / Hkv``.  The query
    rows go in blocks of the most multiples of 64 rows whose scores
    :data:`SCORE_BLOCK_BYTES` holds, at least 64."""
    b, hq, sq, d = q.shape
    group = hq // k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    block_rows = _block_rows(b, hq, k.shape[2])
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    out = torch.empty((b, hq, sq, v.shape[3]), dtype=q.dtype, device=q.device)
    for r0 in range(0, sq, block_rows):
        r1 = min(sq, r0 + block_rows)
        s = _masked_scores(q, kf, r0, r1, causal, window, softcap, scale)
        p = torch.softmax(s, dim=-1)
        del s
        p = torch.nan_to_num(p, nan=0.0)
        out[:, :, r0:r1] = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return out


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, *, causal: bool = True,
                      window: int = 0, softcap: float = 0.0,
                      scale: float | None = None):
    """``(dq, dk, dv)`` of :func:`attention_ref` at ``q, k, v`` for the
    output gradient ``do``, in the inputs' dtypes: autograd through the
    forward, recomputed here."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_ref(*leaves, causal=causal, window=window,
                            softcap=softcap, scale=scale)
        return torch.autograd.grad(out, leaves, do.to(out.dtype))


def attention_bwd_stats_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            softcap: float = 0.0, scale: float | None = None
                            ) -> tuple:
    """The row statistics the dQ kernels write, ``(lse, delta)``, each f32
    ``(B, Hq, Sq)``: LSE = log Σ exp(s) over a row's unmasked keys (+inf
    for a row with none) and D = Σ P ⊙ dP with P = exp(s − LSE) and
    dP = dO·Vᵀ, both in f32 from the inputs' values — not from the
    forward's output.  Query rows go in :func:`attention_ref`'s blocks."""
    b, hq, sq, d = q.shape
    group = hq // k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    block_rows = _block_rows(b, hq, k.shape[2])
    for r0 in range(0, sq, block_rows):
        r1 = min(sq, r0 + block_rows)
        s = _masked_scores(q, kf, r0, r1, causal, window, softcap, scale)
        m = torch.logsumexp(s, dim=-1)
        m = m.masked_fill(m == float("-inf"), float("inf"))
        p = torch.exp(s - m[..., None])
        del s
        dp = torch.einsum("bhqd,bhkd->bhqk", do[:, :, r0:r1].float(), vf)
        lse[:, :, r0:r1] = m
        delta[:, :, r0:r1] = (p * dp).sum(dim=-1)
    return lse, delta
