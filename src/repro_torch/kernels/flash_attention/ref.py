"""Plain-torch attention: the flash kernel's plain version.

The CPU path of :func:`repro_torch.kernels.flash_attention.ops.attention`
and the yardstick the CUDA kernel is held against on the card.  A port of
``repro.kernels.flash_attention.ref.attention_ref``: it materializes the
score matrix in f32, applies scale, then the soft-cap, then the mask
(causal with the ends aligned, so query row ``i`` stands at key position
``i + skv - sq``; sliding window ``rows - cols < window``), and gives 0 for
a fully masked row.  V's head dim may differ from Q's and K's.
"""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  scale: float | None = None) -> torch.Tensor:
    """``q (B,Hq,Sq,D)``, ``k (B,Hkv,Skv,D)``, ``v (B,Hkv,Skv,Dv)`` →
    ``(B,Hq,Sq,Dv)`` in ``q.dtype``; GQA by ratio ``Hq / Hkv``."""
    sq, d = q.shape[2], q.shape[3]
    hkv, skv = k.shape[1], k.shape[2]
    group = q.shape[1] // hkv
    scale = scale if scale is not None else d ** -0.5
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (rows >= cols)
    if window > 0:
        mask = mask & (rows - cols < window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
