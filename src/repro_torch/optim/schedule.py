"""LR schedules as pure ``step -> scale`` functions (scale multiplies the
optimizer's base lr).

Port of ``repro.optim.schedule``: ``step`` is an integer tensor (0-d, on
the optimizer state's device) and the scale an f32 tensor beside it.
"""
from __future__ import annotations

import math

import torch


def constant(step: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(step, dtype=torch.float32)


def linear_warmup_cosine(step: torch.Tensor, *, warmup: int, total: int,
                         min_ratio: float = 0.1) -> torch.Tensor:
    s = step.to(torch.float32)
    warm = s / max(warmup, 1)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(s < warmup, warm, cos)


def inverse_sqrt(step: torch.Tensor, *, warmup: int) -> torch.Tensor:
    s = torch.clamp(step.to(torch.float32), min=1.0)
    return torch.minimum(s / max(warmup, 1), torch.sqrt(warmup / s))
