"""Plain-torch versions of the blocked matmul's kernels.

The CPU path of :func:`repro_torch.kernels.matmul.ops.matmul` and the
yardstick the CUDA kernel is held against on the card.  Mirrors
``repro.kernels.matmul.ref.matmul_ref``: products in f32, result cast to
``out_dtype`` (default ``a.dtype``).  On the card, f32 products run in true
f32 only while ``torch.backends.cuda.matmul.allow_tf32`` is False (the
default), which callers comparing at 1e-5 set explicitly.
"""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype = None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return (a.float() @ b.float()).to(out_dtype)


def splitk_reduce_ref(partial: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the split-K reduction pass: ``partial`` (splits, m,
    n) f32 summed over its first axis in split order, as the kernel adds."""
    out = torch.zeros(partial.shape[1:], dtype=torch.float32,
                      device=partial.device)
    for s in range(partial.shape[0]):
        out = out + partial[s]
    return out.to(out_dtype)
