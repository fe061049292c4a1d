"""Plain-torch versions of the blocked matmul's kernels.

The CPU path of :func:`repro_torch.kernels.matmul.ops.matmul` and the
yardstick the CUDA kernel is held against on the card.  Mirrors
``repro.kernels.matmul.ref.matmul_ref``: products in f32, result cast to
``out_dtype`` (default ``a.dtype``).  On the card, f32 products run in true
f32 only while ``torch.backends.cuda.matmul.allow_tf32`` is False (the
default), which callers comparing at 1e-5 set explicitly.

:func:`matmul_split_ref` sums a product the way the narrow kernel folds
its split-K sum: each K split's partial product, then the partials added
in split order.  :func:`tf32_split_ref` is the plain version of the
tensor-core route's operand pass (``tf32_split_kernel``), in torch bit
operations.
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


def matmul_split_ref(a: torch.Tensor, b: torch.Tensor, bounds,
                     out_dtype: torch.dtype = None) -> torch.Tensor:
    """``a @ b`` summed in the narrow kernel's split order: the partial
    product of each K split ``[bounds[z], bounds[z + 1])`` in f32, then the
    partials added in split order (:func:`splitk_reduce_ref`).  ``bounds``
    runs from 0 to K (``NarrowPlan.k_bounds``)."""
    out_dtype = out_dtype or a.dtype
    parts = torch.stack([matmul_ref(a[:, k0:k1], b[k0:k1], torch.float32)
                         for k0, k1 in zip(bounds[:-1], bounds[1:])])
    return splitk_reduce_ref(parts, out_dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the
    nearest value with 10 mantissa bits, ties away from zero, the low 13
    bits zero (half of the dropped bits' unit added to the magnitude, then
    the bits cut)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split_ref(x: torch.Tensor, kp: int,
                   transpose: bool = False) -> torch.Tensor:
    """Plain version of the split pass: the 2-D f32 ``x`` (or ``xᵀ`` with
    ``transpose``) as a ``(2, R, kp)`` array of its R rows, [0] each value's
    TF32 big term and [1] the TF32 small term of what big leaves, each row
    padded along K to ``kp`` values with zeros."""
    m = (x.t() if transpose else x).float()
    r, k = m.shape
    if kp < k:
        raise ValueError(f"kp {kp} is shorter than K {k}")
    out = torch.zeros((2, r, kp), dtype=torch.float32, device=x.device)
    big = tf32_round(m)
    out[0, :, :k] = big
    out[1, :, :k] = tf32_round(m - big)
    return out
