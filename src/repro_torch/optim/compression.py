"""Gradient compression with error feedback.

Port of ``repro.optim.compression``.  ``bf16_ef``: gradients are rounded
to bf16 before the cross-replica reduction; the rounding error is carried
in a per-leaf f32 residual and added back the next step.  The port's trees
are dicts of tensors (the dotted parameter names of
:class:`~repro_torch.models.model.DenseLM`); nested dicts work too.
"""
from __future__ import annotations

from typing import Callable, Mapping, Tuple

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of dicts of tensors (nested or not), with the
    same keys in every tree."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress(grads, residuals) -> Tuple[object, object]:
    """Returns (bf16 grads to feed the reduction, new residuals)."""
    def one(g, r):
        gf = g.to(torch.float32) + r
        gc = gf.to(torch.bfloat16)
        return gc, gf - gc.to(torch.float32)

    pairs = tree_map(one, grads, residuals)
    return (tree_map(lambda pr: pr[0], pairs),
            tree_map(lambda pr: pr[1], pairs))


def decompress(grads):
    return tree_map(lambda g: g.to(torch.float32), grads)
