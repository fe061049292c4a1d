"""Plan interpreters: the eager logical TRA walk and the local IA walk.

Port of ``repro.core.interp`` for one device:

* ``_evaluate_tra`` — walk a logical plan with the dense eager ops;
* ``_evaluate_ia``  — walk a physical plan ignoring sites (a valid IA plan
  equals its TRA source after projecting sites away).  ``Bcast``/``Shuf``
  are identities here.

The JAX package's SPMD mode (``_evaluate_ia(spmd=True)``, ``_jit_ia_plans``)
and the deprecated ``evaluate_*`` / ``jit_ia_plan`` shims wait for the
distributed slice (A7, see ``ROADMAP.md``).  The walks take ``chunk`` (the
chunked fused lowering's slices per step), ``budget`` (the device
live-bytes budget ``chunk="auto"`` solves against) and ``ctx``, the
engine's :class:`~repro_torch.core.guards.ExecContext`: when it is active
every computed node value — inputs included — passes through
``ctx.on_node`` (fault injection and per-node finite checks with plan
provenance), and the fused Σ∘⋈ calls ``ctx.on_contraction``.  Constants
are materialized on ``device``, which every walk takes explicitly (no
default: a caller that forgets it fails instead of running on the CPU).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import tra
from repro_torch.core.plan import (Bcast, FusedJoinAgg, IAConst, IAInput,
                                   IANode, LocalAgg, LocalConcat, LocalFilter,
                                   LocalJoin, LocalMap, LocalPad, LocalTile,
                                   Shuf, TraAgg, TraConcat, TraConst,
                                   TraFilter, TraInput, TraJoin, TraNode,
                                   TraPad, TraReKey, TraTile, TraTransform,
                                   as_node, children, postorder)
from repro_torch.core.tra import TensorRelation


def _const_rel(rtype, fill: float, device) -> TensorRelation:
    shape = tuple(rtype.key_shape) + tuple(rtype.bound)
    return TensorRelation(
        torch.full(shape, fill, dtype=rtype.dtype, device=device), rtype)


def fusable(n, consumers: Dict[int, int]) -> bool:
    """Does the logical walk run ``n`` as one fused Σ∘⋈?  True for a
    ``TraAgg`` over a single-consumer ``TraJoin`` whose kernels admit it."""
    c = getattr(n, "child", None)
    return (isinstance(n, TraAgg) and isinstance(c, TraJoin)
            and consumers.get(id(c), 0) == 1
            and tra.can_fuse(c.kernel, n.kernel))


def consumer_counts(roots) -> Dict[int, int]:
    counts: Dict[int, int] = {}
    seen: set = set()
    for r in roots:
        for n in postorder(as_node(r)):
            if id(n) in seen:
                continue
            seen.add(id(n))
            for c in children(n):
                counts[id(c)] = counts.get(id(c), 0) + 1
    return counts


def eval_tra_node(n: TraNode, kids, device, fused: bool = False,
                  chunk=None, ctx=None, budget=None) -> TensorRelation:
    """One logical node's value from its children's values.  With
    ``fused`` the node is a ``TraAgg`` and ``kids`` are its join child's
    two operands (see :func:`fusable`).  ``ctx`` reaches the fused Σ∘⋈'s
    contraction hook; the caller applies ``ctx.on_node``."""
    if isinstance(n, TraInput):
        raise TypeError("TraInput values come from the input environment")
    if isinstance(n, TraConst):
        return _const_rel(n.rtype, n.fill, device)
    if isinstance(n, TraPad):
        return tra.pad(kids[0], n.key_shape)
    if isinstance(n, TraJoin):
        return tra.join(kids[0], kids[1], n.join_keys_l, n.join_keys_r,
                        n.kernel)
    if isinstance(n, TraAgg):
        if fused:
            c = n.child
            return tra.fused_join_agg(kids[0], kids[1], c.join_keys_l,
                                      c.join_keys_r, c.kernel, n.group_by,
                                      n.kernel, chunk=chunk,
                                      budget=budget, ctx=ctx, node=n)
        return tra.agg(kids[0], n.group_by, n.kernel)
    if isinstance(n, TraReKey):
        return tra.rekey(kids[0], n.key_func)
    if isinstance(n, TraFilter):
        return tra.filt(kids[0], n.bool_func)
    if isinstance(n, TraTransform):
        return tra.transform(kids[0], n.kernel)
    if isinstance(n, TraTile):
        return tra.tile(kids[0], n.tile_dim, n.tile_size)
    if isinstance(n, TraConcat):
        return tra.concat(kids[0], n.key_dim, n.array_dim)
    raise TypeError(type(n))


def _evaluate_tra(node: TraNode, env: Dict[str, TensorRelation],
                  _cache: Optional[dict] = None,
                  fuse: bool = True, *,
                  device, chunk=None, ctx=None,
                  budget=None) -> TensorRelation:
    """Walk a logical plan with the dense eager ops.

    With ``fuse=True`` (default) every ``TraAgg(TraJoin(...))`` pair whose
    kernels admit it executes through :func:`tra.fused_join_agg` — the
    Σ∘⋈ contraction — instead of materializing the join grid.  Joins with
    more than one consumer are exempt (they are computed once and cached).
    Pass ``fuse=False`` to force the unfused pair (the correctness oracle).
    """
    node = as_node(node)
    cache = _cache if _cache is not None else {}
    consumers = consumer_counts([node]) if fuse else {}
    hook = ctx is not None and ctx.active

    def rec(n):
        if id(n) in cache:
            return cache[id(n)]
        if isinstance(n, TraInput):
            out = env[n.name]
        elif fuse and fusable(n, consumers) and id(n.child) not in cache:
            out = eval_tra_node(n, [rec(n.child.left), rec(n.child.right)],
                                device, fused=True, chunk=chunk, ctx=ctx,
                                budget=budget)
        else:
            out = eval_tra_node(n, [rec(c) for c in children(n)], device,
                                ctx=ctx)
        if hook:
            out = ctx.on_node(n, out)
        cache[id(n)] = out
        return out

    return rec(node)


def eval_ia_node(node: IANode, kids, device, chunk=None,
                 ctx=None, budget=None) -> TensorRelation:
    """One physical node's value from its children's values (``kids`` in
    :func:`repro_torch.core.plan.children` order) — shared by the
    recursive walk below and the engine's ``jit`` schedule.  ``ctx``
    reaches the fused Σ∘⋈'s contraction hook; the caller applies
    ``ctx.on_node``."""
    if isinstance(node, IAInput):
        raise TypeError("IAInput values come from the input environment")
    if isinstance(node, IAConst):
        return _const_rel(node.rtype, node.fill, device)
    if isinstance(node, LocalPad):
        return tra.pad(kids[0], node.key_shape)
    if isinstance(node, (Bcast, Shuf)):
        return kids[0]                 # one site: data movement is a no-op
    if isinstance(node, LocalJoin):
        return tra.join(kids[0], kids[1], node.join_keys_l,
                        node.join_keys_r, node.kernel)
    if isinstance(node, LocalAgg):
        return tra.agg(kids[0], node.group_by, node.kernel)
    if isinstance(node, FusedJoinAgg):
        return tra.fused_join_agg(kids[0], kids[1], node.join_keys_l,
                                  node.join_keys_r, node.join_kernel,
                                  node.group_by, node.agg_kernel,
                                  chunk=chunk, budget=budget, ctx=ctx,
                                  node=node)
    if isinstance(node, LocalFilter):
        return tra.filt(kids[0], node.bool_func)
    if isinstance(node, LocalMap):
        out = kids[0]
        if node.kernel.name != "idOp":
            out = tra.transform(out, node.kernel)
        if node.key_func is not None:
            out = tra.rekey(out, node.key_func)
        return out
    if isinstance(node, LocalTile):
        return tra.tile(kids[0], node.tile_dim, node.tile_size)
    if isinstance(node, LocalConcat):
        return tra.concat(kids[0], node.key_dim, node.array_dim)
    raise TypeError(type(node))


def _evaluate_ia(node: IANode, env: Dict[str, TensorRelation],
                 _cache: Optional[dict] = None, *,
                 device, chunk=None, ctx=None,
                 budget=None) -> TensorRelation:
    """Evaluate a physical plan on one device (sites ignored)."""
    node = as_node(node)
    cache = _cache if _cache is not None else {}
    if id(node) in cache:
        return cache[id(node)]
    if isinstance(node, IAInput):
        out = env[node.name]
    else:
        kids = [_evaluate_ia(c, env, cache, device=device, chunk=chunk,
                             ctx=ctx, budget=budget)
                for c in children(node)]
        out = eval_ia_node(node, kids, device, chunk, ctx, budget)
    if ctx is not None and ctx.active:
        out = ctx.on_node(node, out)
    cache[id(node)] = out
    return out
