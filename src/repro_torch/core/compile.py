"""TRA → IA compiler (paper §4.1, Table 1).

Port of ``repro.core.compile``, unchanged: plain Python over the plan IR.

Produces the *default* physical plan; the optimizer in
:mod:`repro_torch.core.optimize` then rewrites it cost-based.  The mapping is the
paper's Table 1 verbatim:

    Σ_(gb,op)(R)        ↦ Σᴸ_(gb,op)(SHUF_(gb)(R))
    ⋈_(jl,jr,op)(L, R)  ↦ ⋈ᴸ_(jl,jr,op)(BCAST(L), R)
    ReKey_(f)(R)        ↦ λᴸ_(f, idOp)(R)
    σ_(f)(R)            ↦ σᴸ_(f)(R)
    λ_(f)(R)            ↦ λᴸ_(idOp, f)(R)
    Tile / Concat       ↦ LocalTile / Σᴸ∘SHUF (LocalConcat after SHUF on the
                          complement key dims)
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.kernels_registry import get_kernel
from repro_torch.core.plan import (Bcast, IAConst, IAInput, IANode, LocalAgg,
                                   LocalConcat, LocalFilter, LocalJoin,
                                   LocalMap, LocalPad, LocalTile, Placement,
                                   Shuf, TraAgg, TraConcat, TraConst,
                                   TraFilter, TraInput, TraJoin, TraNode,
                                   TraPad, TraReKey, TraTile, TraTransform,
                                   infer)


def compile_tra(node: TraNode,
                input_placements: Optional[Dict[str, Placement]] = None,
                site_axes: Tuple[str, ...] = ("sites",),
                _cache: Optional[dict] = None) -> IANode:
    """Compile a logical plan to the Table-1 default physical plan."""
    from repro_torch.core.plan import as_node
    node = as_node(node)
    placements = input_placements or {}
    cache = _cache if _cache is not None else {}
    if id(node) in cache:
        return cache[id(node)]

    def rec(n):
        return compile_tra(n, placements, site_axes, cache)

    def shuf_dims(dims: Sequence[int]) -> Tuple[Tuple[int, ...],
                                                Tuple[str, ...]]:
        dims = tuple(dims)[:len(site_axes)]
        return dims, tuple(site_axes[:len(dims)])

    out: IANode
    if isinstance(node, TraInput):
        out = IAInput(node.name, node.rtype,
                      placements.get(node.name, Placement.replicated()))
    elif isinstance(node, TraConst):
        out = IAConst(node.rtype, node.fill, Placement.replicated())
    elif isinstance(node, TraPad):
        child = rec(node.child)
        if tuple(node.key_shape) != infer(node.child).rtype.key_shape:
            # growing a frontier is only local on a replicated child
            child = Bcast(child)
        out = LocalPad(child, tuple(node.key_shape))
    elif isinstance(node, TraJoin):
        out = LocalJoin(Bcast(rec(node.left)), rec(node.right),
                        node.join_keys_l, node.join_keys_r, node.kernel)
    elif isinstance(node, TraAgg):
        # Table 1 always re-shuffles on the group-by keys; an empty group-by
        # list shuffles to a single site (SINGLE placement).  The optimizer
        # later removes provably-redundant shuffles (R2-4) or splits the
        # aggregation in two phases (R2-5).
        dims, axes = shuf_dims(node.group_by)
        child = Shuf(rec(node.child), dims, axes)
        out = LocalAgg(child, node.group_by, node.kernel)
    elif isinstance(node, TraReKey):
        out = LocalMap(rec(node.child), node.key_func, get_kernel("idOp"),
                       tag=node.tag)
    elif isinstance(node, TraFilter):
        out = LocalFilter(rec(node.child), node.bool_func, tag=node.tag)
    elif isinstance(node, TraTransform):
        out = LocalMap(rec(node.child), None, node.kernel)
    elif isinstance(node, TraTile):
        out = LocalTile(rec(node.child), node.tile_dim, node.tile_size)
    elif isinstance(node, TraConcat):
        k = infer(node.child).rtype.key_arity
        complement = tuple(d for d in range(k) if d != node.key_dim)
        dims, axes = shuf_dims(complement)
        child = Shuf(rec(node.child), dims, axes)
        out = LocalConcat(child, node.key_dim, node.array_dim)
    else:
        raise TypeError(type(node))
    cache[id(node)] = out
    return out
