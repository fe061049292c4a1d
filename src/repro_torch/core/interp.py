"""Plan interpreters: the eager logical TRA walk, the local IA walk, and
the distributed gspmd walk.

Port of ``repro.core.interp``:

* ``_evaluate_tra`` — walk a logical plan with the dense eager ops;
* ``_evaluate_ia``  — walk a physical plan ignoring sites (a valid IA plan
  equals its TRA source after projecting sites away).  ``Bcast``/``Shuf``
  are identities here;
* ``_jit_ia_plans`` — the ``gspmd`` executor's walk over a
  ``DeviceMesh``.  JAX states each placement-bearing node's sharding with
  ``with_sharding_constraint`` and lets XLA choose the collectives; here
  each node's value is a ``torch.distributed.tensor.DTensor`` placed as
  the node's placement (:func:`_placements_for`, the counterpart of
  ``_pspec_for``), every input, ``Bcast`` and ``Shuf`` value is
  redistributed to its placement, and DTensor chooses the collectives.
  Pending duplicates stay ``Partial(reduce_op)`` until the next
  ``Shuf``/``Bcast`` (JAX defers them the same way), except for a
  reducer DTensor has no op for (``minIndex``): that one resolves where
  it is produced, through the ``shard_map`` executor's gather-and-fold.

Deviations: the gspmd walk computes every ``tra`` call on local shards
(``to_local`` → the op → ``from_local``), so the hand kernels' ops
(``kernels/matmul/ops.py``, ``_fused_einsum``) only ever see plain
tensors — they have no sharding rule, and a DTensor reaching the matmul
op raises.  A join's replicated side is cut to the sharded side's key
window by a ``redistribute`` to ``Shard`` (a local slice).  On gloo,
DTensor's collectives over CUDA tensors go through the host
(:func:`redistribute`).  Every rank runs the walk (one process per rank,
not one controller), on the ``jit`` executor's deduplicated steps.  Masks
(and so filters) are refused, as the ``shard_map`` executor refuses them:
a local shard's key indices are not the global ones a filter reads.  The
deprecated ``evaluate_*`` / ``jit_ia_plan`` shims are not ported.

The walks take ``chunk`` (the chunked fused lowering's slices per step),
``budget`` (the device live-bytes budget ``chunk="auto"`` solves
against) and ``ctx``, the engine's
:class:`~repro_torch.core.guards.ExecContext`: when it is active every
computed node value — inputs included — passes through ``ctx.on_node``
(fault injection and per-node finite checks with plan provenance), and
the fused Σ∘⋈ calls ``ctx.on_contraction``; the gspmd walk applies only
the injector's node faults, through ``ctx.on_array``.  Constants are
materialized on ``device``, which every walk takes explicitly (no
default: a caller that forgets it fails instead of running on the CPU).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import tra
from repro_torch.core.plan import (Bcast, FusedJoinAgg, IAConst, IAInput,
                                   IANode, LocalAgg, LocalConcat, LocalFilter,
                                   LocalJoin, LocalMap, LocalPad, LocalTile,
                                   Shuf, TraAgg, TraConcat, TraConst,
                                   TraFilter, TraInput, TraJoin, TraNode,
                                   TraPad, TraReKey, TraTile, TraTransform,
                                   Placement, TypeInfo, as_node, children,
                                   infer, postorder)
from repro_torch.core.tra import TensorRelation, is_dtensor


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


# ==========================================================================
# The gspmd walk (DTensor placements over a DeviceMesh)
# ==========================================================================

# agg kernels DTensor can hold pending as Partial(reduce_op)
_PARTIAL_OPS = {None: "sum", "matAdd": "sum", "elemMax": "max",
                "elemMin": "min", "elemMul": "product"}


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name → size of a ``DeviceMesh`` (JAX's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def dense_shape(rtype) -> Tuple[int, ...]:
    return tuple(rtype.key_shape) + tuple(rtype.bound)


def _placements_for(placement: Optional[Placement], rtype, mesh) -> tuple:
    """DTensor placements over the dense layout ``key_shape ++ bound``, one
    per mesh dimension: ``Shard(d)`` where the placement partitions key dim
    ``d`` along it, ``Partial`` where it holds pending duplicates along it,
    ``Replicate`` elsewhere (the counterpart of JAX's ``_pspec_for``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if placement is None:
        return tuple(Replicate() for _ in mesh.mesh_dim_names)
    dims = {} if placement.kind == "replicated" \
        else {ax: d for d, ax in zip(placement.dims, placement.axes)}
    out = []
    for ax in mesh.mesh_dim_names:
        if ax in placement.dup_axes:
            out.append(Partial(_PARTIAL_OPS[placement.dup_kernel]))
        elif ax in dims:
            out.append(Shard(dims[ax]))
        else:
            out.append(Replicate())
    return tuple(out)


def to_dtensor(local: torch.Tensor, placement: Optional[Placement], rtype,
               mesh):
    """A rank's block of a relation of type ``rtype`` under ``placement``
    as a DTensor of the global dense shape."""
    from torch.distributed.tensor import DTensor
    shape = dense_shape(rtype)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh,
                              _placements_for(placement, rtype, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


# a mesh's CPU twin over the same process groups, by id(mesh); the mesh
# is kept with it so that its id is not reused while the entry lives
_TWINS: Dict[int, tuple] = {}


def _host_twin(mesh):
    from torch.distributed.device_mesh import DeviceMesh
    entry = _TWINS.get(id(mesh))
    if entry is None or entry[0] is not mesh:
        names = tuple(mesh.mesh_dim_names)
        groups = [mesh.get_group(n) for n in names]
        entry = (mesh, DeviceMesh.from_group(
            groups if len(groups) > 1 else groups[0], "cpu",
            mesh=mesh.mesh, mesh_dim_names=names))
        _TWINS[id(mesh)] = entry
    return entry[1]


def _on_gloo(mesh) -> bool:
    import torch.distributed as dist
    return any(dist.get_backend(mesh.get_group(n)) == "gloo"
               for n in mesh.mesh_dim_names)


def moves_data(src, tgt) -> bool:
    """Does a DTensor redistribute from placements ``src`` to ``tgt`` run
    a collective?  (Replicate → Shard or Partial is a local step.)"""
    return any(s != t and not s.is_replicate() for s, t in zip(src, tgt))


def redistribute(dt, want, stage: Optional[bool] = None):
    """``dt.redistribute(mesh, want)`` → ``(DTensor, staged bytes)``.

    On a gloo group DTensor's functional collectives over CUDA tensors
    crash the process (torch 2.11 on an H100: a segmentation fault in
    ``wait_tensor`` of DTensor's all-gather; ``PERF.md`` §6), while
    gloo's own collectives take CUDA tensors
    (``tools/gloo_cuda_probe.py``).  So on gloo every redistribute of a
    CUDA DTensor that moves data is **staged**: the local block copied to
    a page-locked host tensor, redistributed there on the mesh's CPU twin
    (the same process groups), and copied back.  ``stage`` forces the
    choice (tests); by default the backend and the tensor's device decide,
    never a caught error."""
    from torch.distributed.tensor import DTensor
    want = tuple(want)
    mesh = dt.device_mesh
    if tuple(dt.placements) == want:
        return dt, 0
    local = dt.to_local()
    if stage is None:
        stage = local.is_cuda and _on_gloo(mesh) and \
            moves_data(dt.placements, want)
    if not stage:
        return dt.redistribute(mesh, want), 0
    host = torch.empty(local.shape, dtype=local.dtype,
                       pin_memory=local.is_cuda)
    host.copy_(local)
    twin = _host_twin(mesh)
    moved = DTensor.from_local(host, twin, dt.placements, run_check=False,
                               shape=dt.shape, stride=dt.stride())
    res = moved.redistribute(twin, want).to_local()
    out = DTensor.from_local(res.to(local.device), mesh, want,
                             run_check=False, shape=dt.shape,
                             stride=dt.stride())
    return out, host.numel() * host.element_size() \
        + res.numel() * res.element_size()


def full_value(dt) -> torch.Tensor:
    """A DTensor's global tensor on every rank (``full_tensor``, staged on
    gloo as :func:`redistribute` says)."""
    from torch.distributed.tensor import Replicate
    out, _ = redistribute(dt, [Replicate()] * len(dt.placements))
    return out.to_local()


def _merge_ia_inputs(roots) -> Dict[str, IAInput]:
    """name → IAInput over several physical roots; conflicting declarations
    (type or placement) for one name are rejected."""
    by_name: Dict[str, IAInput] = {}
    for root in roots:
        for n in postorder(as_node(root)):
            if isinstance(n, IAInput):
                prev = by_name.get(n.name)
                if prev is not None and (prev.rtype != n.rtype
                                         or prev.placement != n.placement):
                    raise ValueError(
                        f"input {n.name!r} declared with conflicting "
                        f"type/placement across roots: "
                        f"{prev.placement.describe()} vs "
                        f"{n.placement.describe()}")
                by_name[n.name] = n
    return by_name


def _jit_ia_plans(roots, mesh, chunk=None, budget: Optional[int] = None,
                  ctx=None, *, device):
    """The gspmd executor over ``mesh`` for a tuple of physical roots,
    built once: ``(call, names, exchange)``, ``call(env) -> tuple`` of
    :class:`TensorRelation` results whose data are DTensors placed as the
    outputs' placements (pending duplicates resolved).  ``exchange`` (a
    :class:`repro_torch.core.shardmap_exec.Exchange`) records the
    collectives of the last dispatch."""
    from repro_torch.core.engine import schedule_steps
    from repro_torch.core.guards import label_nodes
    from repro_torch.core.shardmap_exec import (Exchange, _cross_site_reduce,
                                                check_subset, input_block,
                                                join_windows, local_value)
    from torch.distributed.tensor import Shard
    roots = tuple(as_node(r) for r in roots)
    cache: Dict[int, TypeInfo] = {}
    out_infos = tuple(infer(r, cache=cache) for r in roots)
    names = sorted(_merge_ia_inputs(roots))
    sizes = mesh_sizes(mesh)
    axes = tuple(mesh.mesh_dim_names)
    check_subset(roots, cache, sizes)
    steps, drops, out_slots = schedule_steps(roots, fuse=False)
    ex = Exchange(mesh, label_nodes(roots))
    faults = ctx is not None and ctx.faults is not None

    def want(p, rtype):
        return _placements_for(p, rtype, mesh)

    def produce(node, local, p: Placement, rtype):
        # a reducer that DTensor has no Partial for is resolved here
        if p is not None and p.dup_axes and \
                p.dup_kernel not in _PARTIAL_OPS:
            for ax in p.dup_axes:
                local = _cross_site_reduce(ex, node, local, ax,
                                           p.dup_kernel)
            p = Placement.partitioned(p.dims, p.axes) \
                if p.kind == "partitioned" else Placement.replicated()
        return to_dtensor(local, p, rtype, mesh)

    def call(env: Dict[str, TensorRelation]):
        ex.begin()
        vals = []
        for (node, kids, _), drop in zip(steps, drops):
            info = cache[id(node)]
            if isinstance(node, IAInput):
                data = env[node.name].data
                if is_dtensor(data) and data.device_mesh == mesh:
                    ex.resharding = True
                    try:
                        dt = ex.redistribute(
                            node, data, want(node.placement, node.rtype))
                    finally:
                        ex.resharding = False
                else:
                    dt = to_dtensor(input_block(data, node.placement,
                                                node.rtype, mesh),
                                    node.placement, node.rtype, mesh)
            elif isinstance(node, (Bcast, Shuf)):
                dt = ex.redistribute(node, vals[kids[0]],
                                     want(info.placement, info.rtype))
            else:
                dts = [vals[k] for k in kids]
                if isinstance(node, (LocalJoin, FusedJoinAgg)):
                    lt, rt = (cache[id(c)] for c in children(node))
                    for side, d, ax in join_windows(node, lt, rt):
                        pls = list(dts[side].placements)
                        pls[axes.index(ax)] = Shard(d)
                        dts[side], _ = redistribute(dts[side], pls)
                local = local_value(node, [d.to_local() for d in dts],
                                    cache, sizes, device=device, chunk=chunk,
                                    budget=budget, ctx=ctx)
                dt = produce(node, local, info.placement, info.rtype)
            if faults:
                dt = type(dt).from_local(ctx.on_array(node, dt.to_local()),
                                         mesh, dt.placements,
                                         run_check=False, shape=dt.shape,
                                         stride=dt.stride())
            vals.append(dt)
            for k in drop:
                vals[k] = None
        outs = []
        for root, oi, s in zip(roots, out_infos, out_slots):
            dt, p = vals[s], oi.placement
            if p is not None and p.dup_axes:
                # XLA resolves an output's pending partials; so does this
                p = Placement.partitioned(p.dims, p.axes) \
                    if p.kind == "partitioned" else Placement.replicated()
                dt = ex.redistribute(root, dt, want(p, oi.rtype))
            outs.append(TensorRelation(dt, oi.rtype))
        return tuple(outs)

    return call, names, ex
