"""Explicit-collective IA executor (paper-faithful ``shard_map`` mode).

Port of ``repro.core.shardmap_exec`` on ``torch.distributed``.  Where the
``gspmd`` walk (:mod:`repro_torch.core.interp`) *describes* placements and
lets DTensor choose the collectives, this executor *is* the IA: every
``BCAST`` is an all-gather, every dim-changing ``SHUF`` an all-to-all (or
a local slice, depending on source and target placements), and the
two-phase aggregation state (``dup_axes``) resolves through a
reduce-scatter or an all-reduce — exactly the collective schedule the
paper's cost model prices and :func:`repro_torch.analysis.collectives.
collective_schedule` derives.

Supported subset (as in JAX): continuous relations (no masks — push filters
to the logical layer first), local joins / aggregations / kernel maps /
tiles / concats.  Key-rewriting maps require a replicated input or a pure
key permutation.  This mode is the semantics reference for the distributed
algebra.

Deviations from the JAX module:

* **Ranks, not one controller.**  Every rank runs the same driver program
  with the same ``Engine(mesh, executor="shard_map")`` and passes the same
  *global* input relations to ``run``, as JAX's callers pass global arrays.
  The executor takes each rank's block by the input's ``Placement`` (a
  view: no copy); an input whose data is a DTensor is redistributed to
  that placement if it holds another, and its local shard taken.
* **Results are DTensors.**  Each output comes back as a
  :class:`~repro_torch.core.tra.TensorRelation` whose ``data`` is a
  ``torch.distributed.tensor.DTensor`` on the engine's ``DeviceMesh``,
  placed as the output's placement (pending duplicates resolved), the
  counterpart of a sharded ``jax.Array``: ``to_tensor`` gives the global
  tensor on every rank, and a result fed to the next run stays sharded.
* **An eager walk, built once.**  :func:`_build_shardmap` infers types,
  checks the subset and flattens the plans into the ``jit`` executor's
  steps (:func:`repro_torch.core.engine.schedule_steps`: structurally
  identical nodes run once across roots, as XLA's CSE merges them under
  ``jax.jit``; values are dropped after their last reader) at compile
  time, so a cache hit is pure dispatch.  Node-scoped faults fire through
  ``ExecContext.on_array`` as each node is dispatched (JAX fires them at
  trace time).
* **One function issues every collective** (:meth:`Exchange.run`): it
  records the :class:`~repro_torch.analysis.collectives.CollectiveOp` the
  lowering emits, with the bytes of this rank's input block, in the
  program's :class:`Exchange` log, and counts it in :data:`COLLECTIVES` by
  kind (``all_gather``, ``all_to_all``, ``psum_scatter``, ``all_reduce``).
  The recorded schedule of a dispatch is :func:`expected_schedule` of the
  program op for op.  A reducer without a native collective (anything
  but ``matAdd``/``elemMax``/``elemMin``) is recorded as the
  ``all_reduce`` the schedule names and travels as an all-gather with a
  local fold, as in JAX.
* **Backends.**  NCCL for CUDA tensors on separate cards, gloo on the CPU
  and for ranks that share one card.  The collectives of :meth:`Exchange.run`
  go to the group as they are, CUDA tensors included:
  ``tools/gloo_cuda_probe.py`` shows gloo taking all four of them on a
  card (torch 2.11 on an H100); run it again on a new torch.  The gspmd
  walk's DTensor collectives are another matter
  (:func:`repro_torch.core.interp.redistribute`).
* The deprecated ``execute_shardmap`` shim is not ported (nor are
  ``interp``'s): ``Engine(mesh, executor="shard_map").run`` is the entry.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis.collectives import CollectiveOp, collective_schedule
from repro_torch.core import tra
from repro_torch.core.guards import label_nodes
from repro_torch.core.interp import (_merge_ia_inputs, dense_shape,
                                     is_dtensor, mesh_sizes, to_dtensor)
from repro_torch.core.plan import (Bcast, FusedJoinAgg, IAConst, IAInput,
                                   LocalAgg, LocalConcat, LocalFilter,
                                   LocalJoin, LocalMap, LocalPad, LocalTile,
                                   Placement, Shuf, TypeInfo, as_node,
                                   children, infer, postorder)
from repro_torch.core.tra import RelType, TensorRelation

#: collectives issued by the mesh executors, by kind (reset with ``clear()``)
COLLECTIVES: "collections.Counter[str]" = collections.Counter()

_NATIVE = {None: dist.ReduceOp.SUM, "matAdd": dist.ReduceOp.SUM,
           "elemMax": dist.ReduceOp.MAX, "elemMin": dist.ReduceOp.MIN}
# DTensor Partial reduce ops → agg kernel names
_REDUCERS = {"sum": "matAdd", "max": "elemMax", "min": "elemMin",
             "product": "elemMul"}

# torch 2.13 renamed the single-tensor gather / scatter; older releases
# have only the first names
_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


@dataclasses.dataclass(frozen=True)
class Issued:
    """One collective a dispatch issued: the schedule's op, the bytes of
    this rank's input block, the bytes the gspmd walk staged through the
    host for it (both ways), and whether it re-placed an input (a DTensor fed back in
    another placement than the program declares: outside the program's
    schedule, as JAX reshards a ``jax.Array`` to a jitted function's input
    sharding)."""

    op: CollectiveOp
    nbytes: int
    staged_bytes: int
    reshard: bool = False


def _wire(call: str, x: torch.Tensor, group, size: int, op=None
          ) -> torch.Tensor:
    """The collective ``call`` over dim 0 of ``x`` (a fresh result)."""
    x = x.contiguous()
    if call == "all_reduce":
        out = x.clone()
        dist.all_reduce(out, op=op, group=group)
    elif call == "all_gather_into_tensor":
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        _GATHER(out, x, group=group)
    elif call == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
    elif call == "reduce_scatter_tensor":
        out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
        _SCATTER(out, x, op=dist.ReduceOp.SUM, group=group)
    else:
        raise ValueError(call)
    return out


class Exchange:
    """The collective transport of one built program on one rank.

    :meth:`run` is the one place a mesh executor issues a collective; the
    last dispatch's records are in ``log`` (cleared by :meth:`begin`).  On
    a card each collective is bracketed by CUDA events (read by
    :meth:`ms`, which synchronizes); on the CPU by the host clock."""

    def __init__(self, mesh, labels):
        self.mesh = mesh
        self.sizes = mesh_sizes(mesh)
        self.labels = labels
        self.groups = {ax: mesh.get_group(ax) for ax in self.sizes}
        self.log: List[Issued] = []
        self._times: List[object] = []
        self.resharding = False         # set while an input is re-placed

    def begin(self) -> None:
        self.log.clear()
        self._times.clear()

    def index(self, ax: str) -> int:
        return self.mesh.get_local_rank(ax)

    def run(self, kind: str, ax: str, reducer: Optional[str], node,
            x: torch.Tensor, call: str, op=None) -> torch.Tensor:
        """Issue ``call`` over dim 0 of ``x`` on axis ``ax``'s group,
        recorded as the schedule's ``kind`` op (with ``reducer``) of
        ``node``."""
        size, group = self.sizes[ax], self.groups[ax]
        out = self._timed(x, lambda: _wire(call, x, group, size, op))
        self._record(kind, ax, reducer, node, x, 0)
        return out

    def redistribute(self, node, dt, want):
        """The gspmd walk's constraint: ``dt`` redistributed to ``want``
        (:func:`repro_torch.core.interp.redistribute`, staged on gloo over
        CUDA tensors), recording the collectives DTensor's rules issue for
        each mesh dimension whose placement changes: Partial → Replicate
        an all-reduce, Partial → Shard a reduce-scatter, Shard → Replicate
        an all-gather, Shard → Shard an all-to-all; Replicate → Shard is a
        local slice."""
        from repro_torch.core.interp import redistribute
        want = tuple(want)
        if tuple(dt.placements) == want:
            return dt
        local = dt.to_local()
        ops = []
        for ax, src, tgt in zip(self.sizes, dt.placements, want):
            if src == tgt or src.is_replicate():
                continue
            if src.is_partial():
                kind = "all_reduce" if tgt.is_replicate() else "psum_scatter"
                ops.append((kind, ax, _REDUCERS.get(src.reduce_op,
                                                    src.reduce_op)))
            else:
                kind = "all_gather" if tgt.is_replicate() else "all_to_all"
                ops.append((kind, ax, None))
        out, staged = self._timed(local, lambda: redistribute(dt, want))
        for i, (kind, ax, reducer) in enumerate(ops):
            self._record(kind, ax, reducer, node, local,
                         staged if i == 0 else 0)
        return out

    def _timed(self, x, fn):
        if x.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            self._times.append((start, end))
        else:
            t0 = time.perf_counter()
            out = fn()
            self._times.append(time.perf_counter() - t0)
        return out

    def _record(self, kind, ax, reducer, node, x, staged) -> None:
        nid, label = self.labels.get(id(node), (-1, type(node).__name__))
        self.log.append(Issued(CollectiveOp(kind, ax, reducer, nid, label),
                               x.numel() * x.element_size(), staged,
                               self.resharding))
        COLLECTIVES[kind] += 1

    # -- readings of the last dispatch ------------------------------------
    def schedule(self) -> List[CollectiveOp]:
        """The program's collectives (input re-placements left out)."""
        return [i.op for i in self.log if not i.reshard]

    def bytes_by_kind(self) -> Dict[str, int]:
        """This rank's input bytes into each kind of collective, input
        re-placements included."""
        out: Dict[str, int] = collections.Counter()
        for i in self.log:
            out[i.op.kind] += i.nbytes
        return dict(out)

    @property
    def reshard_bytes(self) -> int:
        return sum(i.nbytes for i in self.log if i.reshard)

    @property
    def staged_bytes(self) -> int:
        return sum(i.staged_bytes for i in self.log)

    def ms(self) -> float:
        """Milliseconds spent in the last dispatch's collectives."""
        total = 0.0
        for t in self._times:
            if isinstance(t, float):
                total += t * 1e3
            else:
                t[1].synchronize()
                total += t[0].elapsed_time(t[1])
        return total


# ==========================================================================
# The collectives of the lowering (each through Exchange.run)
# ==========================================================================

def _along(x: torch.Tensor, d: int, fn: Callable) -> torch.Tensor:
    """``fn`` of ``x`` with dim ``d`` moved to the front, moved back."""
    return torch.movedim(fn(torch.movedim(x, d, 0)), 0, d)


def _all_gather(ex: Exchange, node, x, ax: str, d: int) -> torch.Tensor:
    """The tiled all-gather of ``x``'s dim ``d`` over ``ax``."""
    return _along(x, d, lambda y: ex.run("all_gather", ax, None, node, y,
                                         "all_gather_into_tensor"))


def _all_to_all(ex: Exchange, node, x, ax: str, split: int,
                concat: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all(x, ax, split_axis, concat_axis)``: dim
    ``split`` cut into one block per rank, block ``j`` sent to rank ``j``,
    the blocks received laid along dim ``concat`` in rank order."""
    size = ex.sizes[ax]
    shape = list(x.shape)
    recv = ex.run("all_to_all", ax, None, node,
                  torch.movedim(x, split, 0), "all_to_all_single")
    shape[split] //= size
    # (size, block of x with dim split cut) → blocks laid along concat
    blocks = torch.movedim(recv.reshape((size, shape[split])
                                        + tuple(s for i, s in enumerate(shape)
                                                if i != split)),
                           1, split + 1)
    out = torch.movedim(blocks, 0, concat)
    shape[concat] *= size
    return out.reshape(shape)


def _cross_site_reduce(ex: Exchange, node, x, ax: str,
                       kernel_name: Optional[str]) -> torch.Tensor:
    """All-reduce the pending partials along mesh axis ``ax`` with the agg
    kernel's combiner.  ``matAdd``/``elemMax``/``elemMin`` are native
    all-reduces; any other associative kernel gathers the per-site
    partials and folds them locally (semantically exact: aggregation
    kernels are associative by construction)."""
    reducer = kernel_name or "matAdd"
    if kernel_name in _NATIVE:
        return ex.run("all_reduce", ax, reducer, node, x, "all_reduce",
                      _NATIVE[kernel_name])
    from repro_torch.core.kernels_registry import get_kernel
    kern = get_kernel(kernel_name)
    if not kern.is_associative:
        raise NotImplementedError(
            f"shard_map two-phase aggregation for kernel {kernel_name}")
    stacked = ex.run("all_reduce", ax, reducer, node, x[None],
                     "all_gather_into_tensor")
    if kern.reduce is not None:
        return kern.reduce(stacked, (0,))
    return tra._tree_fold(stacked, kern)


def _window(ex: Exchange, x, ax: str, d: int) -> torch.Tensor:
    """This rank's block of ``x``'s dim ``d`` along ``ax`` (a view)."""
    local = x.shape[d] // ex.sizes[ax]
    return x.narrow(d, ex.index(ax) * local, local)


def _resolve_dups(ex: Exchange, node, x, src: Placement,
                  tgt: Optional[Placement]) -> Tuple[torch.Tensor, Placement]:
    """Reduce pending duplicate-key partials (R2-5's second phase).

    Additive reducers scatter straight through a reduce-scatter; other
    associative reducers all-reduce via :func:`_cross_site_reduce` and,
    when the target placement partitions a dim along the dup axis, slice
    their local window afterwards."""
    if not src.dup_axes:
        return x, src
    remaining = list(src.dup_axes)
    scattered = []
    if tgt is not None and tgt.kind == "partitioned":
        for d, ax in zip(tgt.dims, tgt.axes):
            if ax not in remaining:
                continue
            size = ex.sizes[ax]
            if x.shape[d] % size == 0:
                if src.dup_kernel in (None, "matAdd"):
                    x = _along(x, d, lambda y, ax=ax: ex.run(
                        "psum_scatter", ax, src.dup_kernel or "matAdd",
                        node, y, "reduce_scatter_tensor"))
                else:
                    x = _cross_site_reduce(ex, node, x, ax, src.dup_kernel)
                    x = _window(ex, x, ax, d)
                scattered.append((d, ax))
            else:
                # the caller's _move slices
                x = _cross_site_reduce(ex, node, x, ax, src.dup_kernel)
            remaining.remove(ax)
    for ax in remaining:
        x = _cross_site_reduce(ex, node, x, ax, src.dup_kernel)
    dims = list(src.dims) + [d for d, _ in scattered]
    axes = list(src.axes) + [ax for _, ax in scattered]
    return x, Placement.partitioned(dims, axes)


def _move(ex: Exchange, node, x, src: Placement, tgt: Placement
          ) -> torch.Tensor:
    """Repartition local block ``x`` from ``src`` to ``tgt`` placement."""
    x, src = _resolve_dups(ex, node, x, src, tgt)
    src_map = {ax: d for d, ax in zip(src.dims, src.axes)}
    tgt_map = {} if tgt.kind == "replicated" \
        else {ax: d for d, ax in zip(tgt.dims, tgt.axes)}
    for ax in sorted(set(src_map) | set(tgt_map)):
        od, nd = src_map.get(ax), tgt_map.get(ax)
        if od == nd:
            continue
        if od is None:                         # replicated → sharded: slice
            x = _window(ex, x, ax, nd)
        elif nd is None:                       # sharded → replicated: gather
            x = _all_gather(ex, node, x, ax, od)
        else:                                  # dim change: all_to_all
            x = _all_to_all(ex, node, x, ax, nd, od)
    return x


# ==========================================================================
# The local program (shared with the gspmd walk)
# ==========================================================================

def _local_rtype(info: TypeInfo, sizes: Dict[str, int]) -> RelType:
    ks = list(info.rtype.key_shape)
    p = info.placement
    if p is not None and p.kind == "partitioned":
        for d, ax in zip(p.dims, p.axes):
            size = sizes[ax]
            if ks[d] % size:
                raise ValueError(
                    f"frontier dim {d} ({ks[d]}) not divisible by axis "
                    f"{ax} ({size})")
            ks[d] //= size
    return RelType(tuple(ks), info.rtype.bound, info.rtype.dtype)


def _rel(x: torch.Tensor, info: TypeInfo) -> TensorRelation:
    """A local block as a relation: its own key window, the node's bound."""
    k = info.rtype.key_arity
    return TensorRelation(x, RelType(tuple(x.shape[:k]), info.rtype.bound,
                                     info.rtype.dtype))


def join_windows(node, lt: TypeInfo, rt: TypeInfo):
    """``(side, dim, axis)`` for every joined dim pair where exactly one
    side is sharded: ``side`` (0 left, 1 right) is the full side, whose
    dim ``dim`` must be cut to the sharded side's window along ``axis``."""
    out = []
    lp, rp = lt.placement, rt.placement
    for dl, dr in zip(node.join_keys_l, node.join_keys_r):
        la = None if lp is None or lp.kind != "partitioned" \
            else lp.axis_of_dim(dl)
        ra = None if rp is None or rp.kind != "partitioned" \
            else rp.axis_of_dim(dr)
        if la is not None and ra is None:
            out.append((1, dr, la))
        elif ra is not None and la is None:
            out.append((0, dl, ra))
    return out


def local_value(node, kids, cache: Dict[int, TypeInfo], sizes, *, device,
                chunk=None, budget=None, ctx=None) -> torch.Tensor:
    """One non-exchange node's local block from its children's local
    blocks (a join's already cut to matching key windows)."""
    info = cache[id(node)]
    if isinstance(node, IAConst):
        lt = _local_rtype(info, sizes)
        return torch.full(tuple(lt.key_shape) + tuple(lt.bound), node.fill,
                          dtype=lt.dtype, device=device)
    cts = [cache[id(c)] for c in children(node)]
    if isinstance(node, LocalPad):
        if tuple(node.key_shape) == cts[0].rtype.key_shape:
            return kids[0]          # masks are rejected → identity
        # frontier growth: placement rules force a replicated child, so
        # the local block IS the global relation
        return tra.pad(_rel(kids[0], cts[0]), node.key_shape).data
    if isinstance(node, LocalJoin):
        return tra.join(_rel(kids[0], cts[0]), _rel(kids[1], cts[1]),
                        node.join_keys_l, node.join_keys_r,
                        node.kernel).data
    if isinstance(node, FusedJoinAgg):
        # Σᴸ∘⋈ᴸ over the local key windows; the partial (R2-5) phase's
        # pending duplicates resolve at the next Shuf/Bcast
        return tra.fused_join_agg(
            _rel(kids[0], cts[0]), _rel(kids[1], cts[1]), node.join_keys_l,
            node.join_keys_r, node.join_kernel, node.group_by,
            node.agg_kernel, chunk=chunk, budget=budget, ctx=ctx,
            node=node).data
    if isinstance(node, LocalAgg):
        return tra.agg(_rel(kids[0], cts[0]), node.group_by,
                       node.kernel).data
    if isinstance(node, LocalMap):
        ct = cts[0]
        perm = None
        if node.key_func is not None and not ct.placement.is_replicated:
            from repro_torch.core.plan import _detect_key_permutation
            perm = _detect_key_permutation(node.key_func,
                                           ct.rtype.key_shape)
            if perm is None:
                raise NotImplementedError(
                    "non-permutation key rewrite on partitioned data in "
                    "shard_map mode")
        crel = _rel(kids[0], ct)
        if node.kernel.name != "idOp":
            crel = tra.transform(crel, node.kernel)
        if node.key_func is None:
            return crel.data
        if perm is not None:
            # pure key-axis permutation: local transpose
            k = ct.rtype.key_arity
            return torch.permute(crel.data,
                                 list(perm) + list(range(k, crel.data.ndim)))
        return tra.rekey(crel, node.key_func).data
    if isinstance(node, LocalTile):
        return tra.tile(_rel(kids[0], cts[0]), node.tile_dim,
                        node.tile_size).data
    if isinstance(node, LocalConcat):
        return tra.concat(_rel(kids[0], cts[0]), node.key_dim,
                          node.array_dim).data
    if isinstance(node, LocalFilter):
        raise NotImplementedError("filter in shard_map mode")
    raise TypeError(type(node))


def check_subset(roots, cache: Dict[int, TypeInfo], sizes) -> None:
    """Refuse what the mesh executors do not run, before any rank moves:
    masks, and inputs, constants or outputs whose partitioned key dims
    the mesh axes do not divide."""
    for r in roots:
        for n in postorder(r):
            info = cache[id(n)]
            if info.mask is not None:
                raise NotImplementedError(
                    "shard_map mode requires continuous relations")
            if isinstance(n, (IAInput, IAConst)):
                _local_rtype(info, sizes)
        _local_rtype(cache[id(r)], sizes)


def _build_shardmap(roots, mesh, chunk=None, budget: Optional[int] = None,
                    ctx=None, *, device):
    """Build the explicit-collective program ONCE for a tuple of physical
    roots.

    Returns ``(call, names, out_infos, exchange)``: ``call(env) -> tuple``
    of global :class:`TensorRelation` results (DTensor data).  Building at
    *compile* time lets the engine's compile cache reuse it: repeat
    executions of one plan signature are pure dispatch.  ``ctx`` threads
    the engine's fault injector into the local walk (node faults fire as
    each node is dispatched); per-node numerics stay off inside the
    collective program, the engine checks the outputs instead.
    """
    from repro_torch.core.engine import schedule_steps
    roots = tuple(as_node(r) for r in roots)
    cache: Dict[int, TypeInfo] = {}
    out_infos = tuple(infer(r, cache=cache) for r in roots)
    by_name = _merge_ia_inputs(roots)
    names = sorted(by_name)
    sizes = mesh_sizes(mesh)
    check_subset(roots, cache, sizes)
    steps, drops, out_slots = schedule_steps(roots, fuse=False)
    ex = Exchange(mesh, label_nodes(roots))
    faults = ctx is not None and ctx.faults is not None

    def call(env: Dict[str, TensorRelation]):
        ex.begin()
        vals: List[Optional[torch.Tensor]] = []
        for (node, kids, _), drop in zip(steps, drops):
            info = cache[id(node)]
            if isinstance(node, IAInput):
                out = input_block(env[node.name].data, node.placement,
                                  node.rtype, mesh, ex, node)
            elif isinstance(node, (Bcast, Shuf)):
                src = cache[id(node.child)].placement
                out = _move(ex, node, vals[kids[0]], src, info.placement)
            else:
                xs = [vals[k] for k in kids]
                if isinstance(node, (LocalJoin, FusedJoinAgg)):
                    lt, rt = (cache[id(c)] for c in children(node))
                    for side, d, ax in join_windows(node, lt, rt):
                        xs[side] = _window(ex, xs[side], ax, d)
                out = local_value(node, xs, cache, sizes, device=device,
                                  chunk=chunk, budget=budget, ctx=ctx)
            if faults:
                out = ctx.on_array(node, out)
            vals.append(out)
            for k in drop:
                vals[k] = None
        outs = []
        for root, oi, s in zip(roots, out_infos, out_slots):
            res, p = vals[s], oi.placement
            # resolve any trailing duplicate state so the output is clean
            if p is not None and p.dup_axes:
                res, p = _resolve_dups(ex, root, res, p, None)
            outs.append(TensorRelation(to_dtensor(res, p, oi.rtype, mesh),
                                       oi.rtype))
        return tuple(outs)

    return call, names, out_infos, ex


def placement_of(dt) -> Placement:
    """The IA placement a DTensor's placements describe on its mesh."""
    dims, axes, dups, reducer = [], [], [], None
    for ax, p in zip(dt.device_mesh.mesh_dim_names, dt.placements):
        if p.is_shard():
            dims.append(p.dim)
            axes.append(ax)
        elif p.is_partial():
            dups.append(ax)
            reducer = _REDUCERS.get(p.reduce_op, p.reduce_op)
    if not dims and not dups:
        return Placement.replicated()
    return Placement.partitioned(dims, axes, dups, reducer)


def input_block(data, placement: Placement, rtype, mesh, ex=None,
                node=None) -> torch.Tensor:
    """This rank's block of an input under ``placement``: a window (view)
    of a global tensor, or a DTensor's local shard — moved by ``ex`` (the
    explicit collectives, recorded as a re-placement) when it holds
    another placement on this mesh; a DTensor of another mesh is read
    whole first."""
    if is_dtensor(data):
        if data.device_mesh == mesh:
            src = placement_of(data)
            if src == placement:
                return data.to_local()
            ex.resharding = True
            try:
                return _move(ex, node, data.to_local(), src, placement)
            finally:
                ex.resharding = False
        data = tra.global_data(data)
    if tuple(data.shape) != dense_shape(rtype):
        raise ValueError(f"input of shape {tuple(data.shape)}, expected "
                         f"{dense_shape(rtype)}")
    sizes = mesh_sizes(mesh)
    if placement.kind == "partitioned":
        for d, ax in zip(placement.dims, placement.axes):
            local = data.shape[d] // sizes[ax]
            data = data.narrow(d, mesh.get_local_rank(ax) * local, local)
    return data


def expected_schedule(roots, axis_sizes: Dict[str, int]
                      ) -> List[CollectiveOp]:
    """The collectives one dispatch of ``roots`` issues, in order, as the
    static lowering (:func:`collective_schedule`) derives them: each
    exchange node's ops in the order the executor's steps run them
    (structurally identical nodes once), then each root's trailing
    duplicate resolution in root order.  For a single-root plan without
    repeated exchanges it is ``collective_schedule(root, axis_sizes)``."""
    from repro_torch.core.engine import schedule_steps
    roots = tuple(as_node(r) for r in roots)
    labels = label_nodes(roots)
    by_node: Dict[int, List[CollectiveOp]] = collections.defaultdict(list)
    trailing: List[List[CollectiveOp]] = []
    for r in roots:
        ops = collective_schedule(r, axis_sizes, labels=labels)
        p = infer(r).placement
        n_tail = len(p.dup_axes) if p is not None else 0
        body = ops[:len(ops) - n_tail]
        trailing.append(ops[len(ops) - n_tail:])
        for op in body:
            by_node[op.node_id].append(op)
    steps, _, _ = schedule_steps(roots, fuse=False)
    out: List[CollectiveOp] = []
    for node, _, _ in steps:
        if isinstance(node, (Bcast, Shuf)):
            out.extend(by_node.get(labels[id(node)][0], ()))
    for ops in trailing:
        out.extend(ops)
    return out
