"""Cost-based IA plan optimization (paper §4.2–4.3).

Port of ``repro.core.optimize``, unchanged: plain Python over the plan IR,
so plan choice (the comm metric plus the ``tmp_floats`` tiebreak, strict
``<``, first entry wins a tie) matches the JAX package plan for plan.

Two stages, mirroring the paper's two rule classes:

1. **Logical rewrites** (kernel-composition rules R1-*): filter merge &
   pushdown, transform fusion, transform∘join composition (R1-7),
   distributive transform past aggregation (R1-4).  These produce a small
   set of logical variants.

2. **Placement DP** (repartition rules R2-*): bottom-up dynamic programming
   over *interesting placements* (replicated; every single-dim partition;
   2-D partitions when the mesh offers two axes).  Join entries enumerate
   the R2-6 family — broadcast-left/right (BMM), co-partitioned shuffle
   (CPMM) and two-axis replication (RMM, the paper's §4.2.2 domain-specific
   rule, admitted by the per-axis local-join validity rule).  Aggregations
   enumerate direct (R2-4), shuffle-then-aggregate (Table 1) and two-phase
   partial aggregation (R2-5 — lowering to reduce-scatter / all-reduce).

Costs are the paper's exact float-movement metric via
:func:`repro_torch.core.cost.comm_cost` — no estimation anywhere.

Beyond the paper, aggregation entries whose child is a join also enumerate
the fused Σ∘⋈ node (:class:`repro_torch.core.plan.FusedJoinAgg`, direct and
two-phase).  Fusion never changes the float-movement metric, so selection
uses the cost model's ``tmp_floats`` (intermediate materialization) as a
tiebreak — fused plans win at equal comm cost.  :func:`fuse_join_agg`
applies the same collapse as a rewrite over existing physical plans.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import kernels_registry as kr
from repro_torch.core.cost import cost_plan
from repro_torch.core.plan import (Bcast, FusedJoinAgg, IAConst, IAInput,
                                   IANode, LocalAgg, LocalConcat, LocalFilter,
                                   LocalJoin, LocalMap, LocalPad, LocalTile,
                                   Placement, Shuf, TraAgg, TraConcat,
                                   TraConst, TraFilter, TraInput, TraJoin,
                                   TraNode, TraPad, TraReKey, TraTile,
                                   TraTransform, TypeInfo, check_valid,
                                   children, infer)
from repro_torch.core.tra import can_fuse

PlacementSig = Tuple


def placement_sig(p: Optional[Placement]) -> PlacementSig:
    if p is None:
        return ("unknown",)
    return (p.kind, tuple(sorted(zip(p.dims, p.axes))), tuple(p.dup_axes))


# ==========================================================================
# Stage 1 — logical rewrites (R1 family)
# ==========================================================================

def logical_variants(node: TraNode, limit: int = 24) -> List[TraNode]:
    """Enumerate rewritten logical trees (original included, deduped)."""
    variants = [node]
    seen = {_tree_sig(node)}
    frontier = [node]
    while frontier and len(variants) < limit:
        cur = frontier.pop()
        for nxt in _rewrite_once(cur):
            sig = _tree_sig(nxt)
            if sig not in seen:
                seen.add(sig)
                variants.append(nxt)
                frontier.append(nxt)
    return variants


def _tree_sig(node: TraNode) -> Tuple:
    if isinstance(node, TraInput):
        return ("in", node.name)
    if isinstance(node, TraConst):
        return ("const", node.rtype.key_shape, node.rtype.bound, node.fill)
    if isinstance(node, TraPad):
        return ("pad", node.key_shape, _tree_sig(node.child))
    if isinstance(node, TraJoin):
        return ("join", node.join_keys_l, node.join_keys_r, node.kernel.name,
                _tree_sig(node.left), _tree_sig(node.right))
    if isinstance(node, TraAgg):
        return ("agg", node.group_by, node.kernel.name, _tree_sig(node.child))
    if isinstance(node, TraTransform):
        return ("map", node.kernel.name, _tree_sig(node.child))
    if isinstance(node, TraFilter):
        return ("filter", node.tag, _tree_sig(node.child))
    if isinstance(node, TraReKey):
        return ("rekey", node.tag, _tree_sig(node.child))
    if isinstance(node, TraTile):
        return ("tile", node.tile_dim, node.tile_size, _tree_sig(node.child))
    if isinstance(node, TraConcat):
        return ("concat", node.key_dim, node.array_dim, _tree_sig(node.child))
    raise TypeError(type(node))


def _rebuild(node: TraNode, new_children: Sequence[TraNode]) -> TraNode:
    if isinstance(node, TraJoin):
        return TraJoin(new_children[0], new_children[1], node.join_keys_l,
                       node.join_keys_r, node.kernel)
    if isinstance(node, TraAgg):
        return TraAgg(new_children[0], node.group_by, node.kernel)
    if isinstance(node, TraTransform):
        return TraTransform(new_children[0], node.kernel)
    if isinstance(node, TraFilter):
        return TraFilter(new_children[0], node.bool_func, node.tag)
    if isinstance(node, TraReKey):
        return TraReKey(new_children[0], node.key_func, node.tag)
    if isinstance(node, TraTile):
        return TraTile(new_children[0], node.tile_dim, node.tile_size)
    if isinstance(node, TraConcat):
        return TraConcat(new_children[0], node.key_dim, node.array_dim)
    if isinstance(node, TraPad):
        return TraPad(new_children[0], node.key_shape)
    return node


def _rewrite_once(node: TraNode) -> List[TraNode]:
    """All trees reachable by one rule application anywhere in ``node``."""
    out: List[TraNode] = []

    # rules at the root
    if isinstance(node, TraTransform):
        c = node.child
        # R1-2: fuse stacked transforms
        if isinstance(c, TraTransform):
            out.append(TraTransform(c.child,
                                    kr.compose(node.kernel, c.kernel)))
        # R1-7: compose transform into the join's projection kernel
        if isinstance(c, TraJoin):
            out.append(TraJoin(c.left, c.right, c.join_keys_l, c.join_keys_r,
                               kr.compose(node.kernel, c.kernel)))
        # R1-4: distributive transform commutes past aggregation
        if isinstance(c, TraAgg) and \
                c.kernel.name in node.kernel.distributes_over:
            out.append(TraAgg(TraTransform(c.child, node.kernel),
                              c.group_by, c.kernel))
    if isinstance(node, TraAgg):
        c = node.child
        # R1-4 reverse direction: pull a distributive transform back out
        if isinstance(c, TraTransform) and \
                node.kernel.name in c.kernel.distributes_over:
            out.append(TraTransform(TraAgg(c.child, node.group_by,
                                           node.kernel), c.kernel))
    if isinstance(node, TraFilter):
        c = node.child
        # R1-1: merge stacked filters
        if isinstance(c, TraFilter):
            f1, f2 = node.bool_func, c.bool_func
            out.append(TraFilter(c.child, lambda k: f1(k) and f2(k),
                                 tag=f"{node.tag}∧{c.tag}"))
        # R1-6: push a join-key-only filter into both join inputs
        if isinstance(c, TraJoin):
            pushed = _push_filter_through_join(node, c)
            if pushed is not None:
                out.append(pushed)

    # recurse into children
    if isinstance(node, TraJoin):
        for lv in _rewrite_once(node.left):
            out.append(_rebuild(node, (lv, node.right)))
        for rv in _rewrite_once(node.right):
            out.append(_rebuild(node, (node.left, rv)))
    elif not isinstance(node, (TraInput, TraConst)):
        for cv in _rewrite_once(node.child):
            out.append(_rebuild(node, (cv,)))
    return out


def _push_filter_through_join(f: TraFilter, j: TraJoin) -> Optional[TraNode]:
    """R1-6 — valid when the predicate only reads *joined* output dims.

    Joined output dims are exactly the ``join_keys_l`` positions (left and
    right agree there), so the predicate can be evaluated on either input.
    We verify the read-set empirically over the key grid: the predicate must
    be constant in every non-joined dim.
    """
    info = infer(j)
    import numpy as np
    k = info.rtype.key_arity
    jset = set(j.join_keys_l)
    grid = np.indices(info.rtype.key_shape).reshape(k, -1).T
    vals = np.asarray([bool(f.bool_func(tuple(int(x) for x in kk)))
                       for kk in grid]).reshape(info.rtype.key_shape)
    # constant along all non-join dims?
    for d in range(k):
        if d in jset:
            continue
        if not np.all(vals == np.take(vals, [0], axis=d)):
            return None

    def mk_pred(dim_map: Dict[int, int]) -> Callable:
        def pred(key: Tuple[int, ...]) -> bool:
            probe = [0] * k
            for out_d, in_d in dim_map.items():
                probe[out_d] = key[in_d]
            return bool(f.bool_func(tuple(probe)))
        return pred

    lmap = {jl: jl for jl in j.join_keys_l}           # out dim -> left dim
    rmap = {jl: jr for jl, jr in zip(j.join_keys_l, j.join_keys_r)}
    fl = TraFilter(j.left, mk_pred(lmap), tag=f"{f.tag}↓L")
    fr = TraFilter(j.right, mk_pred(rmap), tag=f"{f.tag}↓R")
    return TraJoin(fl, fr, j.join_keys_l, j.join_keys_r, j.kernel)


# ==========================================================================
# Stage 2 — placement DP (R2 family + domain-specific join placements)
# ==========================================================================

@dataclasses.dataclass
class PlanEntry:
    cost: int
    plan: IANode
    placement: Optional[Placement]
    # intermediate-materialization floats: a *tiebreak* under equal comm
    # cost, so fused Σ∘⋈ plans beat grid-materializing ones without ever
    # perturbing the paper's float-movement metric.
    tmp: int = 0


def interesting_placements(key_arity: int,
                           site_axes: Tuple[str, ...]) -> List[Placement]:
    out = [Placement.replicated()]
    for d in range(key_arity):
        for ax in site_axes:
            out.append(Placement.partitioned((d,), (ax,)))
    if len(site_axes) >= 2:
        for d0, d1 in itertools.permutations(range(key_arity), 2):
            out.append(Placement.partitioned((d0, d1), site_axes[:2]))
    return out


class Optimizer:
    def __init__(self, site_axes: Tuple[str, ...],
                 axis_sizes: Dict[str, int], accounting: str = "wire"):
        self.site_axes = tuple(site_axes)
        self.axis_sizes = dict(axis_sizes)
        self.accounting = accounting

    # -- helpers ----------------------------------------------------------
    def _entry(self, plan: IANode) -> Optional[PlanEntry]:
        from repro_torch.core.plan import postorder as _post
        try:
            cache: Dict[int, TypeInfo] = {}
            info = infer(plan, cache=cache)
            for n in _post(plan):
                ti = cache[id(n)]
                # every local op must satisfy its placement preconditions
                # NOW — a later SHUF cannot repair locally-wrong results
                if isinstance(n, (LocalJoin, LocalAgg, LocalConcat,
                                  FusedJoinAgg, LocalPad)) \
                        and ti.placement is None:
                    return None
                # partitioned frontier dims must divide their axis sizes
                # (keeps both executors well-formed; GSPMD could pad, the
                # explicit shard_map mode cannot)
                p = ti.placement
                if p is not None and p.kind == "partitioned":
                    for d, ax in zip(p.dims, p.axes):
                        if ti.rtype.key_shape[d] % self.axis_sizes[ax]:
                            return None
        except (ValueError, TypeError):
            return None
        rep = cost_plan(plan, self.axis_sizes, self.accounting)
        return PlanEntry(rep.comm_floats, plan, info.placement,
                         rep.tmp_floats)

    def _add(self, table: Dict[PlacementSig, PlanEntry],
             entry: Optional[PlanEntry]) -> None:
        if entry is None:
            return
        sig = placement_sig(entry.placement)
        cur = table.get(sig)
        if cur is None or (entry.cost, entry.tmp) < (cur.cost, cur.tmp):
            table[sig] = entry

    def _closure(self, table: Dict[PlacementSig, PlanEntry],
                 key_arity: int) -> None:
        """Extend a table with BCAST/SHUF-moved versions of each entry."""
        base = list(table.values())
        for e in base:
            self._add(table, self._entry(Bcast(e.plan)))
            for p in interesting_placements(key_arity, self.site_axes):
                if p.is_replicated:
                    continue
                self._add(table,
                          self._entry(Shuf(e.plan, p.dims, p.axes)))

    # -- DP ----------------------------------------------------------------
    def tables(self, node: TraNode,
               input_placements: Dict[str, Placement],
               memo: Dict[int, Dict[PlacementSig, PlanEntry]]
               ) -> Dict[PlacementSig, PlanEntry]:
        if id(node) in memo:
            return memo[id(node)]
        table: Dict[PlacementSig, PlanEntry] = {}
        info = infer(node)

        if isinstance(node, TraInput):
            p = input_placements.get(node.name, Placement.replicated())
            self._add(table, self._entry(IAInput(node.name, node.rtype, p)))

        elif isinstance(node, TraConst):
            # a constant materializes locally at ANY placement for free —
            # seed the table with every interesting placement directly
            for p in interesting_placements(node.rtype.key_arity,
                                            self.site_axes):
                self._add(table, self._entry(
                    IAConst(node.rtype, node.fill, p)))

        elif isinstance(node, TraPad):
            ct = self.tables(node.child, input_placements, memo)
            for ce in ct.values():
                self._add(table, self._entry(
                    LocalPad(ce.plan, tuple(node.key_shape))))
                # frontier growth needs a replicated child
                self._add(table, self._entry(
                    LocalPad(Bcast(ce.plan), tuple(node.key_shape))))

        elif isinstance(node, TraJoin):
            lt = self.tables(node.left, input_placements, memo)
            rt_ = self.tables(node.right, input_placements, memo)
            for le in lt.values():
                for re_ in rt_.values():
                    self._add(table, self._entry(
                        LocalJoin(le.plan, re_.plan, node.join_keys_l,
                                  node.join_keys_r, node.kernel)))

        elif isinstance(node, TraAgg):
            ct = self.tables(node.child, input_placements, memo)
            for ce in ct.values():
                # R2-4: aggregate in place when already valid
                self._add(table, self._entry(
                    LocalAgg(ce.plan, node.group_by, node.kernel)))
                # Table 1 default: shuffle on group-by dims then aggregate
                dims = tuple(node.group_by)[:len(self.site_axes)]
                axes = self.site_axes[:len(dims)]
                self._add(table, self._entry(LocalAgg(
                    Shuf(ce.plan, dims, axes), node.group_by, node.kernel)))
                # R2-5: two-phase — partial agg, then reduce-scatter (SHUF)
                # or all-reduce (BCAST)
                if node.kernel.is_associative:
                    partial = LocalAgg(ce.plan, node.group_by, node.kernel,
                                       partial=True)
                    out_arity = len(node.group_by)
                    for p in interesting_placements(out_arity,
                                                    self.site_axes):
                        if p.is_replicated:
                            self._add(table, self._entry(Bcast(partial)))
                        else:
                            self._add(table, self._entry(
                                Shuf(partial, p.dims, p.axes)))
            # Σ∘⋈ contraction: when the agg consumes a join directly, also
            # enumerate the fused node over the join operands' tables —
            # same comm cost as the LocalAgg∘LocalJoin pair but no
            # materialized grid, so the tmp tiebreak selects it.
            if isinstance(node.child, TraJoin) \
                    and can_fuse(node.child.kernel, node.kernel):
                j = node.child
                lt = self.tables(j.left, input_placements, memo)
                rt_ = self.tables(j.right, input_placements, memo)
                out_arity = len(node.group_by)
                for le in lt.values():
                    for re_ in rt_.values():
                        self._add(table, self._entry(FusedJoinAgg(
                            le.plan, re_.plan, j.join_keys_l, j.join_keys_r,
                            j.kernel, node.group_by, node.kernel)))
                        partial = FusedJoinAgg(
                            le.plan, re_.plan, j.join_keys_l, j.join_keys_r,
                            j.kernel, node.group_by, node.kernel,
                            partial=True)
                        for p in interesting_placements(out_arity,
                                                        self.site_axes):
                            if p.is_replicated:
                                self._add(table,
                                          self._entry(Bcast(partial)))
                            else:
                                self._add(table, self._entry(
                                    Shuf(partial, p.dims, p.axes)))

        elif isinstance(node, TraTransform):
            ct = self.tables(node.child, input_placements, memo)
            for ce in ct.values():
                self._add(table, self._entry(
                    LocalMap(ce.plan, None, node.kernel)))

        elif isinstance(node, TraFilter):
            ct = self.tables(node.child, input_placements, memo)
            for ce in ct.values():
                self._add(table, self._entry(
                    LocalFilter(ce.plan, node.bool_func, tag=node.tag)))

        elif isinstance(node, TraReKey):
            ct = self.tables(node.child, input_placements, memo)
            for ce in ct.values():
                self._add(table, self._entry(
                    LocalMap(ce.plan, node.key_func, kr.get_kernel("idOp"),
                             tag=node.tag)))

        elif isinstance(node, TraTile):
            ct = self.tables(node.child, input_placements, memo)
            for ce in ct.values():
                self._add(table, self._entry(
                    LocalTile(ce.plan, node.tile_dim, node.tile_size)))

        elif isinstance(node, TraConcat):
            ct = self.tables(node.child, input_placements, memo)
            cinfo = infer(node.child)
            complement = tuple(d for d in range(cinfo.rtype.key_arity)
                               if d != node.key_dim)
            for ce in ct.values():
                self._add(table, self._entry(
                    LocalConcat(ce.plan, node.key_dim, node.array_dim)))
                dims = complement[:len(self.site_axes)]
                axes = self.site_axes[:len(dims)]
                self._add(table, self._entry(LocalConcat(
                    Shuf(ce.plan, dims, axes), node.key_dim,
                    node.array_dim)))
        else:
            raise TypeError(type(node))

        self._closure(table, info.rtype.key_arity)
        memo[id(node)] = table
        return table


@dataclasses.dataclass
class OptimizeResult:
    plan: IANode
    cost: int
    placement: Placement
    candidates: List[Tuple[str, int]]          # (description, cost) log
    logical_variants_tried: int


def optimize(root: TraNode,
             input_placements: Optional[Dict[str, Placement]] = None,
             site_axes: Tuple[str, ...] = ("sites",),
             axis_sizes: Optional[Dict[str, int]] = None,
             target: Optional[Placement] = None,
             try_logical_rewrites: bool = True,
             accounting: str = "wire") -> OptimizeResult:
    """Full optimization: logical variants × placement DP; min comm cost."""
    from repro_torch.core.plan import as_node
    root = as_node(root)
    input_placements = input_placements or {}
    axis_sizes = axis_sizes or {a: 1 for a in site_axes}
    variants = logical_variants(root) if try_logical_rewrites else [root]

    best: Optional[PlanEntry] = None
    log: List[Tuple[str, int]] = []
    for var in variants:
        opt = Optimizer(site_axes, axis_sizes, accounting)
        table = opt.tables(var, input_placements, {})
        for sig, entry in table.items():
            if entry.placement is None or entry.placement.has_duplicates:
                continue
            if target is not None and placement_sig(entry.placement) \
                    != placement_sig(target):
                continue
            log.append((f"{sig}", entry.cost))
            if best is None or (entry.cost, entry.tmp) < (best.cost,
                                                          best.tmp):
                best = entry
    if best is None:
        raise ValueError("no valid physical plan found")
    check_valid(best.plan)
    log.sort(key=lambda x: x[1])
    return OptimizeResult(best.plan, best.cost, best.placement, log,
                          len(variants))


# ==========================================================================
# Physical-plan fusion rewrite (for hand-built / Table-1 default plans)
# ==========================================================================

def _rebuild_ia(node: IANode, kids: Sequence[IANode]) -> IANode:
    if isinstance(node, (IAInput, IAConst)):
        return node
    if isinstance(node, LocalPad):
        return LocalPad(kids[0], node.key_shape)
    if isinstance(node, LocalJoin):
        return LocalJoin(kids[0], kids[1], node.join_keys_l,
                         node.join_keys_r, node.kernel)
    if isinstance(node, FusedJoinAgg):
        return FusedJoinAgg(kids[0], kids[1], node.join_keys_l,
                            node.join_keys_r, node.join_kernel,
                            node.group_by, node.agg_kernel, node.partial)
    if isinstance(node, Bcast):
        return Bcast(kids[0])
    if isinstance(node, Shuf):
        return Shuf(kids[0], node.part_dims, node.axes)
    if isinstance(node, LocalAgg):
        return LocalAgg(kids[0], node.group_by, node.kernel, node.partial)
    if isinstance(node, LocalFilter):
        return LocalFilter(kids[0], node.bool_func, node.tag)
    if isinstance(node, LocalMap):
        return LocalMap(kids[0], node.key_func, node.kernel, node.tag)
    if isinstance(node, LocalTile):
        return LocalTile(kids[0], node.tile_dim, node.tile_size)
    if isinstance(node, LocalConcat):
        return LocalConcat(kids[0], node.key_dim, node.array_dim)
    raise TypeError(type(node))


def _valid_same_placement(cand: IANode, original: IANode) -> bool:
    """cand typechecks, every local op has a placement, and the subtree's
    final placement signature matches the original's (so parents above the
    rewrite site stay valid).

    Deliberately NOT plan.check_valid: that also rejects roots whose
    placement still carries pending duplicates, but a dup-carrying
    *subtree* (a partial FusedJoinAgg awaiting its Shuf/Bcast) is legal
    mid-plan — the signature comparison against the original covers it.
    """
    from repro_torch.core.plan import postorder as _post
    try:
        cache: Dict[int, TypeInfo] = {}
        info = infer(cand, cache=cache)
        for n in _post(cand):
            if isinstance(n, (LocalJoin, LocalAgg, LocalConcat,
                              FusedJoinAgg, LocalPad)) \
                    and cache[id(n)].placement is None:
                return False
        orig = infer(original)
    except (ValueError, TypeError):
        return False
    return placement_sig(info.placement) == placement_sig(orig.placement)


def fuse_join_agg(root: IANode) -> IANode:
    """Collapse ``LocalAgg(Shuf?(LocalJoin(L, R)))`` into the fused Σ∘⋈
    node wherever the agg kernel is an associative reducer of the join
    kernel's output.

    With an interposed ``Shuf`` the rewrite produces the *two-phase* form
    ``Shuf(FusedJoinAgg(..., partial=True))`` — the shuffle of the small
    aggregated output (a reduce-scatter of the pending partials) replaces
    the shuffle of the whole join grid.  Candidates are only accepted when
    they typecheck and land on the same output placement as the original
    subtree, so the rewrite is always plan-validity-preserving.
    """
    cache: Dict[int, IANode] = {}

    def rec(n: IANode) -> IANode:
        if id(n) in cache:
            return cache[id(n)]
        kids = [rec(c) for c in children(n)]
        out = _rebuild_ia(n, kids)
        if isinstance(out, LocalAgg):
            c = out.child
            if isinstance(c, LocalJoin) and can_fuse(c.kernel, out.kernel):
                cand = FusedJoinAgg(c.left, c.right, c.join_keys_l,
                                    c.join_keys_r, c.kernel, out.group_by,
                                    out.kernel, partial=out.partial)
                if _valid_same_placement(cand, out):
                    out = cand
            elif (isinstance(c, Shuf) and isinstance(c.child, LocalJoin)
                    and not out.partial
                    and can_fuse(c.child.kernel, out.kernel)
                    and set(c.part_dims) <= set(out.group_by)):
                j = c.child
                odims = tuple(out.group_by.index(d) for d in c.part_dims)
                # partial=True leaves pending duplicates resolved by the
                # next Shuf/Bcast: psum/psum_scatter for matAdd, the
                # pmax/pmin/gather-fold psum-equivalents for every other
                # associative reducer (shardmap_exec._cross_site_reduce)
                for partial in (True, False):
                    fused = FusedJoinAgg(
                        j.left, j.right, j.join_keys_l, j.join_keys_r,
                        j.kernel, out.group_by, out.kernel, partial=partial)
                    cand = Shuf(fused, odims, c.axes)
                    if _valid_same_placement(cand, out):
                        out = cand
                        break
        cache[id(n)] = out
        return out

    return rec(root)
