"""Placement / exchange soundness pass (port of
``repro.analysis.placement``, unchanged).

Re-derives every physical node's placement bottom-up (the same
:func:`repro_torch.core.plan.infer` rules the runtime checker uses) and turns
each violated precondition into a *diagnosis*: instead of
``check_valid``'s blanket "placement preconditions unsatisfied", the pass
names the offending node, states which operand placements are
incompatible, and says which exchange (``Shuf``/``Bcast``) — or which
duplicate-resolution obligation the shard_map ``_resolve_dups`` path
assumes — is missing.

Checks, per physical root:

* local joins / fused contractions whose operand placements cannot
  combine (mismatched shardings on one mesh axis, or an operand still
  carrying R2-5 partial duplicates);
* full aggregations that reduce away partitioned dims (rule R2-4 —
  needs the two-phase ``partial=True`` + exchange form);
* concats across a partitioned key dim and frontier-growing pads of
  partitioned children;
* roots whose placement still carries ``dup_axes``: on every executor
  but shard_map (which auto-resolves trailing duplicates at the output)
  the partial values would be returned as if final;
* mesh-axis references that don't exist in the engine's axis table, and
  — on shard_map, whose lowering hard-requires it — frontier dims not
  divisible by their mesh axis.

Logical (``TraNode``) roots carry no placements and are skipped.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.plan import (FusedJoinAgg, IANode, LocalAgg, LocalConcat,
                             LocalJoin, LocalPad, Placement, TypeInfo,
                             _join_types, _local_join_placement, postorder)

PASS = "placement"


def _sharding_table(p: Placement) -> dict:
    if p.is_replicated:
        return {}
    return {ax: d for d, ax in zip(p.dims, p.axes)}


def _join_failure(node, lt: TypeInfo, rt: TypeInfo
                  ) -> Tuple[str, str]:
    """(message, hint) for a join whose placement derivation failed."""
    lp, rp = lt.placement, rt.placement
    if lp is None or rp is None:
        side = "left" if lp is None else "right"
        return (f"the {side} operand's placement could not be derived "
                f"(its own subtree is invalid)",
                "fix the operand subtree first — its diagnostic precedes "
                "this one in postorder")
    for side, p in (("left", lp), ("right", rp)):
        if p.has_duplicates:
            return (f"the {side} operand still carries partial duplicates "
                    f"along mesh axes {list(p.dup_axes)} (pending "
                    f"{p.dup_kernel or 'matAdd'} reduction from a "
                    f"two-phase aggregation); joining partial values is "
                    f"not TRA-equivalent",
                    "resolve the duplicates first: a Shuf lowers to "
                    "reduce-scatter, a Bcast to all-reduce "
                    "(shard_map _resolve_dups)")
    jl, jr = node.join_keys_l, node.join_keys_r
    l_tab, r_tab = _sharding_table(lp), _sharding_table(rp)
    for ax in sorted(set(l_tab) & set(r_tab)):
        dl, dr = l_tab[ax], r_tab[ax]
        pair = dl in jl and jr[jl.index(dl)] == dr
        if not pair:
            return (f"both operands are sharded along mesh axis {ax!r} "
                    f"on non-corresponding key dims (left dim {dl}, "
                    f"right dim {dr}) — the local join would combine "
                    f"unrelated key windows",
                    f"insert a Shuf to re-shard one side so axis {ax!r} "
                    f"lands on a corresponding join-key pair, or Bcast "
                    f"one side")
    return ("two mesh axes shard the same output key dim — the combined "
            "placement is not expressible",
            "re-shard one operand (Shuf) onto a distinct output dim")


def _agg_failure(node, ct: TypeInfo) -> Tuple[str, str]:
    p = ct.placement
    if p is None:
        return ("the operand's placement could not be derived "
                "(its own subtree is invalid)",
                "fix the operand subtree first")
    if p.has_duplicates:
        return (f"aggregating an operand that still carries partial "
                f"duplicates along mesh axes {list(p.dup_axes)}",
                "resolve the pending duplicates with a Shuf "
                "(reduce-scatter) or Bcast (all-reduce) before "
                "aggregating again")
    group_by = tuple(node.group_by)
    partial = getattr(node, "partial", False)
    if partial:
        return ("partial=True but no partitioned dim is reduced away — "
                "nothing is partial about this aggregation",
                "use partial=False (plain local aggregation)")
    reduced = sorted(set(p.dims) - set(group_by))
    return (f"the aggregation reduces away partitioned key dims "
            f"{reduced} (sharded over "
            f"{[ax for d, ax in zip(p.dims, p.axes) if d in reduced]}) — "
            f"each site would return its local partial as if it were the "
            f"full reduction (rule R2-4)",
            "use the two-phase form: partial=True here, then a "
            "Shuf/Bcast to resolve the pending duplicates (R2-5)")


def check_placements(ctx) -> None:
    """Placement-soundness pass body (see module docstring).

    Severity is executor-aware: on the placement-sensitive executors
    (``gspmd``/``shard_map``) a violation executes wrongly or not at all
    — an *error*; on the site-ignoring host executors
    (``reference``/``jit``, which evaluate the dense relations and treat
    placements as annotations) the same plan computes correct values, so
    the violation is reported as a *warning* (the plan is not
    distributable as written — exactly the status of the paper's cost-
    model-only BMM plan variants).
    """
    diags = ctx.diags
    sev = "error" if ctx.executor in ("gspmd", "shard_map") else "warning"
    for root in ctx.roots:
        if not isinstance(root, IANode):
            continue
        try:
            info = ctx.type_of(root)
        except (ValueError, TypeError) as exc:
            diags.add(PASS, "error",
                      f"type inference over the physical plan failed: "
                      f"{exc}", node=root, labels=ctx.labels)
            continue
        for n in postorder(root):
            ti = ctx.types[id(n)]
            if ti.placement is None:
                if isinstance(n, (LocalJoin, FusedJoinAgg)):
                    lt = ctx.types[id(n.left)]
                    rt = ctx.types[id(n.right)]
                    jp = _local_join_placement(n, lt, rt)
                    if isinstance(n, FusedJoinAgg) and jp is not None:
                        # the join half is fine — the fused agg half is
                        # what failed (e.g. R2-4)
                        jt = _join_types(lt, rt, n.join_keys_l,
                                         n.join_keys_r, n.join_kernel)
                        jt.placement = jp
                        msg, hint = _agg_failure(n, jt)
                        diags.add(PASS, sev,
                                  f"fused contraction's aggregation is "
                                  f"not TRA-equivalent: {msg}",
                                  node=n, labels=ctx.labels, hint=hint)
                        continue
                    msg, hint = _join_failure(n, lt, rt)
                    diags.add(PASS, sev,
                              f"local join is not TRA-equivalent: {msg}",
                              node=n, labels=ctx.labels, hint=hint)
                elif isinstance(n, LocalAgg):
                    msg, hint = _agg_failure(n, ctx.types[id(n.child)])
                    diags.add(PASS, sev,
                              f"local aggregation is not TRA-equivalent: "
                              f"{msg}",
                              node=n, labels=ctx.labels, hint=hint)
                elif isinstance(n, LocalConcat):
                    diags.add(
                        PASS, sev,
                        f"concat along key dim {n.key_dim} which is "
                        f"partitioned (or the operand subtree is "
                        f"invalid) — concatenating across sites is not "
                        f"a local op",
                        node=n, labels=ctx.labels,
                        hint="Bcast (or Shuf off the concat dim) before "
                             "the concat")
                elif isinstance(n, LocalPad):
                    diags.add(
                        PASS, sev,
                        "pad grows the key frontier of a partitioned "
                        "relation — per-site key windows would shift",
                        node=n, labels=ctx.labels,
                        hint="Bcast the child first (frontier growth "
                             "needs a replicated operand); zero-filling "
                             "holes alone is local")
            p = ti.placement
            if p is None:
                continue
            for ax in tuple(p.axes) + tuple(p.dup_axes):
                if ax not in ctx.axis_sizes:
                    diags.add(
                        PASS, sev,
                        f"placement references mesh axis {ax!r} which "
                        f"is not in the engine's mesh "
                        f"(axes: {sorted(ctx.axis_sizes)})",
                        node=n, labels=ctx.labels,
                        hint="build the plan against the engine's "
                             "site_axes / mesh axis names")
            if p.kind == "partitioned" and ctx.executor == "shard_map":
                for d, ax in zip(p.dims, p.axes):
                    size = ctx.axis_sizes.get(ax)
                    if size and ti.rtype.key_shape[d] % size:
                        diags.add(
                            PASS, sev,
                            f"frontier dim {d} ({ti.rtype.key_shape[d]}) "
                            f"not divisible by axis {ax!r} ({size}); the "
                            f"shard_map lowering has no uneven-shard "
                            f"support",
                            node=n, labels=ctx.labels,
                            hint="pad the relation to a multiple of the "
                                 "axis size, or run on gspmd")
        rp = _root_placement(info)
        if rp is not None and rp.has_duplicates \
                and ctx.executor != "shard_map":
            diags.add(
                PASS, sev,
                f"the plan result still holds partial duplicates along "
                f"mesh axes {list(rp.dup_axes)} (pending "
                f"{rp.dup_kernel or 'matAdd'}); executor "
                f"{ctx.executor!r} would return per-site partials as if "
                f"final",
                node=root, labels=ctx.labels,
                hint="finish the two-phase aggregation with a Shuf "
                     "(reduce-scatter) or Bcast (all-reduce), or run on "
                     "shard_map which resolves trailing duplicates at "
                     "the output")


def _root_placement(info: TypeInfo) -> Optional[Placement]:
    return info.placement
