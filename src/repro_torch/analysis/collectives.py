"""Collective-consistency (race) detector.

Port of ``repro.analysis.collectives``, unchanged.  The schedule below is
the one the ``shard_map`` executor (:mod:`repro_torch.core.shardmap_exec`)
issues — each of its collectives is recorded as a :class:`CollectiveOp`,
and a dispatch's record equals this schedule op for op
(``shardmap_exec.expected_schedule``) — so a plan the port verifies clean
is one that executor runs.

Symbolically lowers a physical plan's exchanges exactly the way
the shard_map lowering does — ``Bcast`` → ``all_gather``,
dim-changing ``Shuf`` → ``all_to_all``, pending R2-5 duplicates →
``psum_scatter`` (divisible additive case) or an all-reduce via
``_cross_site_reduce`` — and checks the resulting **ordered collective
schedule** statically:

* every collective's mesh axis must exist in the engine's axis table
  (a nonexistent axis hangs or crashes at trace time today);
* every cross-site reduction's kernel must be *registered and
  associative* and must match the placement's pending ``dup_kernel`` —
  a non-associative reducer silently computes order-dependent (wrong)
  sums on a ring;
* the additive reduce-scatter specialization only fires when the local
  window divides the axis — the pass re-derives that branch so the
  schedule it validates is the one that will actually trace.

Because the lowering is SPMD — one program, data-independent lowering
decisions — every site executes this one schedule by construction;
:func:`check_site_schedules` is the alignment half of the pass for
callers that *do* hold per-site programs (multi-host launchers, planner
v2 candidates): it verifies all sites execute an identical ordered
sequence with matching axes and reducers, the property whose violation
surfaces as a hang (mismatched collective count) or a wrong sum
(mismatched reducer/axis) at run time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.diagnostics import Diagnostics
from repro_torch.core.plan import (Bcast, IANode, Placement, Shuf, TypeInfo,
                             infer, postorder)

PASS = "collectives"

# reducers with a native fused collective (psum / pmax / pmin); every
# other associative kernel lowers to all_gather + local fold
_NATIVE_REDUCERS = (None, "matAdd", "elemMax", "elemMin")


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective in the lowered schedule of a physical plan."""

    kind: str                       # all_gather | all_to_all |
    #                                 psum_scatter | all_reduce
    axis: str
    reducer: Optional[str] = None   # cross-site reduction kernel name
    node_id: int = -1
    node_label: str = ""

    def describe(self) -> str:
        red = f", reducer={self.reducer}" if self.reducer else ""
        return f"{self.kind}(axis={self.axis!r}{red})"

    def matches(self, other: "CollectiveOp") -> bool:
        return (self.kind, self.axis, self.reducer) == \
            (other.kind, other.axis, other.reducer)


def _local_key_shape(ti: TypeInfo, axis_sizes: Dict[str, int]
                     ) -> Tuple[int, ...]:
    """Per-site key window under ``ti.placement`` (shard_map local view)."""
    ks = list(ti.rtype.key_shape)
    p = ti.placement
    if p is not None and p.kind == "partitioned":
        for d, ax in zip(p.dims, p.axes):
            size = axis_sizes.get(ax, 1)
            if size and ks[d] % size == 0:
                ks[d] //= size
    return tuple(ks)


def _reducer_ok(kernel_name: Optional[str], node, labels,
                diags: Diagnostics) -> None:
    if kernel_name in _NATIVE_REDUCERS:
        return
    from repro_torch.core.kernels_registry import get_kernel
    try:
        kern = get_kernel(kernel_name)
    except KeyError:
        diags.add(PASS, "error",
                  f"cross-site reduction names unknown kernel "
                  f"{kernel_name!r}",
                  node=node, labels=labels,
                  hint="register the kernel, or use one of "
                       "matAdd/elemMax/elemMin")
        return
    if not kern.is_associative:
        diags.add(PASS, "error",
                  f"cross-site reduction over non-associative kernel "
                  f"{kernel_name!r} — per-site fold order differs, so "
                  f"sites would disagree on the reduced value (wrong "
                  f"sums, not an error at run time)",
                  node=node, labels=labels,
                  hint="two-phase aggregation requires an associative "
                       "reducer; keep the aggregation single-phase "
                       "(replicated operand) for this kernel")


def _dup_resolution_ops(src: Placement, tgt: Optional[Placement],
                        local_ks: Tuple[int, ...],
                        axis_sizes: Dict[str, int], node, labels,
                        diags: Diagnostics) -> List[CollectiveOp]:
    """Mirror ``shardmap_exec._resolve_dups``'s collective choices."""
    nid, label = labels.get(id(node), (-1, type(node).__name__))
    ops: List[CollectiveOp] = []
    remaining = list(src.dup_axes)
    _reducer_ok(src.dup_kernel, node, labels, diags)
    if tgt is not None and tgt.kind == "partitioned":
        for d, ax in zip(tgt.dims, tgt.axes):
            if ax not in remaining:
                continue
            size = axis_sizes.get(ax, 0)
            if size and local_ks[d] % size == 0 \
                    and src.dup_kernel in (None, "matAdd"):
                ops.append(CollectiveOp("psum_scatter", ax,
                                        src.dup_kernel or "matAdd",
                                        nid, label))
            else:
                ops.append(CollectiveOp("all_reduce", ax,
                                        src.dup_kernel or "matAdd",
                                        nid, label))
            remaining.remove(ax)
    for ax in remaining:
        ops.append(CollectiveOp("all_reduce", ax,
                                src.dup_kernel or "matAdd", nid, label))
    return ops


def collective_schedule(root: IANode, axis_sizes: Dict[str, int],
                        labels: Optional[Dict] = None,
                        diags: Optional[Diagnostics] = None
                        ) -> List[CollectiveOp]:
    """The ordered collective sequence the shard_map lowering emits.

    Walks the plan in evaluation (postorder) order — the same order the
    lowering's memoized recursion visits exchanges — and records each
    communication op with its axis, reducer, and provenance.  Structural
    problems (unknown axes, bad reducers) are reported into ``diags``
    when given.
    """
    from repro_torch.core.guards import label_nodes
    if labels is None:
        labels = label_nodes((root,))
    if diags is None:
        diags = Diagnostics()
    cache: Dict[int, TypeInfo] = {}
    infer(root, cache=cache)
    sched: List[CollectiveOp] = []
    for n in postorder(root):
        if not isinstance(n, (Bcast, Shuf)):
            continue
        nid, label = labels.get(id(n), (-1, type(n).__name__))
        src = cache[id(n.child)].placement
        tgt = cache[id(n)].placement
        if src is None:
            diags.add(PASS, "error",
                      "exchange over an operand whose placement could "
                      "not be derived — the collective's source sharding "
                      "is undefined",
                      node=n, labels=labels,
                      hint="fix the operand subtree (see the placement "
                           "pass diagnostics)")
            continue
        src_eff = src
        if src.dup_axes:
            local_ks = _local_key_shape(cache[id(n.child)], axis_sizes)
            sched.extend(_dup_resolution_ops(
                src, tgt, local_ks, axis_sizes, n, diags=diags,
                labels=labels))
            scattered = []
            if tgt is not None and tgt.kind == "partitioned":
                # only divisible dup axes scatter into place; the rest
                # all-reduce and stay replicated along their axis
                scattered = [(d, ax) for d, ax in zip(tgt.dims, tgt.axes)
                             if ax in src.dup_axes
                             and axis_sizes.get(ax, 0)
                             and local_ks[d] % axis_sizes[ax] == 0]
            src_eff = Placement.partitioned(
                tuple(src.dims) + tuple(d for d, _ in scattered),
                tuple(src.axes) + tuple(ax for _, ax in scattered))
        # the _move phase: per mesh axis, slice / all_gather / all_to_all
        src_map = {ax: d for d, ax in zip(src_eff.dims, src_eff.axes)}
        tgt_map = {} if tgt is None or tgt.kind == "replicated" \
            else {ax: d for d, ax in zip(tgt.dims, tgt.axes)}
        for ax in sorted(set(src_map) | set(tgt_map)):
            if ax not in axis_sizes:
                diags.add(PASS, "error",
                          f"collective over mesh axis {ax!r} which does "
                          f"not exist in the mesh "
                          f"(axes: {sorted(axis_sizes)}) — this hangs or "
                          f"fails at trace time",
                          node=n, labels=labels,
                          hint="use the engine's mesh axis names")
                continue
            od, nd = src_map.get(ax), tgt_map.get(ax)
            if od == nd:
                continue
            if od is None:
                continue            # replicated → sharded: local slice
            if nd is None:
                sched.append(CollectiveOp("all_gather", ax, None,
                                          nid, label))
            else:
                sched.append(CollectiveOp("all_to_all", ax, None,
                                          nid, label))
    # trailing output duplicates resolve at the root (shard_map emits an
    # all-reduce per remaining dup axis before returning)
    rp = cache[id(root)].placement
    if rp is not None and rp.dup_axes:
        rid, rlabel = labels.get(id(root), (-1, type(root).__name__))
        _reducer_ok(rp.dup_kernel, root, labels, diags)
        for ax in rp.dup_axes:
            if ax not in axis_sizes:
                diags.add(PASS, "error",
                          f"output duplicate resolution over mesh axis "
                          f"{ax!r} which does not exist in the mesh",
                          node=root, labels=labels)
                continue
            sched.append(CollectiveOp("all_reduce", ax,
                                      rp.dup_kernel or "matAdd",
                                      rid, rlabel))
    return sched


def check_site_schedules(schedules: Sequence[Sequence[CollectiveOp]],
                         diags: Optional[Diagnostics] = None
                         ) -> Diagnostics:
    """Verify every site executes one identical ordered collective
    sequence.

    ``schedules[i]`` is site *i*'s sequence.  Any divergence — a site
    with more/fewer collectives (a guaranteed hang: the extra collective
    blocks forever), or the same position lowering to different
    kind/axis/reducer (wrong data movement or wrong sums) — becomes an
    error naming the first divergent position and both ops.
    """
    if diags is None:
        diags = Diagnostics()
    if not schedules:
        return diags
    ref = list(schedules[0])
    for site, sched in enumerate(schedules[1:], start=1):
        sched = list(sched)
        if len(sched) != len(ref):
            k = min(len(sched), len(ref))
            extra = ref[k] if len(ref) > k else sched[k]
            diags.add(
                PASS, "error",
                f"site {site} executes {len(sched)} collectives where "
                f"site 0 executes {len(ref)} — the unmatched "
                f"{extra.describe()} at position {k} "
                f"(node {extra.node_label}) blocks forever (hang)",
                hint="every site must run the same program; re-derive "
                     "per-site plans from one logical root")
            continue
        for k, (a, b) in enumerate(zip(ref, sched)):
            if not a.matches(b):
                diags.add(
                    PASS, "error",
                    f"collective schedules diverge at position {k}: "
                    f"site 0 runs {a.describe()} "
                    f"(node {a.node_label}) but site {site} runs "
                    f"{b.describe()} (node {b.node_label}) — mismatched "
                    f"collectives hang or silently corrupt the "
                    f"reduction",
                    hint="align the exchange placement and reducer "
                         "across sites")
                break
    return diags


def check_collectives(ctx) -> None:
    """Pass body: schedule well-formedness + cross-site alignment.

    On the site-ignoring host executors (``reference``/``jit``) no
    collective ever actually runs, so findings are downgraded to
    warnings — the plan would misbehave *if distributed*; on
    ``gspmd``/``shard_map`` they are errors.
    """
    n_sites = 1
    for s in ctx.axis_sizes.values():
        n_sites *= max(1, s)
    distributed = ctx.executor in ("gspmd", "shard_map")
    for root in ctx.roots:
        if not isinstance(root, IANode):
            continue
        diags = ctx.diags if distributed else Diagnostics()
        try:
            sched = collective_schedule(root, ctx.axis_sizes,
                                        labels=ctx.labels, diags=diags)
        except (ValueError, TypeError) as exc:
            diags.add(PASS, "error",
                      f"collective lowering failed: {exc}",
                      node=root, labels=ctx.labels)
            sched = []
        # SPMD: the lowering is site-uniform by construction, so the
        # per-site alignment check is over n_sites copies of the one
        # derived schedule — it guards the invariant the executors rely
        # on, and the same checker validates externally-supplied
        # per-site programs (see check_site_schedules)
        if n_sites > 1 and sched:
            check_site_schedules([sched] * min(n_sites, 16), diags=diags)
        if not distributed:
            ctx.diags.extend(Diagnostics(
                dataclasses.replace(d, severity="warning")
                if d.severity == "error" else d for d in diags))
