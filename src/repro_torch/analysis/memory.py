"""Memory-model audit (port of ``repro.analysis.memory``, unchanged).

``cost.plan_peak_bytes`` is load-bearing: ``Engine(memory_budget=...)``
trusts it to decide whether a plan runs resident or is routed through
the host relation store, and the out-of-core planner's chunk sizing is
an affine fit over it.  An estimator bug does not fail loudly — it
surfaces as an OOM (under-estimate) or as pointless streaming
(over-estimate).

This pass recomputes the peak with an *independent* formulation —
interval liveness over the evaluation order (each value is alive from
its producing step to its last consuming step; roots to the end), swept
as a birth/death event walk — rather than the estimator's incremental
reference-count walk.  Both encode the same execution model (postorder
evaluation, dense allocation, fused contractions never materialize the
join grid, streamed contractions hold output + one merged partial), so
the two peaks must agree exactly; any divergence means one of the two
walks no longer models what the executors do.

Two model-level invariants are checked as well: the peak can never be
below the largest single relation, nor below the sum of the root
outputs (roots are never released).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.analysis.diagnostics import Diagnostics
from repro_torch.core.cost import _itemsize, plan_peak_bytes
from repro_torch.core.plan import (FusedJoinAgg, TraAgg, TraJoin, TypeInfo,
                             as_node, children, infer, postorder)

PASS = "memory"


def independent_peak_bytes(roots, *, fuse: bool = True) -> int:
    """Peak live bytes via interval liveness (event sweep).

    Independent cross-check of :func:`repro_torch.core.cost.plan_peak_bytes`:
    same execution model, different algorithm.  Value *v* is live over
    the closed step interval ``[birth(v), death(v)]`` where ``birth`` is
    its evaluation step and ``death`` the step of its last consumer
    (roots die at the final step); the peak is the max over steps of the
    live-byte sum, plus — at a streamed contraction's own step — one
    extra output-sized transient for the in-flight merged partial.
    """
    from repro_torch.core.tra import can_fuse
    if not isinstance(roots, (tuple, list)):
        roots = (roots,)
    roots = tuple(as_node(r) for r in roots)
    cache: Dict[int, TypeInfo] = {}
    for r in roots:
        infer(r, cache=cache)
    order, seen = [], set()
    for r in roots:
        for n in postorder(r):
            if id(n) not in seen:
                seen.add(id(n))
                order.append(n)

    consumers: Dict[int, int] = {}
    for n in order:
        for c in children(n):
            consumers[id(c)] = consumers.get(id(c), 0) + 1

    fused = set()
    for n in order:
        if isinstance(n, FusedJoinAgg):
            continue
        if (fuse and isinstance(n, TraAgg) and isinstance(n.child, TraJoin)
                and consumers.get(id(n.child), 0) == 1
                and can_fuse(n.child.kernel, n.kernel)):
            fused.add(id(n.child))

    def eff_children(n):
        out = []
        for c in children(n):
            if id(c) in fused:
                out.extend(children(c))
            else:
                out.append(c)
        return out

    steps = [n for n in order if id(n) not in fused]
    step_of = {id(n): i for i, n in enumerate(steps)}
    last = len(steps) - 1
    death: Dict[int, int] = {id(n): step_of[id(n)] for n in steps}
    for n in steps:
        for c in eff_children(n):
            death[id(c)] = max(death[id(c)], step_of[id(n)])
    for r in roots:
        death[id(r)] = last

    if not steps:
        return 0
    delta: List[int] = [0] * (len(steps) + 1)
    transient: List[int] = [0] * len(steps)
    for n in steps:
        b = cache[id(n)].rtype.nfloats * _itemsize(cache[id(n)].rtype)
        i = step_of[id(n)]
        delta[i] += b
        delta[death[id(n)] + 1] -= b
        if isinstance(n, FusedJoinAgg) or (
                isinstance(n, TraAgg) and id(n.child) in fused):
            transient[i] = b
    peak = cur = 0
    for i in range(len(steps)):
        cur += delta[i]
        peak = max(peak, cur + transient[i])
    return peak


def audit_memory_model(roots, *, fuse: bool = True,
                       estimator: Optional[Callable] = None,
                       labels=None,
                       diags: Optional[Diagnostics] = None
                       ) -> Diagnostics:
    """Cross-check ``estimator`` (default ``plan_peak_bytes``) against
    the independent liveness analysis and the model invariants."""
    from repro_torch.core.guards import label_nodes
    if not isinstance(roots, (tuple, list)):
        roots = (roots,)
    roots = tuple(as_node(r) for r in roots)
    if estimator is None:
        estimator = plan_peak_bytes
    if diags is None:
        diags = Diagnostics()
    if labels is None:
        labels = label_nodes(roots)
    try:
        est = estimator(roots, fuse=fuse)
    except (ValueError, TypeError) as exc:
        diags.add(PASS, "error",
                  f"peak-bytes estimator failed: {exc}",
                  node=roots[0], labels=labels)
        return diags
    ind = independent_peak_bytes(roots, fuse=fuse)
    if est != ind:
        diags.add(
            PASS, "error",
            f"memory model divergence: plan_peak_bytes reports "
            f"{est:,} B but independent interval liveness reports "
            f"{ind:,} B — the budget/streaming decisions built on the "
            f"estimator are untrustworthy "
            f"({'under' if est < ind else 'over'}-estimate)",
            node=roots[0], labels=labels,
            hint="one of the two walks no longer models postorder "
                 "evaluation with last-consumer release; diff "
                 "cost.plan_peak_bytes against "
                 "analysis.memory.independent_peak_bytes")
        return diags

    from repro_torch.core.tra import can_fuse
    cache: Dict[int, TypeInfo] = {}
    for r in roots:
        infer(r, cache=cache)
    # fused-away join grids are never materialized — they don't bound the
    # peak (the same fusion rule both liveness walks apply)
    consumers: Dict[int, int] = {}
    seen = set()
    order = []
    for r in roots:
        for n in postorder(r):
            if id(n) in seen:
                continue
            seen.add(id(n))
            order.append(n)
            for c in children(n):
                consumers[id(c)] = consumers.get(id(c), 0) + 1
    fused = set()
    for n in order:
        if (fuse and not isinstance(n, FusedJoinAgg)
                and isinstance(n, TraAgg) and isinstance(n.child, TraJoin)
                and consumers.get(id(n.child), 0) == 1
                and can_fuse(n.child.kernel, n.kernel)):
            fused.add(id(n.child))
    biggest, biggest_node = 0, roots[0]
    for n in order:
        if id(n) in fused:
            continue
        b = cache[id(n)].rtype.nfloats * _itemsize(cache[id(n)].rtype)
        if b > biggest:
            biggest, biggest_node = b, n
    if est < biggest:
        diags.add(
            PASS, "error",
            f"estimated peak ({est:,} B) is below the largest single "
            f"relation in the plan ({biggest:,} B) — that relation alone "
            f"must be resident at its evaluation step",
            node=biggest_node, labels=labels,
            hint="the estimator is dropping a live value")
    roots_bytes = sum(
        cache[id(r)].rtype.nfloats * _itemsize(cache[id(r)].rtype)
        for r in {id(r): r for r in roots}.values())
    if est < roots_bytes:
        diags.add(
            PASS, "error",
            f"estimated peak ({est:,} B) is below the sum of root "
            f"outputs ({roots_bytes:,} B), which are all live at the "
            f"final step (outputs never release)",
            node=roots[0], labels=labels,
            hint="the estimator is releasing a root output")
    return diags


def check_memory_model(ctx) -> None:
    """Pass body: audit the estimator over the plans being compiled."""
    audit_memory_model(ctx.roots, fuse=ctx.fuse, labels=ctx.labels,
                       diags=ctx.diags)
