"""Stream-carrier legality pass (port of ``repro.analysis.streaming``).

Statically re-runs the out-of-core planner's carrier analysis
(:func:`repro_torch.store.stream._slot_walk`) over a logical root and explains
— with node provenance — why each candidate streamed dimension is
accepted or refused: masked types, in-plan filter/rekey/pad refusals,
the frontier-min rule forcing both join sides to slice, tiled dims,
sliced-and-whole conflicts.

The pass only fires for engines with an out-of-core configuration
(``memory_budget`` set) on a single logical root — exactly the
population :meth:`Engine._streaming_applicable` routes through the
store.  A plan that *fits the budget resident* is fine (info only); an
over-budget plan with no streamable dimension is the error case the pass
exists for: today that surfaces either as a silent resident fallback
that then OOMs, or as a bare ``NotStreamable`` deep in execution — the
diagnostic instead names the first refusing node per candidate dim at
compile time.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.diagnostics import Diagnostics
from repro_torch.core.cost import plan_peak_bytes
from repro_torch.core.plan import (TraAgg, TraFilter, TraInput, TraJoin, TraNode,
                             TraPad, TraReKey, TypeInfo, infer, postorder)

PASS = "streaming"


def _chunk_feasible(root, sliced, types, nkeys: int, budget: int,
                    fuse: bool) -> Tuple[bool, str]:
    """Mirror ``StreamExecutor._chunk_keys``: does any chunk size fit?"""
    from repro_torch.store.stream import _itemsize, _rebuild
    p1 = plan_peak_bytes(_rebuild(root, sliced, 1), fuse=fuse)
    p2 = plan_peak_bytes(_rebuild(root, sliced, 2), fuse=fuse) \
        if nkeys >= 2 else p1
    slope = max(1, p2 - p1)
    fixed = max(0, p1 - slope)
    prefetch = 0
    for n in postorder(root):
        if isinstance(n, TraInput) and id(n) in sliced:
            ti = types[id(n)]
            prefetch += (ti.rtype.nfloats * _itemsize(ti.rtype)
                         // max(1, ti.rtype.key_shape[sliced[id(n)]]))
    ck = (budget - fixed) // max(1, slope + prefetch)
    if ck < 1:
        return False, (f"even a 1-key chunk exceeds the budget "
                       f"(fixed resident set ~{fixed:,} B + per-key "
                       f"~{slope + prefetch:,} B > {budget:,} B)")
    if ck >= nkeys:
        return False, (f"the non-streamed resident part alone "
                       f"(~{fixed:,} B) is what exceeds the budget — "
                       f"slicing this dim does not help")
    return True, ""


def explain_unstreamable(root: TraNode, *, budget: Optional[int],
                         fuse: bool = True, labels: Optional[Dict] = None,
                         diags: Optional[Diagnostics] = None,
                         device=None) -> Diagnostics:
    """Diagnostics for a plan's streamability under ``budget``.

    Mirrors :meth:`repro_torch.store.stream.StreamExecutor.plan` decision for
    decision, but records *why* instead of just failing: one diagnostic
    per blocking construct (masked types, key rewrites), and one per
    refused candidate dimension carrying the refusing node's provenance.
    No error diagnostics means the plan either fits resident or streams.
    ``device`` resolves a ``budget`` of ``None`` as the stream executor
    does (a quarter of the card's memory; see
    :func:`repro_torch.store.autotune.stream_budget_bytes`).
    """
    from repro_torch.core.guards import label_nodes
    from repro_torch.core.tra import can_fuse
    from repro_torch.store.autotune import stream_budget_bytes
    from repro_torch.store.stream import _slot_walk
    if labels is None:
        labels = label_nodes((root,))
    if diags is None:
        diags = Diagnostics()
    types: Dict[int, TypeInfo] = {}
    out_info = infer(root, cache=types)
    eff_budget = stream_budget_bytes(budget, device)
    total = plan_peak_bytes(root, fuse=fuse)
    if total <= eff_budget:
        diags.add(PASS, "info",
                  f"plan fits resident: estimated peak "
                  f"{total:,} B <= budget {eff_budget:,} B",
                  node=root, labels=labels)
        return diags

    # hard blockers: masks / key rewrites anywhere in the plan
    blocked = False
    for n in postorder(root):
        if isinstance(n, (TraFilter, TraPad, TraReKey)):
            blocked = True
            diags.add(
                PASS, "error",
                f"over-budget plan (peak {total:,} B > budget "
                f"{eff_budget:,} B) cannot stream: "
                f"{type(n).__name__} rewrites the key space, so chunk "
                f"concatenation loses continuity",
                node=n, labels=labels,
                hint="run resident (raise memory_budget), or move the "
                     "filter/rekey outside the streamed region")
        elif types[id(n)].mask is not None:
            blocked = True
            diags.add(
                PASS, "error",
                f"over-budget plan cannot stream: node carries a static "
                f"mask ({types[id(n)].valid_tuples} of "
                f"{types[id(n)].rtype.ntuples} keys valid) — chunked "
                f"execution requires continuous relations",
                node=n, labels=labels,
                hint="densify with pad() before the streamed region, or "
                     "run resident")
    if blocked:
        return diags

    # candidate dims, largest-first — the same order plan() tries
    refusals: List[Tuple[int, str, object, str]] = []
    out_ks = out_info.rtype.key_shape
    for d in sorted(range(len(out_ks)), key=lambda dd: -out_ks[dd]):
        if out_ks[d] < 2:
            continue
        rej: list = []
        sliced = _slot_walk(root, root, d, types, reject=rej)
        if sliced is not None:
            ok, why = _chunk_feasible(root, sliced, types, out_ks[d],
                                      eff_budget, fuse)
            if ok:
                diags.add(PASS, "info",
                          f"stream-out over output key dim {d} "
                          f"({out_ks[d]} keys) is legal",
                          node=root, labels=labels)
                return diags
            refusals.append((d, "stream-out", root, why))
            continue
        node, why = rej[0] if rej else (root, "refused")
        refusals.append((d, "stream-out", node, why))
    if isinstance(root, TraAgg) and isinstance(root.child, TraJoin) \
            and root.kernel.is_associative \
            and can_fuse(root.child.kernel, root.kernel):
        j_ks = types[id(root.child)].rtype.key_shape
        red = [d for d in range(len(j_ks)) if d not in root.group_by]
        for d in sorted(red, key=lambda dd: -j_ks[dd]):
            if j_ks[d] < 2:
                continue
            rej = []
            sliced = _slot_walk(root, root.child, d, types, reject=rej)
            if sliced is not None:
                ok, why = _chunk_feasible(root, sliced, types, j_ks[d],
                                          eff_budget, fuse)
                if ok:
                    diags.add(PASS, "info",
                              f"stream-reduce over reduced join dim {d} "
                              f"({j_ks[d]} keys) is legal",
                              node=root, labels=labels)
                    return diags
                refusals.append((d, "stream-reduce", root, why))
                continue
            node, why = rej[0] if rej else (root, "refused")
            refusals.append((d, "stream-reduce", node, why))

    if not refusals:
        diags.add(PASS, "error",
                  f"over-budget plan (peak {total:,} B > budget "
                  f"{eff_budget:,} B) has no key dim with >= 2 keys to "
                  f"stream over",
                  node=root, labels=labels,
                  hint="raise memory_budget or reshape the program "
                       "around a larger key dim")
        return diags
    for d, mode, node, why in refusals:
        diags.add(
            PASS, "error",
            f"over-budget plan (peak {total:,} B > budget "
            f"{eff_budget:,} B): candidate {mode} dim {d} refused — "
            f"{why}",
            node=node, labels=labels,
            hint="every candidate dim is blocked; restructure the plan "
                 "or raise memory_budget (resident fallback may OOM)")
    return diags


def check_streaming(ctx) -> None:
    """Pass body: out-of-core legality for budgeted single-root plans."""
    if ctx.memory_budget is None:
        return
    roots = ctx.logical_roots if ctx.logical_roots is not None \
        else ctx.roots
    if len(roots) != 1 or not isinstance(roots[0], TraNode):
        return                      # multi-root / physical plans run resident
    # provenance over the logical root (ctx.labels covers ctx.roots,
    # which may be the lowered physical plans)
    labels = ctx.labels if id(roots[0]) in ctx.labels else None
    explain_unstreamable(roots[0], budget=ctx.memory_budget,
                         fuse=ctx.fuse, labels=labels, diags=ctx.diags)
