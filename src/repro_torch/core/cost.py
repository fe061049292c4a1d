"""Exact cost model for IA plans (paper §4.3).

Port of ``repro.core.cost``: ``cost_plan``/``comm_cost`` unchanged, so plan
choice still follows the paper's comm metric and the ``tmp_floats``
tiebreak.  The hardware model describes one NVIDIA H100 SXM instead of a
TPU v5e, and is exported as :data:`H100_SXM` in place of ``TPU_V5E``.
``plan_peak_bytes`` (the out-of-core estimator) comes with the
out-of-core slice (6, see ``ROADMAP.md``).

Because uniqueness + continuity hold (and our masks make even the
post-filter cardinalities *exact*), no estimation is involved:

    tuples(R)  = #valid keys           (∏ fᵢ when continuous)
    floats(R)  = tuples × ∏ bᵢ  ×  dup_multiplicity

    cost(BCAST(R)) = floats(R) × s       (every tuple to every site)
    cost(SHUF(R))  = floats(R)           (every tuple moves once)

``dup_multiplicity`` covers the transient duplicate-key state inside a
two-phase aggregation (R2-5): a relation whose placement has ``dup_axes``
holds one partial copy per site along those axes.  A SHUF of that state is
a reduce-scatter, a BCAST of it is an all-reduce; both formulas then match
the paper's accounting of "every (partial) tuple moves".

Beyond the paper we also expose the *compute* side (exact kernel flops) and
*roofline seconds* against a hardware model — used by the §Perf loop — but
plan *selection* defaults to the paper's pure-communication metric so the
reproduction stays faithful.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

from repro_torch.core.plan import (Bcast, FusedJoinAgg, IANode, LocalAgg,
                                   LocalJoin, LocalMap, Shuf, TypeInfo,
                                   _join_types, infer, postorder)


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """NVIDIA H100 SXM defaults (per card), from NVIDIA's H100 data sheet:
    dense rates without sparsity, at the card's full 700 W power limit."""

    peak_flops: float = 989e12          # bf16 FLOP/s, tensor cores
    peak_flops_f32: float = 67e12       # f32 FLOP/s, FFMA (no tensor cores)
    hbm_bw: float = 3.35e12             # bytes/s (80 GB HBM3)
    ici_bw: float = 450e9               # bytes/s NVLink, each direction
    bytes_per_float: int = 4


H100_SXM = HardwareModel()


@dataclasses.dataclass
class NodeCost:
    node: str
    comm_floats: int = 0
    flops: int = 0
    # floats a node *materializes* beyond its inputs/output (an unfused
    # LocalJoin builds the whole broadcasted grid; FusedJoinAgg streams it).
    # Not part of the paper's §4.3 metric — used as a memory tiebreak.
    tmp_floats: int = 0


@dataclasses.dataclass
class CostReport:
    comm_floats: int
    flops: int
    per_node: List[NodeCost]
    tmp_floats: int = 0

    def comm_seconds(self, hw: HardwareModel = H100_SXM,
                     n_sites: int = 1) -> float:
        return (self.comm_floats * hw.bytes_per_float) / (hw.ici_bw * n_sites)

    def compute_seconds(self, hw: HardwareModel = H100_SXM,
                        n_sites: int = 1) -> float:
        return self.flops / (hw.peak_flops * n_sites)

    def __str__(self) -> str:
        lines = [f"total comm floats: {self.comm_floats:,}",
                 f"total flops:       {self.flops:,}"]
        for nc in self.per_node:
            if nc.comm_floats or nc.flops:
                lines.append(f"  {nc.node:<40} comm={nc.comm_floats:<14,} "
                             f"flops={nc.flops:,}")
        return "\n".join(lines)


def _dup_multiplicity(info: TypeInfo, axis_sizes: Dict[str, int]) -> int:
    if info.placement is None or not info.placement.dup_axes:
        return 1
    return math.prod(axis_sizes[a] for a in info.placement.dup_axes)


def floats_of(info: TypeInfo, axis_sizes: Dict[str, int]) -> int:
    return info.valid_floats * _dup_multiplicity(info, axis_sizes)


def move_floats(f_logical: int, src, tgt, axis_sizes: Dict[str, int],
                accounting: str = "wire") -> int:
    """Floats on the wire to move a relation from placement src → tgt.

    ``accounting="paper"`` is the paper's §4.3 rule verbatim: SHUF = f,
    BCAST = f×s (used to reproduce Tables 4/6/9 exactly).

    ``accounting="wire"`` (default, used for plan selection) prices each
    transition by actual bytes received: per site, the floats it needs
    under ``tgt`` minus the useful overlap it already holds under ``src``,
    summed over sites.  This correctly charges an axis *un-sharding*
    (all-gather) ``≈ f × axis_size`` where the paper's flat SHUF=f under-
    charges it, reduces to the paper's numbers for the pure cases
    (full-partition shuffle = f; broadcast of a partitioned relation ≈
    f×s; already-in-place = 0), and prices the two-phase aggregation's
    reduce-scatter / all-reduce at their ring-collective wire volumes.
    """
    s = math.prod(axis_sizes.values()) if axis_sizes else 1
    src_axes = {} if src is None or src.kind != "partitioned" else \
        {ax: d for d, ax in zip(src.dims, src.axes)}
    tgt_axes = {} if tgt is None or tgt.kind != "partitioned" else \
        {ax: d for d, ax in zip(tgt.dims, tgt.axes)}
    dup = () if src is None else tuple(src.dup_axes)

    if accounting == "paper":
        f = f_logical
        if tgt is None or tgt.kind == "replicated":
            return f * s
        return f

    cost = 0
    # Phase 1 — resolve pending duplicate partials (R2-5 second phase):
    # a reduce(-scatter) over each dup axis moves every partial once.
    src_eff = dict(src_axes)
    for ax in dup:
        size = axis_sizes.get(ax, 1)
        cost += f_logical * max(size - 1, 0)
        if ax in tgt_axes:
            src_eff[ax] = tgt_axes[ax]      # scattered straight into place
        # else: post-reduce the value is replicated along ax (all-reduce)

    # Phase 2 — per-site need vs overlap (intersection of constraints).
    if src_eff == tgt_axes:
        return cost
    need = 1.0       # fraction of the relation each site needs under tgt
    overlap = 1.0    # fraction it already holds that is *useful*
    for ax, size in axis_sizes.items():
        sd, td = src_eff.get(ax), tgt_axes.get(ax)
        if td is not None:
            need /= size
        if sd is not None and sd == td:
            overlap /= size                  # aligned constraint (shared)
        else:
            if sd is not None:
                overlap /= size              # holdings cut by src shard
            if td is not None:
                overlap /= size              # needs cut independently
    received = max(0.0, need - overlap)
    return cost + int(round(f_logical * s * received))


def cost_plan(root: IANode, axis_sizes: Dict[str, int],
              accounting: str = "wire") -> CostReport:
    """Exact communication + compute cost of a physical plan."""
    from repro_torch.core.plan import as_node
    root = as_node(root)
    cache: Dict[int, TypeInfo] = {}
    infer(root, cache=cache)
    s = math.prod(axis_sizes.values()) if axis_sizes else 1

    per_node: List[NodeCost] = []
    total_comm = 0
    total_flops = 0
    for n in postorder(root):
        ti = cache[id(n)]
        nc = NodeCost(node=type(n).__name__)
        if isinstance(n, Bcast):
            child = cache[id(n.child)]
            if child.placement is not None and child.placement.is_replicated:
                moved = 0  # R2-1: broadcast of a replicated relation is free
            else:
                moved = move_floats(child.valid_floats, child.placement,
                                    None, axis_sizes, accounting)
            nc.comm_floats = moved
            nc.node += "→ALL"
        elif isinstance(n, Shuf):
            child = cache[id(n.child)]
            nc.comm_floats = move_floats(
                child.valid_floats, child.placement, ti.placement,
                axis_sizes, accounting)
            nc.node += f"→{ti.placement.describe()}"
        elif isinstance(n, LocalJoin):
            lt, rt = cache[id(n.left)], cache[id(n.right)]
            nc.flops = ti.valid_tuples * n.kernel.flops(lt.rtype.bound,
                                                        rt.rtype.bound)
            nc.tmp_floats = ti.valid_floats     # materialized join grid
        elif isinstance(n, LocalAgg):
            child = cache[id(n.child)]
            combines = max(child.valid_tuples - ti.valid_tuples, 0)
            if n.kernel.arity == 2:
                nc.flops = combines * n.kernel.flops(child.rtype.bound,
                                                     child.rtype.bound)
        elif isinstance(n, FusedJoinAgg):
            lt, rt = cache[id(n.left)], cache[id(n.right)]
            joint = _join_types(lt, rt, n.join_keys_l, n.join_keys_r,
                                n.join_kernel)
            nc.flops = joint.valid_tuples * n.join_kernel.flops(
                lt.rtype.bound, rt.rtype.bound)
            if n.agg_kernel.arity == 2:
                combines = max(joint.valid_tuples - ti.valid_tuples, 0)
                nc.flops += combines * n.agg_kernel.flops(joint.rtype.bound,
                                                          joint.rtype.bound)
            # streamed: output accumulator + one grid slice in flight
            nc.tmp_floats = 2 * ti.valid_floats
        elif isinstance(n, LocalMap):
            if n.kernel.name != "idOp":
                nc.flops = (cache[id(n.child)].valid_tuples
                            * n.kernel.flops(cache[id(n.child)].rtype.bound))
        per_node.append(nc)
        total_comm += nc.comm_floats
        total_flops += nc.flops
    total_tmp = sum(nc.tmp_floats for nc in per_node)
    return CostReport(total_comm, total_flops, per_node, total_tmp)


def comm_cost(root: IANode, axis_sizes: Dict[str, int],
              accounting: str = "wire") -> int:
    """The plan-selection metric: floats moved (wire-accurate by default;
    pass accounting="paper" for the paper's verbatim §4.3 rules)."""
    return cost_plan(root, axis_sizes, accounting).comm_floats
