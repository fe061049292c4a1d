"""Multi-host launcher gate: verify per-site programs before execution.

Port of ``repro.launch.sites``.  The static verifier's collectives pass
self-checks SPMD plans (one program, every site runs it by construction).
A launcher is where that assumption can break: it hands each site a
physical program, and nothing forces externally supplied per-site plans —
hand-edited, planner candidates, or programs deserialized from different
optimizer versions — to agree on their collective schedules.  A
disagreement is the worst failure class of the distributed story: a site
with an extra collective blocks until its group times out, and a
mismatched reducer or axis silently computes wrong sums.

:func:`verify_site_programs` derives each site's ordered collective
schedule with :func:`repro_torch.analysis.collectives.collective_schedule`
— the lowering the ``shard_map`` executor performs — and aligns them with
:func:`repro_torch.analysis.collectives.check_site_schedules`, raising
:class:`~repro_torch.analysis.diagnostics.PlanVerificationError` before
any site starts executing.

Addition for the port, whose ranks are processes: :func:`verify_rank_program`
is the same gate run collectively — each rank derives its own program's
schedule, the schedules are gathered over the process group (one
``all_gather_object``, before any collective of the program), and every
rank raises alike when they disagree.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.analysis.collectives import (check_site_schedules,
                                              collective_schedule)
from repro_torch.analysis.diagnostics import Diagnostics

PASS = "site-programs"


def site_collective_schedules(site_roots: Sequence,
                              axis_sizes: Dict[str, int],
                              diags: Optional[Diagnostics] = None):
    """Per-site ordered collective schedules for a list of physical
    plan roots (one per site).  Lowering problems (unknown axes, bad
    reducers) are reported into ``diags``; a site whose plan cannot be
    lowered at all contributes an empty schedule plus an error."""
    from repro_torch.core.guards import label_nodes
    if diags is None:
        diags = Diagnostics()
    schedules = []
    for site, root in enumerate(site_roots):
        try:
            labels = label_nodes((root,))
            schedules.append(collective_schedule(root, axis_sizes,
                                                 labels=labels,
                                                 diags=diags))
        except (ValueError, TypeError) as exc:
            diags.add(PASS, "error",
                      f"site {site}: collective lowering failed: {exc}",
                      node=root)
            schedules.append([])
    return schedules


def verify_site_programs(site_roots: Sequence,
                         axis_sizes: Dict[str, int], *,
                         strict: bool = True) -> Diagnostics:
    """Verify externally supplied per-site programs agree on collectives.

    ``site_roots[i]`` is the physical plan (:class:`repro_torch.core.plan.
    IANode`, e.g. ``CompiledExpr.plan``) site *i* would execute;
    ``axis_sizes`` is the launch mesh's axis table.  With ``strict`` (the
    default: this is a pre-launch gate, not a linter) any error raises
    :class:`~repro_torch.analysis.diagnostics.PlanVerificationError`;
    otherwise the diagnostics are returned for the caller to render.
    """
    diags = Diagnostics()
    schedules = site_collective_schedules(site_roots, axis_sizes,
                                          diags=diags)
    check_site_schedules(schedules, diags=diags)
    if strict:
        diags.raise_if_errors()
    return diags


def verify_rank_program(root, axis_sizes: Dict[str, int], *, group=None,
                        strict: bool = True) -> Diagnostics:
    """:func:`verify_site_programs` over the ranks of ``group`` (default:
    the default process group), each rank holding its own ``root``: the
    ranks' schedules are gathered (one ``all_gather_object``) and checked
    on every rank, so all of them raise, or none, before the program's
    first collective.  Every rank of the group must call it."""
    import torch.distributed as dist
    diags = Diagnostics()
    (mine,) = site_collective_schedules((root,), axis_sizes, diags=diags)
    schedules = [None] * dist.get_world_size(group)
    dist.all_gather_object(schedules, mine, group=group)
    check_site_schedules(schedules, diags=diags)
    if strict:
        diags.raise_if_errors()
    return diags
