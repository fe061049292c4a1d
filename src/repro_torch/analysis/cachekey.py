"""Cache-key injectivity fuzzing (port of ``repro.analysis.cachekey``).

:func:`repro_torch.core.engine.plan_sig` is the Engine's compile-cache key: two
plans with equal signatures share one compiled artifact, so a signature
that fails to separate *semantically different* plans silently serves
wrong results from the cache.  This pass perturbs a plan one attribute
at a time — kernel parameters, value dtypes, key shapes, join-key
pairings, group-bys, placements (including the pending ``dup_kernel`` of
a two-phase aggregation), partial flags, tile/concat/pad geometry — and
asserts the signature separates every mutant from the original.  A
surviving collision is reported with the mutated node's provenance and
the exact attribute the signature drops.

The mutation enumeration is deterministic (no RNG): it is cheap enough
to run from tests and ``python -m repro_torch.analysis.lint``.  The
collision classes it found in the JAX package (pending ``dup_kernel``
missing from input-placement signatures; ad-hoc kernels distinguished
only by ``id(apply)``, which a recycled id can alias) are closed in the
port's ``engine.plan_sig`` too.  Value dtypes are ``torch`` dtypes here,
so the dtype mutation flips ``torch.float32`` and ``torch.float64``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Tuple

import torch

from repro_torch.analysis.diagnostics import Diagnostics
from repro_torch.core import plan as P
from repro_torch.core.kernels_registry import Kernel
from repro_torch.core.tra import RelType

PASS = "cachekey"


def _replace_node(root, target, replacement):
    """``root`` with ``target`` (by identity) swapped for ``replacement``;
    ancestors are rebuilt, untouched subtrees are shared."""
    memo = {}

    def rb(n):
        if id(n) in memo:
            return memo[id(n)]
        if n is target:
            out = replacement
        elif isinstance(n, (P.TraJoin, P.LocalJoin, P.FusedJoinAgg)):
            left, right = rb(n.left), rb(n.right)
            out = n if left is n.left and right is n.right \
                else dataclasses.replace(n, left=left, right=right)
        elif isinstance(n, (P.TraInput, P.IAInput, P.TraConst, P.IAConst)):
            out = n
        else:
            child = rb(n.child)
            out = n if child is n.child \
                else dataclasses.replace(n, child=child)
        memo[id(n)] = out
        return out

    return rb(root)


def _flip_dtype(rtype: RelType) -> RelType:
    new = torch.float64 if rtype.dtype == torch.float32 else torch.float32
    return RelType(rtype.key_shape, rtype.bound, new)


def _bump_key_shape(rtype: RelType) -> Optional[RelType]:
    if not rtype.key_shape:
        return None
    ks = (rtype.key_shape[0] + 1,) + rtype.key_shape[1:]
    return RelType(ks, rtype.bound, rtype.dtype)


def _shadow_kernel(k: Kernel) -> Kernel:
    """Same name, same ``apply`` identity, different ``out_bound`` — the
    ad-hoc-kernel collision class: only the out_bound content differs."""
    return dataclasses.replace(
        k, out_bound=lambda *bounds: tuple(k.out_bound(*bounds)))


def _mutate_placement(p: P.Placement) -> List[Tuple[str, P.Placement]]:
    out: List[Tuple[str, P.Placement]] = []
    if p.kind == "partitioned" and p.dims:
        out.append(("drop the partitioning (replicated instead of "
                    f"PART{list(p.dims)})", P.Placement.replicated()))
        if not p.dup_axes:
            out.append((f"mark pending duplicates along {p.axes[0]!r}",
                        P.Placement.partitioned(
                            p.dims, p.axes, dup_axes=(p.axes[0],),
                            dup_kernel="matAdd")))
    if p.dup_axes:
        other = "elemMax" if p.dup_kernel != "elemMax" else "matAdd"
        out.append((f"change the pending dup reducer "
                    f"{p.dup_kernel or 'matAdd'!r} -> {other!r}",
                    dataclasses.replace(p, dup_kernel=other)))
    return out


def node_mutations(n) -> Iterator[Tuple[str, object]]:
    """Yield ``(what changed, mutated node)`` for one plan node."""
    if isinstance(n, (P.TraInput, P.IAInput)):
        yield ("flip the input value dtype",
               dataclasses.replace(n, rtype=_flip_dtype(n.rtype)))
        bumped = _bump_key_shape(n.rtype)
        if bumped is not None:
            yield ("grow the input key frontier",
                   dataclasses.replace(n, rtype=bumped))
        if isinstance(n, P.IAInput):
            for what, pl in _mutate_placement(n.placement):
                yield (what, dataclasses.replace(n, placement=pl))
    elif isinstance(n, (P.TraConst, P.IAConst)):
        yield ("change the constant fill value",
               dataclasses.replace(n, fill=n.fill + 1.0))
        if isinstance(n, P.IAConst):
            for what, pl in _mutate_placement(n.placement):
                yield (what, dataclasses.replace(n, placement=pl))
    elif isinstance(n, (P.TraJoin, P.LocalJoin)):
        if len(n.join_keys_r) > 1:
            yield ("re-pair the join keys (reverse the right key order)",
                   dataclasses.replace(
                       n, join_keys_r=tuple(reversed(n.join_keys_r))))
        yield ("swap the join kernel's out_bound under the same name "
               "and apply",
               dataclasses.replace(n, kernel=_shadow_kernel(n.kernel)))
    elif isinstance(n, P.FusedJoinAgg):
        if len(n.join_keys_r) > 1:
            yield ("re-pair the fused join keys",
                   dataclasses.replace(
                       n, join_keys_r=tuple(reversed(n.join_keys_r))))
        if len(n.group_by) > 1:
            yield ("permute the fused group_by",
                   dataclasses.replace(
                       n, group_by=tuple(reversed(n.group_by))))
        yield ("flip the fused partial flag",
               dataclasses.replace(n, partial=not n.partial))
        yield ("swap the fused agg kernel's out_bound under the same "
               "name and apply",
               dataclasses.replace(n,
                                   agg_kernel=_shadow_kernel(n.agg_kernel)))
    elif isinstance(n, (P.TraAgg, P.LocalAgg)):
        if len(n.group_by) > 1:
            yield ("permute the group_by",
                   dataclasses.replace(n,
                                       group_by=tuple(reversed(n.group_by))))
        if isinstance(n, P.LocalAgg):
            yield ("flip the partial flag",
                   dataclasses.replace(n, partial=not n.partial))
        yield ("swap the agg kernel's out_bound under the same name "
               "and apply",
               dataclasses.replace(n, kernel=_shadow_kernel(n.kernel)))
    elif isinstance(n, P.TraTransform):
        yield ("swap the map kernel's out_bound under the same name "
               "and apply",
               dataclasses.replace(n, kernel=_shadow_kernel(n.kernel)))
    elif isinstance(n, (P.TraFilter, P.LocalFilter)):
        yield ("swap the filter predicate under the same tag",
               dataclasses.replace(n, bool_func=lambda k: True))
    elif isinstance(n, P.TraReKey):
        yield ("swap the key function under the same tag",
               dataclasses.replace(n, key_func=lambda k: k))
    elif isinstance(n, (P.TraTile, P.LocalTile)):
        yield ("double the tile size",
               dataclasses.replace(n, tile_size=n.tile_size * 2))
    elif isinstance(n, (P.TraConcat, P.LocalConcat)):
        yield ("move the concat array_dim",
               dataclasses.replace(n, array_dim=n.array_dim + 1))
    elif isinstance(n, (P.TraPad, P.LocalPad)):
        yield ("grow the pad target key_shape",
               dataclasses.replace(
                   n, key_shape=tuple(k + 1 for k in n.key_shape)))
    elif isinstance(n, P.Shuf):
        yield ("retarget the shuffle axes",
               dataclasses.replace(
                   n, axes=tuple(f"{a}'" for a in n.axes)))
    # Bcast carries no attributes beyond its child


def plan_mutations(root) -> Iterator[Tuple[str, object, object]]:
    """All single-attribute mutants of ``root``:
    ``(description, mutated_node, mutant_root)``."""
    root = P.as_node(root)
    for n in P.postorder(root):
        for what, repl in node_mutations(n):
            yield (f"{what} at {type(n).__name__}",
                   n, _replace_node(root, n, repl))


def check_sig_injectivity(roots, sig_fn: Optional[Callable] = None,
                          labels=None,
                          diags: Optional[Diagnostics] = None
                          ) -> Diagnostics:
    """Assert ``sig_fn`` separates every single-attribute mutant.

    ``sig_fn`` defaults to the engine's :func:`plan_sig`.  Each surviving
    collision is an error diagnostic naming the mutation and the node it
    perturbs — i.e. the attribute the signature fails to observe.
    """
    if sig_fn is None:
        from repro_torch.core.engine import plan_sig
        sig_fn = plan_sig
    if diags is None:
        diags = Diagnostics()
    if not isinstance(roots, (tuple, list)):
        roots = (roots,)
    if labels is None:
        from repro_torch.core.guards import label_nodes
        labels = label_nodes(roots)
    for root in roots:
        base = sig_fn(root)
        for what, node, mutant in plan_mutations(root):
            if sig_fn(mutant) == base:
                diags.add(
                    PASS, "error",
                    f"plan_sig collision: \"{what}\" leaves the "
                    f"signature unchanged — two structurally different "
                    f"plans would share one compile-cache artifact",
                    node=node, labels=labels,
                    hint="include the mutated attribute in that node "
                         "type's signature tuple in "
                         "repro_torch.core.engine.plan_sig")
    return diags


def check_cache_keys(ctx) -> None:
    """Pass body (lint/tests only — not part of the per-compile set)."""
    check_sig_injectivity(ctx.roots, labels=ctx.labels, diags=ctx.diags)
