"""Pass manager for the static plan verifier.

The verifier is a short, deterministic pipeline over one compiled
program's roots: every pass is a plain function ``(VerifyContext) ->
None`` that appends to ``ctx.diags``.  The manager owns pass ordering,
the shared type-inference cache, and the node-provenance table — all
passes address nodes by the :func:`repro_torch.core.guards.label_nodes` ids so
diagnostics, fault-injection selectors and numerics attribution agree on
what "node 7" means.

:func:`verify_plans` is the one-call entry the
:class:`~repro_torch.core.engine.Engine` uses on every compile (post
optimization, pre executor construction); ``python -m
repro_torch.analysis.lint`` drives the same manager over the program corpus.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.diagnostics import Diagnostics
from repro_torch.core.guards import label_nodes
from repro_torch.core.plan import TypeInfo, as_node, infer

# passes cheap enough (pure shape/placement walks) to run on every
# Engine compile; "cachekey" mutates and re-signs whole plans, so it
# runs from the lint CLI / tests instead
DEFAULT_COMPILE_PASSES = ("placement", "collectives", "streaming", "memory")
ALL_PASSES = DEFAULT_COMPILE_PASSES + ("cachekey",)


@dataclasses.dataclass
class VerifyContext:
    """Shared state threaded through every verifier pass.

    ``roots`` are the plans as handed to the executor (physical ``IANode``
    trees post-optimization, or logical ``TraNode`` trees on the
    unoptimized host walks); ``logical_roots`` are the pre-lowering
    logical roots when the caller still has them (the streaming pass
    analyses those — carrier legality is a logical-plan property).
    """

    roots: Tuple
    executor: str = "jit"
    axis_sizes: Dict[str, int] = dataclasses.field(default_factory=dict)
    memory_budget: Optional[int] = None
    fuse: bool = True
    logical_roots: Optional[Tuple] = None
    diags: Diagnostics = dataclasses.field(default_factory=Diagnostics)
    # id(node) -> (nid, label): plan_sig-postorder provenance over roots
    labels: Dict[int, Tuple[int, str]] = dataclasses.field(
        default_factory=dict)
    # id(node) -> TypeInfo, shared across passes (infer is cache-keyed)
    types: Dict[int, TypeInfo] = dataclasses.field(default_factory=dict)

    def type_of(self, node) -> TypeInfo:
        if id(node) not in self.types:
            infer(node, cache=self.types)
        return self.types[id(node)]


def _registry() -> Dict[str, Callable[[VerifyContext], None]]:
    from repro_torch.analysis.cachekey import check_cache_keys
    from repro_torch.analysis.collectives import check_collectives
    from repro_torch.analysis.memory import check_memory_model
    from repro_torch.analysis.placement import check_placements
    from repro_torch.analysis.streaming import check_streaming
    return {
        "placement": check_placements,
        "collectives": check_collectives,
        "streaming": check_streaming,
        "memory": check_memory_model,
        "cachekey": check_cache_keys,
    }


class PassManager:
    """Run an ordered list of verifier passes over one program."""

    def __init__(self, passes: Sequence[str] = DEFAULT_COMPILE_PASSES):
        registry = _registry()
        unknown = [p for p in passes if p not in registry]
        if unknown:
            raise ValueError(
                f"unknown verifier pass(es) {unknown}; "
                f"available: {sorted(registry)}")
        self.passes: List[Tuple[str, Callable]] = [
            (p, registry[p]) for p in passes]

    def run(self, ctx: VerifyContext) -> Diagnostics:
        if not ctx.labels:
            ctx.labels = label_nodes(ctx.roots)
        for name, fn in self.passes:
            try:
                fn(ctx)
            except Exception as exc:  # a crashing pass is itself a finding
                ctx.diags.add(
                    name, "error",
                    f"verifier pass crashed: {type(exc).__name__}: {exc}",
                    hint="this is a verifier bug — report it; the plan "
                         "itself may still be valid")
        return ctx.diags


def verify_plans(roots, *, executor: str = "jit",
                 axis_sizes: Optional[Dict[str, int]] = None,
                 memory_budget: Optional[int] = None,
                 fuse: bool = True,
                 logical_roots=None,
                 passes: Sequence[str] = DEFAULT_COMPILE_PASSES
                 ) -> Diagnostics:
    """Verify a program's plans; returns the collected diagnostics.

    This is the hook :meth:`repro_torch.core.engine.Engine.compile` calls once
    per cache miss (``validate="warn"``/``"strict"``): ``roots`` are the
    executor-bound plans, ``executor``/``axis_sizes``/``memory_budget``/
    ``fuse`` mirror the engine configuration so pass applicability (e.g.
    shard_map divisibility, streaming legality) matches what will
    actually execute.
    """
    if not isinstance(roots, (tuple, list)):
        roots = (roots,)
    roots = tuple(as_node(r) for r in roots)
    if logical_roots is not None:
        if not isinstance(logical_roots, (tuple, list)):
            logical_roots = (logical_roots,)
        logical_roots = tuple(as_node(r) for r in logical_roots)
    ctx = VerifyContext(
        roots=roots, executor=executor,
        axis_sizes=dict(axis_sizes or {}), memory_budget=memory_budget,
        fuse=fuse, logical_roots=logical_roots)
    return PassManager(passes).run(ctx)
