"""Unified evaluation entry point for the TRA: the :class:`Engine`.

Port of ``repro.core.engine``.  One object owns everything between a
logical expression and a result:

* the **optimizer invocation** (cost-based placement DP + logical rewrites,
  including the fused Σ∘⋈ contraction selection);
* the **executor** choice:

  - ``"reference"`` — the eager recursive walk (logical plans run the dense
    eager ops; physical plans the sites-ignoring IA walk);
  - ``"jit"``       — the cached plan walk: at compile time the plan is
    flattened once into a schedule of node evaluations (postorder,
    shared nodes once), and every dispatch replays that schedule.  It is
    not ``torch.compile`` and captures no CUDA graph (a later slice);
  - ``"gspmd"``     — the same steps on every rank of a ``DeviceMesh``,
    each node's value a DTensor redistributed to its placement, DTensor
    choosing the collectives (:func:`repro_torch.core.interp.
    _jit_ia_plans`; requires ``mesh``);
  - ``"shard_map"`` — paper-faithful explicit collectives
    (:mod:`repro_torch.core.shardmap_exec`; requires ``mesh``);
  - ``"auto"``      — ``"gspmd"`` when a mesh is given, else ``"jit"``;

* a **keyed compile cache** — structurally identical expressions (same
  shapes, kernels, placements, executor) reuse the compiled artifact
  (``plan_sig`` with content fingerprints of kernel code, as in JAX), with
  ``pin`` / ``cache_info`` / ``cache_clear`` and ``cache_hits`` /
  ``cache_misses``;
* the **kernel registry view** (``engine.kernel(name)``).

``run``/``compile`` accept an :class:`~repro_torch.core.expr.Expr`, a raw
logical ``TraNode``, a physical ``IANode`` (run as is), a tuple of roots or
a dict of named roots (``run`` then returns ``{name: relation}``).  Input
values are :class:`TensorRelation`\\ s or raw tensors / numpy arrays of the
declared dense shape ``key_shape ++ bound``.

Deviations from the JAX ``Engine``:

* ``device`` (default ``"cuda"``) names where the engine runs: raw array
  inputs are placed there, constants are made there, and an input
  relation on another device is rejected rather than moved.  Without a
  card, the default raises; pass ``device="cpu"`` to run on the CPU.
* ``mesh`` is a ``torch.distributed`` ``DeviceMesh``
  (:func:`repro_torch.launch.mesh.make_mesh`) whose dimension names are
  the mesh axes.  Every rank runs the same program with the same engine
  and the same *global* inputs; the mesh executors take each rank's block
  by its input placement and return DTensor results (see
  :mod:`repro_torch.core.shardmap_exec`).  The engine's ``device``
  defaults to the mesh's device type.  A mesh engine's ``CompiledExpr``
  carries ``exchange``, the log of its last dispatch's collectives.
* The executor-fallback ladder of ``degrade`` treats the injected
  ``CompileFailure`` and ``NotImplementedError`` as compile failures (the
  port's ``_compile`` builds no kernel: a CUDA kernel is built at its
  first launch).  A mesh engine that falls back to ``jit`` or
  ``reference`` runs the whole program on every rank, on global inputs.
* A streamed artifact (``memory_budget``, ``HostRelation`` inputs) takes
  its inputs as they come — ``HostRelation``\\ s, numpy arrays, CPU or
  device tensors — and hands them to the stream executor untouched: a
  host input reaches the card one chunk at a time, never whole.  A
  resident artifact moves numpy inputs and materializes ``HostRelation``
  inputs on the engine's device.
* ``degrade``'s ladder lets go of a failed attempt's frames (and the
  tensors they hold) before the next rung starts: a real
  ``torch.OutOfMemoryError``'s traceback would otherwise keep them alive.
* ``fault_injector`` node hooks fire on every dispatch on ``jit`` too (it
  replays eager node evaluations; JAX fires them once, at trace time — see
  :mod:`repro_torch.core.faults`).  ``check_numerics`` on ``jit`` reads a
  dispatch's flags with one host sync, and its attribution re-run replays
  the dispatch's injected NaNs instead of consulting the injector again
  (see :mod:`repro_torch.core.guards`).
* The ``jit`` schedule runs structurally identical nodes of a program
  once, across roots too, and drops each value after its last reader
  (:func:`_schedule_call`): the work XLA's common subexpression
  elimination and buffer liveness do under ``jax.jit``.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import os
import traceback
import warnings
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis.inputs import (check_chunk, check_memory_budget,
                                         masked_inputs_error,
                                         missing_inputs_error,
                                         unexpected_inputs_error)
from repro_torch.core import kernels_registry as kr
from repro_torch.core.compile import compile_tra
from repro_torch.core.guards import (ExecContext, NumericsError,
                                     finite_flag, label_nodes)
from repro_torch.core.interp import (_evaluate_ia, _evaluate_tra,
                                     consumer_counts, eval_ia_node,
                                     eval_tra_node, fusable)
from repro_torch.core.optimize import OptimizeResult, optimize as _optimize
from repro_torch.core.plan import (IAInput, IANode, Placement, TraInput,
                                   TraNode, TypeInfo, as_node, children,
                                   describe, infer, postorder)
from repro_torch.core.tra import TensorRelation, global_data, is_dtensor
from repro_torch.device import DeviceLike, resolve_device

EXECUTORS = ("auto", "reference", "jit", "gspmd", "shard_map")
VALIDATE_MODES = ("off", "warn", "strict")

# graceful-degradation ladders (Engine(degrade=True)): on a *compile*
# failure of the preferred executor, fall back left-to-right; on a device
# OOM at *run* time, retry streamed through the host relation store, then
# on the chunked lowering with a halving chunk starting here
_EXECUTOR_FALLBACKS = {
    "shard_map": ("jit", "reference"),
    "gspmd": ("jit", "reference"),
    "jit": ("reference",),
}
MESH_EXECUTORS = ("gspmd", "shard_map")
DEFAULT_OOM_LADDER_START = 64


# ==========================================================================
# Structural plan signatures (compile-cache keys)
# ==========================================================================

# id(fn)-only signatures have a collision class: a kernel rebuilt after its
# predecessor was garbage-collected can reuse the exact id, and two kernels
# sharing one `apply` but differing in `out_bound` are distinct semantics
# under one id.  The content fingerprint below closes both; ids stay in the
# signature so live distinct objects never need a fingerprint comparison to
# separate.  Memoized per function *object* (weak keys — a GC'd function
# drops its entry, so a recycled id can never alias a stale fingerprint).
_code_fp_memo: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _code_fp(fn) -> str:
    """Content fingerprint of a callable (bytecode + consts + closure)."""
    try:
        return _code_fp_memo[fn]
    except (KeyError, TypeError):
        pass

    def feed(h, code):
        h.update(code.co_code)
        h.update(repr(code.co_names).encode())
        for c in code.co_consts:
            if hasattr(c, "co_code"):
                feed(h, c)              # nested lambdas/defs: hash content,
            else:                       # not their repr (which embeds ids)
                h.update(repr(c).encode())

    code = getattr(fn, "__code__", None)
    if code is None:
        # builtins / partials / callables: class + best-effort repr
        fp = f"{type(fn).__name__}:{getattr(fn, '__name__', repr(fn))}"
    else:
        h = hashlib.sha1()
        feed(h, code)
        for cell in getattr(fn, "__closure__", None) or ():
            try:
                h.update(repr(cell.cell_contents).encode())
            except Exception:
                h.update(b"?")
        fp = h.hexdigest()[:12]
    try:
        _code_fp_memo[fn] = fp
    except TypeError:
        pass                            # non-weakref-able callable
    return fp


def _kernel_sig(k) -> Tuple:
    # registered kernels are singletons and factory kernels embed their
    # parameters in the name (scaleMul(eta), ...); the id covers ad-hoc
    # kernels with colliding names, the content fingerprints cover id reuse
    # and shared-apply kernels (see _code_fp)
    return (k.name, id(k.apply), _code_fp(k.apply), _code_fp(k.out_bound))


def _func_sig(tag: str, fn) -> Tuple:
    # user key/bool functions are opaque — the tag plus identity keys them;
    # the fingerprint closes the id-reuse-after-GC collision
    return (tag, id(fn), _code_fp(fn))


def _local_sig(n, kids: Tuple) -> Tuple:
    """One node's signature, its children given as ``kids`` (references in
    :func:`children` order: back-references into a plan signature, or the
    ``jit`` schedule's value slots)."""
    from repro_torch.core import plan as P
    if isinstance(n, (P.TraInput, P.IAInput)):
        sig = ("in", n.name, n.rtype.key_shape, n.rtype.bound,
               str(n.rtype.dtype))
        if isinstance(n, P.IAInput):
            sig += (n.placement.kind, n.placement.dims,
                    n.placement.axes, n.placement.dup_axes,
                    n.placement.dup_kernel)
    elif isinstance(n, (P.TraConst, P.IAConst)):
        sig = ("const", n.rtype.key_shape, n.rtype.bound,
               str(n.rtype.dtype), n.fill)
        if isinstance(n, P.IAConst):
            sig += (n.placement.kind, n.placement.dims,
                    n.placement.axes, n.placement.dup_axes,
                    n.placement.dup_kernel)
    elif isinstance(n, (P.TraPad, P.LocalPad)):
        sig = ("pad", n.key_shape)
    elif isinstance(n, (P.TraJoin, P.LocalJoin)):
        sig = ("join", n.join_keys_l, n.join_keys_r, _kernel_sig(n.kernel))
    elif isinstance(n, P.FusedJoinAgg):
        sig = ("fja", n.join_keys_l, n.join_keys_r,
               _kernel_sig(n.join_kernel), n.group_by,
               _kernel_sig(n.agg_kernel), n.partial)
    elif isinstance(n, (P.TraAgg, P.LocalAgg)):
        sig = ("agg", n.group_by, _kernel_sig(n.kernel),
               getattr(n, "partial", False))
    elif isinstance(n, P.TraTransform):
        sig = ("map", _kernel_sig(n.kernel))
    elif isinstance(n, P.LocalMap):
        sig = ("lmap", _kernel_sig(n.kernel),
               None if n.key_func is None
               else _func_sig(n.tag, n.key_func))
    elif isinstance(n, (P.TraFilter, P.LocalFilter)):
        sig = ("filter", _func_sig(n.tag, n.bool_func))
    elif isinstance(n, P.TraReKey):
        sig = ("rekey", _func_sig(n.tag, n.key_func))
    elif isinstance(n, (P.TraTile, P.LocalTile)):
        sig = ("tile", n.tile_dim, n.tile_size)
    elif isinstance(n, (P.TraConcat, P.LocalConcat)):
        sig = ("concat", n.key_dim, n.array_dim)
    elif isinstance(n, P.Bcast):
        sig = ("bcast",)
    elif isinstance(n, P.Shuf):
        sig = ("shuf", n.part_dims, n.axes)
    else:
        raise TypeError(type(n))
    return sig + (kids,)


def plan_sig(node) -> Tuple:
    """Structural signature of a logical or physical plan (cache key)."""
    node = as_node(node)
    memo: Dict[int, int] = {}
    parts = []

    def rec(n) -> int:
        if id(n) in memo:               # shared subexpression → back-ref
            return memo[id(n)]
        sig = _local_sig(n, tuple(rec(c) for c in children(n)))
        memo[id(n)] = len(parts)
        parts.append(sig)
        return memo[id(n)]

    rec(node)
    return tuple(parts)


def _placements_sig(placements: Optional[Dict[str, Placement]]) -> Tuple:
    if not placements:
        return ()
    return tuple(sorted(
        (name, p.kind, p.dims, p.axes, p.dup_axes, p.dup_kernel or "")
        for name, p in placements.items()))


# ==========================================================================
# Compiled artifacts
# ==========================================================================

@dataclasses.dataclass
class CompiledExpr:
    """A compiled expression: physical plan (when one exists) + callable.

    ``__call__``/``run`` accept the program inputs by name and return
    :class:`TensorRelation` results (a tuple for multi-root programs, a
    dict for dict-compiled ones).
    """

    executor: str
    roots: Tuple                        # plan nodes (logical or physical)
    input_rtypes: Dict[str, object]
    out_infos: Tuple[TypeInfo, ...]
    _call: Callable                     # env dict -> tuple of TensorRelation
    device: torch.device
    opts: Tuple[OptimizeResult, ...] = ()   # one per optimizer-lowered root
    multi: bool = False                 # caller passed a tuple of roots
    # set for dict-compiled programs: run() returns {name: relation}
    root_names: Optional[Tuple[str, ...]] = None
    # stable process-local id ("<executor>:<sig digest>") assigned by the
    # engine at compile time; serving layers report which artifact served
    # a request by this id (see Engine.cache_info)
    artifact_id: Optional[str] = None
    # the engine's FaultInjector (run-scoped faults hook every dispatch)
    faults: Optional[object] = None
    # the same dispatch with no fault hook and no numerics check (warm())
    _bare: Optional[Callable] = None
    # set when Engine(degrade=True) fell back from a failed preferred
    # executor — names that executor so callers can see the degradation
    degraded_from: Optional[str] = None
    # out-of-core streamed artifacts (Engine(memory_budget=...)): inputs
    # may be host-resident (HostRelations, numpy, CPU tensors) and reach
    # the stream executor untouched
    streamed: bool = False
    stream_stats: Optional[object] = None   # metering.StreamStats
    # value_and_grad artifacts: the names differentiated against
    grad_wrt: Optional[Tuple[str, ...]] = None
    # mesh executors: the collectives of the last dispatch
    # (repro_torch.core.shardmap_exec.Exchange)
    exchange: Optional[object] = None

    @property
    def plan(self):
        """The (first) root plan node this artifact executes."""
        return self.roots[0]

    @property
    def opt(self) -> Optional[OptimizeResult]:
        """The optimizer result (single optimized root only)."""
        return self.opts[0] if len(self.opts) == 1 else None

    @property
    def cost(self) -> Optional[int]:
        """Comm cost of the optimizer's plan(s) — summed over roots."""
        return sum(o.cost for o in self.opts) if self.opts else None

    def describe(self) -> str:
        return "\n".join(describe(r) for r in self.roots)

    def run(self, **inputs) -> Union[TensorRelation, Tuple, Dict]:
        if self.faults is not None:
            self.faults.on_run()
        outs = self._call(self._env(inputs))
        if self.root_names is not None:
            return dict(zip(self.root_names, outs))
        return outs if self.multi else outs[0]

    def warm(self, **inputs) -> None:
        """Dispatch once as :meth:`run` does, but past the engine's fault
        injector and numerics guard: a serving warmup pays the device's
        first-run costs without spending the injector's run counts."""
        self._bare(self._env(inputs))

    def _env(self, inputs) -> Dict[str, TensorRelation]:
        unknown = [n for n in inputs if n not in self.input_rtypes]
        if unknown:
            raise unexpected_inputs_error(unknown, self.input_rtypes)
        env = {name: _coerce(name, val, self.input_rtypes[name], self.device,
                             keep_host=self.streamed,
                             mesh=self.executor in MESH_EXECUTORS)
               for name, val in inputs.items()}
        missing = [n for n in self.input_rtypes if n not in env]
        if missing:
            raise missing_inputs_error(missing, self.input_rtypes)
        if self.executor != "reference" and not self.streamed:
            # the jit schedule types its outputs from the compile-time
            # inference, so an input-side static mask would be dropped —
            # only the eager reference walk threads per-value masks
            holey = [n for n, r in env.items() if r.mask is not None]
            if holey:
                raise masked_inputs_error(self.executor, holey)
        return env

    __call__ = run


@dataclasses.dataclass
class _CacheSlot:
    """Internal compile-cache slot: artifact + per-entry accounting."""

    compiled: CompiledExpr
    hits: int = 0
    pinned: bool = False


@dataclasses.dataclass(frozen=True)
class CacheEntry:
    """One compile-cache entry as reported by :meth:`Engine.cache_info`.

    ``signature`` is the full structural cache key; ``artifact_id`` is its
    short digest — the id a serving layer logs per request.  ``degraded``
    marks artifacts cached by the ``Engine(degrade=True)`` executor-fallback
    ladder under the fallback executor's key.
    """

    artifact_id: str
    executor: str
    hits: int
    pinned: bool
    degraded: bool
    root_names: Optional[Tuple[str, ...]]
    signature: Tuple
    compiled: CompiledExpr
    # per-artifact out-of-core streaming counters
    # (repro_torch.launch.metering.StreamStats) for artifacts compiled
    # through the host relation store; None for resident artifacts
    stream_stats: Optional[object] = None


def _is_host_relation(value) -> bool:
    # duck-typed so the core layer does not import repro_torch.store
    return hasattr(value, "to_relation") and hasattr(value, "split_dim")


def _coerce(name: str, value, rtype, device: torch.device,
            keep_host: bool = False, mesh: bool = False):
    """An input as the artifact's walk takes it.  ``keep_host`` (streamed
    artifacts) hands host values — ``HostRelation``\\ s, numpy arrays, CPU
    tensors and relations — through untouched, after the same checks.  A
    DTensor (a mesh executor's result) reaches a mesh executor as it is
    and any other executor as its global tensor."""
    if not mesh:
        if isinstance(value, TensorRelation) and is_dtensor(value.data):
            value = TensorRelation(global_data(value.data), value.rtype,
                                   value.mask)
        elif is_dtensor(value):
            value = global_data(value)
    if _is_host_relation(value):
        if value.rtype != rtype:
            raise ValueError(
                f"input {name!r}: host relation type {value.rtype} != "
                f"declared {rtype}")
        return value if keep_host else value.to_relation(device)
    if isinstance(value, TensorRelation):
        if keep_host and value.data.device.type == "cpu":
            return value
        if value.data.device != device:
            raise ValueError(
                f"input {name!r} lies on {value.data.device}, the engine "
                f"runs on {device}; move it explicitly")
        return value
    if isinstance(value, torch.Tensor):
        if value.device != device and not (keep_host
                                           and value.device.type == "cpu"):
            raise ValueError(
                f"input {name!r} lies on {value.device}, the engine runs "
                f"on {device}; move it explicitly")
    elif isinstance(value, np.ndarray):
        if not keep_host:
            value = torch.as_tensor(value, dtype=rtype.dtype, device=device)
    else:
        raise TypeError(f"input {name!r}: expected a TensorRelation, tensor "
                        f"or numpy array, got {type(value).__name__}")
    expect = tuple(rtype.key_shape) + tuple(rtype.bound)
    if tuple(value.shape) != expect:
        raise ValueError(
            f"input {name!r}: dense shape {tuple(value.shape)} != "
            f"key_shape ++ bound {expect}")
    if keep_host:
        return value
    return TensorRelation(value, rtype)


def _input_nodes(roots) -> Dict[str, object]:
    """name -> rtype over all roots; duplicate names must agree."""
    rtypes: Dict[str, object] = {}
    for root in roots:
        for n in postorder(root):
            if isinstance(n, (TraInput, IAInput)):
                prev = rtypes.get(n.name)
                if prev is not None and prev != n.rtype:
                    raise ValueError(
                        f"input {n.name!r} declared with conflicting types "
                        f"{prev} vs {n.rtype}")
                rtypes[n.name] = n.rtype
    return rtypes


def schedule_steps(plans, fuse: bool):
    """Flatten ``plans`` once into ``(steps, drops, out_slots)``: the
    ``(node, child slots, fused)`` evaluations in postorder, the slots
    whose last reader each step is (dropped after it), and each plan's
    output slot.

    Logical plans get the eager walk's Σ∘⋈ fusion (a ``TraAgg`` over a
    single-consumer fusable ``TraJoin`` becomes one step over the join's
    operands); physical plans carry their ``FusedJoinAgg`` nodes already.

    Structurally identical nodes share one step, across roots too: each
    root of a multi-root program is optimized on its own, so a train step's
    eight roots hold eight copies of the forward pass, which XLA's common
    subexpression elimination merges under ``jax.jit`` in the JAX package.
    A step's value is dropped after its last reader has run (XLA's buffer
    liveness), unless it is an output.  The ``jit`` schedule and the mesh
    executors replay these steps.
    """
    consumers = consumer_counts(plans) if fuse else {}
    slot: Dict[int, int] = {}
    by_sig: Dict[Tuple, int] = {}
    steps = []

    def visit(n) -> int:
        if id(n) in slot:
            return slot[id(n)]
        fused = (fuse and not isinstance(n, IANode)
                 and fusable(n, consumers))
        operands = (n.child.left, n.child.right) if fused else children(n)
        kids = tuple(visit(c) for c in operands)
        sig = (_local_sig(n, kids) if not fused else
               ("fused", _local_sig(n.child, kids), _local_sig(n, ())))
        if sig not in by_sig:
            by_sig[sig] = len(steps)
            steps.append((n, kids, fused))
        slot[id(n)] = by_sig[sig]
        return slot[id(n)]

    out_slots = tuple(visit(p) for p in plans)
    keep = set(out_slots)
    last_read: Dict[int, int] = {}
    for i, (_, kids, _) in enumerate(steps):
        for k in kids:
            last_read[k] = i
    drops = [tuple(k for k in set(kids)
                   if last_read[k] == i and k not in keep)
             for i, (_, kids, _) in enumerate(steps)]
    return steps, drops, out_slots


def _schedule_call(plans, out_infos, device, fuse: bool, chunk,
                   budget=None) -> Callable:
    """The ``jit`` executor: the steps of :func:`schedule_steps`, replayed
    on every dispatch.  The returned ``call(env, ctx=None)`` passes every
    step's value through ``ctx.on_node`` when an active
    :class:`ExecContext` is given.
    """
    steps, drops, out_slots = schedule_steps(plans, fuse)

    def call(env, ctx=None):
        hook = ctx is not None and ctx.active
        vals = []
        for (n, kids, fused), drop in zip(steps, drops):
            if isinstance(n, (IAInput, TraInput)):
                val = env[n.name]
            elif isinstance(n, IANode):
                val = eval_ia_node(n, [vals[k] for k in kids], device, chunk,
                                   ctx, budget)
            else:
                val = eval_tra_node(n, [vals[k] for k in kids], device,
                                    fused=fused, chunk=chunk, ctx=ctx,
                                    budget=budget)
            vals.append(ctx.on_node(n, val) if hook else val)
            for k in drop:
                vals[k] = None
        return tuple(TensorRelation(vals[s].data, oi.rtype, oi.mask)
                     for s, oi in zip(out_slots, out_infos))

    return call


# ==========================================================================
# Engine
# ==========================================================================

class Engine:
    """Unified entry point: optimizer + executor + compile cache.

    Parameters
    ----------
    mesh:
        Optional ``DeviceMesh`` (:func:`repro_torch.launch.mesh.make_mesh`)
        for the distributed executors; its dimension names and sizes
        default ``site_axes`` and ``axis_sizes``.
    executor:
        ``"auto" | "reference" | "jit" | "gspmd" | "shard_map"``.
    optimize:
        ``True`` (default) runs the cost-based optimizer on logical roots
        (fused Σ∘⋈ selection included).  ``False`` walks the logical tree
        directly.
    device:
        Where the engine runs (default: the mesh's device type, else
        ``"cuda"``; raises without a card — pass ``"cpu"`` explicitly to
        run on the CPU).
    fuse:
        Only meaningful with ``optimize=False`` on logical walks: ``False``
        forces the unfused pair (the correctness oracle).
    input_placements / site_axes / axis_sizes / accounting /
    try_logical_rewrites:
        Optimizer configuration (1-site ``("sites",)`` by default).
    chunk:
        Grid slices gathered per step of the chunked fused-Σ∘⋈ lowering:
        ``"auto"`` (default, as in JAX) autotunes a per-shape value from
        the device memory budget (``memory_budget`` when given, else the
        card's memory, else the static ``tra.DEFAULT_CHUNK_BYTES`` — see
        :mod:`repro_torch.store.autotune`); ``None`` keeps the static
        bytes-based default; an int pins it.  ``compile(..., chunk=...)``
        overrides it per program.
    memory_budget:
        Optional device live-bytes budget enabling the out-of-core mode: at
        compile time the engine estimates each plan's peak live bytes
        (:func:`repro_torch.core.cost.plan_peak_bytes`) and routes
        over-budget single-root logical plans through the host relation
        store (:mod:`repro_torch.store`) — operands stream in key-range
        chunks, copied on a side stream while the previous chunk computes,
        instead of materializing resident.  Plans under budget run exactly
        as without it.
    store:
        Optional :class:`repro_torch.store.RelationStore` backing
        ``HostRelation`` inputs/outputs (one is created lazily when
        needed).  ``engine.store.put(name, rel)`` turns any relation into
        a host-resident handle accepted by ``run``.
    degrade:
        ``True`` enables graceful degradation: a device OOM (injected
        ``DeviceOOM`` or a real ``torch.OutOfMemoryError``) retries the
        expression streamed through the host relation store, then through
        a halving chunk ladder on the chunked lowering; a failed executor
        compile falls back ``jit → reference`` with one
        :class:`RuntimeWarning`.  Off by default — without it every
        failure propagates unchanged.
    validate:
        Static plan verification mode (:mod:`repro_torch.analysis`): on
        every compile-cache miss the post-optimization plans run the
        verifier passes (placement/exchange soundness, collective
        consistency, out-of-core streamability, memory-model audit).
        ``"warn"`` (default) emits one :class:`RuntimeWarning` carrying the
        rendered error diagnostics; ``"strict"`` raises
        :class:`repro_torch.analysis.PlanVerificationError` (a
        ``ValueError``) instead of handing the plan to the executor;
        ``"off"`` skips verification.  Defaults from the ``REPRO_VALIDATE``
        environment variable when unset.  The last run's findings — errors
        or not — are kept on ``engine.last_diagnostics``; a streamed
        refusal (:class:`~repro_torch.store.NotStreamable`) carries the
        streaming pass's per-candidate diagnostics unless ``"off"``.
    fault_injector:
        Optional :class:`repro_torch.core.faults.FaultInjector`: simulated
        site failures, device OOM, compile failures, stragglers and NaN
        poisoning fire at deterministic plan-addressable points.
    check_numerics:
        ``True`` adds finite checks; a NaN/Inf raises
        :class:`repro_torch.core.guards.NumericsError` naming the first
        producing plan node.  On ``jit`` the guard is two-tier: a dispatch
        flags its outputs (one host sync), and a trip re-runs the same
        inputs once with every node flagged to name the node.  ``"all"``
        flags every node in the dispatch itself.
    """

    def __init__(self, mesh=None, executor: str = "auto",
                 optimize: bool = True, *,
                 device: Optional[DeviceLike] = None,
                 input_placements: Optional[Dict[str, Placement]] = None,
                 site_axes: Optional[Sequence[str]] = None,
                 axis_sizes: Optional[Dict[str, int]] = None,
                 accounting: str = "wire",
                 try_logical_rewrites: bool = True,
                 fuse: bool = True,
                 chunk: Union[int, str, None] = "auto",
                 memory_budget: Optional[int] = None,
                 store=None,
                 fault_injector=None,
                 check_numerics=False,
                 degrade: bool = False,
                 validate: Optional[str] = None):
        if executor not in EXECUTORS:
            raise ValueError(
                f"unknown executor {executor!r}; choose from {EXECUTORS}")
        if validate is None:
            validate = os.environ.get("REPRO_VALIDATE", "warn")
        if validate not in VALIDATE_MODES:
            raise ValueError(
                f"unknown validate mode {validate!r}; "
                f"choose from {VALIDATE_MODES}")
        if check_numerics not in (False, True, "all"):
            raise ValueError(f"check_numerics must be False, True or 'all', "
                             f"got {check_numerics!r}")
        check_chunk(chunk)
        check_memory_budget(memory_budget)
        if device is None:
            device = "cuda" if mesh is None else mesh.device_type
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh's ranks compute on "
                             f"{mesh.device_type}, the engine on "
                             f"{self.device}")
        self.validate = validate
        # Diagnostics of the most recent verified compile (any severity)
        self.last_diagnostics = None
        self.mesh = mesh
        self.executor = executor
        self.optimize = optimize
        self.fuse = fuse
        self.chunk = chunk
        self.accounting = accounting
        self.try_logical_rewrites = try_logical_rewrites
        self.fault_injector = fault_injector
        self.check_numerics = check_numerics
        self.degrade = degrade
        # out-of-core mode: device live-bytes budget + host relation store
        self.memory_budget = memory_budget
        self._store_obj = store
        self.input_placements = dict(input_placements or {})
        if site_axes is None:
            site_axes = tuple(mesh.mesh_dim_names) if mesh is not None \
                else ("sites",)
        self.site_axes = tuple(site_axes)
        if axis_sizes is None:
            from repro_torch.core.interp import mesh_sizes
            sizes = mesh_sizes(mesh) if mesh is not None else {}
            axis_sizes = {a: sizes.get(a, 1) for a in self.site_axes}
        self.axis_sizes = dict(axis_sizes)
        self._cache: Dict[Tuple, _CacheSlot] = {}
        self.cache_hits = 0
        self.cache_misses = 0

    # -- host relation store (out-of-core tier) ---------------------------
    @property
    def store(self):
        """The engine's :class:`repro_torch.store.RelationStore` (lazy)."""
        if self._store_obj is None:
            from repro_torch.store import RelationStore
            self._store_obj = RelationStore()
        return self._store_obj

    # -- compile-cache introspection --------------------------------------
    def cache_info(self) -> Tuple[CacheEntry, ...]:
        """Per-entry view of the compile cache, in insertion order
        (``sum(e.hits for e in cache_info()) == engine.cache_hits``)."""
        return tuple(CacheEntry(
            artifact_id=slot.compiled.artifact_id or "?",
            executor=slot.compiled.executor,
            hits=slot.hits,
            pinned=slot.pinned,
            degraded=key[-1] == "degraded",
            root_names=slot.compiled.root_names,
            signature=key,
            compiled=slot.compiled,
            stream_stats=slot.compiled.stream_stats)
            for key, slot in self._cache.items())

    def pin(self, compiled: CompiledExpr) -> CompiledExpr:
        """Pin a compiled artifact: ``cache_clear()`` keeps it by default."""
        for slot in self._cache.values():
            if slot.compiled is compiled:
                slot.pinned = True
                return compiled
        raise ValueError(
            f"artifact {compiled.artifact_id!r} is not in this engine's "
            f"compile cache (compiled by another engine?)")

    def cache_clear(self, *, pinned: bool = False) -> int:
        """Drop cache entries; ``pinned=True`` also drops pinned ones.

        Returns the number of entries evicted.  Hit/miss counters are
        cumulative and unaffected.
        """
        if pinned:
            n = len(self._cache)
            self._cache.clear()
            return n
        keep = {k: s for k, s in self._cache.items() if s.pinned}
        n = len(self._cache) - len(keep)
        self._cache = keep
        return n

    # -- kernel registry view ---------------------------------------------
    @staticmethod
    def kernel(name: str) -> kr.Kernel:
        return kr.get_kernel(name)

    @staticmethod
    def kernels() -> Sequence[str]:
        return kr.registered_kernels()

    # -- entry points ------------------------------------------------------
    def run(self, expr, **inputs) -> Union[TensorRelation, Tuple, Dict]:
        """Compile (with caching) and execute in one call.

        With ``memory_budget`` set (or ``HostRelation`` inputs) a
        single-root logical expression is first considered for the
        out-of-core path: when its estimated peak live bytes exceed the
        budget it executes through the host relation store, streaming
        key-range chunks (:class:`repro_torch.store.StreamExecutor`);
        under-budget plans run resident exactly as without the budget.

        With ``degrade=True`` a device OOM (injected
        :class:`~repro_torch.core.faults.DeviceOOM` or a real
        ``torch.OutOfMemoryError``) walks a two-rung recovery ladder:
        first the whole expression is retried *streamed through the host
        relation store* (which bounds peak operand bytes); if that cannot
        apply or still OOMs, the fused Σ∘⋈ is forced onto the chunked
        lowering with a halving chunk ladder until a rung fits.  Each rung
        starts after the failed attempt's frames are cleared.
        """
        from repro_torch.core.guards import is_oom_error
        from repro_torch.store.stream import NotStreamable
        try:
            return self._dispatch(expr, inputs)
        except Exception as err:
            if not (self.degrade and is_oom_error(err)):
                raise
            _release(err)
        # rung 1: out-of-core streaming through the relation store —
        # bounds peak device bytes without shrinking the fused chunk
        warnings.warn(
            "device OOM in fused contraction; retrying streamed "
            "through the host relation store (out-of-core key-range "
            "chunks) before the last-resort chunked fallback",
            RuntimeWarning, stacklevel=2)
        try:
            return self._compile_streamed(expr, force=True).run(**inputs)
        except NotStreamable:
            pass
        except Exception as err:
            if not is_oom_error(err):
                raise
            _release(err)
        # rung 2: force the fused Σ∘⋈ onto its chunked lowering with a
        # halving chunk ladder
        start = self.chunk if isinstance(self.chunk, int) \
            else DEFAULT_OOM_LADDER_START
        warnings.warn(
            f"device OOM persists; degrading to the streamed chunked "
            f"fallback (halving chunk ladder from {start}) — consider a "
            f"smaller Engine(chunk=...), Engine(memory_budget=...), or "
            f"more device memory",
            RuntimeWarning, stacklevel=2)
        c = start
        while True:
            try:
                return self.compile(expr, chunk=c, _stream=True) \
                           .run(**inputs)
            except Exception as err:
                if not (is_oom_error(err) and c > 1):
                    raise
                _release(err)
            c = max(1, c // 2)

    def _dispatch(self, expr, inputs):
        """Route a ``run`` through the out-of-core path when applicable."""
        if self._streaming_applicable(expr, inputs):
            from repro_torch.store.stream import NotStreamable
            try:
                return self._compile_streamed(expr).run(**inputs)
            except NotStreamable:
                pass
        return self.compile(expr).run(**inputs)

    def _streaming_applicable(self, expr, inputs) -> bool:
        """Cheap pre-check: is the out-of-core path worth consulting?

        True when the engine has a memory budget or any input is a
        host-resident store handle, and the expression is a single-root
        logical plan.
        """
        if isinstance(expr, (dict, tuple, list)):
            return False
        if self._resolve_executor() in MESH_EXECUTORS:
            return False
        if not (self.memory_budget is not None
                or any(_is_host_relation(v) for v in inputs.values())):
            return False
        try:
            return isinstance(as_node(expr), TraNode)
        except TypeError:
            return False

    def _compile_streamed(self, expr, force: bool = False) -> CompiledExpr:
        """Compile ``expr`` as an out-of-core streamed artifact.

        Plans the expression through
        :class:`repro_torch.store.StreamExecutor` (raising
        :class:`repro_torch.store.NotStreamable` when the plan has no
        streamable axis, or — unless ``force`` — when it fits the budget
        resident) and caches a :class:`CompiledExpr` whose call runs the
        chunked schedule.  ``force`` (the degradation ladder's rung-1 knob)
        streams even plans the estimator judges resident.
        """
        from repro_torch.launch.metering import StreamStats
        from repro_torch.store.stream import NotStreamable, StreamExecutor
        if isinstance(expr, (dict, tuple, list)):
            raise NotStreamable("multi-root programs run resident")
        root = as_node(expr)
        if not isinstance(root, TraNode):
            raise NotStreamable("physical IA plans run resident")
        executor = self._resolve_executor()
        if executor in MESH_EXECUTORS:
            raise NotStreamable(
                "out-of-core streaming chunks compile on the host "
                "executors (reference/jit) only")
        key = ("streamed", plan_sig(root), executor, self.optimize,
               self.fuse, self.memory_budget, bool(force))
        hit = self._cache.get(key)
        if hit is not None:
            self.cache_hits += 1
            hit.hits += 1
            return hit.compiled
        se = StreamExecutor(self)
        try:
            splan = se.plan(root, force=force)
        except NotStreamable as err:
            if self.validate == "off":
                raise
            # the refusal gains the streaming pass's per-candidate
            # provenance; its type stays, so _dispatch's resident fallback
            # and the degrade ladder's rung 1 behave as before
            from repro_torch.analysis.streaming import explain_unstreamable
            diags = explain_unstreamable(root, budget=self.memory_budget,
                                         fuse=self.fuse, device=self.device)
            self.last_diagnostics = diags
            if diags.errors:
                raise NotStreamable(
                    f"{err}\n{diags.render(min_severity='warning')}"
                ) from err
            raise
        self.cache_misses += 1
        stats = StreamStats(mode=splan.mode, budget_bytes=splan.budget)

        def call(env):
            return (se.execute(splan, env, stats),)

        compiled = CompiledExpr(
            executor=f"{executor}+stream", roots=(root,),
            input_rtypes=_input_nodes((root,)),
            out_infos=(splan.out_info,), _call=call, device=self.device,
            _bare=call, streamed=True, stream_stats=stats)
        compiled.artifact_id = (
            f"{compiled.executor}:"
            f"{hashlib.sha1(repr(key).encode()).hexdigest()[:10]}")
        self._cache[key] = _CacheSlot(compiled)
        return compiled

    def compile(self, expr,
                input_placements: Optional[Dict[str, Placement]] = None,
                target: Optional[Placement] = None,
                chunk: Union[int, str, None] = None,
                _grad_wrt: Optional[Tuple[str, ...]] = None,
                _stream: bool = False) -> CompiledExpr:
        """Compile an expression for this engine's executor.

        ``input_placements`` (falling back to the engine-level default)
        seed the optimizer; ``target`` constrains the result placement;
        ``chunk`` overrides the engine-level fused-path chunk size.
        ``_stream`` (the OOM ladder's knob) forces the fused Σ∘⋈ onto the
        chunked lowering even for contraction kernel pairs.
        """
        check_chunk(chunk)
        chunk = self.chunk if chunk is None else chunk
        root_names = None
        if isinstance(expr, dict):
            # named multi-root program: run() returns {name: relation}
            root_names = tuple(expr)
            expr = tuple(expr.values())
        multi = isinstance(expr, (tuple, list))
        roots = tuple(as_node(e) for e in (expr if multi else (expr,)))
        placements = dict(self.input_placements)
        placements.update(input_placements or {})
        executor = self._resolve_executor()
        # the robustness fields are keyed because they are baked into the
        # compiled callable
        inj = self.fault_injector
        key = (tuple(plan_sig(r) for r in roots), executor, self.optimize,
               self.fuse, self.accounting, self.try_logical_rewrites,
               _placements_sig(placements),
               _placements_sig({"·": target} if target else None),
               multi, chunk, _grad_wrt, root_names, _stream,
               self.check_numerics, None if inj is None else id(inj))
        hit = self._cache.get(key)
        if hit is not None:
            self.cache_hits += 1
            hit.hits += 1
            return hit.compiled
        self.cache_misses += 1
        degraded_from = None
        try:
            compiled = self._compile(roots, placements, target, executor,
                                     multi, chunk, _stream)
        except Exception as err:
            compiled, executor, err2 = self._compile_degraded(
                err, roots, placements, target, executor, multi, chunk,
                _stream)
            if compiled is None:
                raise err2
            degraded_from = self._resolve_executor()
            # the degraded artifact is cached under the *fallback*
            # executor's key (plus a marker): the preferred key stays
            # vacant, so the next compile() retries the preferred executor
            # and a later successful compile is never shadowed
            key = key[:1] + (executor,) + key[2:] + ("degraded",)
        compiled.grad_wrt = _grad_wrt
        compiled.root_names = root_names
        compiled.faults = inj
        compiled.degraded_from = degraded_from
        compiled.artifact_id = (
            f"{compiled.executor}:"
            f"{hashlib.sha1(repr(key).encode()).hexdigest()[:10]}")
        self._cache[key] = _CacheSlot(compiled)
        return compiled

    def value_and_grad(self, expr, wrt, seed=None,
                       input_placements: Optional[Dict[str,
                                                       Placement]] = None,
                       chunk: Optional[int] = None) -> CompiledExpr:
        """Compile ``(expr, *d expr/d wrt)`` as one multi-output program.

        The gradient expressions are *derived* from the forward plan by
        :mod:`repro_torch.core.autodiff` and flow through the same
        optimizer/executor stack as any expression — the fused Σ∘⋈
        selection applies to backward plans too.  ``wrt`` is an input name
        (or input ``Expr``) or a list of them; ``seed`` is the output
        cotangent (default: ones — the gradient of the sum of every output
        entry).  The returned artifact's ``run`` yields
        ``(value, grad_0, grad_1, ...)`` in ``wrt`` order.
        """
        from repro_torch.core.autodiff import grad as _grad
        from repro_torch.core.expr import Expr, wrap
        if not isinstance(expr, Expr):
            expr = wrap(as_node(expr))
        wrt_list = list(wrt) if isinstance(wrt, (tuple, list)) else [wrt]
        grads = _grad(expr, wrt=wrt_list, seed=seed)
        names = tuple(w if isinstance(w, str) else w.node.name
                      for w in wrt_list)
        return self.compile((expr,) + tuple(grads),
                            input_placements=input_placements,
                            chunk=chunk, _grad_wrt=names)

    def _compile_degraded(self, err, roots, placements, target, executor,
                          multi, chunk, stream):
        """Walk the executor fallback ladder after a failed compile.

        Only *compile-class* failures degrade (the injected
        :class:`~repro_torch.core.faults.CompileFailure`,
        ``NotImplementedError`` from an executor's unsupported subset) —
        user errors such as shape ``ValueError`` propagate unchanged.
        Returns ``(compiled, executor, err)``; ``compiled`` is ``None``
        when no rung succeeded (re-raise ``err``).
        """
        from repro_torch.core.faults import CompileFailure

        def compile_class(e):
            return isinstance(e, (CompileFailure, NotImplementedError))

        ladder = _EXECUTOR_FALLBACKS.get(executor, ())
        if not self.degrade or not ladder or not compile_class(err):
            return None, executor, err
        for fb in ladder:
            try:
                compiled = self._compile(roots, placements, target, fb,
                                         multi, chunk, stream)
            except Exception as err2:
                if not compile_class(err2):
                    return None, executor, err2
                err = err2
                continue
            warnings.warn(
                f"executor {executor!r} failed to compile ({err}); "
                f"degraded to executor {fb!r} for this expression — fix "
                f"the {executor!r} failure to restore the preferred "
                f"executor (it is retried on the next compile)",
                RuntimeWarning, stacklevel=3)
            return compiled, fb, err
        return None, executor, err

    # -- internals ---------------------------------------------------------
    def _resolve_executor(self) -> str:
        if self.executor != "auto":
            return self.executor
        return "gspmd" if self.mesh is not None else "jit"

    def _physical_roots(self, roots, placements, target):
        """Lower logical roots to physical plans; pass IANodes through.

        Each logical root is optimized *independently*, as in the JAX
        package: cross-root DAG sharing survives only on the unoptimized
        logical walk.
        """
        phys, opts = [], []
        for r in roots:
            if isinstance(r, IANode):
                phys.append(r)
            elif self.optimize:
                opt = _optimize(
                    r, placements, site_axes=self.site_axes,
                    axis_sizes=self.axis_sizes, target=target,
                    try_logical_rewrites=self.try_logical_rewrites,
                    accounting=self.accounting)
                opts.append(opt)
                phys.append(opt.plan)
            else:
                phys.append(compile_tra(r, placements, self.site_axes))
        return tuple(phys), tuple(opts)

    def _make_ctx(self, plans, executor,
                  stream: bool = False) -> Optional[ExecContext]:
        """The :class:`ExecContext` threaded through the executor walks, or
        ``None`` when no robustness feature is active (the walks then run
        exactly as without one).  ``reference`` checks every node eagerly;
        ``jit`` flags nodes in the dispatch only under
        ``check_numerics="all"`` (``True`` flags outputs, and attributes on
        a lazily built re-run); the mesh executors get output checks only
        (per-node probes would perturb the collective schedule under
        test).  ``stream`` (the OOM ladder's rung 2) forces the fused Σ∘⋈
        onto the chunked lowering."""
        if executor == "reference":
            per_node = self.check_numerics
        elif executor == "jit":
            per_node = "all" if self.check_numerics == "all" else False
        else:
            per_node = False
        if self.fault_injector is None and not per_node and not stream:
            return None
        return ExecContext(faults=self.fault_injector, check=per_node,
                           labels=label_nodes(plans),
                           defer=executor == "jit", stream=stream)

    def _verify_compile(self, plans, executor, logical_roots) -> None:
        """Run the static verifier over the executor-bound plans.

        Called once per compile-cache miss (cache hits re-dispatch
        already-verified artifacts).  ``"warn"`` surfaces error
        diagnostics as one RuntimeWarning; ``"strict"`` raises
        :class:`~repro_torch.analysis.PlanVerificationError` before the
        executor's schedule is built.  All findings (any severity) are
        kept on ``self.last_diagnostics``.
        """
        if self.validate == "off":
            return
        from repro_torch.analysis.diagnostics import PlanVerificationError
        from repro_torch.analysis.manager import verify_plans
        diags = verify_plans(
            plans, executor=executor, axis_sizes=self.axis_sizes,
            memory_budget=self.memory_budget, fuse=self.fuse,
            logical_roots=logical_roots)
        self.last_diagnostics = diags
        if not diags.errors:
            return
        if self.validate == "strict":
            raise PlanVerificationError(diags)
        warnings.warn(
            f"plan verification found {len(diags.errors)} error(s) "
            f"(Engine(validate=\"warn\") — compiling anyway):\n"
            f"{diags.render(min_severity='warning')}",
            RuntimeWarning, stacklevel=4)

    def _compile(self, roots, placements, target, executor,
                 multi, chunk, stream: bool = False) -> CompiledExpr:
        if self.fault_injector is not None:
            self.fault_injector.on_compile(executor)
        if executor in MESH_EXECUTORS:
            return self._compile_mesh(roots, placements, target, executor,
                                      multi, chunk, stream)
        # logical roots run the eager TRA walk (optimized ones run the
        # physical walk), as in the JAX package
        if self.optimize or any(isinstance(r, IANode) for r in roots):
            plans, opts = self._physical_roots(roots, placements, target)
        else:
            plans, opts = roots, ()
        self._verify_compile(plans, executor, roots)
        out_infos = tuple(infer(p) for p in plans)
        device, fuse, budget = self.device, self.fuse, self.memory_budget
        ctx = self._make_ctx(plans, executor, stream)
        if executor == "reference":
            def walk(env, ctx):
                # shared subexpressions are evaluated once via the id-keyed
                # cache shared across roots
                if ctx is not None:
                    ctx.begin()
                cache: dict = {}
                return tuple(
                    _evaluate_ia(p, env, cache, device=device, chunk=chunk,
                                 ctx=ctx, budget=budget)
                    if isinstance(p, IANode) else
                    _evaluate_tra(p, env, cache, fuse=fuse, device=device,
                                  chunk=chunk, ctx=ctx, budget=budget)
                    for p in plans)

            def call(env):
                return walk(env, ctx)
        else:
            walk = _schedule_call(plans, out_infos, device, fuse, chunk,
                                  budget)
            call = self._jit_call(walk, plans, ctx)
        return CompiledExpr(executor, plans, _input_nodes(plans), out_infos,
                            call, device, opts, multi,
                            _bare=lambda env: walk(env, None))

    def _compile_mesh(self, roots, placements, target, executor, multi,
                      chunk, stream) -> CompiledExpr:
        """The ``gspmd`` / ``shard_map`` artifact: physical plans (the
        optimizer's, or Table 1's defaults with ``optimize=False``) built
        once into the executor's program; output finite checks under
        ``check_numerics``."""
        if self.mesh is None:
            raise ValueError(f"executor {executor!r} requires a mesh")
        plans, opts = self._physical_roots(roots, placements, target)
        self._verify_compile(plans, executor, roots)
        ctx = self._make_ctx(plans, executor, stream)
        kw = dict(chunk=chunk, budget=self.memory_budget, ctx=ctx,
                  device=self.device)
        if executor == "gspmd":
            from repro_torch.core.interp import _jit_ia_plans
            run, _, exchange = _jit_ia_plans(plans, self.mesh, **kw)
        else:
            from repro_torch.core.shardmap_exec import _build_shardmap
            run, _, _, exchange = _build_shardmap(plans, self.mesh, **kw)
        call = run
        if self.check_numerics:
            from repro_torch.core.guards import check_output_rel

            def call(env):
                outs = run(env)
                for i, r in enumerate(outs):
                    check_output_rel(r, f"output[{i}]")
                return outs
        compiled = CompiledExpr(executor, plans, _input_nodes(plans),
                                tuple(infer(p) for p in plans), call,
                                self.device, opts, multi, _bare=run)
        compiled.exchange = exchange
        return compiled

    def _jit_call(self, sched, plans, ctx) -> Callable:
        """The ``jit`` dispatch with its two-tier numerics guard.

        A checked dispatch gathers finite flags — its outputs' (``True``)
        or every node's (``"all"``) — and reads them with ONE host sync.
        When that trips under ``True``, the same inputs run once more with
        every node flagged, replaying the dispatch's injected NaNs, and the
        error names the first non-finite node in plan postorder.
        """
        check = self.check_numerics
        if not check:
            def plain(env):
                if ctx is not None:
                    ctx.begin()
                return sched(env, ctx)
            return plain
        labels = ctx.labels if ctx is not None else label_nodes(plans)

        def call(env):
            if ctx is not None:
                ctx.begin()
            outs = sched(env, ctx)
            if check == "all":
                pairs = ctx.take_flags()
            else:
                pairs = [(f"output[{i}]", finite_flag(r.data, r.mask))
                         for i, r in enumerate(outs)]
                pairs = [(la, fl) for la, fl in pairs if fl is not None]
            # one host sync for every flag of the dispatch
            if not pairs or bool(torch.stack([f for _, f in pairs]).all()):
                return outs
            if check != "all":
                poisoned = () if ctx is None else ctx.poisoned
                again = ExecContext(check="all", labels=labels, defer=True,
                                    stream=ctx is not None and ctx.stream,
                                    replay=frozenset(poisoned))
                sched(env, again)
                pairs = again.take_flags()
            for lab, fl in pairs:
                if not bool(fl):
                    raise NumericsError(
                        f"non-finite values first produced by node {lab} "
                        f"(jit finite-flags; plan postorder attribution)",
                        node_label=lab)
            raise NumericsError(
                "non-finite values in jit outputs (attribution re-run did "
                "not reproduce the failure)")

        return call


def _release(err: BaseException) -> None:
    """Let go of a failed attempt's frames before the ladder's next rung:
    the exception's traceback keeps every frame of the attempt, and with
    them the tensors it had allocated (a real ``torch.OutOfMemoryError``
    from a large product holds gigabytes that way)."""
    traceback.clear_frames(err.__traceback__)
    if isinstance(err, torch.OutOfMemoryError):
        gc.collect()
