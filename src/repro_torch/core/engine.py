"""Unified evaluation entry point for the TRA: the :class:`Engine`.

Port of ``repro.core.engine`` for one device.  One object owns everything
between a logical expression and a result:

* the **optimizer invocation** (cost-based placement DP + logical rewrites,
  including the fused Σ∘⋈ contraction selection);
* the **executor** choice:

  - ``"reference"`` — the eager recursive walk (logical plans run the dense
    eager ops; physical plans the sites-ignoring IA walk);
  - ``"jit"``       — the cached plan walk: at compile time the plan is
    flattened once into a schedule of node evaluations (postorder,
    shared nodes once), and every dispatch replays that schedule.  It is
    not ``torch.compile`` and captures no CUDA graph (a later slice);
  - ``"auto"``      — ``"jit"`` (there is no mesh in this slice);

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
* ``validate`` accepts only ``"off"``, its default: the static verifier
  (``repro.analysis``) is a later slice (4).
* ``mesh`` and the ``gspmd``/``shard_map`` executors (slice 7),
  ``memory_budget``/``store`` (slice 6), ``fault_injector``,
  ``check_numerics`` and ``degrade`` (slice 5), and ``value_and_grad``
  (slice 2) raise ``NotImplementedError`` when set or called.
* There is no ``chunk`` argument: it only steers the chunked fused
  lowering and the out-of-core autotuner, neither ported yet.
"""
from __future__ import annotations

import dataclasses
import hashlib
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import kernels_registry as kr
from repro_torch.core.compile import compile_tra
from repro_torch.core.interp import (_evaluate_ia, _evaluate_tra,
                                     consumer_counts, eval_ia_node,
                                     eval_tra_node, fusable)
from repro_torch.core.optimize import OptimizeResult, optimize as _optimize
from repro_torch.core.plan import (IAInput, IANode, Placement, TraInput,
                                   TypeInfo, as_node, children, describe,
                                   infer, postorder)
from repro_torch.core.tra import TensorRelation
from repro_torch.device import DeviceLike, resolve_device

EXECUTORS = ("auto", "reference", "jit", "gspmd", "shard_map")
VALIDATE_MODES = ("off", "warn", "strict")


def _not_ported(what: str, slice_no: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (slice {slice_no}; see "
        f"ROADMAP.md)")


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


def plan_sig(node) -> Tuple:
    """Structural signature of a logical or physical plan (cache key)."""
    node = as_node(node)
    memo: Dict[int, int] = {}
    parts = []

    def rec(n) -> int:
        if id(n) in memo:               # shared subexpression → back-ref
            return memo[id(n)]
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
            sig = ("pad", rec(n.child), n.key_shape)
        elif isinstance(n, (P.TraJoin, P.LocalJoin)):
            sig = ("join", rec(n.left), rec(n.right), n.join_keys_l,
                   n.join_keys_r, _kernel_sig(n.kernel))
        elif isinstance(n, P.FusedJoinAgg):
            sig = ("fja", rec(n.left), rec(n.right), n.join_keys_l,
                   n.join_keys_r, _kernel_sig(n.join_kernel), n.group_by,
                   _kernel_sig(n.agg_kernel), n.partial)
        elif isinstance(n, (P.TraAgg, P.LocalAgg)):
            sig = ("agg", rec(n.child), n.group_by, _kernel_sig(n.kernel),
                   getattr(n, "partial", False))
        elif isinstance(n, P.TraTransform):
            sig = ("map", rec(n.child), _kernel_sig(n.kernel))
        elif isinstance(n, P.LocalMap):
            sig = ("lmap", rec(n.child), _kernel_sig(n.kernel),
                   None if n.key_func is None
                   else _func_sig(n.tag, n.key_func))
        elif isinstance(n, (P.TraFilter, P.LocalFilter)):
            sig = ("filter", rec(n.child), _func_sig(n.tag, n.bool_func))
        elif isinstance(n, P.TraReKey):
            sig = ("rekey", rec(n.child), _func_sig(n.tag, n.key_func))
        elif isinstance(n, (P.TraTile, P.LocalTile)):
            sig = ("tile", rec(n.child), n.tile_dim, n.tile_size)
        elif isinstance(n, (P.TraConcat, P.LocalConcat)):
            sig = ("concat", rec(n.child), n.key_dim, n.array_dim)
        elif isinstance(n, P.Bcast):
            sig = ("bcast", rec(n.child))
        elif isinstance(n, P.Shuf):
            sig = ("shuf", rec(n.child), n.part_dims, n.axes)
        else:
            raise TypeError(type(n))
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
        unknown = [n for n in inputs if n not in self.input_rtypes]
        if unknown:
            raise ValueError(f"unexpected inputs: {unknown}; expected "
                             f"{sorted(self.input_rtypes)}")
        env = {name: _coerce(name, val, self.input_rtypes[name], self.device)
               for name, val in inputs.items()}
        missing = [n for n in self.input_rtypes if n not in env]
        if missing:
            raise ValueError(f"missing inputs: {missing}; expected "
                             f"{sorted(self.input_rtypes)}")
        if self.executor != "reference":
            # the jit schedule types its outputs from the compile-time
            # inference, so an input-side static mask would be dropped —
            # only the eager reference walk threads per-value masks
            holey = [n for n, r in env.items() if r.mask is not None]
            if holey:
                raise NotImplementedError(
                    f"executor {self.executor!r} requires continuous "
                    f"(mask-free) input relations; inputs {holey} carry "
                    f"masks — run on executor=\"reference\", or express "
                    f"the filter inside the plan")
        outs = self._call(env)
        if self.root_names is not None:
            return dict(zip(self.root_names, outs))
        return outs if self.multi else outs[0]

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
    is always False in this slice (no degradation ladder yet).
    """

    artifact_id: str
    executor: str
    hits: int
    pinned: bool
    degraded: bool
    root_names: Optional[Tuple[str, ...]]
    signature: Tuple
    compiled: CompiledExpr


def _coerce(name: str, value, rtype, device: torch.device) -> TensorRelation:
    if isinstance(value, TensorRelation):
        if value.data.device != device:
            raise ValueError(
                f"input {name!r} lies on {value.data.device}, the engine "
                f"runs on {device}; move it explicitly")
        return value
    if isinstance(value, torch.Tensor):
        if value.device != device:
            raise ValueError(
                f"input {name!r} lies on {value.device}, the engine runs "
                f"on {device}; move it explicitly")
    elif isinstance(value, np.ndarray):
        value = torch.as_tensor(value, dtype=rtype.dtype, device=device)
    else:
        raise TypeError(f"input {name!r}: expected a TensorRelation, tensor "
                        f"or numpy array, got {type(value).__name__}")
    expect = tuple(rtype.key_shape) + tuple(rtype.bound)
    if tuple(value.shape) != expect:
        raise ValueError(
            f"input {name!r}: dense shape {tuple(value.shape)} != "
            f"key_shape ++ bound {expect}")
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


def _schedule_call(plans, out_infos, device, fuse: bool) -> Callable:
    """The ``jit`` executor: flatten the plans once into a list of
    ``(node, child slots, fused)`` steps, replayed on every dispatch.

    Logical plans get the eager walk's Σ∘⋈ fusion (a ``TraAgg`` over a
    single-consumer fusable ``TraJoin`` becomes one step over the join's
    operands); physical plans carry their ``FusedJoinAgg`` nodes already.
    """
    consumers = consumer_counts(plans) if fuse else {}
    slot: Dict[int, int] = {}
    steps = []

    def visit(n) -> int:
        if id(n) in slot:
            return slot[id(n)]
        fused = (fuse and not isinstance(n, IANode)
                 and fusable(n, consumers))
        operands = (n.child.left, n.child.right) if fused else children(n)
        kids = tuple(visit(c) for c in operands)
        slot[id(n)] = len(steps)
        steps.append((n, kids, fused))
        return slot[id(n)]

    out_slots = tuple(visit(p) for p in plans)

    def call(env):
        vals = []
        for n, kids, fused in steps:
            if isinstance(n, (IAInput, TraInput)):
                vals.append(env[n.name])
            elif isinstance(n, IANode):
                vals.append(eval_ia_node(n, [vals[k] for k in kids], device))
            else:
                vals.append(eval_tra_node(n, [vals[k] for k in kids], device,
                                          fused=fused))
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
        Must be ``None`` in this slice (the distributed executors come in
        slice 7).
    executor:
        ``"auto" | "reference" | "jit"`` (``"gspmd"``/``"shard_map"``
        raise ``NotImplementedError``).
    optimize:
        ``True`` (default) runs the cost-based optimizer on logical roots
        (fused Σ∘⋈ selection included).  ``False`` walks the logical tree
        directly.
    device:
        Where the engine runs (default ``"cuda"``; raises without a card —
        pass ``"cpu"`` explicitly to run on the CPU).
    fuse:
        Only meaningful with ``optimize=False`` on logical walks: ``False``
        forces the unfused pair (the correctness oracle).
    input_placements / site_axes / axis_sizes / accounting /
    try_logical_rewrites:
        Optimizer configuration (1-site ``("sites",)`` by default).
    validate:
        ``"off"`` only (the default here; the verifier is slice 4).
    memory_budget / store / fault_injector / check_numerics / degrade:
        Not ported yet; setting any raises ``NotImplementedError``.
    """

    def __init__(self, mesh=None, executor: str = "auto",
                 optimize: bool = True, *,
                 device: DeviceLike = "cuda",
                 input_placements: Optional[Dict[str, Placement]] = None,
                 site_axes: Optional[Sequence[str]] = None,
                 axis_sizes: Optional[Dict[str, int]] = None,
                 accounting: str = "wire",
                 try_logical_rewrites: bool = True,
                 fuse: bool = True,
                 memory_budget: Optional[int] = None,
                 store=None,
                 fault_injector=None,
                 check_numerics=False,
                 degrade: bool = False,
                 validate: str = "off"):
        if executor not in EXECUTORS:
            raise ValueError(
                f"unknown executor {executor!r}; choose from {EXECUTORS}")
        if executor in ("gspmd", "shard_map") or mesh is not None:
            raise _not_ported("the mesh and the gspmd/shard_map executors",
                              7)
        if validate not in VALIDATE_MODES:
            raise ValueError(
                f"unknown validate mode {validate!r}; "
                f"choose from {VALIDATE_MODES}")
        if validate != "off":
            raise _not_ported(f"Engine(validate={validate!r})", 4)
        if memory_budget is not None or store is not None:
            raise _not_ported("the out-of-core tier (memory_budget, store)",
                              6)
        if fault_injector is not None or check_numerics or degrade:
            raise _not_ported(
                "fault injection, check_numerics and degrade", 5)
        self.device = resolve_device(device)
        self.validate = validate
        self.mesh = None
        self.executor = executor
        self.optimize = optimize
        self.fuse = fuse
        self.accounting = accounting
        self.try_logical_rewrites = try_logical_rewrites
        self.input_placements = dict(input_placements or {})
        self.site_axes = tuple(site_axes or ("sites",))
        self.axis_sizes = dict(axis_sizes or {a: 1 for a in self.site_axes})
        self._cache: Dict[Tuple, _CacheSlot] = {}
        self.cache_hits = 0
        self.cache_misses = 0

    # -- compile-cache introspection --------------------------------------
    def cache_info(self) -> Tuple[CacheEntry, ...]:
        """Per-entry view of the compile cache, in insertion order
        (``sum(e.hits for e in cache_info()) == engine.cache_hits``)."""
        return tuple(CacheEntry(
            artifact_id=slot.compiled.artifact_id or "?",
            executor=slot.compiled.executor,
            hits=slot.hits,
            pinned=slot.pinned,
            degraded=False,
            root_names=slot.compiled.root_names,
            signature=key,
            compiled=slot.compiled) for key, slot in self._cache.items())

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
        """Compile (with caching) and execute in one call."""
        return self.compile(expr).run(**inputs)

    def compile(self, expr,
                input_placements: Optional[Dict[str, Placement]] = None,
                target: Optional[Placement] = None) -> CompiledExpr:
        """Compile an expression for this engine's executor.

        ``input_placements`` (falling back to the engine-level default)
        seed the optimizer; ``target`` constrains the result placement.
        """
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
        key = (tuple(plan_sig(r) for r in roots), executor, self.optimize,
               self.fuse, self.accounting, self.try_logical_rewrites,
               _placements_sig(placements),
               _placements_sig({"·": target} if target else None),
               multi, root_names)
        hit = self._cache.get(key)
        if hit is not None:
            self.cache_hits += 1
            hit.hits += 1
            return hit.compiled
        self.cache_misses += 1
        compiled = self._compile(roots, placements, target, executor, multi)
        compiled.root_names = root_names
        compiled.artifact_id = (
            f"{compiled.executor}:"
            f"{hashlib.sha1(repr(key).encode()).hexdigest()[:10]}")
        self._cache[key] = _CacheSlot(compiled)
        return compiled

    def value_and_grad(self, expr, wrt, seed=None, input_placements=None):
        """Value and plan-level gradients — not ported yet (slice 2)."""
        raise _not_ported("Engine.value_and_grad", 2)

    # -- internals ---------------------------------------------------------
    def _resolve_executor(self) -> str:
        return "jit" if self.executor == "auto" else self.executor

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

    def _compile(self, roots, placements, target, executor,
                 multi) -> CompiledExpr:
        # logical roots run the eager TRA walk (optimized ones run the
        # physical walk), as in the JAX package
        if self.optimize or any(isinstance(r, IANode) for r in roots):
            plans, opts = self._physical_roots(roots, placements, target)
        else:
            plans, opts = roots, ()
        out_infos = tuple(infer(p) for p in plans)
        device, fuse = self.device, self.fuse
        if executor == "reference":
            def call(env):
                # shared subexpressions are evaluated once via the id-keyed
                # cache shared across roots
                cache: dict = {}
                return tuple(
                    _evaluate_ia(p, env, cache, device)
                    if isinstance(p, IANode) else
                    _evaluate_tra(p, env, cache, fuse=fuse, device=device)
                    for p in plans)
        else:
            call = _schedule_call(plans, out_infos, device, fuse)
        return CompiledExpr(executor, plans, _input_nodes(plans), out_infos,
                            call, device, opts, multi)
