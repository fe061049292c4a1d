"""Lazy expression frontend for the TRA — the user-facing API.

Port of ``repro.core.expr``.  Builders (``input``, ``const``, ``join``,
``agg``, ``map``, ``@``, ``+``/``-``/``*``, ``scale_by``, ``slot_update``,
``grad``, ``einsum``, ``describe`` …) are unchanged apart from torch dtypes.

The paper's point is that the TRA is *declarative*: a computation written
once against the logical algebra can be re-optimized and retargeted across
back-ends.  :class:`Expr` makes that the ergonomic default.  An ``Expr`` is
a thin immutable handle over a logical :class:`~repro_torch.core.plan.TraNode`
with

* **method chaining / operator overloading** — ``A.join(B, on=...).agg(...)``,
  ``A @ B`` for the §5.1 matmul pattern, ``A + B`` / ``A - B`` / ``A * B``
  for keywise elementwise joins;
* **eager type inference** — every constructor runs the exact static
  type/frontier/mask inference at *build* time, so shape mistakes raise
  where the expression is written, not where it is run;
* **true DAG sharing** — reusing one ``Expr`` in several places reuses the
  same underlying node, and every executor caches by node identity, so a
  shared subexpression is evaluated exactly once per run.

Expressions carry no data and no executor: pair them with
:class:`repro_torch.core.engine.Engine`, whose ``run``/``compile`` are the
only two evaluation entry points.

    >>> import repro_torch.core as tra
    >>> A = tra.input("A", key_shape=(4, 4), bound=(16, 24))
    >>> B = tra.input("B", key_shape=(4, 4), bound=(24, 12))
    >>> C = A @ B                       # Σ_(⟨0,2⟩,+) ∘ ⋈_(⟨1⟩,⟨0⟩,matMul)
    >>> tra.Engine(device="cuda").run(C, A=RA, B=RB)

``einsum`` builds through the same constructors, so every frontend —
fluent, operator, Einstein notation — lands on one optimizer entry path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple, Union

import torch

from repro_torch.core.kernels_registry import Kernel, get_kernel
from repro_torch.core.plan import (TraAgg, TraConcat, TraConst, TraFilter,
                                   TraInput, TraJoin, TraNode, TraPad,
                                   TraReKey, TraTile, TraTransform, TypeInfo,
                                   infer)
from repro_torch.core.tra import RelType

KernelLike = Union[Kernel, str]


def _kern(k: KernelLike) -> Kernel:
    return get_kernel(k) if isinstance(k, str) else k


class ExprTypeError(TypeError):
    """Build-time type/shape error in an Expr constructor."""


def _describe_rtype(info: TypeInfo) -> str:
    return f"f={info.rtype.key_shape} b={info.rtype.bound}"


@dataclasses.dataclass(frozen=True)
class Expr:
    """Immutable lazy handle over a logical TRA plan node.

    ``node`` is the wrapped :class:`TraNode`; ``info`` its eagerly inferred
    :class:`TypeInfo` (exact key frontier, bound, static mask).  Building
    an invalid expression raises :class:`ExprTypeError` immediately.
    """

    node: TraNode
    info: TypeInfo

    # -- introspection -----------------------------------------------------
    @property
    def rtype(self) -> RelType:
        return self.info.rtype

    @property
    def key_shape(self) -> Tuple[int, ...]:
        return self.info.rtype.key_shape

    @property
    def bound(self) -> Tuple[int, ...]:
        return self.info.rtype.bound

    @property
    def key_arity(self) -> int:
        return self.info.rtype.key_arity

    def describe(self) -> str:
        from repro_torch.core.plan import describe
        return describe(self.node)

    def __repr__(self) -> str:
        return (f"Expr<{type(self.node).__name__} "
                f"{_describe_rtype(self.info)}>")

    # -- algebra -----------------------------------------------------------
    def join(self, other: "Expr",
             on: Union[Sequence[int], Tuple[Sequence[int], Sequence[int]]],
             kernel: KernelLike) -> "Expr":
        """⋈_(on, kernel)(self, other).

        ``on`` is either one key-dim list shared by both sides or a
        ``(left_dims, right_dims)`` pair.
        """
        other = _as_expr(other)
        if (len(on) == 2 and on and not isinstance(on[0], int)):
            jkl, jkr = tuple(on[0]), tuple(on[1])
        else:
            jkl = jkr = tuple(on)          # type: ignore[arg-type]
        return _build(TraJoin(self.node, other.node, jkl, jkr, _kern(kernel)),
                      "join", self, other)

    def agg(self, group_by: Sequence[int],
            kernel: KernelLike = "matAdd") -> "Expr":
        """Σ_(group_by, kernel)(self)."""
        return _build(TraAgg(self.node, tuple(group_by), _kern(kernel)),
                      "agg", self)

    def sum(self, *group_by: int) -> "Expr":
        """Shorthand for ``agg(group_by, "matAdd")``."""
        return self.agg(group_by, "matAdd")

    def rekey(self, key_func: Callable, tag: str = "keyFunc") -> "Expr":
        return _build(TraReKey(self.node, key_func, tag), "rekey", self)

    def filter(self, bool_func: Callable, tag: str = "boolFunc") -> "Expr":
        return _build(TraFilter(self.node, bool_func, tag), "filter", self)

    def map(self, kernel: KernelLike) -> "Expr":
        """λ_(kernel)(self) — apply a unary kernel to every array."""
        return _build(TraTransform(self.node, _kern(kernel)), "map", self)

    transform = map

    def tile(self, tile_dim: int, tile_size: int) -> "Expr":
        return _build(TraTile(self.node, tile_dim, tile_size), "tile", self)

    def concat(self, key_dim: int, array_dim: int) -> "Expr":
        return _build(TraConcat(self.node, key_dim, array_dim),
                      "concat", self)

    def pad(self, key_shape: Sequence[int]) -> "Expr":
        """Pad_(keyShape)(self) — densify to the full key grid (the dual
        of σ: holes become zero tuples, the frontier grows)."""
        return _build(TraPad(self.node, tuple(key_shape)), "pad", self)

    def scale_by(self, scalar: "Expr") -> "Expr":
        """Multiply every array by a *scalar relation* (key ``(1,)``,
        bound ``(1, 1)``).

        The scalar joins in on no key dims (a broadcast join with the
        ``scaleBy`` kernel) and the appended singleton key dim is
        aggregated away.  This is how per-step scalars — Adam bias
        corrections, learning-rate schedules — thread through a compiled
        train-step program as *data* instead of kernel constants, so one
        compiled artifact serves every step (see
        :mod:`repro_torch.core.train`).
        """
        scalar = _as_expr(scalar)
        if scalar.key_shape != (1,) or scalar.bound != (1, 1):
            raise ExprTypeError(
                f"scale_by needs a scalar relation (key (1,), bound "
                f"(1, 1) — tra.scalar / tra.scalar_input), got "
                f"{_describe_rtype(scalar.info)}")
        k = self.key_arity
        j = self.join(scalar, on=((), ()), kernel="scaleBy")
        return j.agg(tuple(range(k)), "matAdd")

    def slot_update(self, rows: "Expr", mask: "Expr") -> "Expr":
        """Masked in-plan slot update: ``mask·rows + (1−mask)·self``.

        The carrier of continuous-batching decode state
        (:mod:`repro_torch.serve`): ``self`` is a fixed-capacity slot-keyed
        state relation, ``rows`` the freshly computed per-slot values
        (keyed identically), and ``mask`` an activity relation over the
        same key grid with ``(1, 1)`` blocks — ``1.0`` rows take the new
        value, ``0.0`` rows keep the old state unchanged.  Built from
        keywise ``scaleBy`` joins and a ``matAdd`` — no new plan node, so
        every executor, the optimizer, and autodiff see plain algebra.
        """
        rows = _as_expr(rows)
        mask = _as_expr(mask)
        if rows.key_shape != self.key_shape:
            raise ExprTypeError(
                f"slot_update: rows key grid {rows.key_shape} != state "
                f"key grid {self.key_shape}")
        if mask.key_shape != self.key_shape or mask.bound != (1, 1):
            raise ExprTypeError(
                f"slot_update: mask must be keyed {self.key_shape} with "
                f"(1, 1) blocks, got {_describe_rtype(mask.info)}")
        on = tuple(range(self.key_arity))
        inv = const(1.0, mask.key_shape, mask.bound, mask.rtype.dtype) - mask
        take = rows.join(mask, on=on, kernel="scaleBy")
        keep = self.join(inv, on=on, kernel="scaleBy")
        return take + keep

    # -- differentiation ---------------------------------------------------
    def grad(self, wrt, seed: "Expr" = None):
        """Cotangent expression(s) of ``self`` w.r.t. input(s) ``wrt``.

        The backward graph is derived from this expression's plan by
        :mod:`repro_torch.core.autodiff` and is itself an ``Expr`` DAG —
        run it on any executor, optimizer fusion included.  ``wrt`` is an
        input name / input ``Expr`` (returns one ``Expr``) or a sequence of
        them (returns a tuple); ``seed`` overrides the default ones
        cotangent (∂Σ(out)/∂out).

            >>> z = (x @ w).map("relu")
            >>> dw = z.grad("W")                  # d Σ(relu(x@w)) / dW
        """
        from repro_torch.core.autodiff import grad as _grad
        single = isinstance(wrt, (str, Expr))
        outs = _grad(self, [wrt] if single else list(wrt), seed=seed)
        return outs[0] if single else outs

    # -- operator sugar ----------------------------------------------------
    def _keywise(self, other: "Expr", kernel: str) -> "Expr":
        other = _as_expr(other)
        k = self.key_arity
        if other.key_arity != k:
            raise ExprTypeError(
                f"{kernel}: key arity mismatch — left has {k} key dims "
                f"({_describe_rtype(self.info)}), right has "
                f"{other.key_arity} ({_describe_rtype(other.info)})")
        return self.join(other, on=tuple(range(k)), kernel=kernel)

    def __add__(self, other: "Expr") -> "Expr":
        return self._keywise(other, "matAdd")

    def __sub__(self, other: "Expr") -> "Expr":
        return self._keywise(other, "matSub")

    def __mul__(self, other: "Expr") -> "Expr":
        return self._keywise(other, "elemMul")

    def __matmul__(self, other: "Expr") -> "Expr":
        """Blocked matrix product — the paper's §2.1 running example.

        ``Σ_(⟨0,2⟩, matAdd)(⋈_(⟨1⟩,⟨0⟩, matMul)(self, other))`` over
        matrix-chunked relations (key arity 2, rank-2 bounds).
        """
        other = _as_expr(other)
        for side, e in (("left", self), ("right", other)):
            if e.key_arity != 2 or e.info.rtype.rank != 2:
                raise ExprTypeError(
                    f"@: {side} operand must be a matrix-chunked relation "
                    f"(2 key dims, rank-2 bound), got "
                    f"{_describe_rtype(e.info)}")
        return self.join(other, on=((1,), (0,)),
                         kernel="matMul").agg((0, 2), "matAdd")


def _as_expr(obj) -> Expr:
    if isinstance(obj, Expr):
        return obj
    if isinstance(obj, TraNode):
        return wrap(obj)
    raise ExprTypeError(f"expected an Expr, got {type(obj).__name__}")


def _build(node: TraNode, op: str, *operands: Expr) -> Expr:
    """Construct an Expr, running inference now so errors are build-time."""
    try:
        info = infer(node)
    except (ValueError, TypeError, KeyError, IndexError) as exc:
        ops = "; ".join(f"{type(o.node).__name__}[{_describe_rtype(o.info)}]"
                        for o in operands)
        raise ExprTypeError(
            f"cannot build {op} over {ops}: {exc}") from exc
    return Expr(node, info)


# ==========================================================================
# Constructors
# ==========================================================================

def input(name: str, key_shape: Sequence[int], bound: Sequence[int],
          dtype=torch.float32) -> Expr:  # noqa: A001 — mirrors tf.placeholder
    """A named logical input of type ``R^(f=key_shape, b=bound)``."""
    rt = RelType(tuple(key_shape), tuple(bound), dtype)
    return wrap(TraInput(name, rt))


def input_like(name: str, rtype: RelType) -> Expr:
    """A named logical input matching an existing :class:`RelType`."""
    return wrap(TraInput(name, rtype))


def const(fill: float, key_shape: Sequence[int], bound: Sequence[int],
          dtype=torch.float32) -> Expr:
    """A literal constant relation (every key maps to a ``fill`` array).

    Materialized locally by every executor — zero communication cost."""
    return wrap(TraConst(RelType(tuple(key_shape), tuple(bound), dtype),
                         float(fill)))


def scalar(fill: float, dtype=torch.float32) -> Expr:
    """A literal *scalar relation* — key ``(1,)``, bound ``(1, 1)``.

    The carrier type for per-step scalars (step counts, schedules) in
    :mod:`repro_torch.core.train`; apply one with :meth:`Expr.scale_by`."""
    return const(fill, (1,), (1, 1), dtype)


def scalar_input(name: str, dtype=torch.float32) -> Expr:
    """A named scalar-relation input (key ``(1,)``, bound ``(1, 1)``)."""
    return input(name, (1,), (1, 1), dtype)


def ones_like(e: Expr) -> Expr:
    """A ones constant typed like ``e`` — the default autodiff seed."""
    e = _as_expr(e)
    return wrap(TraConst(e.info.rtype, 1.0))


def wrap(node: TraNode) -> Expr:
    """Wrap an existing logical plan node (type-checks it eagerly)."""
    return _build(node, type(node).__name__)


def einsum(spec: str, *operands: Expr) -> Expr:
    """Einstein-notation frontend (paper §2.3) over ``Expr`` operands.

    Builds the paper's binary-production construction — one join +
    aggregation per contraction step — through the same ``Expr``
    constructors as the fluent API, so einsum expressions flow through the
    identical optimizer entry path.

        >>> C = tra.einsum("ij,jk->ik", A, B)

    Each operand's key arity and rank must both equal its index-term
    length (one key dim + one array dim per index).
    """
    from repro_torch.core.einsum_frontend import build_einsum, parse_spec
    terms, out_idx = parse_spec(spec)
    if len(terms) != len(operands):
        raise ExprTypeError(
            f"einsum '{spec}' has {len(terms)} terms but "
            f"{len(operands)} operands were given")
    exprs = [_as_expr(o) for o in operands]
    for t, e in zip(terms, exprs):
        if e.key_arity != len(t) or e.info.rtype.rank != len(t):
            raise ExprTypeError(
                f"einsum term '{t}' needs {len(t)} key dims and rank "
                f"{len(t)}, got {_describe_rtype(e.info)}")
    node = build_einsum(terms, out_idx, [e.node for e in exprs],
                        [e.bound for e in exprs])
    return wrap(node)
