"""Kernel-function registry for the TRA/IA.

Port of ``repro.core.kernels_registry``: every registered kernel with the
same name, ``out_bound``, ``flops``, ``identity``, ``distributes_over`` and
``vjp`` data, its ``apply``/``reduce`` written in torch.  ``identity`` of
the max/min reducers is ``±math.inf`` (a Python float, as ``jnp.inf`` is).

The paper's TRA is a family of *higher-order* functions: every algebra op
takes a kernel function over plain arrays (in the paper: an MKL/CUDA kernel).
Here kernels are torch callables obeying one convention:

    kernel.apply operates on the LAST ``rank`` dims of its operands and
    broadcasts over any leading (key/batch) dims.

That convention is what lets the dense executor evaluate a join by aligning
key dims and issuing a *single* batched kernel call instead of looping over
tuples like the paper's Python engine.

Each kernel carries the metadata the optimizer needs:
  * ``out_bound``   — array-type inference (bound of the output),
  * ``flops``       — exact flop count for the compute roofline term,
  * ``is_associative``/``identity``/``reduce`` — for aggregation kernels,
  * ``distributes_over`` — names of agg kernels it distributes over (R1-4 /
    R1-7 side conditions),
  * ``vjp``         — the kernel-level derivative rule consumed by
    :mod:`repro.core.autodiff` (Tang et al., arXiv 2306.00088: backward
    passes are *derived* from the forward relational plan).  For a binary
    (join) kernel the rule is a pair of :class:`JoinVjp` specs — one per
    operand — each naming the *registered kernel* that computes that
    operand's cotangent from (cotangent, other operand); the autodiff
    transform then emits the cotangent as a TRA join+aggregation, so the
    backward graph is itself a ``TraNode`` DAG the optimizer can fuse.
    For a unary (transform) kernel the rule is a builder
    ``vjp(child_expr, out_expr, cot_expr) -> Expr`` written against the
    lazy frontend (again: plain TRA ops, never opaque autograd).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

Bound = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class JoinVjp:
    """Derivative rule for ONE operand of a binary (join) kernel.

    ``kernel`` names the registered kernel computing the operand's
    cotangent (or is the :class:`Kernel` itself, for parameterized
    factory kernels such as the einsum-frontend contractions);
    ``cot_first`` says whether the incoming cotangent is that kernel's
    first operand (the other forward operand is the remaining one).
    E.g. for ``matMul``: dL = g @ Rᵀ = ``matTranMulR(g, R)`` →
    ``JoinVjp("matTranMulR", cot_first=True)``.
    """

    kernel: Any                       # str (registered name) or Kernel
    cot_first: bool = True


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A named array kernel usable inside TRA/IA operations."""

    name: str
    arity: int                                  # 1 or 2 operand arrays
    apply: Callable[..., torch.Tensor]
    out_bound: Callable[..., Bound]             # (*bounds) -> bound
    flops: Callable[..., int]                   # (*bounds) -> flop count
    is_associative: bool = False                # usable as an agg kernel
    identity: Optional[float] = None            # identity element for agg
    reduce: Optional[Callable[[torch.Tensor, Tuple[int, ...]], torch.Tensor]] = None
    distributes_over: Tuple[str, ...] = ()      # agg kernels f with k(f(a,b)) = f(k(a),k(b))
    # derivative rule (see module docstring): for arity 2 a pair of
    # Optional[JoinVjp] (None = that operand is non-differentiable); for
    # arity 1 a builder (child_expr, out_expr, cot_expr) -> Expr.
    vjp: Optional[Any] = None

    @property
    def differentiable(self) -> bool:
        return self.vjp is not None

    def __call__(self, *arrays: torch.Tensor) -> torch.Tensor:
        return self.apply(*arrays)

    def __repr__(self) -> str:  # keep plans printable
        return f"Kernel<{self.name}>"


_REGISTRY: dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    _REGISTRY[kernel.name] = kernel
    return kernel


def get_kernel(name: str) -> Kernel:
    try:
        return _REGISTRY[name]
    except KeyError as exc:
        raise KeyError(
            f"unknown kernel {name!r}; registered: {sorted(_REGISTRY)}"
        ) from exc


def registered_kernels() -> Sequence[str]:
    return sorted(_REGISTRY)


def _prod(xs: Sequence[int]) -> int:
    return math.prod(xs) if xs else 1


def _prod_reduce(x: torch.Tensor, axes: Tuple[int, ...]) -> torch.Tensor:
    # torch.prod reduces one dim per call; fold from the last axis down so
    # the remaining indices stay valid
    for ax in sorted((a % x.ndim for a in axes), reverse=True):
        x = torch.prod(x, dim=ax)
    return x


def _same_bound(*bounds: Bound) -> Bound:
    first = bounds[0]
    for b in bounds[1:]:
        if tuple(b) != tuple(first):
            raise ValueError(f"bound mismatch: {bounds}")
    return tuple(first)


# --------------------------------------------------------------------------
# Structural gradient kernels (operand projections).  ``gradL``/``gradLNeg``
# pass through (resp. negate) their first operand and ignore the second —
# the VJP images of the linear elementwise kernels.  They exist so that the
# backward graph stays inside the algebra: the shape/keys of the ignored
# operand still drive the join's key alignment.
# --------------------------------------------------------------------------

gradL = register(Kernel(
    name="gradL", arity=2,
    apply=lambda a, b: a,
    out_bound=lambda bl, br: tuple(bl),
    flops=lambda *bs: 0,
))

gradLNeg = register(Kernel(
    name="gradLNeg", arity=2,
    apply=lambda a, b: -a,
    out_bound=lambda bl, br: tuple(bl),
    flops=lambda *bs: _prod(bs[0]),
))

# broadcast-back of an aggregated cotangent: second operand wins (the first
# is a shape donor keyed by the pre-aggregation key space)
gradR = register(Kernel(
    name="gradR", arity=2,
    apply=lambda a, b: b,
    out_bound=lambda bl, br: tuple(br),
    flops=lambda *bs: 0,
))


# --------------------------------------------------------------------------
# Elementwise binary kernels
# --------------------------------------------------------------------------

matAdd = register(Kernel(
    name="matAdd", arity=2,
    apply=lambda a, b: a + b,
    out_bound=_same_bound,
    flops=lambda *bs: _prod(bs[0]),
    is_associative=True, identity=0.0,
    reduce=lambda x, axes: torch.sum(x, dim=axes),
    vjp=(JoinVjp("gradL"), JoinVjp("gradL")),
))

matSub = register(Kernel(
    name="matSub", arity=2,
    apply=lambda a, b: a - b,
    out_bound=_same_bound,
    flops=lambda *bs: _prod(bs[0]),
    vjp=(JoinVjp("gradL"), JoinVjp("gradLNeg")),
))

elemMul = register(Kernel(
    name="elemMul", arity=2,
    apply=lambda a, b: a * b,
    out_bound=_same_bound,
    flops=lambda *bs: _prod(bs[0]),
    is_associative=True, identity=1.0,
    reduce=_prod_reduce,
    vjp=(JoinVjp("elemMul"), JoinVjp("elemMul", cot_first=False)),
))

elemDiv = register(Kernel(
    name="elemDiv", arity=2,
    apply=lambda a, b: a / b,
    out_bound=_same_bound,
    flops=lambda *bs: _prod(bs[0]),
    # dA = g / b; dB needs both operands (−g·a/b²) — not JoinVjp-shaped
    vjp=(JoinVjp("elemDiv"), None),
))

# exact-equality indicator — the argmax-mask primitive behind the
# max/min aggregation VJP rules (ties get the mask at every maximal
# entry; the autodiff rule divides by the tie count, matching jax)
eqMask = register(Kernel(
    name="eqMask", arity=2,
    apply=lambda a, b: (a == b).to(a.dtype),
    out_bound=_same_bound,
    flops=lambda *bs: _prod(bs[0]),
))

elemMax = register(Kernel(
    name="elemMax", arity=2,
    apply=lambda a, b: torch.maximum(a, b),
    out_bound=_same_bound,
    flops=lambda *bs: _prod(bs[0]),
    is_associative=True, identity=-math.inf,
    reduce=lambda x, axes: torch.amax(x, dim=axes),
))

elemMin = register(Kernel(
    name="elemMin", arity=2,
    apply=lambda a, b: torch.minimum(a, b),
    out_bound=_same_bound,
    flops=lambda *bs: _prod(bs[0]),
    is_associative=True, identity=math.inf,
    reduce=lambda x, axes: torch.amin(x, dim=axes),
))


# --------------------------------------------------------------------------
# Matmul family (rank-2 bounds). flops are 2*m*k*n (mult + add).
# --------------------------------------------------------------------------

def _mm_bound(bl: Bound, br: Bound) -> Bound:
    if len(bl) != 2 or len(br) != 2 or bl[1] != br[0]:
        raise ValueError(f"matMul bound mismatch {bl} x {br}")
    return (bl[0], br[1])


matMul = register(Kernel(
    name="matMul", arity=2,
    apply=lambda a, b: torch.matmul(a, b),
    out_bound=_mm_bound,
    flops=lambda bl, br: 2 * bl[0] * bl[1] * br[1],
    # dA = G @ Bᵀ, dB = Aᵀ @ G — the closure of the matmul family under
    # differentiation is exactly the paper's §5.3 kernel triple.
    vjp=(JoinVjp("matTranMulR"), JoinVjp("matTranMulL", cot_first=False)),
))

# A^T @ B  (the backprop weight-gradient kernel of paper §5.3)
matTranMulL = register(Kernel(
    name="matTranMulL", arity=2,
    apply=lambda a, b: torch.einsum("...ij,...ik->...jk", a, b),
    out_bound=lambda bl, br: (bl[1], br[1]),
    flops=lambda bl, br: 2 * bl[0] * bl[1] * br[1],
    # out = AᵀB: dA = B @ Gᵀ, dB = A @ G
    vjp=(JoinVjp("matTranMulR", cot_first=False),
         JoinVjp("matMul", cot_first=False)),
))

# A @ B^T  (the backprop activation-gradient kernel of paper §5.3)
matTranMulR = register(Kernel(
    name="matTranMulR", arity=2,
    apply=lambda a, b: torch.einsum("...ij,...kj->...ik", a, b),
    out_bound=lambda bl, br: (bl[0], br[0]),
    flops=lambda bl, br: 2 * bl[0] * bl[1] * br[0],
    # out = ABᵀ: dA = G @ B, dB = Gᵀ @ A
    vjp=(JoinVjp("matMul"), JoinVjp("matTranMulL")),
))

# dQ of matVecSub: the cotangent summed over the broadcast (row) dim,
# keeping the query's (1, d) bound.  Ignores its second operand.
_sumRowsKeep = register(Kernel(
    name="sumRowsKeep", arity=2,
    apply=lambda g, x: torch.sum(g, dim=-2, keepdim=True),
    out_bound=lambda bg, bx: (1,) + tuple(bg[-1:]),
    flops=lambda bg, bx: _prod(bg),
))

# x (row vector batch) - X : matrix-vector subtraction from paper §5.2
matVecSub = register(Kernel(
    name="matVecSub", arity=2,
    apply=lambda q, x: q - x,
    out_bound=lambda bq, bx: bx,
    flops=lambda bq, bx: _prod(bx),
    vjp=(JoinVjp("sumRowsKeep"), JoinVjp("gradLNeg")),
))


# --------------------------------------------------------------------------
# Unary kernels
# --------------------------------------------------------------------------

idOp = register(Kernel(
    name="idOp", arity=1,
    apply=lambda a: a,
    out_bound=lambda b: tuple(b),
    flops=lambda b: 0,
    distributes_over=("matAdd", "elemMul", "elemMax", "elemMin"),
    vjp=lambda x, y, g: g,
))

relu = register(Kernel(
    name="relu", arity=1,
    apply=lambda a: torch.clamp_min(a, 0.0),
    out_bound=lambda b: tuple(b),
    flops=lambda b: _prod(b),
    # relu'(z)·g — reluGrad on the *pre-activation* child (== reluGrad on
    # the output away from 0, which is how §5.3 writes it by hand)
    vjp=lambda x, y, g: x.map("reluGrad") * g,
))

reluGrad = register(Kernel(
    name="reluGrad", arity=1,
    apply=lambda a: (a > 0.0).to(a.dtype),
    out_bound=lambda b: tuple(b),
    flops=lambda b: _prod(b),
))

sigmoid = register(Kernel(
    name="sigmoid", arity=1,
    apply=lambda a: torch.sigmoid(a),
    out_bound=lambda b: tuple(b),
    flops=lambda b: 4 * _prod(b),
    # σ'(z) = σ(z)(1-σ(z)) — recomputed from the forward *output*, which
    # the autodiff transform passes in as the shared DAG node
    vjp=lambda x, y, g: y.map("sigmoidGrad") * g,
))

sigmoidGrad = register(Kernel(
    name="sigmoidGrad", arity=1,
    apply=lambda s: s * (1.0 - s),
    out_bound=lambda b: tuple(b),
    flops=lambda b: 2 * _prod(b),
))

def _diag(a: torch.Tensor) -> torch.Tensor:
    # diagonal of the last two dims, batched over leading dims
    return torch.diagonal(a, dim1=-2, dim2=-1)

def make_diag_embed(rows: int, cols: int) -> Kernel:
    """Scatter a diagonal vector back into a (rows, cols) zero matrix —
    the VJP image of ``diag``."""
    idx = min(rows, cols)

    def _apply(a: torch.Tensor) -> torch.Tensor:
        out = a.new_zeros(tuple(a.shape[:-1]) + (rows, cols))
        rng = torch.arange(idx, device=a.device)
        out[..., rng, rng] = a[..., :idx]
        return out

    return Kernel(
        name=f"diagEmbed({rows},{cols})", arity=1,
        apply=_apply,
        out_bound=lambda b: (rows, cols),
        flops=lambda b: 0,
    )


diag = register(Kernel(
    name="diag", arity=1,
    apply=_diag,
    out_bound=lambda b: (min(b[-2], b[-1]),),
    flops=lambda b: 0,
    # diag(A + B) == diag(A) + diag(B): exactly the paper's R1-7 example.
    distributes_over=("matAdd",),
    vjp=lambda x, y, g: g.map(make_diag_embed(*x.bound[-2:])),
))


def make_row_broadcast(n: int) -> Kernel:
    """Repeat along a trailing dim of size ``n`` — the VJP image of
    ``rowSum``."""
    return Kernel(
        name=f"rowBroadcast({n})", arity=1,
        apply=lambda a: a[..., None].expand(tuple(a.shape) + (n,)),
        out_bound=lambda b: tuple(b) + (n,),
        flops=lambda b: 0,
        distributes_over=("matAdd",),
    )


rowSum = register(Kernel(
    name="rowSum", arity=1,
    apply=lambda a: torch.sum(a, dim=-1),
    out_bound=lambda b: tuple(b[:-1]),
    flops=lambda b: _prod(b),
    distributes_over=("matAdd",),
    vjp=lambda x, y, g: g.map(make_row_broadcast(x.bound[-1])),
))


def make_scale_mul(eta: float) -> Kernel:
    """scaleMul_(eta) from paper §5.3 — parameterized, hence a factory."""
    return Kernel(
        name=f"scaleMul({eta})", arity=1,
        apply=lambda a: a * eta,
        out_bound=lambda b: tuple(b),
        flops=lambda b: _prod(b),
        distributes_over=("matAdd",),
        vjp=lambda x, y, g: g.map(make_scale_mul(eta)),
    )


# --------------------------------------------------------------------------
# Optimizer update-rule kernels (repro.core.train).  Updates are TRA
# expressions over parameter / gradient / optimizer-state relations, so the
# per-block math lives here: fused axpy for SGD, fused moment updates for
# momentum / AdamW, and the scalar-broadcast machinery that threads the
# step count (bias correction) through the plan as a relation instead of a
# recompile-forcing kernel constant.
# --------------------------------------------------------------------------

def _scale_by_apply(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    # s is a scalar-relation block: trailing (1, 1) bound under any
    # leading key dims.  Drop the bound and re-append singletons matching
    # a's bound rank so broadcasting can never GROW a's rank (a rank-1
    # a-block times a (1, 1) s-block would otherwise come out rank-2).
    if s.ndim < 2 or tuple(s.shape[-2:]) != (1, 1):
        raise ValueError(
            f"scaleBy expects a scalar-relation right operand with "
            f"(1, 1) blocks, got block shape {tuple(s.shape[-2:])}")
    s2 = s[..., 0, 0]
    return a * s2.reshape(tuple(s2.shape) + (1,) * (a.ndim - s2.ndim))


# multiply every array by a co-joined scalar block (bound (1, 1) on the
# right — the scalar-relation carrier type).  Used by Expr.scale_by to
# apply per-step scalars (bias corrections, schedules) without baking
# them into kernel names.
scaleBy = register(Kernel(
    name="scaleBy", arity=2,
    apply=_scale_by_apply,
    out_bound=lambda bl, br: tuple(bl),
    flops=lambda *bs: _prod(bs[0]),
    vjp=(JoinVjp("scaleBy"), None),
))

# t → t + 1: the step-counter update (a (1,)-keyed scalar relation)
stepIncr = register(Kernel(
    name="stepIncr", arity=1,
    apply=lambda t: t + 1.0,
    out_bound=lambda b: tuple(b),
    flops=lambda b: _prod(b),
))


def make_axpy(alpha: float) -> Kernel:
    """Fused ``a + alpha·b`` — the SGD / update-application kernel
    (one join instead of a scale-map plus a subtract-join)."""
    return Kernel(
        name=f"axpy({alpha})", arity=2,
        apply=lambda a, b: a + alpha * b,
        out_bound=lambda bl, br: tuple(bl),
        flops=lambda *bs: 2 * _prod(bs[0]),
        vjp=(JoinVjp("gradL"), JoinVjp(make_scale_mul_bin(alpha))),
    )


def make_scale_mul_bin(alpha: float) -> Kernel:
    """``alpha·a`` ignoring the second operand — the axpy VJP image."""
    return Kernel(
        name=f"scaleMulBin({alpha})", arity=2,
        apply=lambda a, b: alpha * a,
        out_bound=lambda bl, br: tuple(bl),
        flops=lambda *bs: _prod(bs[0]),
    )


def make_momentum(mu: float) -> Kernel:
    """Fused heavy-ball buffer update ``mu·m + g`` (optax trace)."""
    return Kernel(
        name=f"momentum({mu})", arity=2,
        apply=lambda m, g: mu * m + g,
        out_bound=_same_bound,
        flops=lambda *bs: 2 * _prod(bs[0]),
    )


def make_ema(beta: float) -> Kernel:
    """Fused first-moment update ``beta·m + (1−beta)·g`` (Adam m)."""
    return Kernel(
        name=f"ema({beta})", arity=2,
        apply=lambda m, g: beta * m + (1.0 - beta) * g,
        out_bound=_same_bound,
        flops=lambda *bs: 3 * _prod(bs[0]),
    )


def make_ema_sq(beta: float) -> Kernel:
    """Fused second-moment update ``beta·v + (1−beta)·g²`` (Adam v)."""
    return Kernel(
        name=f"emaSq({beta})", arity=2,
        apply=lambda v, g: beta * v + (1.0 - beta) * g * g,
        out_bound=_same_bound,
        flops=lambda *bs: 4 * _prod(bs[0]),
    )


def make_adam_dir(eps: float) -> Kernel:
    """Adam update direction ``m̂ / (√v̂ + eps)`` over co-keyed moments."""
    return Kernel(
        name=f"adamDir({eps})", arity=2,
        apply=lambda m, v: m / (torch.sqrt(v) + eps),
        out_bound=_same_bound,
        flops=lambda *bs: 3 * _prod(bs[0]),
    )


def make_bias_corr(beta: float) -> Kernel:
    """``1 / (1 − betaᵗ)`` from the step-count relation — the Adam bias
    correction as a *data-dependent* scalar, so one compiled train-step
    program serves every step (no per-step kernel constants)."""
    return Kernel(
        name=f"biasCorr({beta})", arity=1,
        apply=lambda t: 1.0 / (1.0 - beta ** t),
        out_bound=lambda b: tuple(b),
        flops=lambda b: 3 * _prod(b),
    )


def _bce_sum(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Blockwise binary-cross-entropy partial sum over rank-2 blocks:
    Σ over the block of −[y·log(p) + (1−y)·log(1−p)] as a (1, 1) array,
    so the total loss is the matAdd aggregation of the blocks (§5.3
    training loss)."""
    pc = torch.clamp(p, 1e-7, 1.0 - 1e-7)
    ll = y * torch.log(pc) + (1.0 - y) * torch.log1p(-pc)
    return torch.sum(-ll, dim=(-2, -1), keepdim=True)


bceSum = register(Kernel(
    name="bceSum", arity=2,
    apply=_bce_sum,
    out_bound=lambda bl, br: (1, 1),
    flops=lambda *bs: 8 * _prod(bs[0]),
))


def make_transpose() -> Kernel:
    return Kernel(
        name="transpose", arity=1,
        apply=lambda a: torch.swapaxes(a, -1, -2),
        out_bound=lambda b: (b[-1], b[-2]),
        flops=lambda b: 0,
        distributes_over=(),
        vjp=lambda x, y, g: g.map("transpose"),
    )


transpose = register(make_transpose())


# --------------------------------------------------------------------------
# (value, index) argmin machinery for the paper's §5.2 nearest-neighbour
# search.  ``toValIdx`` turns a (rows,) distance block into a (2,) array of
# [min_value, global_row_index]; ``minIndex`` is the associative combiner.
# --------------------------------------------------------------------------

def make_to_val_idx(rows_per_block: int) -> Kernel:
    def _apply(a: torch.Tensor) -> torch.Tensor:
        idx = torch.argmin(a, dim=-1)
        val = torch.amin(a, dim=-1)
        return torch.stack([val, idx.to(a.dtype)], dim=-1)

    return Kernel(
        name=f"toValIdx({rows_per_block})", arity=1,
        apply=_apply,
        out_bound=lambda b: (2,),
        flops=lambda b: _prod(b),
    )


def _min_index(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    take_a = a[..., 0] <= b[..., 0]
    return torch.where(take_a[..., None], a, b)


minIndex = register(Kernel(
    name="minIndex", arity=2,
    apply=_min_index,
    out_bound=_same_bound,
    flops=lambda *bs: _prod(bs[0]),
    is_associative=True,
))


# --------------------------------------------------------------------------
# Structural kernels used by Tile / Concat / replication (λ^L multi-map)
# --------------------------------------------------------------------------

def compose(outer: Kernel, inner: Kernel) -> Kernel:
    """Kernel composition (outer ∘ inner) — used by rules R1-2/R1-4/R1-7."""
    if inner.arity == 1:
        if outer.arity != 1:
            raise ValueError("compose: outer of unary must be unary")
        return Kernel(
            name=f"{outer.name}∘{inner.name}", arity=1,
            apply=lambda a: outer.apply(inner.apply(a)),
            out_bound=lambda b: outer.out_bound(inner.out_bound(b)),
            flops=lambda b: inner.flops(b) + outer.flops(inner.out_bound(b)),
            distributes_over=tuple(
                set(outer.distributes_over) & set(inner.distributes_over)),
        )
    # outer unary applied to the result of a binary kernel
    if outer.arity != 1 or inner.arity != 2:
        raise ValueError("compose supports unary∘unary or unary∘binary")
    return Kernel(
        name=f"{outer.name}∘{inner.name}", arity=2,
        apply=lambda a, b: outer.apply(inner.apply(a, b)),
        out_bound=lambda bl, br: outer.out_bound(inner.out_bound(bl, br)),
        flops=lambda bl, br: inner.flops(bl, br)
        + outer.flops(inner.out_bound(bl, br)),
    )
