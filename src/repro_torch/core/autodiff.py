"""Reverse-mode differentiation of TRA expressions (the Tang et al.
direction: arXiv 2306.00088, "Auto-Differentiation of Relational
Computations for Very Large Scale Machine Learning").

Port of ``repro.core.autodiff``, rule for rule: it builds plans, never
touches an array, so nothing in it depends on torch.  No deviation.

The paper's §5.3 writes the FFNN backward pass *by hand* as TRA
expressions.  This module derives it instead: given a lazy
:class:`~repro_torch.core.expr.Expr` forward DAG, :func:`grad` emits the
cotangent of every requested input **as another Expr DAG** — plain joins,
aggregations, maps, pads — so the backward plan flows through the same
cost-based optimizer (including the fused Σ∘⋈ contraction selection) and
runs on every executor, exactly like a forward plan.

Three ingredients:

* **kernel-level derivative rules** — every differentiable
  :class:`~repro_torch.core.kernels_registry.Kernel` carries a ``vjp``:
  binary (join) kernels name the registered kernel computing each
  operand's cotangent (``matMul → (matTranMulR, matTranMulL)``, the
  paper's §5.3 kernel triple); unary (map) kernels provide an
  Expr-builder (``relu → reluGrad(z)·g``);

* **a direct Σ∘⋈ backward rule** — the cotangent of a contraction
  ``Σ_(gb)(⋈(L, R))`` is emitted as one join + one aggregation per
  operand (``dL = Σ(⋈(G, R, vjp_l))``), *not* as a broadcast-back
  followed by a join over the materialized grid, so backward plans
  contain the same ``agg(join(·))`` shape the optimizer fuses;

* **fan-in accumulation** — a node consumed by several operations sums
  its cotangent contributions with keywise ``matAdd`` joins; the
  :class:`~repro_torch.core.plan.TraPad` densify op aligns contributions onto
  one common key grid (zero at filtered-out / out-of-window keys).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.expr import Expr, ExprTypeError, wrap
from repro_torch.core.kernels_registry import JoinVjp, Kernel
from repro_torch.core.plan import (TraAgg, TraConcat, TraConst, TraFilter,
                                   TraInput, TraJoin, TraNode, TraPad,
                                   TraReKey, TraTile, TraTransform, TypeInfo,
                                   children, infer, postorder)
from repro_torch.core.tra import RelType

WrtLike = Union[str, Expr]


class AutodiffError(ExprTypeError, ValueError):
    """A forward expression (or one of its kernels) has no derivative
    rule, or its cotangent cannot be expressed in the algebra.

    Subclasses :class:`~repro_torch.core.expr.ExprTypeError` (these are
    build-time type errors of the backward expression) and ``ValueError``,
    as in the JAX package."""


# aggregation kernels with a derivative rule: matAdd flows the cotangent
# straight through (broadcast-back / direct Σ∘⋈); elemMax / elemMin route
# it through the argmax-mask construction below
DIFFERENTIABLE_AGGS = ("matAdd", "elemMax", "elemMin")


# ==========================================================================
# Contraction backward: the operand cotangent of Σ_(gb, matAdd)∘⋈(L, R)
# ==========================================================================

def _contraction_vjp(G: Expr, side: str, left: Expr, right: Expr,
                     jkl: Tuple[int, ...], jkr: Tuple[int, ...],
                     gb: Tuple[int, ...],
                     spec: JoinVjp) -> Optional[Expr]:
    """Cotangent of the ``side`` operand of ``Σ_(gb)∘⋈_(jkl,jkr)(L, R)``.

    ``G`` is keyed by the ``gb``-selected subspace of the join's output
    key space ``k_out`` (= left keys ++ right non-join keys).  Emits one
    backward join (between ``G`` and the *other* operand, applying the
    ``spec`` kernel) followed by one matAdd aggregation restoring the
    target operand's key space — the structure the optimizer's fused
    Σ∘⋈ selection recognizes.  Returns ``None`` when a reduced key axis
    of the target cannot be recovered from the backward join's key space
    (caller falls back to the broadcast-back construction).
    """
    kl, kr = left.key_arity, right.key_arity
    r_nonjoin = [d for d in range(kr) if d not in jkr]
    axis_of_right = {}
    for i, d in enumerate(jkr):
        axis_of_right[d] = jkl[i]
    for i, d in enumerate(r_nonjoin):
        axis_of_right[d] = kl + i
    pos_in_gb = {a: i for i, a in enumerate(gb)}

    if side == "left":
        target, other = left, right
        target_axes = list(range(kl))
        other_axes = [axis_of_right[d] for d in range(kr)]
    else:
        target, other = right, left
        target_axes = [axis_of_right[d] for d in range(kr)]
        other_axes = list(range(kl))

    # feasibility: every target key axis must be recoverable — either kept
    # by the aggregation (in gb → on the G side) or joined with an
    # other-operand key dim (→ on the other side of the backward join)
    other_axis_set = set(other_axes)
    for a in target_axes:
        if a not in pos_in_gb and a not in other_axis_set:
            return None

    # backward join: pair every G dim whose k_out axis an other-operand
    # dim covers with that dim
    on_g, on_o = [], []
    for od, a in enumerate(other_axes):
        if a in pos_in_gb:
            on_g.append(pos_in_gb[a])
            on_o.append(od)

    if spec.cot_first:
        joined = G.join(other, on=(tuple(on_g), tuple(on_o)),
                        kernel=spec.kernel)
        # output keys: all G dims (leading), then unjoined other dims
        tail = [od for od in range(len(other_axes)) if od not in on_o]
        pos_of_g = {g: g for g in range(len(gb))}
        pos_of_other = {od: len(gb) + i for i, od in enumerate(tail)}
        for g, od in zip(on_g, on_o):
            pos_of_other[od] = g
        n_out = len(gb) + len(tail)
    else:
        joined = other.join(G, on=(tuple(on_o), tuple(on_g)),
                            kernel=spec.kernel)
        # output keys: all other dims (leading), then unjoined G dims
        unjoined = [g for g in range(len(gb)) if g not in on_g]
        pos_of_other = {od: od for od in range(len(other_axes))}
        pos_of_g = {g: len(other_axes) + i for i, g in enumerate(unjoined)}
        for g, od in zip(on_g, on_o):
            pos_of_g[g] = od
        n_out = len(other_axes) + len(unjoined)

    group_by = []
    for a in target_axes:
        if a in pos_in_gb:
            group_by.append(pos_of_g[pos_in_gb[a]])
        else:
            group_by.append(pos_of_other[other_axes.index(a)])

    if group_by != list(range(n_out)):
        out = joined.agg(tuple(group_by), "matAdd")
    else:
        out = joined
    if out.key_shape != target.key_shape:
        # joined frontiers were min-sliced in the forward pass: the
        # out-of-window target entries never contributed → zero cotangent
        out = wrap(TraPad(out.node, target.key_shape))
    return out


# ==========================================================================
# The reverse-mode transform
# ==========================================================================

def _accumulate(contribs: List[Expr], key_shape: Tuple[int, ...]) -> Expr:
    """Sum cotangent contributions onto the primal's key grid."""
    fixed = []
    for c in contribs:
        if c.key_shape != tuple(key_shape) or c.info.mask is not None:
            c = wrap(TraPad(c.node, tuple(key_shape)))
        fixed.append(c)
    total = fixed[0]
    for c in fixed[1:]:
        total = total + c
    return total


def _agg_broadcast_back(node: TraAgg, child_info: TypeInfo,
                        G: Expr) -> Expr:
    """Generic Σ_(gb, matAdd) backward: replicate ``G`` over the reduced
    key dims.  A zero-cost :class:`TraConst` donates the pre-aggregation
    key space; ``gradR`` projects the cotangent through the join."""
    donor = wrap(TraConst(
        RelType(child_info.rtype.key_shape, (1,), child_info.rtype.dtype),
        0.0))
    gb = tuple(node.group_by)
    return donor.join(G, on=(gb, tuple(range(len(gb)))), kernel="gradR")


def _agg_minmax_vjp(node: TraAgg, child_info: TypeInfo, G: Expr) -> Expr:
    """Backward of a max/min aggregation via the argmax-mask construction.

    The cotangent of the reduced child is ``G`` routed to the extremal
    entries only: ``mask = (child == broadcast(out))`` selects them, and
    dividing by the broadcast tie count splits the cotangent evenly among
    ties — exactly ``jax.grad``'s convention for ``reduce_max``.  Every
    step is a plain TRA op (keywise joins + one matAdd aggregation), so
    the backward plan optimizes and executes like any other."""
    child = wrap(node.child)
    out = wrap(node)                     # shared forward DAG node
    k = child_info.rtype.key_arity
    cokey = (tuple(range(k)), tuple(range(k)))
    bo = _agg_broadcast_back(node, child_info, out)
    bg = _agg_broadcast_back(node, child_info, G)
    mask = child.join(bo, on=cokey, kernel="eqMask")
    ties = mask.agg(tuple(node.group_by), "matAdd")
    bt = _agg_broadcast_back(node, child_info, ties)
    return mask.join(bg, on=cokey, kernel="elemMul") \
               .join(bt, on=cokey, kernel="elemDiv")


def _join_vjp_specs(kernel: Kernel) -> Tuple[Optional[JoinVjp],
                                             Optional[JoinVjp]]:
    v = kernel.vjp
    if v is None:
        return (None, None)
    if not (isinstance(v, tuple) and len(v) == 2):
        raise AutodiffError(
            f"binary kernel {kernel.name} carries a malformed vjp rule")
    return v


def grad(expr: Expr, wrt: Sequence[WrtLike],
         seed: Optional[Expr] = None) -> Tuple[Expr, ...]:
    """Cotangent expressions of ``expr`` w.r.t. the named inputs.

    ``seed`` is the root cotangent (an Expr of the same relation type);
    ``None`` seeds with ones — the gradient of ``Σ`` over every entry of
    every output array.  Returns one Expr per ``wrt`` entry, each typed
    exactly like its input (inputs the output does not depend on get a
    zero constant).
    """
    if not isinstance(expr, Expr):
        expr = wrap(expr)
    root = expr.node
    order = postorder(root)
    infos: Dict[int, TypeInfo] = {}
    cache: Dict[int, TypeInfo] = {}
    for n in order:
        infos[id(n)] = infer(n, cache=cache)

    names = []
    for w in wrt:
        if isinstance(w, Expr):
            if not isinstance(w.node, TraInput):
                raise AutodiffError(
                    "wrt entries must be input names or input Exprs")
            names.append(w.node.name)
        else:
            names.append(w)
    have = {n.name for n in order if isinstance(n, TraInput)}
    unknown = [nm for nm in names if nm not in have]
    if unknown:
        raise AutodiffError(
            f"wrt inputs {unknown} do not occur in the expression "
            f"(inputs: {sorted(have)})")

    # active = nodes whose subtree contains a wrt input
    active: set = set()
    for n in order:                       # children precede parents
        if isinstance(n, TraInput) and n.name in names:
            active.add(id(n))
        elif any(id(c) in active for c in children(n)):
            active.add(id(n))
    if id(root) not in active:
        # output independent of every wrt input → all-zero gradients
        return tuple(
            wrap(TraConst(_input_rtype(order, nm), 0.0)) for nm in names)

    if seed is None:
        seed = wrap(TraConst(infos[id(root)].rtype, 1.0))
    if (seed.key_shape != infos[id(root)].rtype.key_shape
            or seed.bound != infos[id(root)].rtype.bound):
        raise AutodiffError(
            f"seed type f={seed.key_shape} b={seed.bound} does not match "
            f"the root's f={infos[id(root)].rtype.key_shape} "
            f"b={infos[id(root)].rtype.bound}")

    consumers: Dict[int, int] = {}
    for n in order:
        for c in children(n):
            consumers[id(c)] = consumers.get(id(c), 0) + 1

    cots: Dict[int, List[Expr]] = {id(root): [seed]}
    grads: Dict[str, List[Expr]] = {nm: [] for nm in names}

    def contribute(node: TraNode, c: Expr) -> None:
        cots.setdefault(id(node), []).append(c)

    for n in reversed(order):             # parents precede children
        contribs = cots.get(id(n))
        if not contribs or id(n) not in active:
            continue
        G = _accumulate(contribs, infos[id(n)].rtype.key_shape)
        _backward(n, G, infos, active, consumers, contribute, grads, names,
                  cots)

    outs = []
    for nm in names:
        rtype = _input_rtype(order, nm)
        if grads[nm]:
            outs.append(_accumulate(grads[nm], rtype.key_shape))
        else:
            outs.append(wrap(TraConst(rtype, 0.0)))
    return tuple(outs)


def _input_rtype(order, name: str) -> RelType:
    for n in order:
        if isinstance(n, TraInput) and n.name == name:
            return n.rtype
    raise KeyError(name)


def _backward(n: TraNode, G: Expr, infos, active, consumers, contribute,
              grads, names, cots) -> None:
    """Propagate the accumulated cotangent ``G`` of ``n`` one step."""
    if isinstance(n, TraInput):
        if n.name in names:
            grads[n.name].append(G)
        return
    if isinstance(n, TraConst):
        return

    if isinstance(n, TraAgg):
        if n.kernel.name in ("elemMax", "elemMin"):
            contribute(n.child,
                       _agg_minmax_vjp(n, infos[id(n.child)], G))
            return
        if n.kernel.name != "matAdd":
            hint = ("product aggregations are not differentiable here — "
                    "rewrite as Σ of logs where the data permits"
                    if n.kernel.name == "elemMul" else
                    "use a differentiable aggregation or stop the "
                    "gradient before it")
            raise AutodiffError(
                f"aggregation kernel {n.kernel.name!r} has no derivative "
                f"rule; differentiable aggregations are "
                f"{', '.join(DIFFERENTIABLE_AGGS)} ({hint})")
        c = n.child
        gb = tuple(n.group_by)
        if isinstance(c, TraJoin) and consumers.get(id(c), 0) == 1 \
                and id(c) not in cots:
            # direct Σ∘⋈ backward: cotangents flow straight into the join
            # operands as agg(join(·)) patterns — fusable by the optimizer
            lspec, rspec = _join_vjp_specs(c.kernel)
            ok = True
            sides = []
            for side, spec, op in (("left", lspec, c.left),
                                   ("right", rspec, c.right)):
                if id(op) not in active:
                    continue
                if spec is None:
                    ok = False
                    break
                lx, rx = wrap(c.left), wrap(c.right)
                cot = _contraction_vjp(G, side, lx, rx, c.join_keys_l,
                                       c.join_keys_r, gb, spec)
                if cot is None:
                    ok = False
                    break
                sides.append((op, cot))
            if ok:
                for op, cot in sides:
                    contribute(op, cot)
                return
        # fall back: broadcast the cotangent over the reduced dims, then
        # let the child's own rule consume it
        contribute(c, _agg_broadcast_back(n, infos[id(c)], G))
        return

    if isinstance(n, TraJoin):
        lspec, rspec = _join_vjp_specs(n.kernel)
        k_out = infos[id(n)].rtype.key_arity
        gb = tuple(range(k_out))
        lx, rx = wrap(n.left), wrap(n.right)
        for side, spec, op in (("left", lspec, n.left),
                               ("right", rspec, n.right)):
            if id(op) not in active:
                continue
            if spec is None:
                from repro_torch.core.kernels_registry import (
                    get_kernel, registered_kernels)
                alts = [nm for nm in registered_kernels()
                        if (kk := get_kernel(nm)).arity == 2
                        and isinstance(kk.vjp, tuple)
                        and all(v is not None for v in kk.vjp)]
                raise AutodiffError(
                    f"join kernel {n.kernel.name!r} has no derivative "
                    f"rule for its {side} operand; differentiable join "
                    f"kernels include {', '.join(alts)}")
            cot = _contraction_vjp(G, side, lx, rx, n.join_keys_l,
                                   n.join_keys_r, gb, spec)
            assert cot is not None      # full gb is always feasible
            contribute(op, cot)
        return

    if isinstance(n, TraTransform):
        if n.kernel.vjp is None:
            raise AutodiffError(
                f"transform kernel {n.kernel.name} has no derivative rule")
        child = wrap(n.child)
        out = wrap(n)
        contribute(n.child, n.kernel.vjp(child, out, G))
        return

    if isinstance(n, TraTile):
        k = infos[id(n.child)].rtype.key_arity
        contribute(n.child, G.concat(k, n.tile_dim))
        return

    if isinstance(n, TraConcat):
        cinfo = infos[id(n.child)]
        t = G.tile(n.array_dim, cinfo.rtype.bound[n.array_dim])
        kd = n.key_dim
        if kd != cinfo.rtype.key_arity - 1:
            # the regrown key dim is appended last; permute it home
            t = t.rekey(
                lambda kk, _kd=kd: kk[:_kd] + (kk[-1],) + kk[_kd:-1],
                tag=f"untile→{kd}")
        contribute(n.child, t)
        return

    if isinstance(n, TraReKey):
        cinfo = infos[id(n.child)]
        inv = {}
        for kk in _valid_keys(cinfo):
            inv[tuple(n.key_func(kk))] = kk
        g = G
        if infos[id(n)].mask is not None:
            # the image has holes: keep only cotangent keys the forward
            # relation actually produced before inverting
            g = g.filter(lambda kk, _inv=inv: kk in _inv,
                         tag=f"{n.tag}⁻¹dom")
        contribute(n.child,
                   g.rekey(lambda kk, _inv=inv: _inv[kk],
                           tag=f"{n.tag}⁻¹"))
        return

    if isinstance(n, TraFilter):
        cinfo = infos[id(n.child)]
        kept = G.filter(n.bool_func, tag=f"{n.tag}∂")
        contribute(n.child,
                   wrap(TraPad(kept.node, cinfo.rtype.key_shape)))
        return

    if isinstance(n, TraPad):
        cinfo = infos[id(n.child)]
        f = cinfo.rtype.key_shape
        if f != infos[id(n)].rtype.key_shape:
            G = G.filter(lambda kk, _f=f: all(x < b for x, b in
                                              zip(kk, _f)),
                         tag="pad∂")
        contribute(n.child, G)
        return

    raise AutodiffError(f"no derivative rule for {type(n).__name__}")


def _valid_keys(info: TypeInfo):
    ks = info.rtype.key_shape
    grid = np.indices(ks).reshape(len(ks), -1).T if ks else \
        np.zeros((1, 0), np.int64)
    if info.mask is not None:
        grid = grid[info.mask.reshape(-1)]
    return [tuple(int(x) for x in kk) for kk in grid]
