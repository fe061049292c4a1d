"""The paper's evaluation workloads as TRA programs (§5.1–§5.3).

Port of ``repro.core.programs``, every builder: each returns lazy
:class:`~repro_torch.core.expr.Expr` programs — built through the fluent
frontend, runnable via :class:`~repro_torch.core.engine.Engine` — plus
the paper's hand-compiled IA plan variants, so the cost model's choices
(Tables 4, 6, 9) can be reproduced.  The IA plans and placements build
without a mesh; running them across sites is the distributed slice's (7,
see ``ROADMAP.md``): on one device the engine walks them with ``Bcast``
and ``Shuf`` as identities.  No deviation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core import expr as E
from repro_torch.core.expr import Expr
from repro_torch.core.kernels_registry import (get_kernel, make_scale_mul,
                                               make_to_val_idx)
from repro_torch.core.plan import (Bcast, FusedJoinAgg, IAInput, IANode,
                                   LocalAgg, LocalJoin, Placement, Shuf)
from repro_torch.core.tra import RelType

S = ("sites",)


# ==========================================================================
# §5.1 — distributed matrix multiplication (BMM / CPMM / RMM)
# ==========================================================================

def matmul_tra(fa: Tuple[int, int], fb: Tuple[int, int],
               ba: Tuple[int, int], bb: Tuple[int, int]) -> Expr:
    """C = A @ B over chunked relations — the §2.1 running example."""
    return E.input("A", fa, ba) @ E.input("B", fb, bb)


def bmm_plan(fa, fb, ba, bbnd) -> IANode:
    """Broadcast-based MM: A broadcast, B row-partitioned (paper §4.2.2)."""
    a = IAInput("A", RelType(fa, ba), Placement.partitioned((0,), S))
    b = IAInput("B", RelType(fb, bbnd), Placement.partitioned((0,), S))
    j = LocalJoin(Bcast(a), b, (1,), (0,), get_kernel("matMul"))
    return LocalAgg(j, (0, 2), get_kernel("matAdd"))


def cpmm_plan(fa, fb, ba, bbnd) -> IANode:
    """Cross-product MM: A col-partitioned, B row-partitioned; the join is
    co-partitioned on the contraction key; Table-1 shuffle then aggregate."""
    a = IAInput("A", RelType(fa, ba), Placement.partitioned((1,), S))
    b = IAInput("B", RelType(fb, bbnd), Placement.partitioned((0,), S))
    j = LocalJoin(a, b, (1,), (0,), get_kernel("matMul"))
    return LocalAgg(Shuf(j, (0,), S), (0, 2), get_kernel("matAdd"))


def cpmm_two_phase_plan(fa, fb, ba, bbnd) -> IANode:
    """Beyond-paper variant: R2-5 partial aggregation before the shuffle
    (reduce-scatter) — strictly less traffic than cpmm_plan when the
    contraction grid exceeds the site count."""
    a = IAInput("A", RelType(fa, ba), Placement.partitioned((1,), S))
    b = IAInput("B", RelType(fb, bbnd), Placement.partitioned((0,), S))
    j = LocalJoin(a, b, (1,), (0,), get_kernel("matMul"))
    partial = LocalAgg(j, (0, 2), get_kernel("matAdd"), partial=True)
    return Shuf(partial, (0,), S)


def bmm_fused_plan(fa, fb, ba, bbnd) -> IANode:
    """BMM with the Σ∘⋈ pair collapsed into one FusedJoinAgg contraction —
    identical comm cost to :func:`bmm_plan`, no materialized join grid."""
    a = IAInput("A", RelType(fa, ba), Placement.partitioned((0,), S))
    b = IAInput("B", RelType(fb, bbnd), Placement.partitioned((0,), S))
    return FusedJoinAgg(Bcast(a), b, (1,), (0,), get_kernel("matMul"),
                        (0, 2), get_kernel("matAdd"))


def cpmm_fused_plan(fa, fb, ba, bbnd) -> IANode:
    """CPMM as the fused two-phase contraction: each site contracts its
    key window in one blocked matmul (partial FusedJoinAgg), then a single
    SHUF reduce-scatters the pending partials — the plan the paper's
    Σ∘⋈-as-contraction claim describes."""
    a = IAInput("A", RelType(fa, ba), Placement.partitioned((1,), S))
    b = IAInput("B", RelType(fb, bbnd), Placement.partitioned((0,), S))
    fused = FusedJoinAgg(a, b, (1,), (0,), get_kernel("matMul"),
                         (0, 2), get_kernel("matAdd"), partial=True)
    return Shuf(fused, (0,), S)


def rmm_cost(fa, fb, ba, bbnd, sites: int, accounting: str = "paper") -> int:
    """Analytic RMM cost per paper §4.2.2.

    The paper's construction sets ``xDups = Front(R_B)[1]`` (B's column
    grid) and ``yDups = Front(R_A)[0]`` (A's row grid) with both operands
    initially partitioned by dimension 0.  With A stored row-partitioned
    in a (s, 1) grid, ``xDups = 1`` — A is not duplicated and its shuffle
    is a no-op under the optimized initial layout — while B is duplicated
    ``yDups = s`` times and shuffled once:

        cost_paper = f_B × s

    which reproduces Table 4's RMM column exactly on all three shapes.
    ``accounting="wire"`` instead prices the balanced 3-D (p1·p2·p3 = s)
    grid: f_A·(p3−1) + f_B·(p1−1) wire floats.
    """
    fa_floats = int(fa[0] * fa[1] * ba[0] * ba[1])
    fb_floats = int(fb[0] * fb[1] * bbnd[0] * bbnd[1])
    if accounting == "paper":
        return fb_floats * sites
    # balanced 3-D grid for the wire variant
    best = (sites, 1, 1)
    best_score = None
    for p1 in range(1, sites + 1):
        if sites % p1:
            continue
        rest = sites // p1
        for p2 in range(1, rest + 1):
            if rest % p2:
                continue
            p3 = rest // p2
            score = max(p1, p2, p3) / min(p1, p2, p3)
            if best_score is None or score < best_score:
                best_score = score
                best = (p1, p2, p3)
    p1, p2, p3 = best
    return fa_floats * (p3 - 1) + fb_floats * (p1 - 1)


# ==========================================================================
# §5.2 — nearest neighbour search in a Riemannian metric space
# ==========================================================================

@dataclasses.dataclass
class NNSearchProgram:
    dist: Expr               # (nblocks,)-keyed distance blocks
    result: Expr             # single (val, idx) pair after concat+argmin


def nn_search_tra(n_blocks: int, d_blocks: int, rows: int, dcol: int
                  ) -> NNSearchProgram:
    """d_A(x_i, x_q) = (x_i − x_q) A (x_i − x_q)ᵀ for every row i.

    Relations: R_xq keyed (d,) bound (1, dcol); R_X keyed (n, d) bound
    (rows, dcol); R_A keyed (d, d) bound (dcol, dcol).

    ``dist`` is shared between the returned roots — with the Expr DAG it
    is evaluated once even when both are computed in one engine run.
    """
    rxq = E.input("xq", (d_blocks,), (1, dcol))
    rx = E.input("X", (n_blocks, d_blocks), (rows, dcol))
    ra = E.input("A", (d_blocks, d_blocks), (dcol, dcol))

    # R_diff[n, d] = X − xq  (join on the feature-block key); keys arrive
    # (d, n) — reorder to (n, d)
    diff = rxq.join(rx, on=((0,), (1,)), kernel="matVecSub") \
              .rekey(lambda k: (k[1], k[0]), tag="swap")

    # R_proj[n, d'] = Σ_d diff · A
    proj = diff @ ra

    # R_dist[n] = rowSum(proj ⊙ diff); agg grouped (0,1) keeps both key
    # dims and rowSum drops the col dim of the block — re-aggregate over
    # d to a (n,)-keyed relation
    dist = (proj * diff).agg((0, 1), "matAdd").map("rowSum").sum(0)

    # global argmin: concatenate the blocks and take (val, idx) once —
    # indices are then global by construction
    result = dist.concat(0, 0).map(make_to_val_idx(rows * n_blocks))
    return NNSearchProgram(dist, result)


# ==========================================================================
# §5.3 — two-layer FFNN SGD step
# ==========================================================================

@dataclasses.dataclass
class FFNNProgram:
    """One SGD step: inputs X, Y, W1, W2 → outputs W1', W2'."""

    w1_new: Expr
    w2_new: Expr
    a2: Expr
    g_w1: Optional[Expr] = None          # raw weight gradients
    g_w2: Optional[Expr] = None


def _ffnn_forward(nb, db, hb, lb, bn, bd, bh, bl):
    rx = E.input("X", (nb, db), (bn, bd))
    ry = E.input("Y", (nb, lb), (bn, bl))
    rw1 = E.input("W1", (db, hb), (bd, bh))
    rw2 = E.input("W2", (hb, lb), (bh, bl))
    a1 = (rx @ rw1).map("relu")
    z2 = a1 @ rw2
    a2 = z2.map("sigmoid")
    return rx, ry, rw1, rw2, a1, z2, a2


def ffnn_step_tra(nb: int, db: int, hb: int, lb: int,
                  bn: int, bd: int, bh: int, bl: int,
                  eta: float = 0.01) -> FFNNProgram:
    """Paper §5.3, with the backward pass **derived by autodiff** from the
    forward plan (Tang et al., arXiv 2306.00088) instead of hand-written.

    The forward pass is the paper's: ``a2 = σ(relu(X@W1)@W2)``.  The
    paper's hand backward uses the classic sigmoid-cross-entropy shortcut
    ``∂L/∂z2 = a2 − Y``; we reproduce it exactly by differentiating the
    *pre-activation* ``z2`` with the seed cotangent ``a2 − Y`` — the
    gradient expressions for W1 and W2 are then emitted by
    :func:`repro_torch.core.autodiff.grad`, not written out.  The hand-built
    version survives as :func:`ffnn_step_tra_hand`, the correctness
    oracle the autodiff output is tested against.
    """
    rx, ry, rw1, rw2, a1, z2, a2 = _ffnn_forward(
        nb, db, hb, lb, bn, bd, bh, bl)
    d_a2 = a2 - ry                       # ∂(Σ BCE(σ(z2), Y))/∂z2
    g_w1, g_w2 = z2.grad(["W1", "W2"], seed=d_a2)

    scale = make_scale_mul(eta)
    w2_new = rw2 - g_w2.map(scale)
    w1_new = rw1 - g_w1.map(scale)
    return FFNNProgram(w1_new, w2_new, a2, g_w1, g_w2)


def ffnn_step_tra_hand(nb: int, db: int, hb: int, lb: int,
                       bn: int, bd: int, bh: int, bl: int,
                       eta: float = 0.01) -> FFNNProgram:
    """Paper §5.3 verbatim (with relu/sigmoid activations) — the
    hand-written backward pass, kept as the autodiff correctness oracle.

    Key grids: X (nb, db), Y (nb, lb), W1 (db, hb), W2 (hb, lb); block
    bounds (bn, bd) etc.  The three roots share ``a1``/``a2``/``d_a2`` as
    DAG nodes, so one engine run over ``(w1_new, w2_new, a2)`` evaluates
    the forward pass once.
    """
    rx, ry, rw1, rw2, a1, z2, a2 = _ffnn_forward(
        nb, db, hb, lb, bn, bd, bh, bl)

    # backward.  NOTE an erratum in the paper's §5.3 expressions: the
    # weight-gradient aggregations are written Σ_(⟨0,2⟩,·) like the matmul
    # template, but their joins contract on key position 0 (the batch
    # block), so TRA-correct group-by keys are ⟨1,2⟩ — otherwise the
    # output would stay keyed by batch block.  (The JAX package's tests
    # verify it against a direct dense SGD step.)
    d_a2 = a2 - ry
    g_w2 = a1.join(d_a2, on=((0,), (0,)),
                   kernel="matTranMulL").agg((1, 2), "matAdd")
    d_a1_1 = d_a2.join(rw2, on=((1,), (1,)),
                       kernel="matTranMulR").agg((0, 2), "matAdd")
    d_a1 = a1.map("reluGrad") * d_a1_1
    g_w1 = rx.join(d_a1, on=((0,), (0,)),
                   kernel="matTranMulL").agg((1, 2), "matAdd")

    # update
    scale = make_scale_mul(eta)
    w2_new = rw2 - g_w2.map(scale)
    w1_new = rw1 - g_w1.map(scale)
    return FFNNProgram(w1_new, w2_new, a2, g_w1, g_w2)


def ffnn_train_step_tra(nb: int, db: int, hb: int, lb: int,
                        bn: int, bd: int, bh: int, bl: int,
                        optimizer=None):
    """§5.3 FFNN as ONE compiled TRA train step: forward + BCE loss +
    autodiff-derived backward + optimizer update, a single named
    multi-root program (see :mod:`repro_torch.core.train`).

    The loss root is the blockwise binary-cross-entropy partial sums
    (``bceSum`` join of ``a2`` with ``Y``, keyed by the (batch, label)
    block grid); its array total is the scalar Σ-BCE loss whose gradient
    w.r.t. the pre-activation ``z2`` is exactly the paper's seed
    ``a2 − Y`` — so the backward sub-DAG is the same autodiff derivation
    :func:`ffnn_step_tra` tests against the paper's hand expressions,
    now composed with the optimizer's update expressions instead of the
    fixed ``scaleMul`` SGD write-out.

    ``optimizer`` is any :class:`repro_torch.core.train.TraOptimizer`
    (default: plain :class:`~repro_torch.core.train.SGD` at the paper's
    η = 0.01).  Returns a :class:`repro_torch.core.train.TrainStep` whose
    ``roots`` compile once and re-dispatch every step on any executor.
    """
    from repro_torch.core.train import SGD, make_train_step
    if optimizer is None:
        optimizer = SGD(lr=0.01)
    rx, ry, rw1, rw2, a1, z2, a2 = _ffnn_forward(
        nb, db, hb, lb, bn, bd, bh, bl)
    loss = a2.join(ry, on=((0, 1), (0, 1)), kernel="bceSum")
    d_a2 = a2 - ry                       # ∂(Σ BCE(σ(z2), Y))/∂z2
    return make_train_step(loss, ["W1", "W2"], optimizer,
                           grad_of=z2, seed=d_a2)


def ffnn_dp_placements(nb, db, hb, lb) -> Dict[str, Placement]:
    """TRA-DP: batch-partitioned data, weights broadcast each step
    (stored partitioned on dim 0, as the paper describes)."""
    return {"X": Placement.partitioned((0,), S),
            "Y": Placement.partitioned((0,), S),
            "W1": Placement.partitioned((0,), S),
            "W2": Placement.partitioned((0,), S)}


def ffnn_mp_placements(nb, db, hb, lb) -> Dict[str, Placement]:
    """TRA-MP: intra-operator model parallelism — W1 col-, W2 row-
    partitioned; batches partitioned on the feature dim."""
    return {"X": Placement.partitioned((1,), S),
            "Y": Placement.partitioned((1,), S),
            "W1": Placement.partitioned((1,), S),
            "W2": Placement.partitioned((0,), S)}
