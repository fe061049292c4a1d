"""Port parity: plan-level autodiff and training
(``repro_torch.core.autodiff``, ``einsum_frontend``, ``train``,
``programs``, ``repro_torch.weights``).

* Gradients: the programs of ``tests/test_autodiff.py`` — every
  differentiable join kernel on either side, the unary kernels and
  structural ops (tile, concat, rekey, filter, pad, fan-in), max/min
  aggregations (ties included), masked inputs and einsum-built
  expressions — built with both packages; ``Engine.value_and_grad`` on
  the same numpy inputs agrees at 1e-5 (the port on its ``reference``
  walk and, for continuous inputs, on the optimized ``jit`` executor; the
  JAX package on its ``reference`` walk).  The einsum frontend's plans
  (``einsum_tra``) agree with the JAX package's, and the error paths
  raise the same errors.
* ``TraTrainer`` with SGD, Momentum and AdamW (with and without weight
  decay) over 30 steps of ``ffnn_train_step_tra``: every step's loss and
  the parameters after the last, against the JAX package's ``TraTrainer``
  on the same numpy data at 1e-4; one compile, then cached dispatch.
* ``ffnn_step_tra`` (the autodiff backward) against the port's
  ``ffnn_step_tra_hand`` (the paper's hand backward, its group-by erratum
  ported as is) and against the JAX package's, at 1e-5.
* The optimized step's ``FusedJoinAgg`` count equal to the JAX package's,
  and its forward products run once a step across the program's roots.
* A step resumed from the JAX trainer's state through
  ``weights.train_state_from_numpy``; optimizer state made on the
  parameters' device; the non-finite-loss budget; a trainer refusing
  missing initial parameters (the checkpoint store's cases are in
  ``test_torch_checkpoint.py``).
* The other programs of ``programs``: §5.2's nearest-neighbour search,
  §5.1's matmul with its hand-compiled IA plans (run on one device), the
  RMM cost and the FFNN placements, against the JAX package's.

Every JAX run is made once per module.  One file, so that xdist's
``--dist loadfile`` queue (files with more tests first) runs this JAX
work early, away from the reference's wall-clock tests near its end
(``ROADMAP.md`` C3).
"""
import functools
import zlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.core.kernels_registry as jkr  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.kernels_registry as tkr  # noqa: E402
from repro.core import programs as jprog  # noqa: E402
from repro_torch.core import programs as tprog  # noqa: E402
from repro_torch.weights import train_state_from_numpy  # noqa: E402
from _torch_helpers import CPU, as_np, normal, rng  # noqa: E402

GRAD_TOL = 1e-5
PKGS = {"jax": (jcore, jkr), "torch": (tcore, tkr)}

JOIN_CASES = {
    "matMul-bmm": (lambda E, K, a, b: a @ b,
                   [((2, 3), (4, 5)), ((3, 2), (5, 4))]),
    "matMul-join-only": (
        lambda E, K, a, b: a.join(b, on=((1,), (0,)), kernel="matMul"),
        [((2, 3), (4, 5)), ((3, 2), (5, 4))]),
    "matTranMulL": (
        lambda E, K, a, b: a.join(b, on=((0,), (0,)),
                                  kernel="matTranMulL").agg((1, 2),
                                                            "matAdd"),
        [((3, 2), (4, 3)), ((3, 2), (4, 5))]),
    "matTranMulR": (
        lambda E, K, a, b: a.join(b, on=((1,), (1,)),
                                  kernel="matTranMulR").agg((0, 2),
                                                            "matAdd"),
        [((2, 3), (4, 5)), ((2, 3), (6, 5))]),
    "matAdd": (lambda E, K, a, b: (a + b).sum(0),
               [((2, 3), (4, 5)), ((2, 3), (4, 5))]),
    "matSub": (lambda E, K, a, b: (a - b).map("sigmoid"),
               [((2, 3), (4, 5)), ((2, 3), (4, 5))]),
    "elemMul": (lambda E, K, a, b: (a * b).agg((1,), "matAdd"),
                [((2, 3), (4, 5)), ((2, 3), (4, 5))]),
    "matVecSub": (
        lambda E, K, q, x: q.join(x, on=((0,), (1,)),
                                  kernel="matVecSub").map("relu").sum(0),
        [((2,), (1, 4)), ((3, 2), (5, 4))]),
    "cross-frontier-min": (
        lambda E, K, a, b: a.join(b, on=((0,), (0,)),
                                  kernel="elemMul").agg((0, 1), "matAdd"),
        [((3, 2), (4, 4)), ((2, 2), (4, 4))]),
    "scale_by": (lambda E, K, a, s: (a * a).scale_by(s).map("sigmoid"),
                 [((2, 3), (4, 5)), ((1,), (1, 1))]),
}

UNARY_CASES = {
    "idOp": lambda E, K, m: m.map("idOp").sum(0),
    "relu": lambda E, K, m: m.map("relu").sum(0, 1),
    "sigmoid": lambda E, K, m: m.map("sigmoid"),
    "relu∘sigmoid": lambda E, K, m: m.map("sigmoid").map("relu").sum(1),
    "transpose": lambda E, K, m: m.map("transpose").map("sigmoid"),
    "scaleMul": lambda E, K, m: m.map(K.make_scale_mul(0.37)),
    "rowSum": lambda E, K, m: m.map("rowSum").sum(0),
    "diag": lambda E, K, m: m.map("diag").sum(1),
    "tile": lambda E, K, m: m.tile(1, 2).map("relu").sum(0, 1),
    "concat": lambda E, K, m: m.concat(0, 0).map("sigmoid"),
    "rekey-swap": lambda E, K, m: m.rekey(lambda kk: (kk[1], kk[0]),
                                          tag="swap").map("relu"),
    "rekey-holes": lambda E, K, m: m.rekey(lambda kk: (2 * kk[0], kk[1]),
                                           tag="spread").sum(1),
    "filter-hole": lambda E, K, m: m.filter(lambda kk: kk != (1, 1),
                                            tag="hole").agg((0, 1),
                                                            "matAdd"),
    "filter-shrink": lambda E, K, m: m.filter(lambda kk: kk[1] < 2,
                                              tag="shrink").sum(0, 1),
    "pad": lambda E, K, m: m.filter(lambda kk: kk[0] == 0,
                                    tag="row0").pad((2, 3)).map("relu"),
    "agg-bcast-back": lambda E, K, m: m.map("sigmoid").sum(1).map("relu"),
    "permuted-gb": lambda E, K, m: (m * m.map("sigmoid")).agg((1, 0),
                                                              "matAdd"),
    "fan-in": lambda E, K, m: (m.map("relu")
                               + m.map("relu").map("sigmoid")).sum(0, 1),
    "max": lambda E, K, m: m.agg((1,), "elemMax").map("sigmoid"),
    "min": lambda E, K, m: m.agg((0,), "elemMin"),
    "max-all-reduced": lambda E, K, m: m.agg((0, 1), "elemMax")
                                        .agg((1,), "elemMax"),
    "max-then-sum": lambda E, K, m: (m * m).agg((0,), "elemMax").sum(0),
    "max-ties": lambda E, K, m: m.agg((1,), "elemMax"),
}

MASKED_CASES = {
    "elemMul": lambda E, K, m, o: (m * o).sum(0),
    "matAdd": lambda E, K, m, o: (m + o).map("sigmoid"),
    "relu-masked": lambda E, K, m, o: m.map("relu").map("sigmoid"),
    "agg-masked": lambda E, K, m, o: m.agg((1,), "matAdd"),
}

EINSUM_CASES = {
    "ij,jk->ik": [((2, 3), (4, 5)), ((3, 2), (5, 4))],
    "ij,kj->ik": [((2, 3), (4, 5)), ((2, 3), (6, 5))],
    "ij,ij->ij": [((2, 3), (4, 5)), ((2, 3), (4, 5))],
    "ij,jk->ki": [((2, 3), (4, 5)), ((3, 2), (5, 4))],
    "ij->i": [((2, 3), (4, 5))],
    "ij->ji": [((2, 3), (4, 5))],
    "ij,jk,kl->il": [((2, 3), (4, 5)), ((3, 2), (5, 4)),
                     ((2, 2), (4, 3))],
    "ij,j->i": [((2, 3), (4, 5)), ((3,), (5,))],
    "bij,bjk->bik": [((2, 2, 3), (2, 4, 5)), ((2, 3, 2), (2, 5, 4))],
    "ij,ik->jk": [((3, 2), (5, 4)), ((3, 2), (5, 3))],
}


def _program(kind: str, case: str, pkg: str):
    """(expr, {name: (key shape, bound)}, {name: mask}) built with one
    package."""
    E, K = PKGS[pkg]
    if kind == "join":
        build, types = JOIN_CASES[case]
        names = ["L", "R"]
    elif kind == "unary":
        build, types, names = UNARY_CASES[case], [((2, 3), (4, 4))], ["M"]
    elif kind == "masked":
        build, types = MASKED_CASES[case], [((2, 3), (4, 4))] * 2
        names = ["M", "O"]
    else:
        types = EINSUM_CASES[case]
        names = ["A", "B", "C"][:len(types)]
        ins = [E.input(nm, ks, b) for nm, (ks, b) in zip(names, types)]
        return E.einsum(case, *ins), dict(zip(names, types)), {}
    ins = [E.input(nm, ks, b) for nm, (ks, b) in zip(names, types)]
    masks = {}
    if kind == "masked":
        masks["M"] = np.ones((2, 3), bool)
        masks["M"][0, 1] = False
    return build(E, K, *ins), dict(zip(names, types)), masks


def _wrt(case, expr):
    """The inputs the program reads, but the scalar of scale_by, which
    carries no cotangent (scaleBy's right vjp)."""
    names, todo = set(), [expr.node]
    while todo:
        n = todo.pop()
        if hasattr(n, "name"):
            names.add(n.name)
        todo += [getattr(n, a) for a in ("left", "right", "child")
                 if hasattr(n, a)]
    return sorted(names - {"R"} if case == "scale_by" else names)


def _inputs(kind, case, types):
    r = rng(zlib.crc32(f"{kind}/{case}".encode()) % 1000)
    out = {nm: normal(r, tuple(ks) + tuple(b)) for nm, (ks, b)
           in types.items()}
    if case == "max-ties":             # ties split the cotangent evenly
        base = np.arange(16, dtype=np.float32).reshape(4, 4)
        out["M"] = np.stack([base, base, base - 1.0, base, base, base],
                            axis=0).reshape(2, 3, 4, 4)
    return out


def _grad_rels(pkg, types, arrays, masks):
    E, _ = PKGS[pkg]
    conv = jnp.asarray if pkg == "jax" else \
        (lambda a: torch.from_numpy(a.copy()))
    return {nm: E.TensorRelation(conv(arrays[nm]),
                                 E.RelType(*map(tuple, types[nm])),
                                 masks.get(nm))
            for nm in types}


@functools.lru_cache(maxsize=None)
def _jax_grads(kind, case):
    """Every input's gradient of the JAX program, on its reference walk —
    computed once per module."""
    expr, types, masks = _program(kind, case, "jax")
    names = _wrt(case, expr)
    env = _grad_rels("jax", types, _inputs(kind, case, types), masks)
    env = {nm: env[nm] for nm in _wrt(None, expr)}
    eng = jcore.Engine(executor="reference", optimize=False)
    outs = eng.value_and_grad(expr, wrt=names).run(**env)
    return [(np.asarray(o.data), o.mask) for o in outs]


def _check(kind, case):
    want = _jax_grads(kind, case)
    expr, types, masks = _program(kind, case, "torch")
    arrays = _inputs(kind, case, types)
    names = _wrt(case, expr)
    used = _wrt(None, expr)
    executors = [("reference", False)]
    if not masks:
        executors.append(("jit", True))
    for executor, optimize in executors:
        eng = tcore.Engine(executor=executor, optimize=optimize, device=CPU)
        env = _grad_rels("torch", types, arrays, masks)
        got = eng.value_and_grad(expr, wrt=names).run(
            **{nm: env[nm] for nm in used})
        assert len(got) == len(want)
        for g, (w, wmask) in zip(got, want):
            gd = as_np(g)
            assert gd.shape == w.shape, (gd.shape, w.shape)
            if wmask is not None:
                np.testing.assert_array_equal(g.mask, wmask)
                sel = wmask.reshape(wmask.shape + (1,) * (w.ndim
                                                          - wmask.ndim))
                gd, w = gd * sel, w * sel
            np.testing.assert_allclose(gd, w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=f"{executor}")


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_join_kernel_gradients_match_jax(case):
    _check("join", case)


@pytest.mark.parametrize("case", sorted(UNARY_CASES))
def test_unary_structural_and_minmax_gradients_match_jax(case):
    _check("unary", case)


@pytest.mark.parametrize("case", sorted(MASKED_CASES))
def test_masked_input_gradients_match_jax(case):
    _check("masked", case)


@pytest.mark.parametrize("case", sorted(EINSUM_CASES))
def test_einsum_gradients_match_jax(case):
    _check("einsum", case)


def test_grad_takes_one_input_or_many():
    m = tcore.input("M", (2, 2), (4, 4))
    o = tcore.input("O", (2, 2), (4, 4))
    e = (m.map("relu") + o.map("sigmoid")).sum(0)
    assert isinstance(e.grad("M"), tcore.Expr)
    assert isinstance(e.grad(m), tcore.Expr)
    dm, do = e.grad(["M", "O"])
    eng = tcore.Engine(executor="jit", device=CPU)
    x = normal(rng(1), (2, 2, 4, 4))
    np.testing.assert_array_equal(as_np(eng.run(dm, M=x, O=x)),
                                  (x > 0).astype(np.float32))
    s = torch.sigmoid(torch.from_numpy(x))
    np.testing.assert_allclose(as_np(eng.run(do, M=x, O=x)),
                               (s * (1 - s)).numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)


def test_error_paths_raise_as_jax_does():
    a = tcore.input("A", (2,), (4, 4))
    b = tcore.input("B", (2,), (4, 4))
    with pytest.raises(tcore.AutodiffError, match="elemMax"):
        a.join(b, on=((0,), (0,)), kernel="elemMax").grad("A")
    m = tcore.input("M", (2, 2), (4, 4))
    with pytest.raises(tcore.ExprTypeError, match="elemMul") as ei:
        m.agg((0,), "elemMul").grad("M")
    for alt in ("matAdd", "elemMax", "elemMin"):
        assert alt in str(ei.value)
    e = m.map("relu")
    with pytest.raises(tcore.AutodiffError, match="do not occur"):
        e.grad("Q")
    with pytest.raises(tcore.AutodiffError, match="seed type"):
        e.grad("M", seed=tcore.const(1.0, (2, 2), (3, 3)))
    with pytest.raises(tcore.ExprTypeError, match="scalar relation"):
        m.scale_by(m)
    with pytest.raises(tcore.ExprTypeError, match="2 terms"):
        tcore.einsum("ij,jk->ik", m)
    with pytest.raises(tcore.ExprTypeError, match="needs 3 key dims"):
        tcore.einsum("ijk->i", m)


def test_backward_plans_have_the_same_shape_in_both_packages():
    """The derived ∂/∂W2 of the §5.3 forward is the paper's hand
    expression, Σ_(1,2)(⋈_(0,0)(a1, a2−Y, matTranMulL)), in both; the
    optimizer fuses both gradients of the port's plan, as JAX's."""
    from repro.core.programs import ffnn_step_tra as jstep
    from repro_torch.core.programs import ffnn_step_tra as tstep
    dims = (4, 2, 2, 2, 4, 4, 4, 2)
    jp, tp = jstep(*dims), tstep(*dims)
    for g in ("g_w1", "g_w2"):
        assert getattr(tp, g).describe() == getattr(jp, g).describe()
        jeng = jcore.Engine(executor="jit", axis_sizes={"sites": 2})
        teng = tcore.Engine(executor="jit", axis_sizes={"sites": 2},
                            device=CPU)
        jd = jeng.compile(getattr(jp, g)).describe()
        td = teng.compile(getattr(tp, g)).describe()
        assert td.count("FusedJoinAgg") == jd.count("FusedJoinAgg") >= 1


# ------------------------------------------------------ einsum frontend
FRONTEND_CASES = [
    ("ij,jk->ik", [(8, 12), (12, 16)], [(4, 4), (4, 4)]),
    ("ij,jk,kl->il", [(8, 12), (12, 16), (16, 6)],
     [(4, 4), (4, 4), (4, 3)]),
    ("ij,jk->ki", [(8, 12), (12, 16)], [(4, 4), (4, 4)]),
    ("bij,bjk->bik", [(4, 8, 12), (4, 12, 8)], [(2, 4, 4), (2, 4, 4)]),
    ("ij->i", [(8, 12)], [(4, 4)]),
    ("ij,ij->ij", [(8, 12), (8, 12)], [(4, 4), (4, 4)]),
    ("ij,j->i", [(8, 12), (12,)], [(4, 4), (4,)]),
]


@pytest.mark.parametrize("case", range(len(FRONTEND_CASES)))
def test_einsum_frontend_matches_jax(case):
    """``einsum_tra`` (the spec-dict form) builds the same plan in both
    packages and evaluates to the same relation, and to ``torch.einsum``
    of the dense tensors."""
    from repro.core import einsum_frontend as jef
    from repro_torch.core import einsum_frontend as tef
    spec, shapes, tiles = FRONTEND_CASES[case]
    lhs = tef.parse_spec(spec)[0]
    assert lhs == jef.parse_spec(spec)[0]
    r = rng(30 + case)
    dense = [normal(r, s) for s in shapes]
    plans, envs = {}, {"jax": {}, "torch": {}}
    for pkg, ef in (("jax", jef), ("torch", tef)):
        ops = [ef.OperandSpec(f"T{i}", idx,
                              tuple(s // b for s, b in zip(t.shape, tile)),
                              tuple(tile))
               for i, (idx, t, tile) in enumerate(zip(lhs, dense, tiles))]
        plans[pkg] = ef.einsum_tra(spec, ops)
    for i, (t, tile) in enumerate(zip(dense, tiles)):
        envs["jax"][f"T{i}"] = jcore.from_tensor(jnp.asarray(t), tile)
        envs["torch"][f"T{i}"] = tcore.from_tensor(torch.from_numpy(t),
                                                   tile)
    assert tcore.describe(plans["torch"]) == jcore.describe(plans["jax"])
    want = jcore.Engine(executor="reference", optimize=False).run(
        plans["jax"], **envs["jax"])
    got = tcore.Engine(executor="jit", device=CPU).run(plans["torch"],
                                                       **envs["torch"])
    np.testing.assert_allclose(as_np(got), np.asarray(want.data),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(
        as_np(tcore.to_tensor(got)),
        torch.einsum(spec, *map(torch.from_numpy, dense)).numpy(),
        rtol=1e-4, atol=1e-4)


# ================================================================ training
DIMS = (4, 2, 2, 2, 4, 4, 4, 2)          # nb db hb lb bn bd bh bl
BENCH_DIMS = (8, 4, 4, 2, 64, 64, 64, 32)    # benchmarks/train.py's
STEPS = 30
TOL = 1e-4                               # 30 train steps

OPTIMIZERS = {
    "sgd": lambda m: m.SGD(0.05),
    "momentum": lambda m: m.Momentum(0.05, 0.9),
    "adamw": lambda m: m.AdamW(1e-2, weight_decay=0.01),
    "adamw-plain": lambda m: m.AdamW(1e-2),
}


def _data(dims=DIMS, seed=0):
    """X normal, Y = sigmoid(X·Wt), W1 and W2 scaled by D^-1/2 and
    H^-1/2, as ``benchmarks/train.py`` draws them (from numpy here)."""
    nb, db, hb, lb, bn, bd, bh, bl = dims
    n, d, h, l_ = nb * bn, db * bd, hb * bh, lb * bl
    r = rng(seed)
    x = normal(r, (n, d))
    wt = normal(r, (d, l_)) * 0.5
    y = (1.0 / (1.0 + np.exp(-(x @ wt)))).astype(np.float32)
    w1 = normal(r, (d, h)) * np.float32(d ** -0.5)
    w2 = normal(r, (h, l_)) * np.float32(h ** -0.5)
    return {"X": x, "Y": y, "W1": w1, "W2": w2}


def _rels(pkg, arrays, dims=DIMS):
    """(data, params) relations of one package, blocked as the program."""
    nb, db, hb, lb, bn, bd, bh, bl = dims
    tiles = {"X": (bn, bd), "Y": (bn, bl), "W1": (bd, bh), "W2": (bh, bl)}
    if pkg == "jax":
        rel = {k: jcore.from_tensor(jnp.asarray(arrays[k]), t)
               for k, t in tiles.items()}
    else:
        rel = {k: tcore.from_tensor(torch.from_numpy(arrays[k].copy()), t)
               for k, t in tiles.items()}
    return ({k: rel[k] for k in ("X", "Y")},
            {k: rel[k] for k in ("W1", "W2")})


@functools.lru_cache(maxsize=None)
def _jax_run(name, steps=STEPS, dims=DIMS):
    """JAX's trainer over ``steps`` steps: the losses, and the parameters
    and optimizer state after each of the first three steps and the
    last (numpy)."""
    data, params = _rels("jax", _data(dims), dims)
    step = jprog.ffnn_train_step_tra(*dims, optimizer=OPTIMIZERS[name](
        jcore))
    trainer = jcore.TraTrainer(jcore.Engine(executor="jit", optimize=False),
                               step, params=params)
    snaps = {}
    for t in range(1, steps + 1):
        trainer.step(**data)
        if t <= 3 or t == steps:
            snaps[t] = {k: np.asarray(r.data) for k, r in
                        {**trainer.params, **trainer.state}.items()}
    return list(trainer.history), snaps


def _port_trainer(name, optimize=True, executor="jit", dims=DIMS):
    data, params = _rels("torch", _data(dims), dims)
    step = tprog.ffnn_train_step_tra(*dims, optimizer=OPTIMIZERS[name](
        tcore))
    eng = tcore.Engine(executor=executor, optimize=optimize, device=CPU)
    return tcore.TraTrainer(eng, step, params=params), data


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_trainer_matches_jax_over_30_steps(name):
    want_losses, snaps = _jax_run(name)
    trainer, data = _port_trainer(name)
    losses = trainer.fit(STEPS, **data)
    np.testing.assert_allclose(losses, want_losses, rtol=TOL, atol=TOL)
    for k, want in snaps[STEPS].items():
        got = {**trainer.params, **trainer.state}[k]
        np.testing.assert_allclose(as_np(got), want, rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert losses[-1] < losses[0]
    assert trainer.engine.cache_misses == 1
    assert trainer.engine.cache_hits == STEPS - 1


def test_trainer_on_the_reference_walk_matches_jax():
    want_losses, snaps = _jax_run("adamw-plain")
    trainer, data = _port_trainer("adamw-plain", optimize=False,
                                  executor="reference")
    losses = trainer.fit(3, **data)
    np.testing.assert_allclose(losses, want_losses[:3], rtol=TOL, atol=TOL)
    for k in ("W1", "W2", "W1.m", "W2.v", "opt.step"):
        np.testing.assert_allclose(
            as_np({**trainer.params, **trainer.state}[k]), snaps[3][k],
            rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("shape", [(4, 2, 2, 2, 4, 4, 4, 2),
                                   (2, 4, 4, 2, 4, 4, 4, 2),
                                   (2, 2, 2, 2, 4, 4, 4, 2)])
def test_ffnn_step_matches_hand_backward_and_jax(shape):
    """The autodiff-derived SGD step against the paper's hand backward
    (group-by erratum and all) in the port, and against the JAX
    package's autodiff step, at 1e-5; the raw gradients too."""
    arrays = _data(shape, seed=3)
    jdata, jparams = _rels("jax", arrays, shape)
    tdata, tparams = _rels("torch", arrays, shape)
    jenv, tenv = {**jdata, **jparams}, {**tdata, **tparams}
    jp = jprog.ffnn_step_tra(*shape, eta=0.01)
    want = jcore.Engine(executor="jit", optimize=False).run(
        (jp.w1_new, jp.w2_new, jp.g_w1, jp.g_w2), **jenv)
    eng = tcore.Engine(executor="jit", device=CPU)
    for build in (tprog.ffnn_step_tra, tprog.ffnn_step_tra_hand):
        tp = build(*shape, eta=0.01)
        got = eng.run((tp.w1_new, tp.w2_new, tp.g_w1, tp.g_w2), **tenv)
        for g, w in zip(got, want):
            np.testing.assert_allclose(as_np(g), np.asarray(w.data),
                                       rtol=1e-5, atol=1e-5)


def test_value_and_grad_of_the_forward_matches_jax():
    arrays = _data(seed=4)
    jdata, jparams = _rels("jax", arrays)
    tdata, tparams = _rels("torch", arrays)
    jp, tp = jprog.ffnn_step_tra(*DIMS), tprog.ffnn_step_tra(*DIMS)
    want = jcore.Engine(executor="jit", optimize=False).value_and_grad(
        jp.a2, wrt=["W1", "W2"]).run(X=jdata["X"], **jparams)
    for executor in ("reference", "jit"):
        got = tcore.Engine(executor=executor, device=CPU).value_and_grad(
            tp.a2, wrt=["W1", "W2"]).run(X=tdata["X"], **tparams)
        for g, w in zip(got, want):
            np.testing.assert_allclose(as_np(g), np.asarray(w.data),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sites", [1, 2])
def test_optimized_step_fuses_as_jax_does(sites):
    """The same number of ``FusedJoinAgg`` nodes in the optimized train
    step (34 at ``benchmarks/train.py``'s dims on two sites, as
    ``BENCH_train.json`` records)."""
    jstep = jprog.ffnn_train_step_tra(*BENCH_DIMS,
                                      optimizer=jcore.AdamW(1e-2))
    tstep = tprog.ffnn_train_step_tra(*BENCH_DIMS,
                                      optimizer=tcore.AdamW(1e-2))
    jd = jcore.Engine(executor="jit", axis_sizes={"sites": sites}).compile(
        jstep.roots).describe()
    td = tcore.Engine(executor="jit", axis_sizes={"sites": sites},
                      device=CPU).compile(tstep.roots).describe()
    assert td.count("FusedJoinAgg") == jd.count("FusedJoinAgg") > 0
    if sites == 2:
        assert td.count("FusedJoinAgg") == 34


def test_forward_products_run_once_a_step(monkeypatch):
    """Each root of the train step is optimized on its own, so the
    physical plans hold several copies of the forward pass; the ``jit``
    schedule runs each structurally distinct node once, so a step makes
    the two forward products once each.  At ``db`` and ``hb`` above 2 the
    optimizer fuses both products (at 2 the unfused pair ties on its
    temporaries and is kept), as at the speech-100k blocking."""
    from repro_torch.kernels.matmul import ops
    calls = []
    real = ops.matmul

    def spy(a, b, **kw):
        calls.append(kw.get("a_rows"))
        return real(a, b, **kw)

    monkeypatch.setattr(ops, "matmul", spy)
    dims = (2, 3, 3, 1, 4, 4, 4, 2)
    trainer, data = _port_trainer("adamw-plain", dims=dims)
    assert "FusedJoinAgg(LocalJoin(L[1]=R[0], matMul)" in \
        trainer.engine.compile(trainer.program.roots).describe()
    trainer.fit(3, **data)
    assert len(calls) == 2 * 3
    want_losses, _ = _jax_run("adamw-plain", 3, dims)
    np.testing.assert_allclose(trainer.history, want_losses[:3], rtol=TOL,
                               atol=TOL)


def test_step_resumes_from_the_jax_state():
    """Three JAX steps, then the state carried over as numpy: the port's
    fourth step equals JAX's fourth."""
    want_losses, snaps = _jax_run("adamw")
    step = tprog.ffnn_train_step_tra(*DIMS, optimizer=tcore.AdamW(
        1e-2, weight_decay=0.01))
    params, state = train_state_from_numpy(step, snaps[3], device=CPU)
    assert set(state) == {"W1.m", "W1.v", "W2.m", "W2.v", "opt.step"}
    data, _ = _rels("torch", _data())
    trainer = tcore.TraTrainer(tcore.Engine(executor="jit", device=CPU),
                               step, params=params)
    trainer.state = state
    loss = trainer.step(**data)
    np.testing.assert_allclose(loss, want_losses[3], rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="do not match"):
        train_state_from_numpy(step, {"W1": snaps[3]["W1"]}, device=CPU)
    bad = dict(snaps[3], W1=snaps[3]["W1"][:1])
    with pytest.raises(ValueError, match="does not fit"):
        train_state_from_numpy(step, bad, device=CPU)


def test_optimizer_state_lies_on_the_parameters_device():
    rt = tcore.RelType((2, 2), (3, 4))
    meta = {"W": tcore.TensorRelation(torch.empty((2, 2, 3, 4),
                                                  device="meta"), rt)}
    for opt in (tcore.Momentum(), tcore.AdamW()):
        state = opt.init_state(meta)
        assert state and all(r.data.device.type == "meta"
                             for r in state.values())
    mixed = dict(meta, V=tcore.TensorRelation(torch.zeros((2, 2, 3, 4)),
                                              rt))
    with pytest.raises(ValueError, match="devices"):
        tcore.AdamW().init_state(mixed)


def test_nonfinite_loss_budget():
    trainer, data = _port_trainer("sgd")
    bad = dict(data, X=tcore.TensorRelation(
        torch.full_like(data["X"].data, float("nan")), data["X"].rtype))
    trainer.skip_nonfinite = 1
    w1 = trainer.params["W1"]
    assert np.isnan(trainer.step(**bad))
    assert trainer.params["W1"] is w1 and trainer.step_count == 0
    with pytest.raises(tcore.NumericsError, match="consecutive"):
        trainer.step(**bad)
    trainer.skip_nonfinite = 0
    assert np.isnan(trainer.step(**bad))      # no budget: the step applies
    assert trainer.step_count == 1


def test_trainer_refuses_missing_initial_parameters():
    trainer, _ = _port_trainer("sgd")
    with pytest.raises(ValueError, match="missing initial parameters"):
        tcore.TraTrainer(trainer.engine, trainer.program, params={})


# ---------------------------------------------- the other paper programs
def test_nn_search_matches_jax():
    """§5.2: the Riemannian-metric distances and the (value, index) argmin,
    on both executors, against the JAX package's program."""
    nb, dbk, rows, dcol = 4, 2, 3, 4
    r = rng(9)
    arrays = {"xq": normal(r, (dbk, 1, dcol)),
              "X": normal(r, (nb, dbk, rows, dcol))}
    a = normal(r, (dbk * dcol, dbk * dcol))
    arrays["A"] = (a @ a.T).reshape(dbk, dcol, dbk, dcol).transpose(
        0, 2, 1, 3).copy()
    jp, tp = jprog.nn_search_tra(nb, dbk, rows, dcol), \
        tprog.nn_search_tra(nb, dbk, rows, dcol)
    want = jcore.Engine(executor="jit", optimize=False).run(
        (jp.dist, jp.result), **{k: jnp.asarray(v) for k, v in
                                 arrays.items()})
    for executor in ("reference", "jit"):
        got = tcore.Engine(executor=executor, device=CPU).run(
            (tp.dist, tp.result), **arrays)
        for g, w in zip(got, want):
            np.testing.assert_allclose(as_np(g), np.asarray(w.data),
                                       rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("plan", ["bmm_plan", "cpmm_plan",
                                  "cpmm_two_phase_plan", "bmm_fused_plan",
                                  "cpmm_fused_plan"])
def test_ia_plans_match_jax_and_run_on_one_device(plan):
    """§5.1's hand-compiled plans build in the port as in the JAX package
    (same description and cost on four sites) and, on one device, compute
    A @ B."""
    shapes = ((4, 2), (2, 4), (3, 5), (5, 2))
    jplan, tplan = getattr(jprog, plan)(*shapes), \
        getattr(tprog, plan)(*shapes)
    assert tcore.describe(tplan) == jcore.describe(jplan)
    sz = {"sites": 4}
    assert tcore.cost_plan(tplan, sz).comm_floats == \
        jcore.cost_plan(jplan, sz).comm_floats
    r = rng(10)
    a, b = normal(r, (12, 10)), normal(r, (10, 8))
    got = tcore.Engine(executor="jit", device=CPU).run(
        tplan, A=tcore.from_tensor(torch.from_numpy(a), (3, 5)),
        B=tcore.from_tensor(torch.from_numpy(b), (5, 2)))
    np.testing.assert_allclose(as_np(tcore.to_tensor(got)), a @ b,
                               rtol=1e-5, atol=1e-5)


def test_matmul_program_cost_and_placements_match_jax():
    shapes = ((4, 2), (2, 4), (3, 5), (5, 2))
    want = jcore.Engine(executor="reference", optimize=False).run(
        jprog.matmul_tra(*shapes),
        A=jnp.asarray(normal(rng(11), (4, 2, 3, 5))),
        B=jnp.asarray(normal(rng(12), (2, 4, 5, 2))))
    got = tcore.Engine(executor="jit", device=CPU).run(
        tprog.matmul_tra(*shapes), A=normal(rng(11), (4, 2, 3, 5)),
        B=normal(rng(12), (2, 4, 5, 2)))
    np.testing.assert_allclose(as_np(got), np.asarray(want.data),
                               rtol=1e-5, atol=1e-5)
    for sites in (2, 4, 8):
        for acc in ("paper", "wire"):
            assert tprog.rmm_cost(*shapes, sites, acc) == \
                jprog.rmm_cost(*shapes, sites, acc)
    for name in ("ffnn_dp_placements", "ffnn_mp_placements"):
        tp, jp = getattr(tprog, name)(4, 2, 2, 2), \
            getattr(jprog, name)(4, 2, 2, 2)
        assert {k: (p.kind, p.dims, p.axes) for k, p in tp.items()} == \
            {k: (p.kind, p.dims, p.axes) for k, p in jp.items()}
