"""Port parity: the mesh executors in one process, and their plans.

The JAX package's tests run ``gspmd`` and ``shard_map`` on a one-device
mesh (``make_mesh((1,), S)``); here the port's run on a one-rank gloo
group made once for the module (``init_sites`` on a ``FileStore``), held
against JAX's own gspmd and shard_map engines on that mesh, in this
process, at those tests' tolerances (``tests/test_train.py:175``,
``tests/test_autodiff.py:378``, ``:456``, ``:473``,
``tests/test_oocore.py:74-76``, ``tests/test_robustness.py:201``,
``:267``).  Then plan parity without a mesh: for every program of
``tests/_distributed_checks.py``, at ``{"sites": 8}`` and ``{"s0": 4,
"s1": 2}``, the port's compiled plan equals JAX's — its text, its cost
and its collective schedule.  The multi-rank runs are in
``tests/test_torch_mesh_sites.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as jtra  # noqa: E402
import repro_torch.core as ttra  # noqa: E402
from _torch_helpers import CPU, as_np  # noqa: E402

S = ("sites",)
MESH_EXECUTORS = ("gspmd", "shard_map")
DIMS = (4, 2, 2, 2, 4, 4, 4, 2)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A one-rank gloo group and its ``("sites",)`` mesh, for the module."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_sites, make_mesh
    path = str(tmp_path_factory.mktemp("sites") / "store")
    init_sites("gloo", store=dist.FileStore(path, 1), rank=0, world_size=1,
               device="cpu")
    try:
        yield make_mesh((1,), S, device="cpu")
    finally:
        dist.destroy_process_group()


def _jmesh():
    from repro.launch.mesh import make_mesh
    return make_mesh((1,), S)


def _np(rel):
    return as_np(ttra.to_tensor(rel) if hasattr(rel, "rtype") else rel)


def _jnp(rel):
    return np.asarray(jtra.to_tensor(rel), np.float32)


def _rel(seed, key_shape, bound):
    """The same random relation for JAX and the port."""
    import jax.numpy as jnp
    data = np.asarray(np.random.default_rng(seed).normal(
        size=tuple(key_shape) + tuple(bound)), np.float32)
    return (jtra.TensorRelation(jnp.asarray(data),
                                jtra.RelType(key_shape, bound)),
            ttra.TensorRelation(torch.from_numpy(data.copy()),
                                ttra.RelType(key_shape, bound)))


def _tplaces(spec):
    return {k: ttra.Placement.replicated() if v is None
            else ttra.Placement.partitioned(*v) for k, v in spec.items()}


def _jplaces(spec):
    return {k: jtra.Placement.replicated() if v is None
            else jtra.Placement.partitioned(*v) for k, v in spec.items()}


def _train_data():
    """tests/test_train.py's data for DIMS, as numpy."""
    import jax
    nb, db, hb, lb, bn, bd, bh, bl = DIMS
    n, d, h, l_ = nb * bn, db * bd, hb * bh, lb * bl
    x = jax.random.normal(jax.random.PRNGKey(0), (n, d))
    wt = jax.random.normal(jax.random.PRNGKey(4), (d, l_)) * 0.5
    y = jax.nn.sigmoid(x @ wt)
    w1 = jax.random.normal(jax.random.PRNGKey(2), (d, h)) * 0.3
    w2 = jax.random.normal(jax.random.PRNGKey(3), (h, l_)) * 0.3
    return {k: np.asarray(v, np.float32)
            for k, v in (("X", x), ("Y", y), ("W1", w1), ("W2", w2))}


def _blocked(dense, tiles):
    """The dense arrays blocked by ``tiles``, for JAX and for the port."""
    import jax.numpy as jnp
    return ({k: jtra.from_tensor(jnp.asarray(dense[k]), t)
             for k, t in tiles.items()},
            {k: ttra.from_tensor(torch.from_numpy(dense[k].copy()), t)
             for k, t in tiles.items()})


TRAIN_PLACES = {"X": ((0,), S), "Y": ((0,), S), "W1": None, "W2": None}


# ==========================================================================
# tests/test_train.py:175 — the FFNN trains on the mesh executors
# ==========================================================================

@pytest.mark.parametrize("executor", MESH_EXECUTORS)
def test_ffnn_trains_like_jax_on_the_mesh_executor(mesh, executor):
    from repro.core.programs import ffnn_train_step_tra as jstep
    from repro_torch.core.programs import ffnn_train_step_tra as tstep
    nb, db, hb, lb, bn, bd, bh, bl = DIMS
    dense = _train_data()
    tiles = {"X": (bn, bd), "Y": (bn, bl), "W1": (bd, bh), "W2": (bh, bl)}
    jrel, trel = _blocked(dense, tiles)
    jeng = jtra.Engine(_jmesh(), executor=executor,
                       input_placements=_jplaces(TRAIN_PLACES))
    teng = ttra.Engine(mesh, executor=executor,
                       input_placements=_tplaces(TRAIN_PLACES))
    jtr = jtra.TraTrainer(jeng, jstep(*DIMS, optimizer=jtra.AdamW(1e-2)),
                          params={k: jrel[k] for k in ("W1", "W2")})
    ttr = ttra.TraTrainer(teng, tstep(*DIMS, optimizer=ttra.AdamW(1e-2)),
                          params={k: trel[k] for k in ("W1", "W2")})
    for _ in range(30):
        want = jtr.step(X=jrel["X"], Y=jrel["Y"])
        got = ttr.step(X=trel["X"], Y=trel["Y"])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        for k in ("W1", "W2"):
            np.testing.assert_allclose(_np(ttr.params[k]),
                                       _jnp(jtr.params[k]),
                                       atol=1e-4, rtol=1e-4)
    assert ttr.history[-1] < ttr.history[0]
    assert teng.cache_hits == jeng.cache_hits == 29
    assert teng.cache_misses == 1


# ==========================================================================
# tests/test_autodiff.py:378, :456, :473
# ==========================================================================

@pytest.mark.parametrize("executor", MESH_EXECUTORS)
def test_value_and_grad_matches_jax_on_the_mesh_executor(mesh, executor):
    from repro.core.programs import ffnn_step_tra as jprog
    from repro_torch.core.programs import ffnn_step_tra as tprog
    dims = (4, 2, 2, 2, 4, 4, 4, 2)
    nb, db, hb, lb, bn, bd, bh, bl = dims
    dense = _train_data()
    tiles = {"X": (bn, bd), "W1": (bd, bh), "W2": (bh, bl)}
    jrel, trel = _blocked(dense, tiles)
    places = {"X": ((0,), S), "W1": None, "W2": None}
    jvg = jtra.Engine(_jmesh(), executor=executor,
                      input_placements=_jplaces(places)).value_and_grad(
        jprog(*dims).a2, wrt=["W1", "W2"])
    tvg = ttra.Engine(mesh, executor=executor,
                      input_placements=_tplaces(places)).value_and_grad(
        tprog(*dims).a2, wrt=["W1", "W2"])
    assert tvg.grad_wrt == jvg.grad_wrt == ("W1", "W2")
    for got, want in zip(tvg.run(**trel), jvg.run(**jrel)):
        assert type(got.data).__name__ == "DTensor"
        np.testing.assert_allclose(_np(got), _jnp(want), atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("executor", MESH_EXECUTORS)
def test_multi_root_matches_jax_on_the_mesh_executor(mesh, executor):
    def roots(mod):
        a = mod.input("A", (2, 2), (4, 4))
        b = mod.input("B", (2, 2), (4, 4))
        return (a @ b), (a + b).sum(0)
    (ja, ta), (jb, tb) = _rel(41, (2, 2), (4, 4)), _rel(42, (2, 2), (4, 4))
    want = jtra.Engine(_jmesh(), executor=executor).run(roots(jtra), A=ja,
                                                        B=jb)
    got = ttra.Engine(mesh, executor=executor).run(roots(ttra), A=ta, B=tb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(as_np(g.data.full_tensor()),
                                   np.asarray(w.data), atol=1e-5)


@pytest.mark.parametrize("executor", MESH_EXECUTORS)
def test_const_and_pad_match_jax_on_the_mesh_executor(mesh, executor):
    def expr(mod):
        ones = mod.const(1.0, (2, 2), (4, 4))
        m = mod.input("M", (2, 2), (4, 4))
        return (m * ones).pad((3, 3)).sum(0, 1)
    jm, tm = _rel(51, (2, 2), (4, 4))
    want = jtra.Engine(_jmesh(), executor=executor).run(expr(jtra), M=jm)
    got = ttra.Engine(mesh, executor=executor).run(expr(ttra), M=tm)
    np.testing.assert_allclose(as_np(got.data.full_tensor()),
                               np.asarray(want.data), atol=1e-6)


# ==========================================================================
# tests/test_oocore.py:74-76 — streamed equals resident on every executor
# ==========================================================================

@pytest.mark.parametrize("executor", MESH_EXECUTORS)
@pytest.mark.parametrize("chunk_keys", [1, 3, 8])
def test_stream_out_matches_the_mesh_executor(mesh, executor, chunk_keys):
    from repro_torch.launch.metering import StreamStats
    from repro_torch.store.stream import StreamExecutor

    def expr(mod):
        return mod.input("A", (8, 2), (8, 8)) @ mod.input("B", (2, 3),
                                                          (8, 8))
    (ja, ta), (jb, tb) = _rel(0, (8, 2), (8, 8)), _rel(1, (2, 3), (8, 8))
    jres = jtra.Engine(_jmesh(), executor=executor).run(expr(jtra), A=ja,
                                                        B=jb)
    tres = ttra.Engine(mesh, executor=executor).run(expr(ttra), A=ta, B=tb)
    np.testing.assert_allclose(as_np(tres.data.full_tensor()),
                               np.asarray(jres.data), atol=1e-5, rtol=1e-5)
    se = StreamExecutor(ttra.Engine(executor="jit", device=CPU),
                        budget=1 << 30)
    sp = se.plan(expr(ttra), force=True, chunk_keys=chunk_keys)
    assert sp.mode == "stream-out" and sp.chunk_keys == chunk_keys
    stats = StreamStats()
    got = se.execute(sp, {"A": ta, "B": tb}, stats)
    np.testing.assert_allclose(as_np(got.data), np.asarray(jres.data),
                               atol=1e-5, rtol=1e-5)
    assert stats.chunks == sp.nchunks == -(-8 // chunk_keys)


# ==========================================================================
# tests/test_robustness.py:201, :267
# ==========================================================================

def _bmm(mod):
    return mod.input("A", (4, 3), (2, 2)) @ mod.input("B", (3, 5), (2, 2))


def _bmm_data(nan_in_a=False):
    r = np.random.default_rng(0)
    a = r.normal(size=(4, 3, 2, 2)).astype(np.float32)
    b = r.normal(size=(3, 5, 2, 2)).astype(np.float32)
    if nan_in_a:
        a[1, 2, 0, 1] = np.nan
    return a, b


@pytest.mark.parametrize("executor", MESH_EXECUTORS)
def test_mesh_executors_check_outputs(mesh, executor):
    a, b = _bmm_data(nan_in_a=True)
    for mod, eng_mesh in ((jtra, _jmesh()), (ttra, mesh)):
        eng = mod.Engine(eng_mesh, executor=executor, check_numerics=True)
        with pytest.raises(mod.NumericsError, match="output"):
            eng.run(_bmm(mod), A=a, B=b)


@pytest.mark.parametrize("executor", MESH_EXECUTORS)
def test_oom_ladder_completes_like_jax_on_the_mesh_executor(mesh, executor):
    from repro.core.faults import FaultInjector as JInj
    from repro_torch.core.engine import DEFAULT_OOM_LADDER_START
    from repro_torch.core.faults import FaultInjector as TInj
    a, b = _bmm_data()
    base = np.asarray(jtra.Engine(executor="reference").run(
        _bmm(jtra), A=a, B=b).data)
    logs = []
    for mod, eng_mesh, inj in ((jtra, _jmesh(), JInj()),
                               (ttra, mesh, TInj())):
        inj.inject_oom(ok_chunk=2)
        eng = mod.Engine(eng_mesh, executor=executor, fault_injector=inj,
                         degrade=True)
        with pytest.warns(RuntimeWarning, match="streamed"):
            out = eng.run(_bmm(mod), A=a, B=b).data
        np.testing.assert_allclose(as_np(getattr(out, "full_tensor",
                                                 lambda: out)()),
                                   base, atol=1e-4)
        logs.append([d for k, d in inj.log if k == "oom"])
    assert any("unstreamed" in d for d in logs[1])
    assert any(f"chunk={DEFAULT_OOM_LADDER_START}" in d for d in logs[1])
    assert len(logs[1]) == len(logs[0])


# ==========================================================================
# The engine's mesh surface
# ==========================================================================

@pytest.mark.parametrize("executor", MESH_EXECUTORS)
def test_mesh_executor_without_a_mesh_raises_at_compile(executor):
    """``tests/test_expr_engine.py:346-351``'s refusal."""
    eng = ttra.Engine(executor=executor, device=CPU)
    with pytest.raises(ValueError, match="requires a mesh"):
        eng.compile(_bmm(ttra))


def test_auto_is_gspmd_on_a_mesh_and_the_mesh_names_the_axes(mesh):
    eng = ttra.Engine(mesh)
    assert eng._resolve_executor() == "gspmd"
    assert eng.site_axes == S and eng.axis_sizes == {"sites": 1}
    assert eng.device == CPU
    assert ttra.Engine(device=CPU)._resolve_executor() == "jit"


def test_a_dtensor_reaching_the_matmul_op_raises(mesh):
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.matmul import ops
    a = DTensor.from_local(torch.ones(4, 4), mesh, [Replicate()])
    with pytest.raises(TypeError, match="DTensor"):
        ops.matmul(a, torch.ones(4, 4))


def test_mesh_makers_check_the_world_size(mesh):
    from repro_torch.launch.mesh import (make_host_mesh, make_mesh,
                                         make_production_mesh)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh((2,), S, device="cpu")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh(device="cpu")
    assert make_host_mesh(1, 1, device="cpu").mesh_dim_names == \
        ("data", "model")


@pytest.mark.parametrize("executor", MESH_EXECUTORS)
def test_a_dispatch_records_its_collectives(mesh, executor):
    """At one rank the CPMM plan's exchange still runs (a copy) and is
    recorded; on shard_map the record is the lowering's schedule."""
    from repro_torch.core.shardmap_exec import COLLECTIVES, expected_schedule
    (ja, ta), (jb, tb) = _rel(3, (8, 8), (4, 8)), _rel(4, (8, 8), (8, 4))
    places = {"A": ((1,), S), "B": ((0,), S)}
    expr = ttra.input("A", (8, 8), (4, 8)) @ ttra.input("B", (8, 8), (8, 4))
    eng = ttra.Engine(mesh, executor=executor,
                      input_placements=_tplaces(places), axis_sizes={
                          "sites": 8})
    compiled = eng.compile(expr)
    before = sum(COLLECTIVES.values())
    got = compiled.run(A=ta, B=tb)
    want = jtra.Engine(executor="jit").run(
        jtra.input("A", (8, 8), (4, 8)) @ jtra.input("B", (8, 8), (8, 4)),
        A=ja, B=jb)
    np.testing.assert_allclose(_np(got), _jnp(want), rtol=2e-4, atol=2e-4)
    log = compiled.exchange.log
    assert log and sum(COLLECTIVES.values()) - before == len(log)
    assert compiled.exchange.bytes_by_kind()
    assert compiled.exchange.staged_bytes == 0
    if executor == "shard_map":
        assert [i.op for i in log] == [
            o for o in expected_schedule(compiled.roots, eng.axis_sizes)]


# ==========================================================================
# Plan parity without a mesh: every program of _distributed_checks.py
# ==========================================================================

def _mm(mod, fl, fr, bl, br):
    return mod.input("A", fl, bl) @ mod.input("B", fr, br)


def _programs(mod):
    import importlib
    return importlib.import_module(f"{mod.__name__}.programs")


def _vg(mod):
    """``value_and_grad``'s roots: the forward a2 and its two gradients."""
    a2 = _programs(mod).ffnn_step_tra(8, 2, 2, 2, 4, 4, 4, 2).a2
    return (a2,) + tuple(mod.grad(a2, wrt=["W1", "W2"]))


def _train(mod):
    return _programs(mod).ffnn_train_step_tra(
        8, 2, 2, 2, 4, 4, 4, 2, optimizer=mod.AdamW(1e-2)).roots


# name -> (builder(mod), placements over axes (a0, a1))
PROGRAMS = {
    "BMM": (lambda m: _mm(m, (8, 8), (8, 8), (4, 8), (8, 4)),
            lambda a0, a1: {"A": None, "B": ((0,), (a0,))}),
    "CPMM": (lambda m: _mm(m, (8, 8), (8, 8), (4, 8), (8, 4)),
             lambda a0, a1: {"A": ((1,), (a0,)), "B": ((0,), (a0,))}),
    "rows": (lambda m: _mm(m, (8, 8), (8, 8), (4, 8), (8, 4)),
             lambda a0, a1: {"A": ((0,), (a0,)), "B": ((0,), (a0,))}),
    "RMM": (lambda m: _mm(m, (8, 8), (8, 8), (4, 8), (8, 4)),
            lambda a0, a1: {"A": ((0,), (a0,)), "B": ((1,), (a1,))}),
    "two_phase": (lambda m: _mm(m, (2, 16), (16, 2), (4, 8), (8, 4)),
                  lambda a0, a1: {"A": ((1,), (a0,)), "B": ((0,), (a0,))}),
    "value_and_grad": (_vg,
                       lambda a0, a1: {"X": ((0,), (a0,)), "W1": None,
                                       "W2": None}),
    "train_step": (_train,
                   lambda a0, a1: {"X": ((0,), (a0,)), "Y": ((0,), (a0,)),
                                   "W1": None, "W2": None}),
    "stream": (lambda m: _mm(m, (64, 4), (4, 2), (4, 8), (8, 4)),
               lambda a0, a1: {"A": ((0,), (a0,)), "B": None}),
}
AXES = {"1d": {"sites": 8}, "2d": {"s0": 4, "s1": 2}}


@pytest.mark.parametrize("axes", sorted(AXES))
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_plans_at_axis_sizes_match_jax(name, axes):
    from repro.analysis.collectives import collective_schedule as jsched
    from repro_torch.analysis.collectives import \
        collective_schedule as tsched
    sizes = AXES[axes]
    build, places = PROGRAMS[name]
    names = tuple(sizes)
    spec = places(names[0], names[-1])
    jc = jtra.Engine(executor="jit", axis_sizes=sizes, site_axes=names,
                     input_placements=_jplaces(spec)).compile(build(jtra))
    tc = ttra.Engine(executor="jit", device=CPU, axis_sizes=sizes,
                     site_axes=names,
                     input_placements=_tplaces(spec)).compile(build(ttra))
    assert tc.describe() == jc.describe()
    assert tc.cost == jc.cost
    for tp, jp in zip(tc.roots, jc.roots):
        assert [o.describe() for o in tsched(tp, sizes)] == \
            [o.describe() for o in jsched(jp, sizes)]


def test_site_programs_gate_matches_jax():
    """``verify_site_programs`` over two sites' plans: clean when they
    agree, the same error as JAX's when one site's plan diverges."""
    from repro.launch.sites import verify_site_programs as jverify
    from repro_torch.launch.sites import verify_site_programs as tverify
    sizes = {"sites": 8}
    spec = PROGRAMS["CPMM"][1]("sites", "sites")
    plans = {}
    for mod in (jtra, ttra):
        kw = {} if mod is jtra else {"device": CPU}
        eng = mod.Engine(executor="jit", axis_sizes=sizes,
                         input_placements=(_jplaces if mod is jtra
                                           else _tplaces)(spec), **kw)
        expr = _mm(mod, (8, 8), (8, 8), (4, 8), (8, 4))
        plans[mod] = (eng.compile(expr).plan,
                      eng.compile(expr, target=mod.Placement.replicated())
                      .plan)
    assert not tverify([plans[ttra][0]] * 2, sizes).errors
    msgs = []
    for verify, mod in ((jverify, jtra), (tverify, ttra)):
        diags = verify(list(plans[mod]), sizes, strict=False)
        msgs.append([d.message for d in diags.errors])
    assert msgs[0] == msgs[1] and msgs[1]
