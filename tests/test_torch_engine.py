"""Port parity: the ``Engine`` (``repro_torch.core.engine``).

Same outputs as the JAX ``Engine`` on the ``reference`` and ``jit``
executors for single-root, tuple and dict programs (optimized and not),
the same ``cache_hits`` / ``cache_misses`` sequence over a program stream,
``pin`` / ``cache_clear`` / ``cache_info``, and the chunked lowering of a
fused plan (``chunk="auto"`` too).  The mesh executors are held in
``tests/test_torch_mesh.py`` and ``tests/test_torch_mesh_sites.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.core.expr as jE  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.expr as tE  # noqa: E402
from _torch_helpers import CPU, as_np, normal, rng  # noqa: E402

EXECUTORS = ("reference", "jit")


def _programs(E):
    a = E.input("A", (2, 3), (4, 5))
    b = E.input("B", (3, 2), (5, 6))
    c = E.input("C", (2, 2), (4, 6))
    ab = a @ b
    return {
        "matmul": ab,
        "mlp": (ab.map("relu") + c).map("sigmoid"),
        "sum": ab.sum(0),
        "residual": (ab - c) * c,
        "shared": (ab, ab.map("relu")),
        "named": {"y": ab + c, "z": ab.map("sigmoid")},
        "const": ab + E.const(0.5, (2, 2), (4, 6)),
    }


def _inputs(seed=0):
    r = rng(seed)
    return {"A": normal(r, (2, 3, 4, 5)), "B": normal(r, (3, 2, 5, 6)),
            "C": normal(r, (2, 2, 4, 6))}


def _flat(out):
    if isinstance(out, dict):
        return [as_np(out[k]) for k in sorted(out)]
    if isinstance(out, tuple):
        return [as_np(o) for o in out]
    return [as_np(out)]


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("optimize", [True, False])
@pytest.mark.parametrize("name", sorted(_programs(jE)))
def test_engine_outputs_match_jax(executor, optimize, name):
    import jax.numpy as jnp
    x = _inputs()
    jeng = jcore.Engine(executor=executor, optimize=optimize,
                        validate="off")
    teng = tcore.Engine(executor=executor, optimize=optimize, device=CPU)
    jc, tc = jeng.compile(_programs(jE)[name]), teng.compile(
        _programs(tE)[name])
    assert sorted(tc.input_rtypes) == sorted(jc.input_rtypes)
    want = jc.run(**{k: jnp.asarray(x[k]) for k in jc.input_rtypes})
    got = tc.run(**{k: torch.from_numpy(x[k]) for k in tc.input_rtypes})
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(_flat(got), _flat(want)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_cache_sequence_matches_jax(executor):
    """Rebuilt-but-identical programs hit, new shapes miss, executors key
    separately — the same hit/miss sequence and cache entries as JAX."""
    seq = []
    for core, E in ((jcore, jE), (tcore, tE)):
        kw = {"validate": "off"} if core is jcore else {"device": CPU}
        eng = core.Engine(executor=executor, **kw)
        trace = []
        for rebuild in range(3):
            progs = _programs(E)
            for name in ("matmul", "mlp", "matmul", "named"):
                eng.compile(progs[name])
                trace.append((eng.cache_hits, eng.cache_misses))
        wide = E.input("A", (2, 3), (4, 7)) @ E.input("B", (3, 2), (7, 6))
        eng.compile(wide)
        trace.append((eng.cache_hits, eng.cache_misses))
        info = eng.cache_info()
        trace.append(tuple((e.executor, e.hits, e.pinned) for e in info))
        eng.pin(info[0].compiled)
        trace.append(eng.cache_clear())
        trace.append(len(eng.cache_info()))
        seq.append(trace)
    assert seq[1] == seq[0]


def test_physical_plan_runs_as_is():
    x = _inputs(1)
    plan = tcore.compile_tra(_programs(tE)["matmul"])
    eng = tcore.Engine(executor="jit", device=CPU)
    got = eng.run(plan, **{k: torch.from_numpy(v) for k, v in x.items()
                           if k != "C"})
    ref = tcore.Engine(executor="reference", device=CPU).run(
        _programs(tE)["matmul"],
        **{k: torch.from_numpy(v) for k, v in x.items() if k != "C"})
    np.testing.assert_allclose(as_np(got), as_np(ref), rtol=1e-5, atol=1e-5)


def test_input_checks():
    eng = tcore.Engine(executor="jit", device=CPU)
    prog = _programs(tE)["matmul"]
    x = _inputs(2)
    with pytest.raises(ValueError, match="missing inputs"):
        eng.run(prog, A=torch.from_numpy(x["A"]))
    with pytest.raises(ValueError, match="unexpected inputs"):
        eng.run(prog, Z=1, **{k: x[k] for k in ("A", "B")})
    with pytest.raises(ValueError, match="dense shape"):
        eng.run(prog, A=x["A"][:1], B=x["B"])
    # numpy inputs are placed on the engine's device
    out = eng.run(prog, A=x["A"], B=x["B"])
    assert out.data.device == CPU


@pytest.mark.parametrize("executor", EXECUTORS)
def test_chunked_fused_plan_matches_jax(executor):
    """``rowSum`` distributes over ``matAdd``, so the optimizer composes it
    into the join (R1-4, R1-7) and fuses a ``rowSum∘matMul → matAdd``
    node, which runs on the chunked streaming lowering: the same values
    as the JAX engine's, and one artifact per ``chunk``."""
    x = _inputs(3)
    want = jcore.Engine(executor=executor).run(
        _programs(jE)["matmul"].map("rowSum"), A=x["A"], B=x["B"])
    prog = _programs(tE)["matmul"].map("rowSum")
    eng = tcore.Engine(executor=executor, device=CPU)
    assert "FusedJoinAgg" in eng.compile(prog).describe()
    for chunk in (None, 1, 2):
        got = eng.compile(prog, chunk=chunk).run(A=x["A"], B=x["B"])
        np.testing.assert_allclose(as_np(got), np.asarray(want.data),
                                   rtol=1e-5, atol=1e-5)
    assert eng.cache_misses == 3
    with pytest.raises(ValueError, match="chunk"):
        tcore.Engine(chunk=0, device=CPU)
    # chunk="auto" (the JAX default): the JAX engine's values
    got = tcore.Engine(executor=executor, chunk="auto",
                       device=CPU).run(prog, A=x["A"], B=x["B"])
    np.testing.assert_allclose(as_np(got), np.asarray(want.data),
                               rtol=1e-5, atol=1e-5)


def test_unported_frontend_raises():
    with pytest.raises(ValueError, match="unknown executor"):
        tcore.Engine(executor="xla", device=CPU)
