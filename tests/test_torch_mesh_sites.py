"""Port parity: the mesh executors on 8 ranks (gloo, CPU).

The counterpart of ``tests/_distributed_checks.py``: its nine checks run
on 8 ranks of one gloo group, spawned once for the module by
``repro_torch.launch.mesh.run_sites`` with a deadline.  The ranks import
no JAX (``tests/_torch_mesh_sites.py``); this process computes each
check's values with JAX's single-device engines and holds what every rank
returns against them at the checks' tolerances (2e-4 for the strategies,
1e-5 / 1e-4 for value-and-grad and the train steps).  Every rank's
executed collective schedule matches the static lowering's; a rank whose
plan differs fails the launcher gate on every rank; a rank that raises
fails its run within the deadline.  Each rank's results are their own
test case; JAX's values are computed once for the module.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import _torch_helpers  # noqa: E402,F401  (one torch thread)
import _torch_mesh_sites as sites  # noqa: E402
from repro_torch.launch.mesh import SiteError, run_sites  # noqa: E402

WORLD = 8
DEADLINE = 420.0                 # seconds, the whole spawn
TRAIN_DIMS = sites.TRAIN_DIMS


def _data():
    r = np.random.default_rng(30)

    def f(*shape):
        return r.standard_normal(shape).astype(np.float32)

    nb, db, hb, lb, bn, bd, bh, bl = TRAIN_DIMS
    n, d, h, l_ = nb * bn, db * bd, hb * bh, lb * bl
    x = f(n, d)
    y = (1.0 / (1.0 + np.exp(-(x @ (f(d, l_) * 0.5))))).astype(np.float32)
    return {"A": f(32, 64), "B": f(64, 32), "A2": f(8, 128), "B2": f(128, 8),
            "A3": r.uniform(0.5, 1.5, (32, 64)).astype(np.float32),
            "B3": r.uniform(0.5, 1.5, (64, 32)).astype(np.float32),
            "X": f(n, d), "W1": f(d, h) * 0.3, "W2": f(h, l_) * 0.3,
            "TX": x, "TY": y, "TW1": f(d, h) * 0.3, "TW2": f(h, l_) * 0.3,
            "SA": f(64, 4, 4, 8), "SB": f(4, 2, 8, 4)}


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def ranks(data):
    """Every rank's results of every check: one spawn for the module."""
    return run_sites(sites.all_checks, WORLD, backend="gloo", device="cpu",
                     timeout=DEADLINE, args=(data,))


class _Refs:
    """JAX's values for the checks, each computed once for the module
    (every rank's result is held against the same one)."""

    def __init__(self, data):
        self.data = data
        self._memo = {}

    def get(self, name, fn):
        if name not in self._memo:
            self._memo[name] = fn(self.data)
        return self._memo[name]


@pytest.fixture(scope="module")
def refs(data):
    return _Refs(data)


def _result(ranks, rank, name):
    got = ranks[rank][name]
    assert "error" not in got, f"rank {rank}:\n{got.get('error')}"
    return got


def _jax_matmul(fl, fr, bl, br, a, b, tile_a, tile_b, axis_sizes=None,
                places=None):
    """(value, optimizer cost) of A @ B by JAX's engines: the value on the
    single-device ``jit`` executor, the cost of the plan JAX's optimizer
    picks at ``axis_sizes``."""
    import jax.numpy as jnp

    import repro.core as jtra
    from repro.core import Engine, from_tensor, to_tensor
    expr = jtra.input("A", fl, bl) @ jtra.input("B", fr, br)
    env = {"A": from_tensor(jnp.asarray(a), tile_a),
           "B": from_tensor(jnp.asarray(b), tile_b)}
    val = np.asarray(to_tensor(Engine(executor="jit").run(expr, **env)))
    cost = None
    if axis_sizes is not None:
        cost = Engine(executor="jit", axis_sizes=axis_sizes,
                      site_axes=tuple(axis_sizes),
                      input_placements=places).compile(expr).cost
    return val, cost


def _jplaces(spec):
    from repro.core import Placement
    return {k: Placement.replicated() if v is None
            else Placement.partitioned(*v) for k, v in spec.items()}


STRATEGIES = {"BMM": {"A": None, "B": ((0,), ("sites",))},
              "CPMM": {"A": ((1,), ("sites",)), "B": ((0,), ("sites",))},
              "rows": {"A": ((0,), ("sites",)), "B": ((0,), ("sites",))}}
RANKS = range(WORLD)


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_strategies_match_jax(ranks, refs, rank, name):
    want, cost = refs.get(name, lambda d: _jax_matmul(
        (8, 8), (8, 8), (4, 8), (8, 4), d["A"], d["B"], (4, 8), (8, 4),
        {"sites": WORLD}, _jplaces(STRATEGIES[name])))
    g = _result(ranks, rank, "strategies")[name]
    np.testing.assert_allclose(g["opt"], want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(g["table1"], want, rtol=2e-4, atol=2e-4)
    assert g["cost"] == cost


@pytest.mark.parametrize("rank", RANKS)
def test_rmm_on_a_2d_mesh_matches_jax(ranks, refs, rank):
    places = {"A": ((0,), ("s0",)), "B": ((1,), ("s1",))}
    want, cost = refs.get("RMM", lambda d: _jax_matmul(
        (8, 8), (8, 8), (4, 8), (8, 4), d["A"], d["B"], (4, 8), (8, 4),
        {"s0": 4, "s1": 2}, _jplaces(places)))
    got = _result(ranks, rank, "rmm_2d")
    np.testing.assert_allclose(got["C"], want, rtol=2e-4, atol=2e-4)
    assert got["cost"] == cost


@pytest.mark.parametrize("rank", RANKS)
def test_gspmd_matches_shard_map_and_hits_the_cache(ranks, rank):
    got = _result(ranks, rank, "gspmd_matches_shardmap")
    np.testing.assert_allclose(got["gspmd"], got["shard_map"],
                               rtol=2e-4, atol=2e-4)
    # DTensor really moved data, and the walk recorded what it chose
    assert got["dtensor_collectives"] > 0 and got["recorded"]
    assert got["cache_same"] and got["hits"] == 1


@pytest.mark.parametrize("rank", RANKS)
def test_two_phase_aggregation_matches_jax(ranks, refs, rank):
    want, _ = refs.get("two_phase", lambda d: _jax_matmul(
        (2, 16), (16, 2), (4, 8), (8, 4), d["A2"], d["B2"], (4, 8), (8, 4)))
    got = _result(ranks, rank, "two_phase_reduce_scatter")
    assert "partial" in got["describe"], got["describe"]
    np.testing.assert_allclose(got["C"], want, rtol=2e-4, atol=2e-4)


def _jax_reducer(agg):
    def fn(d):
        import jax.numpy as jnp

        import repro.core as jtra
        from repro.core import Engine, from_tensor
        a = jtra.input("A", (8, 16), (4, 4))
        b = jtra.input("B", (16, 8), (4, 4))
        expr = a.join(b, on=((1,), (0,)), kernel="elemMul").agg((0, 2), agg)
        return np.asarray(Engine(executor="reference", optimize=False).run(
            expr, A=from_tensor(jnp.asarray(d["A3"]), (4, 4)),
            B=from_tensor(jnp.asarray(d["B3"]), (4, 4))).data)
    return fn


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("agg", ["elemMax", "elemMin", "elemMul"])
def test_other_reducers_match_jax(ranks, refs, rank, agg):
    want = refs.get(agg, _jax_reducer(agg))
    g = _result(ranks, rank, "other_reducers")[agg]
    assert "FusedJoinAgg" in g["describe"]
    assert "[partial]" in g["describe"]
    np.testing.assert_allclose(g["hand"], want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(g["fused"], want, rtol=2e-4, atol=2e-4)


def _jax_value_and_grad(d):
    import jax.numpy as jnp

    from repro.core import Engine, from_tensor, to_tensor
    from repro.core.programs import ffnn_step_tra
    nb, db, hb, lb, bn, bd, bh, bl = 8, 2, 2, 2, 4, 4, 4, 2
    prog = ffnn_step_tra(nb, db, hb, lb, bn, bd, bh, bl)
    env = dict(X=from_tensor(jnp.asarray(d["X"]), (bn, bd)),
               W1=from_tensor(jnp.asarray(d["W1"]), (bd, bh)),
               W2=from_tensor(jnp.asarray(d["W2"]), (bh, bl)))
    outs = Engine(executor="jit").value_and_grad(
        prog.a2, wrt=["W1", "W2"]).run(**env)
    return [np.asarray(to_tensor(o)) for o in outs]


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("executor", ["gspmd", "shard_map"])
def test_value_and_grad_matches_jax(ranks, refs, rank, executor):
    wants = refs.get("value_and_grad", _jax_value_and_grad)
    g = _result(ranks, rank, "value_and_grad")[executor]
    for k, want in zip(("val", "g1", "g2"), wants):
        np.testing.assert_allclose(g[k], want, atol=1e-5, rtol=1e-4)
    assert g["fused"] and g["cache_same"] and g["hits"] == 1


def _jax_trainer(optimizer, data):
    import jax.numpy as jnp

    from repro.core import Engine, TraTrainer, from_tensor
    from repro.core.programs import ffnn_train_step_tra
    nb, db, hb, lb, bn, bd, bh, bl = TRAIN_DIMS
    tr = TraTrainer(Engine(executor="jit"),
                    ffnn_train_step_tra(*TRAIN_DIMS, optimizer=optimizer),
                    params={"W1": from_tensor(jnp.asarray(data["TW1"]),
                                              (bd, bh)),
                            "W2": from_tensor(jnp.asarray(data["TW2"]),
                                              (bh, bl))})
    feed = dict(X=from_tensor(jnp.asarray(data["TX"]), (bn, bd)),
                Y=from_tensor(jnp.asarray(data["TY"]), (bn, bl)))
    return tr, feed


def _jax_train_steps(d):
    from repro.core import AdamW, to_tensor
    tr, feed = _jax_trainer(AdamW(1e-2, 0.9, 0.999, 1e-8,
                                  weight_decay=0.01), d)
    losses, params = [], []
    for _ in range(5):
        losses.append(tr.step(**feed))
        params.append({k: np.asarray(to_tensor(tr.params[k]))
                       for k in ("W1", "W2")})
    return losses, params


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("executor", ["gspmd", "shard_map"])
def test_train_step_matches_jax(ranks, refs, rank, executor):
    want_losses, want_params = refs.get("train", _jax_train_steps)
    g = _result(ranks, rank, "train_step")[executor]
    np.testing.assert_allclose(g["losses"], want_losses, rtol=1e-5,
                               atol=1e-4)
    for gp, wp in zip(g["params"], want_params):
        for k in wp:
            np.testing.assert_allclose(gp[k], wp[k], atol=1e-4, rtol=1e-4)
    assert g["hits"] == 4            # steps 2-5 pure dispatch
    assert g["losses"][-1] < g["losses"][0]


def _jax_oracle_fit(d):
    from repro.core import AdamW
    tr, feed = _jax_trainer(AdamW(1e-2), d)
    return tr.fit(8, **feed)


@pytest.mark.parametrize("rank", RANKS)
def test_elastic_resume_across_mesh_shapes_matches_jax(ranks, refs, rank):
    oracle = refs.get("fit", _jax_oracle_fit)
    got = _result(ranks, rank, "elastic_resume")
    assert got["log"] == [("site", "run 5")]
    assert got["step_count"] == 6 and got["step_count2"] == 8
    np.testing.assert_allclose(got["history"], oracle[:6], atol=1e-5)
    np.testing.assert_allclose(got["resumed"], oracle, atol=1e-5)


def _jax_stream(d):
    import jax.numpy as jnp

    import repro.core as jtra
    from repro.core import Engine, RelType, TensorRelation
    expr = jtra.input("A", (64, 4), (4, 8)) @ jtra.input("B", (4, 2), (8, 4))
    return np.asarray(Engine(executor="reference", optimize=False).run(
        expr, A=TensorRelation(jnp.asarray(d["SA"]),
                               RelType((64, 4), (4, 8))),
        B=TensorRelation(jnp.asarray(d["SB"]),
                         RelType((4, 2), (8, 4)))).data)


@pytest.mark.parametrize("rank", RANKS)
def test_streamed_run_through_gspmd_matches_jax(ranks, refs, rank):
    want = refs.get("stream", _jax_stream)
    got = _result(ranks, rank, "stream_gspmd")
    assert (got["mode"], got["dim"], got["nchunks"]) == ("stream-out", 0, 8)
    assert got["chunks"] == 8 and got["h2d_bytes"] >= got["a_bytes"]
    assert got["misses"] >= 1 and got["executors"] == ["gspmd"]
    np.testing.assert_allclose(got["C"], want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rank", RANKS)
def test_executed_schedules_match_the_lowering(ranks, rank):
    """Each shard_map dispatch's recorded collectives equal
    ``expected_schedule`` (the static ``collective_schedule`` lowering)
    op for op; and this rank ran the ones rank 0 ran."""
    res = ranks[rank]
    oks = [res["strategies"][n]["schedule_ok"] for n in STRATEGIES]
    oks += [res["rmm_2d"]["schedule_ok"],
            res["two_phase_reduce_scatter"]["schedule_ok"],
            res["value_and_grad"]["shard_map"]["schedule_ok"],
            res["train_step"]["shard_map"]["schedule_ok"]]
    assert all(oks), oks
    seen = [[r["strategies"][n]["schedule"] for n in STRATEGIES]
            + [r["two_phase_reduce_scatter"]["schedule"]]
            for r in (ranks[0], res)]
    assert seen[1] == seen[0]
    assert any(seen[0])                  # the strategies do exchange data


@pytest.mark.parametrize("rank", RANKS)
def test_mismatched_rank_plans_fail_the_gate(ranks, rank):
    got = _result(ranks, rank, "site_gate")
    assert got["raised"] is not None
    assert "diverge" in got["raised"] and "site 3" in got["raised"]
    assert got["issued"] == 0        # raised before the program ran


@pytest.mark.parametrize("rank", RANKS)
def test_staged_redistribute_equals_dtensors_own(ranks, rank):
    """On gloo, DTensor's collectives over CUDA tensors go through the
    host (``interp.redistribute``); forced here on CPU tensors, every
    case of the 1-D and 2-D meshes equals DTensor's own redistribute."""
    got = _result(ranks, rank, "staged_redistribute")
    assert got and all(all(v) for v in got.values()), got


@pytest.mark.parametrize("rank", RANKS)
def test_lowering_moves_equal_dtensors_own(ranks, rank):
    """Each explicit move of the shard_map lowering holds the values
    DTensor's redistribute gives, through the collective it names."""
    got = _result(ranks, rank, "lowering_collectives")
    assert got == {"gather": (True, ["all_gather"]),
                   "all_to_all": (True, ["all_to_all"]),
                   "scatter": (True, ["psum_scatter"]),
                   "all_reduce": (True, ["all_reduce"])}, got


@pytest.mark.parametrize("rank", RANKS)
def test_sharded_output_numerics_raise_on_every_rank(ranks, rank):
    """One rank's block holds the only non-finite row of a sharded
    output; ``check_numerics`` raises on every rank all the same, and on
    none for the finite product."""
    got = _result(ranks, rank, "output_numerics")
    for executor in ("gspmd", "shard_map"):
        r = got[executor]
        assert r["sharded"] and r["schedule_ok"], r
        assert r["raised"] is not None and "output[0]" in r["raised"], r


@pytest.mark.parametrize("rank", RANKS)
def test_ranks_import_neither_jax_nor_the_jax_package(ranks, rank):
    assert ranks[rank]["imports"] == {"jax": False, "repro": False}


def test_a_failing_rank_fails_the_run_within_the_deadline():
    import time
    t0 = time.monotonic()
    with pytest.raises(SiteError, match="rank 1 fails"):
        run_sites(sites.failing_rank, 2, backend="gloo", device="cpu",
                  timeout=60.0)
    assert time.monotonic() - t0 < 60.0
