"""Port parity: fault injection, numeric guards and the server's recovery.

``FaultInjector``, ``ExecContext`` and the finite flags,
``Engine(fault_injector=, check_numerics=)`` on the ``reference`` and
``jit`` executors, ``loadgen.chaos_injector``, ``TraTrainer``'s skip-step
policy, and every case of ``tests/test_serve_resilience.py`` (admission,
withdrawal, fault-isolated retry with the decode state rewound one tick,
containment) — with the JAX package's ``RecurrentLM(d_model=16,
vocab_size=32)`` and ``FFNNScorer`` weights carried over, results held to
JAX's oracle at 1e-5 and, where a scenario is deterministic, the counters
and injector logs to JAX's own run of it.  Then the ``test_robustness.py``
cases that need neither the checkpoint store, a mesh nor ``degrade``.

No wall-clock limit: deadlines run on ``SpanMeter(clock=...)`` and every
watchdog and wait has a generous timeout.  The JAX runs are small and
cached per module.
"""
import functools
import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.core.expr as jE  # noqa: E402
import repro.core.faults as jfaults  # noqa: E402
import repro.core.programs as jprog  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.expr as tE  # noqa: E402
import repro_torch.core.programs as tprog  # noqa: E402
from repro.core.guards import NumericsError as JNumericsError  # noqa: E402
from repro.core.guards import label_nodes as jlabels  # noqa: E402
from repro.core.plan import as_node as jas_node  # noqa: E402
from repro_torch.core.faults import (CompileFailure, DeviceOOM,  # noqa: E402
                                     FaultInjector, SimulatedFailure,
                                     is_transient)
from repro_torch.core.guards import (ExecContext, NumericsError,  # noqa: E402
                                     check_output_rel, finite_flag,
                                     label_nodes, node_needs_check)
from repro_torch.core.plan import as_node  # noqa: E402
from repro_torch.launch.metering import SpanMeter  # noqa: E402
from repro_torch.serve import (DeadlineExceeded, FFNNScorer,  # noqa: E402
                               LmRequest, RecurrentLM, RequestCancelled,
                               RetryBudgetExceeded, ServerOverloaded,
                               ServerStopped, TraServer, chaos_injector,
                               lm_mix)
from _torch_helpers import CPU, as_np, normal, rng  # noqa: E402

pytestmark = pytest.mark.faults

EXECUTORS = ("reference", "jit")
TOL = 1e-5
WAIT_S = 30.0                      # result / join waits: never the limit


# =========================================================================
# carried weights, servers and JAX's own runs
# =========================================================================

@functools.lru_cache(maxsize=None)
def _jax_lm(capacity):
    return jserve.RecurrentLM(d_model=16, vocab_size=32, capacity=capacity)


def small_lm(capacity=2):
    jlm = _jax_lm(capacity)
    arrays = {k: np.asarray(r.data) for k, r in jlm.weights().items()}
    return RecurrentLM.from_numpy(arrays, jlm.embedding, capacity=capacity,
                                  device=CPU)


@functools.lru_cache(maxsize=None)
def _jax_scorer(**blocking):
    return jserve.FFNNScorer(**blocking)


def small_scorer(**blocking):
    js = _jax_scorer(**blocking)
    arrays = {k: np.asarray(r.data) for k, r in js.weights().items()}
    return FFNNScorer.from_numpy(arrays, device=CPU, **blocking)


def scorer_server(inj=None, executor="reference", blocking=(), **kw):
    eng = tcore.Engine(executor=executor, fault_injector=inj, device=CPU)
    sc = small_scorer(**dict(blocking))
    server = TraServer(eng, sc, **kw)
    server.warmup()
    return server, sc


def lm_server(inj=None, capacity=2, check_numerics=False,
              executor="reference", **kw):
    eng = tcore.Engine(executor=executor, fault_injector=inj,
                       check_numerics=check_numerics, device=CPU)
    lm = small_lm(capacity)
    server = TraServer(eng, lm, **kw)
    server.warmup()
    return server, lm


@functools.lru_cache(maxsize=None)
def jax_oracle_tokens(capacity, prompt, max_new):
    return _jax_lm(capacity).oracle_decode(list(prompt), max_new)[0]


def jax_scorer_oracle(payload, blocking=()):
    return np.asarray(_jax_scorer(**dict(blocking)).oracle(payload))


def assert_drained(server):
    """The invariant every test ends on: nothing leaked."""
    assert server._pending == 0 and server.idle()
    assert not server._waiting
    if hasattr(server, "_slots"):
        assert all(s is None for s in server._slots)
        np.testing.assert_array_equal(as_np(server._state), 0.0)


def assert_weights_untouched(lm):
    """No fault wrote a weight in place: bit-equal to JAX's arrays."""
    jlm = _jax_lm(lm.capacity)
    for name, rel in jlm.weights().items():
        np.testing.assert_array_equal(as_np(lm.weights()[name]),
                                      np.asarray(rel.data))


def _jax_lm_run(inj, reqs, capacity=2, check_numerics=False, **kw):
    """JAX's server (reference executor) over ``reqs`` under ``inj``:
    tokens, counters, retries and the injector's log."""
    eng = jcore.Engine(executor="reference", fault_injector=inj,
                       check_numerics=check_numerics, validate="off")
    server = jserve.TraServer(eng, _jax_lm(capacity), **kw)
    server.warmup()
    handles = [server.submit(jserve.LmRequest(list(r.prompt),
                                              r.max_new_tokens))
               for r in reqs]
    server.run_until_idle()
    return ([h.result(timeout=0)["tokens"] for h in handles],
            dict(server.counters), [h.retries for h in handles],
            list(inj.log) if inj is not None else [])


# =========================================================================
# fault taxonomy and injector mechanics (core/faults.py)
# =========================================================================

class TestTaxonomy:
    def test_is_transient_classification(self):
        assert is_transient(SimulatedFailure("site died"))
        assert is_transient(DeviceOOM("oom"))
        assert is_transient(CompileFailure("flake"))
        assert is_transient(NumericsError("nan at T[join]"))
        assert is_transient(torch.OutOfMemoryError("device full"))
        assert not is_transient(TypeError("bad payload"))
        assert not is_transient(ValueError("shape mismatch"))
        assert not is_transient(KeyError("missing input"))

    @pytest.mark.parametrize("every,runs", [(3, 8), (2, 7), (5, 12)])
    def test_periodic_site_fault_fires_as_jax(self, every, runs):
        fired = {}
        for mod in (jfaults, None):
            inj = (jfaults.FaultInjector() if mod else FaultInjector()) \
                .inject_site_failure(every=every, times=-1)
            got = []
            for idx in range(runs):
                try:
                    inj.on_run()
                except (SimulatedFailure, jfaults.SimulatedFailure):
                    got.append(idx)
            fired[mod] = (got, inj.log)
        assert fired[None] == fired[jfaults]
        assert fired[None][0] == list(range(every, runs, every))

    def test_step_scoped_fault_fires_once(self):
        inj = FaultInjector().inject_site_failure(step=1)
        inj.on_run()
        with pytest.raises(SimulatedFailure):
            inj.on_run()
        inj.on_run()                      # budget spent
        assert inj.log == [("site", "run 1")] and inj.runs == 3

    def test_nan_poisons_a_copy_never_in_place(self):
        data = torch.ones(3, 2)
        out = FaultInjector().inject_nan(node="relu").on_node(
            4, "4:LocalMap[relu]", data)
        assert out is not data and bool(torch.isnan(out).all())
        np.testing.assert_array_equal(data.numpy(), 1.0)
        ints = torch.ones(2, dtype=torch.int64)
        assert FaultInjector().inject_nan(node=4).on_node(
            4, "4:x", ints) is ints        # exact dtypes pass untouched

    def test_compile_fault_fires_on_its_executor_only(self):
        inj = FaultInjector().inject_compile_failure(executor="jit")
        inj.on_compile("reference")
        with pytest.raises(CompileFailure):
            inj.on_compile("jit")
        inj.on_compile("jit")             # budget spent
        assert inj.log == [("compile", "jit")]


class TestGuards:
    def test_finite_flag_is_mask_aware(self):
        data = torch.zeros(2, 3, 4)
        data[1, 2, 0] = float("nan")
        assert not bool(finite_flag(data))
        mask = np.ones((2, 3), bool)
        mask[1, 2] = False
        assert bool(finite_flag(data, mask))
        assert finite_flag(torch.zeros(3, dtype=torch.int32)) is None
        from repro_torch.core.tra import RelType, TensorRelation
        rel = TensorRelation(data, RelType((2, 3), (4,)))
        with pytest.raises(NumericsError, match="output\\[0\\]"):
            check_output_rel(rel, "output[0]")
        check_output_rel(TensorRelation(data, rel.rtype, mask), "output[0]")

    def test_node_ids_match_plan_signature_postorder_as_jax(self):
        """label_nodes numbers as plan_sig (shared subtrees once, multi-
        root numbering continuing across roots) — the same labels as
        JAX's for the same program."""
        out = {}
        for E, labels, node in ((jE, jlabels, jas_node),
                                (tE, label_nodes, as_node)):
            a = E.input("A", (2, 2), (3, 3))
            b = E.input("B", (2, 2), (3, 3))
            shared = a @ b
            r1, r2 = node(shared + a), node(shared)
            lab = labels((r1, r2))
            assert sorted(n for n, _ in lab.values()) == \
                list(range(len(lab)))
            assert lab[id(r2)][0] < len(lab)
            out[E] = sorted(lab.values())
        assert out[tE] == out[jE]
        assert any("TraInput[A]" in la for _, la in out[tE])

    def test_structural_nodes_are_not_checked(self):
        from repro_torch.core import plan as P
        a = tE.input("A", (2, 2), (3, 3))
        tile = as_node(a.tile(0, 1))
        assert isinstance(tile, P.TraTile)
        assert not node_needs_check(tile)
        assert node_needs_check(tile, "all")
        assert node_needs_check(as_node(a.map("relu")))

    def test_replaying_context_poisons_without_the_injector(self):
        from repro_torch.core.tra import RelType, TensorRelation
        a = as_node(tE.input("A", (2,), (3,)))
        labels = label_nodes((a,))
        inj = FaultInjector().inject_nan(node="A", times=-1)
        rel = TensorRelation(torch.ones(2, 3), RelType((2,), (3,)))
        ctx = ExecContext(check="all", labels=labels, defer=True,
                          replay=frozenset({0}), faults=inj)
        out = ctx.on_node(a, rel)
        assert bool(torch.isnan(out.data).all()) and inj.log == []
        ((label, flag),) = ctx.take_flags()
        assert label == "0:TraInput[A]" and not bool(flag)


# =========================================================================
# the engine's guards (test_robustness.py)
# =========================================================================

def _bmm(E):
    a = E.input("A", (4, 3), (2, 2))
    b = E.input("B", (3, 5), (2, 2))
    return a @ b


def _bmm_data(nan_in_a=False):
    r = rng(0)
    a, b = normal(r, (4, 3, 2, 2)), normal(r, (3, 5, 2, 2))
    if nan_in_a:
        a[1, 2, 0, 1] = np.nan
    return a, b


@functools.lru_cache(maxsize=None)
def _jax_nan_label(executor, mode="default", nan_in_a=False):
    inj = None if nan_in_a else jfaults.FaultInjector().inject_nan(
        node="FusedJoinAgg", times=-1)
    eng = jcore.Engine(executor=executor, fault_injector=inj,
                       check_numerics="all" if mode == "all" else True,
                       validate="off")
    a, b = _bmm_data(nan_in_a)
    with pytest.raises(JNumericsError) as ei:
        eng.run(_bmm(jE), A=a, B=b)
    return ei.value.node_label


@pytest.mark.parametrize("executor", EXECUTORS)
def test_injected_nan_attributed_to_the_node_jax_names(executor):
    inj = FaultInjector().inject_nan(node="FusedJoinAgg", times=-1)
    eng = tcore.Engine(executor=executor, fault_injector=inj,
                       check_numerics=True, device=CPU)
    a, b = _bmm_data()
    with pytest.raises(NumericsError) as ei:
        eng.run(_bmm(tE), A=a, B=b)
    assert "FusedJoinAgg" in str(ei.value)
    assert ei.value.node_label == _jax_nan_label(executor)
    assert int(ei.value.node_label.split(":")[0]) >= 0


@pytest.mark.parametrize("executor", EXECUTORS)
def test_data_borne_nan_attributed_to_input_node(executor):
    eng = tcore.Engine(executor=executor, check_numerics=True, device=CPU)
    a, b = _bmm_data(nan_in_a=True)
    with pytest.raises(NumericsError) as ei:
        eng.run(_bmm(tE), A=a, B=b)
    assert "Input[A]" in str(ei.value)
    assert ei.value.node_label == _jax_nan_label(executor, nan_in_a=True)


def test_check_numerics_off_is_silent():
    a, b = _bmm_data(nan_in_a=True)
    out = tcore.Engine(executor="jit", device=CPU).run(_bmm(tE), A=a, B=b)
    assert np.isnan(as_np(out)).any()


def test_check_numerics_all_mode_attributes_in_primary_program():
    """``"all"`` flags every node in the dispatch (no re-run) and names
    the node the two-tier default finds — JAX's label."""
    a, b = _bmm_data()
    labels = {}
    for mode in (True, "all"):
        inj = FaultInjector().inject_nan(node="FusedJoinAgg", times=-1)
        eng = tcore.Engine(executor="jit", fault_injector=inj,
                           check_numerics=mode, device=CPU)
        with pytest.raises(NumericsError) as ei:
            eng.run(_bmm(tE), A=a, B=b)
        labels[mode] = ei.value.node_label
        # the re-run replays the dispatch's NaN: one injection logged
        assert inj.log == [("nan", labels[mode])]
    assert labels[True] == labels["all"] == _jax_nan_label("jit", "all")


def test_attribution_rerun_replays_a_spent_one_shot_nan():
    """A ``times=1`` NaN fires in the dispatch; the attribution re-run
    sees the same NaN without consulting the injector, and the next run
    is clean and equals the unfaulted result."""
    a, b = _bmm_data()
    inj = FaultInjector().inject_nan(node="FusedJoinAgg", times=1)
    eng = tcore.Engine(executor="jit", fault_injector=inj,
                       check_numerics=True, device=CPU)
    with pytest.raises(NumericsError, match="FusedJoinAgg"):
        eng.run(_bmm(tE), A=a, B=b)
    out = eng.run(_bmm(tE), A=a, B=b)
    want = jcore.Engine(executor="reference", validate="off").run(
        _bmm(jE), A=a, B=b)
    np.testing.assert_allclose(as_np(out), as_np(want), rtol=TOL, atol=TOL)
    assert len(inj.log) == 1 and inj.runs == 2


def test_check_numerics_values_are_validated():
    with pytest.raises(ValueError, match="check_numerics"):
        tcore.Engine(check_numerics="some", device=CPU)


def test_oom_propagates_without_degrade():
    inj = FaultInjector().inject_oom(ok_chunk=2)
    eng = tcore.Engine(executor="jit", fault_injector=inj, device=CPU)
    a, b = _bmm_data()
    with pytest.raises(DeviceOOM):
        eng.run(_bmm(tE), A=a, B=b)


@pytest.mark.parametrize("fits", [False, True])
def test_oom_byte_model_matches_jax(fits):
    """``ok_bytes``: the contraction OOMs iff its live bytes (inputs +
    output) exceed the budget — the same count, label and log as JAX's."""
    a, b = _bmm_data()
    live = (a.size + b.size + 4 * 5 * 2 * 2) * 4
    budget = live if fits else live - 1
    logs = {}
    for core, E, faults in ((jcore, jE, jfaults), (tcore, tE, None)):
        inj = (faults.FaultInjector() if faults else FaultInjector()) \
            .inject_oom(ok_bytes=budget)
        kw = {"validate": "off"} if core is jcore else {"device": CPU}
        eng = core.Engine(executor="reference", fault_injector=inj, **kw)
        if fits:
            eng.run(_bmm(E), A=a, B=b)
        else:
            with pytest.raises((DeviceOOM, jfaults.DeviceOOM)):
                eng.run(_bmm(E), A=a, B=b)
        logs[core] = inj.log
    assert logs[tcore] == logs[jcore]
    assert bool(logs[tcore]) != fits
    if not fits:
        assert f"~{live}B" in logs[tcore][0][1]


def test_compile_failure_propagates_without_degrade():
    inj = FaultInjector().inject_compile_failure(executor="jit", times=1)
    eng = tcore.Engine(executor="jit", fault_injector=inj, device=CPU)
    with pytest.raises(CompileFailure):
        eng.compile(_bmm(tE))
    assert eng.compile(_bmm(tE)).executor == "jit"   # budget spent


def test_straggler_delays_but_succeeds():
    inj = FaultInjector().inject_straggler(step=1, delay=0.01)
    eng = tcore.Engine(executor="jit", fault_injector=inj, device=CPU)
    a, b = _bmm_data()
    eng.run(_bmm(tE), A=a, B=b)
    eng.run(_bmm(tE), A=a, B=b)          # delayed, not failed
    assert inj.log == [("straggler", "run 1 +0.01s")]
    assert inj.runs == 2


def test_fault_budget_times_is_respected():
    inj = FaultInjector().inject_site_failure(step=0, times=1)
    eng = tcore.Engine(executor="jit", fault_injector=inj, device=CPU)
    a, b = _bmm_data()
    with pytest.raises(SimulatedFailure):
        eng.run(_bmm(tE), A=a, B=b)
    out = eng.run(_bmm(tE), A=a, B=b)
    assert tuple(out.data.shape) == (4, 5, 2, 2)


def test_injector_identity_keys_the_compile_cache():
    a, b = _bmm_data()
    eng = tcore.Engine(executor="jit", device=CPU)
    first = eng.compile(_bmm(tE))
    eng.fault_injector = FaultInjector()
    second = eng.compile(_bmm(tE))
    assert second is not first and second.faults is eng.fault_injector
    second.run(A=a, B=b)
    assert eng.fault_injector.runs == 1


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("kind", ["scorer", "lm"])
def test_warmup_dispatches_past_the_injector(kind, executor):
    """``TraServer.warmup``'s warm dispatch (``CompiledExpr.warm``, a port
    addition) runs each program once past the fault injector and the
    numerics guard: a site fault due at run 0 and a NaN due at every relu
    are not spent, the injector counts no run, and the first real dispatch
    meets both."""
    inj = (FaultInjector().inject_site_failure(step=0)
           .inject_nan(node="relu", times=-1))
    eng = tcore.Engine(executor=executor, fault_injector=inj,
                       check_numerics=True, device=CPU)
    sv = small_scorer() if kind == "scorer" else small_lm(2)
    server = TraServer(eng, sv)
    compiled = next(iter(server.warmup().values()))   # the first bucket's
    assert inj.runs == 0 and inj.log == []
    if kind == "scorer":
        inputs = sv.pack([sv.warmup_payload()] * sv.buckets[0],
                         sv.buckets[0])
    else:
        inputs = {**sv.step_inputs([1, None]), "lm.state": sv.init_state()}
    with pytest.raises(SimulatedFailure):
        compiled.run(**inputs, **sv.weights())
    with pytest.raises(NumericsError, match="relu"):
        compiled.run(**inputs, **sv.weights())
    assert inj.runs == 2 and server.dispatches == {}


# =========================================================================
# the trainer's skip-step policy under check_numerics
# =========================================================================

DIMS = (4, 2, 2, 2, 4, 4, 4, 2)


def _train_arrays():
    nb, db, hb, lb, bn, bd, bh, bl = DIMS
    r = rng(21)
    x = normal(r, (nb * bn, db * bd))
    wt = normal(r, (db * bd, lb * bl)) * 0.5
    y = (1.0 / (1.0 + np.exp(-(x @ wt)))).astype(np.float32)
    w1 = normal(r, (db * bd, hb * bh)) * 0.3
    w2 = normal(r, (hb * bh, lb * bl)) * 0.3
    return {"X": x, "Y": y, "W1": w1, "W2": w2}


def _trainer(core, engine, **kw):
    import jax.numpy as jnp
    nb, db, hb, lb, bn, bd, bh, bl = DIMS
    arrays = _train_arrays()
    tiles = {"X": (bn, bd), "Y": (bn, bl), "W1": (bd, bh), "W2": (bh, bl)}
    if core is jcore:
        rels = {k: core.from_tensor(jnp.asarray(v), tiles[k])
                for k, v in arrays.items()}
        prog = jprog
    else:
        rels = {k: core.from_tensor(torch.from_numpy(v.copy()), tiles[k])
                for k, v in arrays.items()}
        prog = tprog
    step = prog.ffnn_train_step_tra(*DIMS, optimizer=core.AdamW(1e-2))
    trainer = core.TraTrainer(engine, step, params={
        "W1": rels["W1"], "W2": rels["W2"]}, **kw)
    return trainer, {"X": rels["X"], "Y": rels["Y"]}


@functools.lru_cache(maxsize=None)
def _jax_train_oracle():
    trainer, data = _trainer(jcore, jcore.Engine(
        executor="reference", optimize=False, validate="off"))
    return tuple(trainer.fit(4, **data))


def test_skip_step_policy_matches_oracle_and_bounds():
    """Two NaN steps (steps 1 and 2) trip ``check_numerics`` inside the
    step and are skipped without advancing params/state; the applied
    trajectory equals JAX's unfaulted one.  An unbounded NaN stream
    exhausts the consecutive-skip budget and raises."""
    inj = FaultInjector() \
        .inject_nan(node="TraAgg", step=1) \
        .inject_nan(node="TraAgg", step=2)
    eng = tcore.Engine(executor="reference", optimize=False,
                       fault_injector=inj, check_numerics=True, device=CPU)
    trainer, data = _trainer(tcore, eng, skip_nonfinite=3)
    history = trainer.fit(4, **data)
    assert len(trainer.skipped) == 2
    assert [s for s, _ in trainer.skipped] == [1, 1]
    np.testing.assert_allclose(history, _jax_train_oracle(), rtol=TOL,
                               atol=TOL)

    inj2 = FaultInjector().inject_nan(node="TraAgg", times=-1)
    eng2 = tcore.Engine(executor="reference", optimize=False,
                        fault_injector=inj2, check_numerics=True, device=CPU)
    trainer2, data2 = _trainer(tcore, eng2, skip_nonfinite=2)
    with pytest.raises(NumericsError, match="consecutive non-finite"):
        trainer2.fit(4, **data2)
    assert trainer2.step_count == 0          # params never advanced


def test_numerics_error_propagates_without_the_skip_policy():
    inj = FaultInjector().inject_nan(node="TraAgg", step=0)
    eng = tcore.Engine(executor="jit", optimize=False, fault_injector=inj,
                       check_numerics=True, device=CPU)
    trainer, data = _trainer(tcore, eng)
    with pytest.raises(NumericsError, match="TraAgg"):
        trainer.step(**data)
    assert trainer.step_count == 0


# =========================================================================
# admission control & shedding (test_serve_resilience.py)
# =========================================================================

class TestAdmission:
    def test_over_max_pending_sheds_fast(self):
        server, sc = scorer_server(max_pending=2)
        r = rng(0)
        kept = [server.submit(sc.random_payload(r)) for _ in range(2)]
        shed = server.submit(sc.random_payload(r))
        assert shed.done()                 # failed at submit, never queued
        with pytest.raises(ServerOverloaded, match="shed"):
            shed.result(timeout=0)
        assert shed.span.outcome == "shed"
        assert server.counters["shed"] == 1
        assert server._pending == 2
        server.run_until_idle()
        for h in kept:
            np.testing.assert_allclose(h.result(timeout=0),
                                       jax_scorer_oracle(h.payload),
                                       atol=TOL)
        assert_drained(server)

    def test_max_queue_wait_sheds_stale_requests(self):
        t = [0.0]
        server, sc = scorer_server(meter=SpanMeter(clock=lambda: t[0]),
                                   max_queue_wait_s=1.0)
        r = rng(1)
        stale = server.submit(sc.random_payload(r))
        t[0] = 2.0
        fresh = server.submit(sc.random_payload(r))
        server.run_until_idle()
        with pytest.raises(ServerOverloaded, match="max_queue_wait"):
            stale.result(timeout=0)
        assert server.counters["shed"] == 1
        np.testing.assert_allclose(fresh.result(timeout=0),
                                   jax_scorer_oracle(fresh.payload),
                                   atol=TOL)
        assert_drained(server)

    def test_serve_mixed_shed_retried_completed(self):
        inj = FaultInjector().inject_site_failure(step=0)
        server, sc = scorer_server(inj, max_pending=2)
        r = rng(2)
        payloads = [sc.random_payload(r) for _ in range(4)]
        results = server.serve(payloads, return_exceptions=True)
        assert [isinstance(x, ServerOverloaded) for x in results] == \
            [False, False, True, True]
        for p, x in zip(payloads[:2], results[:2]):
            np.testing.assert_allclose(x, jax_scorer_oracle(p), atol=TOL)
        assert server.counters["shed"] == 2
        assert server.counters["transient_faults"] == 1
        assert server.counters["recovered"] == 2
        assert inj.log == [("site", "run 0")]
        assert_drained(server)


# =========================================================================
# cancellation & deadlines
# =========================================================================

class TestCancellation:
    def test_cancel_while_queued_fails_immediately(self):
        server, sc = scorer_server()
        h = server.submit(sc.random_payload(rng(3)))
        assert h.cancel() and h.done() and h.cancelled()
        with pytest.raises(RequestCancelled, match="while queued"):
            h.result(timeout=0)
        assert h.cancel() is False
        assert server.counters["cancelled"] == 1
        assert_drained(server)

    @pytest.mark.parametrize("executor", EXECUTORS)
    def test_cancel_mid_decode_frees_slot_and_zeroes_row(self, executor):
        server, lm = lm_server(capacity=2, executor=executor)
        victim = server.submit(LmRequest([3, 1, 4], 8))
        neighbour = server.submit(LmRequest([2, 7], 3))
        for _ in range(2):
            server.step()
        assert server._slots[0].handle is victim
        assert np.abs(as_np(server._state)[0]).max() > 0
        assert victim.cancel()
        assert not victim.done()          # eviction happens at next tick
        server.step()
        with pytest.raises(RequestCancelled, match="slot 0 freed"):
            victim.result(timeout=0)
        assert server._slots[0] is None
        np.testing.assert_array_equal(as_np(server._state)[0], 0.0)
        server.run_until_idle()
        assert neighbour.result(timeout=0)["tokens"] == \
            jax_oracle_tokens(2, (2, 7), 3)
        assert server.counters["cancelled"] == 1
        assert_drained(server)

    def test_deadline_expiry_under_saturated_server(self):
        t = [0.0]
        server, lm = lm_server(capacity=1,
                               meter=SpanMeter(clock=lambda: t[0]))
        hog = server.submit(LmRequest([1, 2], 6))
        server.step()
        doomed = server.submit(LmRequest([5], 2), deadline_s=1.0)
        server.step()
        assert not doomed.done()
        t[0] = 2.0
        server.step()
        with pytest.raises(DeadlineExceeded, match="missed its deadline"):
            doomed.result(timeout=0)
        assert server.counters["deadline_expired"] == 1
        server.run_until_idle()
        assert hog.result(timeout=0)["tokens"] == \
            jax_oracle_tokens(1, (1, 2), 6)
        assert_drained(server)

    def test_deadline_expiry_mid_decode_reclaims_slot(self):
        t = [0.0]
        server, lm = lm_server(capacity=2,
                               meter=SpanMeter(clock=lambda: t[0]))
        doomed = server.submit(LmRequest([3, 3, 3], 50), deadline_s=1.0)
        safe = server.submit(LmRequest([4, 2], 4))
        server.step()
        t[0] = 5.0
        server.step()
        with pytest.raises(DeadlineExceeded, match="mid-decode"):
            doomed.result(timeout=0)
        assert server._slots[0] is None
        np.testing.assert_array_equal(as_np(server._state)[0], 0.0)
        server.run_until_idle()
        assert safe.result(timeout=0)["tokens"] == \
            jax_oracle_tokens(2, (4, 2), 4)
        assert server.counters["deadline_expired"] == 1
        assert_drained(server)


# =========================================================================
# fault-isolated retry
# =========================================================================

class TestRetry:
    def test_batch_transient_fault_retried_matches_oracle(self):
        inj = FaultInjector().inject_site_failure(step=0)
        server, sc = scorer_server(inj)
        r = rng(4)
        payloads = [sc.random_payload(r) for _ in range(2)]
        for p, x in zip(payloads, server.serve(payloads)):
            np.testing.assert_allclose(x, jax_scorer_oracle(p), atol=TOL)
        assert inj.log == [("site", "run 0")]
        assert server.counters["transient_faults"] == 1
        assert server.counters["recovered"] == 2
        assert server.health()["status"] == "degraded"
        assert_drained(server)

    def test_retry_budget_exhaustion_chains_fault(self):
        inj = (FaultInjector()
               .inject_site_failure(step=0)
               .inject_site_failure(every=1, times=-1))
        server, sc = scorer_server(inj, max_retries=2)
        h = server.submit(sc.random_payload(rng(5)))
        server.run_until_idle()
        with pytest.raises(RetryBudgetExceeded, match="after 2 retries"):
            h.result(timeout=0)
        assert isinstance(h._error.__cause__, SimulatedFailure)
        assert h.retries == 3
        assert server.counters["retry_exhausted"] == 1
        assert_drained(server)

    def test_batch_permanent_error_fails_without_retry(self):
        server, sc = scorer_server()
        sc.pack = lambda *a, **k: (_ for _ in ()).throw(
            TypeError("bad payload"))
        h = server.submit(sc.random_payload(rng(6)))
        server.run_until_idle()
        with pytest.raises(TypeError, match="bad payload"):
            h.result(timeout=0)
        assert h.retries == 0
        assert server.counters["transient_faults"] == 0
        assert_drained(server)

    @pytest.mark.parametrize("executor", EXECUTORS)
    def test_decode_site_fault_rewinds_one_tick_not_progress(self,
                                                             executor):
        """A site failure mid-decode restores the last committed state
        snapshot; both sequences finish with JAX's oracle tokens, and the
        counters, retries and log are JAX's for the same scenario."""
        reqs = [LmRequest([3, 1, 4], 4), LmRequest([2, 7], 3)]
        inj = FaultInjector().inject_site_failure(step=2)
        server, lm = lm_server(inj, capacity=2, max_retries=3,
                               executor=executor)
        handles = [server.submit(r) for r in reqs]
        server.run_until_idle()
        want = _jax_lm_run(jfaults.FaultInjector().inject_site_failure(
            step=2), reqs, max_retries=3)
        got = ([h.result(timeout=0)["tokens"] for h in handles],
               dict(server.counters), [h.retries for h in handles],
               list(inj.log))
        assert got == want
        for req, toks in zip(reqs, got[0]):
            assert toks == jax_oracle_tokens(2, tuple(req.prompt),
                                             req.max_new_tokens)
        assert ("site", "run 2") in inj.log
        assert server.counters["transient_faults"] == 1
        assert server.counters["recovered"] == 2
        assert all(h.retries == 1 for h in handles)
        assert_drained(server)

    @pytest.mark.parametrize("executor", EXECUTORS)
    def test_decode_nan_fault_recovers_through_numeric_guards(self,
                                                              executor):
        """An injected NaN trips check_numerics; the server classifies the
        NumericsError as transient, rewinds the tick, and the clean retry
        matches JAX's oracle.  The poisoned value was a copy: the weights
        are bit-equal to JAX's afterwards."""
        req = LmRequest([5, 9], 4)
        inj = FaultInjector().inject_nan(node="relu", times=1)
        server, lm = lm_server(inj, capacity=2, check_numerics=True,
                               executor=executor)
        h = server.submit(req)
        server.run_until_idle()
        assert h.result(timeout=0)["tokens"] == \
            jax_oracle_tokens(2, (5, 9), 4)
        assert server.counters["transient_faults"] >= 1
        assert server.counters["recovered"] == 1
        assert [k for k, _ in inj.log] == ["nan"]
        assert "relu" in inj.log[0][1]
        if executor == "reference":
            want = _jax_lm_run(jfaults.FaultInjector().inject_nan(
                node="relu", times=1), [req], check_numerics=True)
            assert (dict(server.counters), list(inj.log)) == \
                (want[1], want[3])
        assert_weights_untouched(lm)
        assert_drained(server)

    def test_decode_permanent_error_fails_victims_keeps_serving(self):
        server, lm = lm_server(capacity=2)
        orig = lm.step_inputs
        calls = {"n": 0}

        def flaky(tokens):
            calls["n"] += 1
            if calls["n"] == 1:
                raise TypeError("poisoned inputs")
            return orig(tokens)

        lm.step_inputs = flaky
        victim = server.submit(LmRequest([1], 2))
        server.run_until_idle()
        with pytest.raises(TypeError, match="poisoned inputs"):
            victim.result(timeout=0)
        assert victim.retries == 0
        survivor = server.submit(LmRequest([6, 2], 3))
        server.run_until_idle()
        assert survivor.result(timeout=0)["tokens"] == \
            jax_oracle_tokens(2, (6, 2), 3)
        assert_drained(server)


# =========================================================================
# chaos runs (loadgen.chaos_injector)
# =========================================================================

def test_chaos_injector_scripts_jax_schedule():
    kw = dict(site_every=7, nan_node="relu", nan_every=11, oom_times=2,
              straggler_every=5, straggler_delay_s=0.0)
    got = chaos_injector(**kw)._faults
    want = jserve.chaos_injector(**kw)._faults
    assert [vars(f) for f in got] == [vars(f) for f in want]


@pytest.mark.parametrize("executor", EXECUTORS)
def test_chaos_decode_run_matches_the_clean_run(executor):
    """The smoke's chaos gate at toy width: site faults every 4th dispatch
    and NaN every 7th under ``check_numerics``, with the retry budget of
    JAX's resilience benchmark (8) — every request completes with the
    clean run's tokens, faults were retried and recovered; on
    ``reference`` the counters and log are JAX's for the same schedule."""
    lm = small_lm(4)
    reqs = lm_mix(lm, rng(11), 8, prompt_len=(1, 4), new_tokens=(1, 6))
    clean, _ = lm_server(capacity=4, executor=executor)
    want = [x["tokens"] for x in clean.serve(reqs)]
    inj = chaos_injector(site_every=4, nan_node="relu", nan_every=7)
    server, lm = lm_server(inj, capacity=4, check_numerics=True,
                           executor=executor, max_retries=8)
    got = [x["tokens"] for x in server.serve(reqs)]
    assert got == want
    for req, toks in zip(reqs, got):
        assert toks == jax_oracle_tokens(4, tuple(req.prompt),
                                         req.max_new_tokens)
    kinds = {k for k, _ in inj.log}
    assert kinds == {"site", "nan"}
    assert server.counters["transient_faults"] > 0
    assert server.counters["recovered"] > 0
    assert server.counters["retry_exhausted"] == 0
    if executor == "reference":
        jax = _jax_lm_run(jserve.chaos_injector(
            site_every=4, nan_node="relu", nan_every=7), reqs, capacity=4,
            check_numerics=True, max_retries=8)
        assert (got, dict(server.counters), list(inj.log)) == \
            (jax[0], jax[1], jax[3])
    assert_weights_untouched(lm)
    assert_drained(server)


def test_chaos_oom_is_retried_as_transient():
    """``oom_times``: without ``degrade`` the injected DeviceOOM leaves the
    fused contraction and the server retries it, as JAX's does."""
    blocking = (("db", 4), ("hb", 4))
    inj = chaos_injector(oom_times=2)
    server, sc = scorer_server(inj, executor="jit", blocking=blocking)
    payloads = [sc.random_payload(rng(12)) for _ in range(3)]
    for p, x in zip(payloads, server.serve(payloads)):
        np.testing.assert_allclose(x, jax_scorer_oracle(p, blocking),
                                   atol=TOL)
    assert [k for k, _ in inj.log] == ["oom", "oom"]
    assert server.counters["transient_faults"] == 2
    assert server.counters["recovered"] == 3
    assert_drained(server)


# =========================================================================
# crash containment & watchdog
# =========================================================================

class TestContainment:
    def test_scheduler_crash_fails_inflight_with_diagnostic(self):
        server, sc = scorer_server()
        boom = RuntimeError("scheduler exploded")
        server.step = lambda: (_ for _ in ()).throw(boom)
        h = server.submit(sc.random_payload(rng(7)))
        server.start(tick_wait_s=0.001)
        with pytest.raises(RuntimeError, match="scheduler crashed") as ei:
            h.result(timeout=WAIT_S)
        assert ei.value.__cause__ is boom
        server.stop()
        assert server.counters["scheduler_crashes"] == 1
        assert server.health()["status"] == "stopped"
        with pytest.raises(ServerStopped):
            server.submit(sc.random_payload(rng(7)))
        assert server._pending == 0

    def test_scheduler_crash_fails_slotted_requests_and_resets_state(self):
        server, lm = lm_server(capacity=2)
        h = server.submit(LmRequest([1, 2, 3], 5))
        server.step()                      # slotted, state row non-zero
        boom = RuntimeError("scheduler exploded")
        server.step = lambda: (_ for _ in ()).throw(boom)
        server.start(tick_wait_s=0.001)
        with pytest.raises(RuntimeError, match="scheduler crashed"):
            h.result(timeout=WAIT_S)
        server.stop()
        assert server._pending == 0
        assert all(s is None for s in server._slots)
        np.testing.assert_array_equal(as_np(server._state), 0.0)

    def test_watchdog_trips_on_hung_scheduler(self):
        server, sc = scorer_server()
        release = threading.Event()
        server.step = lambda: release.wait(WAIT_S) and 0  # hung dispatch
        h = server.submit(sc.random_payload(rng(8)))
        server.start(tick_wait_s=0.001, watchdog_timeout_s=0.5)
        with pytest.raises(RuntimeError, match="watchdog"):
            h.result(timeout=WAIT_S)
        assert server.counters["watchdog_trips"] == 1
        assert server.health()["status"] == "stopped"
        release.set()                     # let the hung thread drain
        server.stop(join_timeout_s=WAIT_S)
        assert server._thread is None
        assert server._pending == 0

    def test_watchdog_quiet_while_healthy(self):
        server, sc = scorer_server()
        r = rng(9)
        server.start(tick_wait_s=0.001, watchdog_timeout_s=WAIT_S)
        handles = [server.submit(sc.random_payload(r)) for _ in range(5)]
        for hd in handles:
            np.testing.assert_allclose(hd.result(timeout=WAIT_S),
                                       jax_scorer_oracle(hd.payload),
                                       atol=TOL)
        server.stop(join_timeout_s=WAIT_S)
        assert server.counters["watchdog_trips"] == 0
        assert server.health()["status"] == "stopped"
        assert_drained(server)

    def test_background_decode_serving(self):
        server, lm = lm_server(capacity=2)
        server.start(tick_wait_s=0.001, watchdog_timeout_s=WAIT_S)
        reqs = [LmRequest([4, 1], 3), LmRequest([7], 2),
                LmRequest([2, 2, 9], 4)]
        handles = [server.submit(x) for x in reqs]
        try:
            for req, hd in zip(reqs, handles):
                assert hd.result(timeout=WAIT_S)["tokens"] == \
                    jax_oracle_tokens(2, tuple(req.prompt),
                                      req.max_new_tokens)
        finally:
            server.stop(join_timeout_s=WAIT_S)
        assert server.counters["watchdog_trips"] == 0
        assert_drained(server)
