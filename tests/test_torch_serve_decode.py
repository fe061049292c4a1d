"""Port parity: the step-decode serving path — ``Expr.slot_update``,
``RecurrentLM``, ``lm_mix`` and ``TraServer``'s continuous batching.

A JAX ``RecurrentLM(d_model=16, vocab_size=32)`` has its weights and
embedding carried to the port through ``repro_torch.weights``
(``RecurrentLM.from_numpy``); both serve the same requests and agree at
1e-5 on the ``reference`` and ``jit`` executors.  Then the decode cases of
``tests/test_serve.py``: the row helpers, ``slot_update``, continuous
batching against the per-request oracle, the slot lifecycle under random
arrival and finish orders, slot reuse, the step servable's payload check;
one step program's state and logits against JAX's ``CompiledExpr``; and the
port's optimized step plan against JAX's, node for node, at gemma2-2b's
full d_model and vocab (plans only, no data).

The JAX runs are small and cached per module; the file holds no
wall-clock limit.
"""
import functools
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.core.expr as jE  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.expr as tE  # noqa: E402
from repro.core import tra as jtra  # noqa: E402
from repro.core.guards import label_nodes as jlabels  # noqa: E402
from repro.core.plan import postorder as jpostorder  # noqa: E402
from repro_torch.core import tra as ttra  # noqa: E402
from repro_torch.core.guards import label_nodes as tlabels  # noqa: E402
from repro_torch.core.plan import (FusedJoinAgg, LocalAgg,  # noqa: E402
                                   LocalJoin, postorder)
from repro_torch.serve import (LmRequest, RecurrentLM, TraServer,  # noqa: E402
                               lm_mix)
from _torch_helpers import CPU, as_np, normal, rng  # noqa: E402

EXECUTORS = ("reference", "jit")
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _jax_lm(capacity):
    return jserve.RecurrentLM(d_model=16, vocab_size=32, capacity=capacity)


def lm_pair(capacity=4):
    """A JAX LM and the port's holding the same weights and embedding."""
    jlm = _jax_lm(capacity)
    arrays = {k: np.asarray(r.data) for k, r in jlm.weights().items()}
    return jlm, RecurrentLM.from_numpy(arrays, jlm.embedding,
                                       capacity=capacity, device=CPU)


def port_server(executor="reference", capacity=4, **kw):
    jlm, lm = lm_pair(capacity)
    server = TraServer(tcore.Engine(executor=executor, device=CPU), lm, **kw)
    server.warmup()
    return server, lm, jlm


@functools.lru_cache(maxsize=None)
def _jax_oracle(capacity, prompt, max_new):
    toks, logs = _jax_lm(capacity).oracle_decode(list(prompt), max_new)
    return toks, [np.asarray(x) for x in logs]


def assert_matches_jax_oracle(req, result, capacity, logits=True):
    toks, logs = _jax_oracle(capacity, tuple(req.prompt), req.max_new_tokens)
    assert result["tokens"] == toks
    if logits:
        assert len(result["logits"]) == len(logs)
        for got, want in zip(result["logits"], logs):
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def assert_drained(server):
    assert server._pending == 0 and server.idle()
    assert not server._waiting
    assert all(s is None for s in server._slots)
    np.testing.assert_array_equal(as_np(server._state), 0.0)


# =========================================================================
# the row helpers (core/tra.py)
# =========================================================================

def _rows(mod, fills, key=(2,), bound=(1, 3)):
    import jax.numpy as jnp
    rt = mod.RelType(key, bound)
    if mod is jtra:
        return [mod.TensorRelation(jnp.full(key + bound, float(f)), rt)
                for f in fills], rt
    return [mod.TensorRelation(torch.full(key + bound, float(f)), rt)
            for f in fills], rt


def test_scatter_and_zero_rows_match_jax():
    out = {}
    for mod in (jtra, ttra):
        rels, rt = _rows(mod, [1, 1, 1, 1, 7, 9])
        base = mod.pack_rows(rels[:4], 4, rt)
        scattered = mod.scatter_rows(base, [1, 3], rels[4:])
        out[mod] = (scattered, mod.zero_rows(scattered, [3]))
    for j, t in zip(out[jtra], out[ttra]):
        np.testing.assert_array_equal(as_np(t), as_np(j))
    data = as_np(out[ttra][1])
    np.testing.assert_array_equal(data[3], 0.0)
    np.testing.assert_array_equal(data[1], 7.0)
    np.testing.assert_array_equal(data[0], 1.0)
    # out of place: the packed input is never written
    np.testing.assert_array_equal(as_np(out[ttra][0])[3], 9.0)


@pytest.mark.parametrize("slots,n", [([2], 1), ([0, 0], 2), ([-1], 1)])
def test_scatter_rejects_bad_slots_as_jax_does(slots, n):
    for mod in (jtra, ttra):
        rels, rt = _rows(mod, [1] + [0] * n)
        base = mod.pack_rows(rels[:1], 2, rt)
        with pytest.raises(ValueError):
            mod.scatter_rows(base, slots, rels[1:])


# =========================================================================
# slot_update (core/expr.py)
# =========================================================================

def _slot_program(E):
    state = E.input("S", (3, 1), (1, 4))
    rows = E.input("R", (3, 1), (1, 4))
    mask = E.input("M", (3, 1), (1, 1))
    return state.slot_update(rows, mask)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_slot_update_matches_jax(executor):
    r = rng(0)
    x = {"S": normal(r, (3, 1, 1, 4)), "R": normal(r, (3, 1, 1, 4)),
         "M": np.asarray([1.0, 0.0, 1.0], np.float32).reshape(3, 1, 1, 1)}
    want = jcore.Engine(executor=executor, validate="off").run(
        _slot_program(jE), **x)
    got = tcore.Engine(executor=executor, device=CPU).run(
        _slot_program(tE), **x)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=TOL, atol=TOL)
    data = as_np(got)
    np.testing.assert_array_equal(data[0], x["R"][0])
    np.testing.assert_array_equal(data[1], x["S"][1])   # kept bit-exactly
    np.testing.assert_array_equal(data[2], x["R"][2])


@pytest.mark.parametrize("rows,mask", [
    (((2, 1), (1, 4)), ((3, 1), (1, 1))),       # rows on another key grid
    (((3, 1), (1, 4)), ((3, 1), (1, 4))),       # mask blocks not (1, 1)
])
def test_slot_update_type_errors_as_jax(rows, mask):
    for E, err in ((jE, jcore.ExprTypeError), (tE, tcore.ExprTypeError)):
        state = E.input("S", (3, 1), (1, 4))
        with pytest.raises(err):
            state.slot_update(E.input("R", *rows), E.input("M", *mask))


# =========================================================================
# RecurrentLM: weights, one step, the plan
# =========================================================================

def test_from_numpy_carries_weights_and_embedding():
    jlm, lm = lm_pair()
    for name, rel in jlm.weights().items():
        np.testing.assert_array_equal(as_np(lm.weights()[name]),
                                      np.asarray(rel.data))
        assert lm.weights()[name].rtype.key_shape == rel.rtype.key_shape
        assert lm.weights()[name].rtype.bound == rel.rtype.bound
    np.testing.assert_array_equal(lm.embedding.numpy(), jlm.embedding)
    assert (lm.d, lm.vocab, lm.capacity) == (16, 32, 4)


def test_from_numpy_rejects_mismatched_weights():
    jlm, _ = lm_pair()
    arrays = {k: np.asarray(r.data) for k, r in jlm.weights().items()}
    with pytest.raises(ValueError):
        RecurrentLM.from_numpy(arrays, jlm.embedding[:5], device=CPU)
    with pytest.raises(ValueError):
        RecurrentLM.from_numpy({k: v for k, v in arrays.items()
                                if k != "lm.Wx"}, jlm.embedding, device=CPU)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_step_program_state_and_logits_match_jax(executor):
    """One dispatch of the step program, three live slots of four, a
    non-zero state: state and logits against JAX's ``CompiledExpr``."""
    import jax.numpy as jnp
    jlm, lm = lm_pair()
    tokens = [3, None, 17, 30]
    state = normal(rng(1), (4, 1, 1, 16))
    state[1] = 0.0
    jin = {**jlm.step_inputs(tokens), **jlm.weights(),
           "lm.state": jnp.asarray(state)}
    tin = {**lm.step_inputs(tokens), **lm.weights(),
           "lm.state": torch.from_numpy(state.copy())}
    want = jcore.Engine(executor=executor, validate="off").compile(
        jlm.step_program()).run(**jin)
    got = tcore.Engine(executor=executor, device=CPU).compile(
        lm.step_program()).run(**tin)
    for name in ("state", "logits"):
        np.testing.assert_allclose(as_np(got[name]), as_np(want[name]),
                                   rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(as_np(got["state"])[1], 0.0)
    np.testing.assert_array_equal(as_np(tin["lm.emb"])[1], 0.0)
    np.testing.assert_array_equal(as_np(tin["lm.active"]).reshape(-1),
                                  [1.0, 0.0, 1.0, 1.0])


def test_step_inputs_reject_foreign_tokens():
    _, lm = lm_pair()
    with pytest.raises(ValueError, match="per-slot tokens"):
        lm.step_inputs([1, 2])
    with pytest.raises(ValueError, match="vocabulary"):
        lm.step_inputs([1, 32, None, None])
    with pytest.raises(ValueError, match="vocabulary"):
        lm.step_inputs([-2, None, None, None])


def test_oracle_decode_matches_jax():
    jlm, lm = lm_pair()
    for prompt, n in (([5], 3), ([3, 1, 4, 1], 6)):
        toks, logs = lm.oracle_decode(prompt, n)
        want_toks, want_logs = _jax_oracle(4, tuple(prompt), n)
        assert toks == want_toks
        for got, want in zip(logs, want_logs):
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _plan_at(E_mod, lm_cls, engine, c, d, v):
    """The optimized step plan of ``lm_cls`` at (capacity, d, vocab),
    built by its own ``step_program`` on a stand-in holding only the
    sizes — no weights are drawn."""
    stub = types.SimpleNamespace(capacity=c, d=d, vocab=v, _program=None)
    return engine.compile(lm_cls.step_program(stub))


def test_step_plan_matches_jax_node_for_node_at_gemma2_width():
    """gemma2-2b's d_model 2304 and vocab 256000, capacity 8: the port's
    optimizer picks JAX's plan — every product an unfused ``LocalJoin``
    (matMul) under a ``LocalAgg`` (matAdd), since the joined key dim has
    size 1 and the fused and unfused plans tie — so on the card the step
    launches no hand-written kernel."""
    from repro.configs import get_config as jconfig
    from repro_torch.configs import get_config as tconfig
    jc, tc = jconfig("gemma2-2b"), tconfig("gemma2-2b")
    assert (jc.d_model, jc.vocab_size) == (tc.d_model, tc.vocab_size) \
        == (2304, 256000)
    want = _plan_at(jE, jserve.RecurrentLM,
                    jcore.Engine(executor="jit", validate="off"),
                    8, jc.d_model, jc.vocab_size)
    got = _plan_at(tE, RecurrentLM, tcore.Engine(executor="jit", device=CPU),
                   8, tc.d_model, tc.vocab_size)
    assert got.root_names == want.root_names == ("state", "logits")
    assert got.describe() == want.describe()
    jl = sorted(jlabels(want.roots).values())
    tl = sorted(tlabels(got.roots).values())
    assert tl == jl
    for jr, tr in zip(want.roots, got.roots):
        for jn, tn in zip(jpostorder(jr), postorder(tr)):
            assert type(tn).__name__ == type(jn).__name__
    nodes = [n for r in got.roots for n in postorder(r)]
    assert not any(isinstance(n, FusedJoinAgg) for n in nodes)
    products = [n for n in nodes if isinstance(n, LocalJoin)
                and n.kernel.name == "matMul"]
    assert len(products) == 5          # s·Wh and emb·Wx in each root; h·Wo
    sums = [n.child for n in nodes if isinstance(n, LocalAgg)
            and n.kernel.name == "matAdd"]
    assert sorted(map(id, sums)) == sorted(map(id, products))


# =========================================================================
# continuous batching vs the oracle (test_serve.py's decode cases)
# =========================================================================

@functools.lru_cache(maxsize=None)
def _jax_served(executor):
    """JAX's server over 9 mixed requests (run once per module)."""
    jlm = _jax_lm(4)
    server = jserve.TraServer(jcore.Engine(executor=executor,
                                           validate="off"), jlm,
                              collect_logits=True)
    server.warmup()
    reqs = jserve.lm_mix(jlm, rng(3), 9, prompt_len=(1, 4),
                         new_tokens=(1, 6))
    return reqs, server.serve(reqs), dict(server.counters)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_continuous_batching_matches_jax_server_and_oracle(executor):
    """9 mixed requests through 4 slots: every token and logit as JAX's
    server serves them and as the per-request oracles (JAX's and the
    port's) give them, the same counters, no cache miss after warmup."""
    jreqs, jresults, jcounters = _jax_served(executor)
    server, lm, _ = port_server(executor, capacity=4, collect_logits=True)
    reqs = lm_mix(lm, rng(3), 9, prompt_len=(1, 4), new_tokens=(1, 6))
    assert [(r.prompt, r.max_new_tokens) for r in reqs] == \
        [(r.prompt, r.max_new_tokens) for r in jreqs]
    results = server.serve(reqs)
    for req, got, want in zip(reqs, results, jresults):
        assert got["tokens"] == want["tokens"]
        for g, w in zip(got["logits"], want["logits"]):
            np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)
        assert_matches_jax_oracle(req, got, 4)
        toks, logs = lm.oracle_decode(req.prompt, req.max_new_tokens)
        assert got["tokens"] == toks
        for g, w in zip(got["logits"], logs):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    assert server.counters == jcounters
    assert server.cache_misses_since_warmup == 0
    assert all(e.pinned for e in server.engine.cache_info())
    assert_drained(server)


def test_lm_mix_matches_jax():
    jlm, lm = lm_pair()
    for seed in (0, 7):
        got = lm_mix(lm, rng(seed), 12)
        want = jserve.lm_mix(jlm, rng(seed), 12)
        assert [(r.prompt, r.max_new_tokens) for r in got] == \
            [(r.prompt, r.max_new_tokens) for r in want]
        assert all(1 <= len(r.prompt) <= 8 and 1 <= r.max_new_tokens <= 12
                   and all(0 <= t < lm.vocab for t in r.prompt)
                   for r in got)


def test_lm_request_validates_as_jax():
    for cls in (LmRequest, jserve.LmRequest):
        with pytest.raises(ValueError):
            cls([], 3)
        with pytest.raises(ValueError):
            cls([1], 0)


# =========================================================================
# slot lifecycle
# =========================================================================

@pytest.mark.parametrize("executor", EXECUTORS)
def test_randomized_arrival_and_finish_orders(executor):
    """Randomized admission with heterogeneous lifetimes: capacity is never
    exceeded, freed slots are reused, free state rows stay zero, and every
    response matches JAX's oracle."""
    server, lm, _ = port_server(executor, capacity=3)
    r = rng(4)
    reqs = lm_mix(lm, r, 10, prompt_len=(1, 3), new_tokens=(1, 5))
    handles, occupied = [], set()
    it = iter(reqs)
    pending = next(it, None)
    while pending is not None or not server.idle():
        while pending is not None and r.random() < 0.6:
            handles.append(server.submit(pending))
            pending = next(it, None)
        server.step()
        live = [s for s in server._slots if s is not None]
        assert len(live) <= lm.capacity
        occupied.update(s.handle.rid for s in live)
        state = as_np(server._state)
        for i, s in enumerate(server._slots):
            if s is None:
                np.testing.assert_array_equal(state[i], 0.0)
    assert len(handles) == 10
    assert occupied == {h.rid for h in handles}
    for h in handles:
        assert_matches_jax_oracle(h.payload, h.result(timeout=0), 3,
                                  logits=False)
    assert_drained(server)


def test_slot_reuse_after_eviction():
    server, lm, _ = port_server("reference", capacity=1)
    reqs = [LmRequest(prompt=[i + 1], max_new_tokens=2) for i in range(3)]
    for req, res in zip(reqs, server.serve(reqs)):
        assert_matches_jax_oracle(req, res, 1, logits=False)
    assert server.dispatches[next(iter(server.artifacts))] == 6
    assert_drained(server)


def test_step_servable_rejects_raw_payloads():
    server, _, _ = port_server("reference")
    with pytest.raises(TypeError, match="LmRequest"):
        server.submit([1, 2, 3])


def test_snapshot_is_a_detached_host_copy():
    _, lm = lm_pair()
    state = lm.init_state()
    snap = lm.snapshot_state(state)
    back = lm.restore_state(snap)
    assert snap.data.device.type == "cpu"
    assert snap.data.data_ptr() != state.data.data_ptr()
    assert back.data.data_ptr() != snap.data.data_ptr()
    back.data.add_(1.0)
    np.testing.assert_array_equal(snap.data.numpy(), 0.0)
    np.testing.assert_array_equal(state.data.numpy(), 0.0)


def test_health_counts_slotted_requests_as_oldest():
    from repro_torch.launch.metering import SpanMeter
    t = [0.0]
    server, _, _ = port_server(
        "reference", capacity=1, meter=SpanMeter(clock=lambda: t[0]))
    server.submit(LmRequest([1, 2], 4))
    server.step()                      # slotted, not queued
    t[0] = 3.0
    h = server.health()
    assert h["queue_depth"] == 0 and h["pending"] == 1
    assert h["oldest_request_age_s"] == pytest.approx(3.0)
    server.run_until_idle()
    assert_drained(server)


def test_launcher_serves_the_lm_on_cpu_when_asked(capsys):
    """``python -m repro_torch.launch.serve --servable lm --arch gemma2-2b
    --smoke --device cpu``: 40 Poisson requests through ``TraServer``,
    exit code 0, no cache miss after warmup."""
    from repro_torch.launch.serve import main
    assert main(["--servable", "lm", "--arch", "gemma2-2b", "--smoke",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "recurrent-lm on jit (cpu): 40 requests (0 errors, 0 shed)" in out
    assert "0 cache misses after warmup" in out
