"""Port parity: out-of-core streaming execution and the ``degrade`` ladder.

Mirrors ``tests/test_oocore.py`` for the ``reference`` and ``jit``
executors (the ``gspmd`` / ``shard_map`` cases wait for the distributed
slice) and the ladder cases of ``tests/test_robustness.py``; every case
feeds the same numpy inputs to ``repro`` and ``repro_torch`` and compares
live: results at 1e-5 (the chained two-matmul case at 1e-4) and the
``StreamStats`` counters equal (mode, budget, runs, chunks, H2D and D2H
bytes, spill counters, the analytic peak).  Also:

* the port's ``StreamPlan`` equals JAX's on the §5.3 FFNN forward at
  speech-100k (N 10000, D 1600, H 100000, L 10, blocked 10/4/10/1) at
  budgets from 0.75 to 4 GiB — shapes only, nothing is allocated;
* ``is_oom_error`` on a ``torch.OutOfMemoryError``, and the ladder
  recovering a real ``torch.OutOfMemoryError`` on rung 1 with the failed
  attempt's tensors released before the rung starts;
* ``chunk="auto"`` under a memory budget on the chunked lowering.

The JAX runs are small and jitted (``executor="jit"`` engines), so the
file's JAX work stays light beside the reference's wall-clock tests.
"""
import gc
import warnings
import weakref

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as jtra  # noqa: E402
import repro_torch.core as ttra  # noqa: E402
from _torch_helpers import CPU, as_np  # noqa: E402
from repro.core.faults import FaultInjector as JFI  # noqa: E402
from repro.launch.metering import StreamStats as JSS  # noqa: E402
from repro.store import StreamExecutor as JSE  # noqa: E402
from repro_torch.core.engine import DEFAULT_OOM_LADDER_START  # noqa: E402
from repro_torch.core.faults import (CompileFailure, DeviceOOM,  # noqa: E402
                                     FaultInjector, SimulatedFailure)
from repro_torch.core.guards import is_oom_error  # noqa: E402
from repro_torch.launch.metering import StreamStats  # noqa: E402
from repro_torch.store import (NotStreamable, RelationStore,  # noqa: E402
                               StreamExecutor)
from repro_torch.store.autotune import ENV_BUDGET  # noqa: E402

COUNTERS = ("mode", "budget_bytes", "runs", "chunks", "h2d_bytes",
            "d2h_bytes", "spill_events", "spill_bytes", "peak_device_bytes")


def _data(seed, key_shape, bound):
    r = np.random.default_rng(seed)
    return np.asarray(r.normal(size=tuple(key_shape) + tuple(bound)),
                      np.float32)


def _masked(key_shape):
    mask = np.ones(key_shape, bool)
    mask[tuple(0 for _ in key_shape)] = False
    return mask


def _jrel(data, mask=None):
    ks, b = data.shape[:2], data.shape[2:]
    return jtra.TensorRelation(data, jtra.RelType(ks, b), mask)


def _trel(data, mask=None):
    ks, b = data.shape[:2], data.shape[2:]
    return ttra.TensorRelation(torch.from_numpy(data.copy()),
                               ttra.RelType(ks, b), mask)


def _matmul(mod, ka=(8, 2), kb=(2, 3), ba=(8, 8), bb=None):
    a = mod.input("A", key_shape=ka, bound=ba)
    b = mod.input("B", key_shape=kb, bound=bb or (ba[1], ba[0]))
    return a @ b


def _np(res):
    return res.to_numpy() if hasattr(res, "to_numpy") else as_np(res)


def _stats(engine):
    return [c.stream_stats for c in engine.cache_info() if c.stream_stats]


def _same_counters(tstats, jstats):
    for f in COUNTERS:
        assert getattr(tstats, f) == getattr(jstats, f), f


def _jit(**kw):
    return jtra.Engine(executor="jit", **kw)


def _port(executor="jit", **kw):
    return ttra.Engine(executor=executor, device=CPU, **kw)


# ==========================================================================
# Property sweep: chunk sizes × executors, streamed == resident at 1e-5
# ==========================================================================

@pytest.mark.parametrize("executor", ["reference", "jit"])
@pytest.mark.parametrize("chunk_keys", [1, 3, 8])
def test_stream_out_matches_every_executor(executor, chunk_keys):
    A, B = _data(0, (8, 2), (8, 8)), _data(1, (2, 3), (8, 8))
    resident = jtra.Engine(executor=executor).run(
        _matmul(jtra), A=_jrel(A), B=_jrel(B))
    jse = JSE(_jit(), budget=1 << 30)
    jsp = jse.plan(_matmul(jtra), force=True, chunk_keys=chunk_keys)
    jstats = JSS()
    jse.execute(jsp, {"A": _jrel(A), "B": _jrel(B)}, jstats)
    se = StreamExecutor(_port(executor), budget=1 << 30)
    sp = se.plan(_matmul(ttra), force=True, chunk_keys=chunk_keys)
    assert (sp.mode, sp.dim, sp.chunk_keys, sp.nkeys) \
        == (jsp.mode, jsp.dim, jsp.chunk_keys, jsp.nkeys) \
        == ("stream-out", jsp.dim, chunk_keys, 8)
    stats = StreamStats()
    got = se.execute(sp, {"A": A, "B": B}, stats)
    np.testing.assert_allclose(_np(got), _np(resident), atol=1e-5,
                               rtol=1e-5)
    assert stats.chunks == sp.nchunks == -(-8 // chunk_keys)
    _same_counters(stats, jstats)


@pytest.mark.parametrize("chunk_keys", [1, 2, 4, 8])
def test_stream_reduce_matches_oracle(chunk_keys):
    A, B = _data(2, (1, 8), (8, 8)), _data(3, (8, 1), (8, 8))
    want = jtra.Engine(executor="reference", optimize=False, fuse=False) \
        .run(_matmul(jtra, (1, 8), (8, 1)), A=_jrel(A), B=_jrel(B))
    jse = JSE(_jit(), budget=1 << 30)
    jsp = jse.plan(_matmul(jtra, (1, 8), (8, 1)), force=True,
                   chunk_keys=chunk_keys)
    jstats = JSS()
    jse.execute(jsp, {"A": _jrel(A), "B": _jrel(B)}, jstats)
    se = StreamExecutor(_port(), budget=1 << 30)
    sp = se.plan(_matmul(ttra, (1, 8), (8, 1)), force=True,
                 chunk_keys=chunk_keys)
    assert sp.mode == jsp.mode == "stream-reduce"
    stats = StreamStats()
    got = se.execute(sp, {"A": A, "B": B}, stats)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    assert stats.chunks == -(-8 // chunk_keys)
    _same_counters(stats, jstats)


@pytest.mark.parametrize("executor", ["reference", "jit"])
def test_masked_inputs_fall_back_resident(executor):
    A, B = _data(4, (64, 2), (32, 16)), _data(5, (2, 1), (16, 16))
    mask = _masked((64, 2))
    e = _matmul(ttra, (64, 2), (2, 1), (32, 16), (16, 16))
    eng = _port(executor, memory_budget=64 * 1024)
    if executor == "jit":
        with pytest.raises(NotImplementedError, match="mask"):
            eng.run(e, A=_trel(A, mask), B=B)
        return
    want = jtra.Engine(executor="reference", optimize=False, fuse=False) \
        .run(_matmul(jtra, (64, 2), (2, 1), (32, 16), (16, 16)),
             A=_jrel(A, mask), B=_jrel(B))
    got = eng.run(e, A=_trel(A, mask), B=B)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    stats = _stats(eng)
    assert stats and stats[0].mode == "resident"


def test_masked_plan_type_refuses_force_streaming():
    a = ttra.input("A", key_shape=(8, 2), bound=(4, 4))
    e = a.filter(lambda k: k[0] < 6) @ ttra.input("B", key_shape=(2, 2),
                                                  bound=(4, 4))
    se = StreamExecutor(_port("reference"), budget=1)
    with pytest.raises(NotStreamable, match="continuous"):
        se.plan(e, force=True)


# ==========================================================================
# Engine(memory_budget=...): over-budget plans stream, bounded live set
# ==========================================================================

def test_over_budget_contraction_streams_under_budget():
    A, B = _data(6, (64, 2), (32, 16)), _data(7, (2, 1), (16, 16))
    budget = 64 * 1024
    assert A.nbytes >= 4 * budget
    jeng = _jit(memory_budget=budget)
    want = jeng.run(_matmul(jtra, (64, 2), (2, 1), (32, 16), (16, 16)),
                    A=_jrel(A), B=_jrel(B))
    eng = _port(memory_budget=budget)
    e = _matmul(ttra, (64, 2), (2, 1), (32, 16), (16, 16))
    got = eng.run(e, A=A, B=B)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    (stats,) = _stats(eng)
    assert stats.mode == "stream-out" and stats.chunks > 1
    assert 0 < stats.peak_device_bytes <= budget
    hits0 = eng.cache_hits
    eng.run(e, A=A, B=B)
    jeng.run(_matmul(jtra, (64, 2), (2, 1), (32, 16), (16, 16)),
             A=_jrel(A), B=_jrel(B))
    assert eng.cache_hits > hits0 and stats.runs == 2
    _same_counters(stats, _stats(jeng)[0])


def test_chained_two_matmul_zero_rematerialization():
    def prog(mod):
        a = mod.input("A", key_shape=(64, 2), bound=(32, 16))
        b = mod.input("B", key_shape=(2, 2), bound=(16, 8))
        c = mod.input("C", key_shape=(2, 1), bound=(8, 8))
        return (a @ b) @ c
    A, B, C = (_data(8, (64, 2), (32, 16)), _data(9, (2, 2), (16, 8)),
               _data(10, (2, 1), (8, 8)))
    budget = 64 * 1024
    jeng = _jit(memory_budget=budget)
    want = jeng.run(prog(jtra), A=_jrel(A), B=_jrel(B), C=_jrel(C))
    eng = _port(memory_budget=budget)
    got = eng.run(prog(ttra), A=A, B=B, C=C)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    (stats,) = _stats(eng)
    assert stats.mode == "stream-out" and stats.chunks > 1
    assert stats.peak_device_bytes <= budget
    _same_counters(stats, _stats(jeng)[0])


def test_store_backed_inputs_stream_with_h2d_accounting():
    from repro.store import RelationStore as JRS
    A, B = _data(11, (64, 1), (32, 16)), _data(12, (1, 1), (16, 16))
    jeng = _jit(memory_budget=64 * 1024, store=JRS())
    want = jeng.run(_matmul(jtra, (64, 1), (1, 1), (32, 16), (16, 16)),
                    A=jeng.store.put("A", _jrel(A)), B=_jrel(B))
    store = RelationStore()
    eng = _port(memory_budget=64 * 1024, store=store)
    got = eng.run(_matmul(ttra, (64, 1), (1, 1), (32, 16), (16, 16)),
                  A=store.put("A", _trel(A)), B=B)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    (stats,) = _stats(eng)
    assert stats.h2d_bytes >= A.nbytes
    _same_counters(stats, _stats(jeng)[0])


def test_under_budget_plan_runs_resident():
    A, B = _data(0, (8, 2), (8, 8)), _data(1, (2, 3), (8, 8))
    want = jtra.Engine(executor="reference", optimize=False, fuse=False) \
        .run(_matmul(jtra), A=_jrel(A), B=_jrel(B))
    eng = _port(memory_budget=1 << 30)
    got = eng.run(_matmul(ttra), A=A, B=B)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    stats = _stats(eng)
    assert stats and stats[0].mode == "resident"


# ==========================================================================
# Fault injection over store-backed runs
# ==========================================================================

def test_oom_ladder_recovers_via_store_streaming_first(monkeypatch):
    monkeypatch.setenv(ENV_BUDGET, str(4 * 64 * 1024))
    A, B = _data(13, (64, 4), (32, 16)), _data(14, (4, 1), (16, 16))
    args = ((64, 4), (4, 1), (32, 16), (16, 16))
    jinj = JFI().inject_oom(ok_bytes=96 * 1024)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _jit(fault_injector=jinj, degrade=True).run(
            _matmul(jtra, *args), A=_jrel(A), B=_jrel(B))
    inj = FaultInjector().inject_oom(ok_bytes=96 * 1024)
    eng = _port(fault_injector=inj, degrade=True)
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        got = eng.run(_matmul(ttra, *args), A=A, B=B)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    msgs = [str(w.message) for w in wlog]
    assert any("host relation store" in m for m in msgs)
    assert not any("halving" in m for m in msgs)
    ooms = [d for k, d in inj.log if k == "oom"]
    assert ooms and any("unstreamed" in d for d in ooms)
    assert ooms == [d for k, d in jinj.log if k == "oom"]
    streamed = [c for c in eng.cache_info() if c.stream_stats]
    assert streamed and streamed[0].signature[0] == "streamed"


def test_oom_without_degrade_propagates_through_budget_mode():
    A, B = _data(0, (8, 3), (8, 8)), _data(1, (3, 5), (8, 8))
    inj = FaultInjector().inject_oom(ok_bytes=1)
    eng = _port(fault_injector=inj, degrade=False)
    with pytest.raises(DeviceOOM):
        eng.run(_matmul(ttra, (8, 3), (3, 5)), A=A, B=B)


def test_kill_mid_stream_then_clean_retry():
    A, B = _data(15, (64, 2), (32, 16)), _data(16, (2, 1), (16, 16))
    args = ((64, 2), (2, 1), (32, 16), (16, 16))
    want = jtra.Engine(executor="reference", optimize=False, fuse=False) \
        .run(_matmul(jtra, *args), A=_jrel(A), B=_jrel(B))
    inj = FaultInjector().inject_site_failure(step=1, times=1)
    eng = _port(memory_budget=64 * 1024, fault_injector=inj)
    with pytest.raises(SimulatedFailure):
        eng.run(_matmul(ttra, *args), A=A, B=B)
    (stats,) = _stats(eng)
    assert 0 < stats.chunks < stats.runs + 64
    got = eng.run(_matmul(ttra, *args), A=A, B=B)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    assert stats.runs == 2


def test_spilling_store_still_streams_correctly(tmp_path):
    from repro.store import RelationStore as JRS
    A, B = _data(17, (64, 1), (32, 16)), _data(18, (1, 1), (16, 16))
    args = ((64, 1), (1, 1), (32, 16), (16, 16))
    blk = 8 * 32 * 16 * 4
    kw = {"ram_limit_bytes": 2 * blk, "block_bytes": blk}
    jstore = JRS(spill_dir=str(tmp_path / "j"), **kw)
    jeng = _jit(memory_budget=64 * 1024, store=jstore)
    want = jeng.run(_matmul(jtra, *args), A=jstore.put("A", _jrel(A)),
                    B=_jrel(B))
    store = RelationStore(spill_dir=str(tmp_path / "t"), **kw)
    eng = _port(memory_budget=64 * 1024, store=store)
    got = eng.run(_matmul(ttra, *args), A=store.put("A", _trel(A)), B=B)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    (stats,) = _stats(eng)
    assert stats.spill_events > 0
    _same_counters(stats, _stats(jeng)[0])


# ==========================================================================
# The degrade ladder (tests/test_robustness.py's reference/jit cases)
# ==========================================================================

def _bmm(mod):
    return mod.input("A", key_shape=(4, 3), bound=(2, 2)) @ \
        mod.input("B", key_shape=(3, 5), bound=(2, 2))


def _bmm_data():
    r = np.random.default_rng(0)
    return (r.normal(size=(4, 3, 2, 2)).astype(np.float32),
            r.normal(size=(3, 5, 2, 2)).astype(np.float32))


@pytest.mark.parametrize("executor", ["reference", "jit"])
def test_oom_ladder_completes_on_all_executors(executor):
    A, B = _bmm_data()
    base = jtra.Engine(executor="reference").run(_bmm(jtra), A=A, B=B).data
    jinj = JFI().inject_oom(ok_chunk=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtra.Engine(executor=executor, fault_injector=jinj,
                    degrade=True).run(_bmm(jtra), A=A, B=B)
    inj = FaultInjector().inject_oom(ok_chunk=2)
    eng = _port(executor, fault_injector=inj, degrade=True)
    with pytest.warns(RuntimeWarning, match="streamed"):
        out = eng.run(_bmm(ttra), A=A, B=B)
    np.testing.assert_allclose(as_np(out), np.asarray(base), atol=1e-4)
    ooms = [d for k, d in inj.log if k == "oom"]
    assert any("unstreamed" in d for d in ooms)
    assert any(f"chunk={DEFAULT_OOM_LADDER_START}" in d for d in ooms)
    # the same walk as JAX's: the same faults, in the same order
    assert ooms == [d for k, d in jinj.log if k == "oom"]


def test_oom_propagates_without_degrade():
    A, B = _bmm_data()
    eng = _port(fault_injector=FaultInjector().inject_oom(ok_chunk=2))
    with pytest.raises(DeviceOOM):
        eng.run(_bmm(ttra), A=A, B=B)


def test_compile_fallback_warns_and_is_not_shadowed():
    A, B = _bmm_data()
    base = jtra.Engine(executor="reference").run(_bmm(jtra), A=A, B=B).data
    inj = FaultInjector().inject_compile_failure(executor="jit", times=1)
    eng = _port(fault_injector=inj, degrade=True)
    with pytest.warns(RuntimeWarning, match="degraded to executor"):
        c1 = eng.compile(_bmm(ttra))
    assert c1.executor == "reference" and c1.degraded_from == "jit"
    np.testing.assert_allclose(as_np(c1.run(A=A, B=B)), np.asarray(base),
                               atol=1e-5)
    assert [e.degraded for e in eng.cache_info()] == [True]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        c2 = eng.compile(_bmm(ttra))
    assert c2.executor == "jit" and c2.degraded_from is None


def test_compile_failure_propagates_without_degrade():
    inj = FaultInjector().inject_compile_failure(executor="jit", times=1)
    with pytest.raises(CompileFailure):
        _port(fault_injector=inj).compile(_bmm(ttra))


def test_user_errors_never_degrade():
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        _port(degrade=True).compile(_bmm(ttra), chunk=0)


# ==========================================================================
# A real torch.OutOfMemoryError through the ladder
# ==========================================================================

def test_is_oom_error_on_torch_out_of_memory():
    assert is_oom_error(torch.OutOfMemoryError("CUDA out of memory."))
    assert is_oom_error(DeviceOOM("injected"))
    assert not is_oom_error(ValueError("shape"))


def test_real_oom_recovers_on_rung_one_with_frames_released(monkeypatch):
    """A product over more than 32 row blocks raises
    ``torch.OutOfMemoryError`` (a card whose memory holds only streamed
    chunks).  ``degrade=True``
    recovers on rung 1 under the env budget, and the tensor the failed
    attempt allocated is gone before the first chunk runs."""
    import repro_torch.core.tra as ttra_mod
    real = ttra_mod._fused_matmul_2d
    held, seen_alive = [], []

    def bounded(g, left, right, jkl, gb):
        seen_alive.append(any(r() is not None for r in held))
        if left.data.shape[0] > 32:
            scratch = torch.empty(1 << 16)
            held.append(weakref.ref(scratch))
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        return real(g, left, right, jkl, gb)

    monkeypatch.setattr(ttra_mod, "_fused_matmul_2d", bounded)
    monkeypatch.setenv(ENV_BUDGET, str(4 * 64 * 1024))
    A, B = _data(19, (64, 4), (8, 16)), _data(20, (4, 1), (16, 16))
    args = ((64, 4), (4, 1), (8, 16), (16, 16))
    want = jtra.Engine(executor="reference", optimize=False, fuse=False) \
        .run(_matmul(jtra, *args), A=_jrel(A), B=_jrel(B))
    with pytest.raises(torch.OutOfMemoryError):
        _port().run(_matmul(ttra, *args), A=A, B=B)
    held.clear()
    seen_alive.clear()
    gc.collect()
    eng = _port(degrade=True)
    with pytest.warns(RuntimeWarning, match="host relation store"):
        got = eng.run(_matmul(ttra, *args), A=A, B=B)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    (stats,) = _stats(eng)
    assert stats.mode == "stream-out" and stats.chunks > 1
    assert len(held) == 1 and seen_alive[1:] and not any(seen_alive[1:])


# ==========================================================================
# chunk="auto" on the chunked lowering, under a budget
# ==========================================================================

@pytest.mark.parametrize("budget", [None, 4096])
def test_chunk_auto_under_a_budget_matches_jax(budget):
    def prog(mod):
        a = mod.input("A", key_shape=(2, 6), bound=(4, 4))
        b = mod.input("B", key_shape=(6, 2), bound=(4, 4))
        return a.join(b, on=((1,), (0,)), kernel="elemMul").agg(
            (0, 2), "elemMax")
    A, B = _data(21, (2, 6), (4, 4)), _data(22, (6, 2), (4, 4))
    want = _jit(memory_budget=budget).run(prog(jtra), A=_jrel(A),
                                          B=_jrel(B))
    for executor in ("reference", "jit"):
        eng = ttra.Engine(executor=executor, device=CPU,
                          memory_budget=budget)
        got = eng.compile(prog(ttra)).run(A=A, B=B)
        np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-5,
                                   rtol=1e-5)


# ==========================================================================
# The §5.3 FFNN forward at speech-100k: the same StreamPlan as JAX's
# ==========================================================================

SPEECH_DIMS = (10, 4, 10, 1, 1000, 400, 10000, 10)


@pytest.mark.parametrize("root", [5, 6], ids=["z2", "a2"])
@pytest.mark.parametrize("gib", [0.75, 1.0, 1.5, 2.0, 4.0])
def test_speech_100k_stream_plan_equals_jax(root, gib):
    from repro.core import programs as jprog
    from repro.store import NotStreamable as JNS
    from repro_torch.core import programs as tprog
    budget = int(gib * 2 ** 30)

    def plan(SE, eng, mod, NS):
        try:
            sp = SE(eng, budget=budget).plan(
                mod._ffnn_forward(*SPEECH_DIMS)[root])
        except NS:
            return "NotStreamable"
        return (sp.mode, sp.dim, dict(sp.input_dims), sp.chunk_keys,
                sp.nkeys, sp.nchunks)

    want = plan(JSE, _jit(), jprog, JNS)
    got = plan(StreamExecutor, _port(), tprog, NotStreamable)
    assert got == want
    if root == 5 and gib == 1.0:
        assert got == ("stream-reduce", 1, {"W1": 1, "W2": 0}, 1, 10, 10)
    if root == 5 and gib == 4.0:
        assert got == ("stream-out", 0, {"X": 0}, 4, 10, 3)
