"""Port parity: the slice as a whole — ``TraServer`` + ``FFNNScorer``.

A JAX ``FFNNScorer(db=4, hb=4, seed=0)`` has its weights carried to the
port through ``repro_torch.weights`` (``FFNNScorer.from_numpy``); both
servers serve the same payloads and agree at 1e-5 on the ``reference``
and ``jit`` executors, with zero cache misses after warmup and inert
bucket padding.  Then the batch-path cases of ``tests/test_serve.py`` and
``tests/test_serve_resilience.py`` that need no fault injector: shedding,
queue-wait shedding, deadlines, cancel while queued, failed dispatches,
background-thread serving, metering and the load generators.
"""
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.serve as jserve  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.core import Engine  # noqa: E402
from repro_torch.core.plan import FusedJoinAgg, postorder  # noqa: E402
from repro_torch.launch.metering import SpanMeter, percentiles  # noqa: E402
from repro_torch.serve import (DeadlineExceeded, FFNNScorer,  # noqa: E402
                               RequestCancelled, ServerOverloaded, TraServer,
                               closed_loop, open_loop, poisson_arrivals,
                               scorer_mix)
from _torch_helpers import CPU  # noqa: E402

EXECUTORS = ("reference", "jit")
BLOCKING = dict(db=4, hb=4)


def carried_pair(seed=0):
    """A JAX scorer and the port scorer holding the same weights."""
    js = jserve.FFNNScorer(seed=seed, **BLOCKING)
    arrays = {k: np.asarray(r.data) for k, r in js.weights().items()}
    ts = FFNNScorer.from_numpy(arrays, device=CPU, **BLOCKING)
    return js, ts


def port_server(executor="reference", sc=None, **kw):
    sc = sc or FFNNScorer(device=CPU, **BLOCKING)
    server = TraServer(Engine(executor=executor, device=CPU), sc, **kw)
    server.warmup()
    return server, sc


def assert_drained(server):
    assert server._pending == 0 and server.idle()
    assert not server._waiting


@pytest.mark.parametrize("executor", EXECUTORS)
class TestSliceParity:
    def test_served_scores_match_jax(self, executor):
        from repro.core import Engine as JEngine
        js, ts = carried_pair()
        jsrv = jserve.TraServer(JEngine(executor=executor, validate="off"),
                                js)
        tsrv = TraServer(Engine(executor=executor, device=CPU), ts)
        jsrv.warmup()
        tsrv.warmup()
        payloads = scorer_mix(ts, np.random.default_rng(0), 11)  # 8 + 3
        want = jsrv.serve(payloads)
        got = tsrv.serve(payloads)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        for p, g in zip(payloads, got):
            np.testing.assert_allclose(g, js.oracle(p), atol=1e-5)
            np.testing.assert_allclose(g, ts.oracle(p), atol=1e-5)
        assert tsrv.cache_misses_since_warmup == 0
        assert sorted(tsrv.dispatches.values()) == \
            sorted(jsrv.dispatches.values())
        for compiled in tsrv.artifacts.values():
            assert sum(isinstance(n, FusedJoinAgg)
                       for n in postorder(compiled.plan)) == 2

    def test_zero_cache_misses_after_warmup(self, executor):
        server, sc = port_server(executor)
        rng = np.random.default_rng(1)
        for n in (1, 3, 8, 2, 5, 8, 1):        # every bucket, re-visited
            server.serve(scorer_mix(sc, rng, n))
        assert server.cache_misses_since_warmup == 0
        assert all(e.pinned for e in server.engine.cache_info())

    def test_bucket_padding_tail_is_inert(self, executor):
        server, sc = port_server(executor)
        rng = np.random.default_rng(2)
        p = sc.random_payload(rng)
        solo = server.serve([p])[0]
        batched = server.serve([p] + scorer_mix(sc, rng, 2))[0]
        np.testing.assert_allclose(batched, solo, atol=1e-5)


def test_warmup_dispatches_each_bucket_once(monkeypatch):
    """The port's warmup runs every bucket's artifact once (so the first
    request on the card does not pay lazy kernel loading), outside the
    dispatch accounting and the cache-miss invariant."""
    import repro_torch.core.tra as ttra
    calls = []
    real = ttra._fused_matmul_2d
    monkeypatch.setattr(ttra, "_fused_matmul_2d",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    server, sc = port_server("jit")
    assert len(calls) == 2 * len(sc.buckets)
    assert server.dispatches == {}
    assert server.cache_misses_since_warmup == 0
    assert len(server.artifacts) == len(sc.buckets)


def test_default_scorer_serves_unfused_plan():
    server, sc = port_server("jit", FFNNScorer(device=CPU))
    for compiled in server.artifacts.values():
        assert not any(isinstance(n, FusedJoinAgg)
                       for n in postorder(compiled.plan))
    p = sc.random_payload(np.random.default_rng(3))
    np.testing.assert_allclose(server.serve([p])[0], sc.oracle(p),
                               atol=1e-5)


def test_from_numpy_rejects_mismatched_weights():
    js, _ = carried_pair()
    arrays = {k: np.asarray(r.data) for k, r in js.weights().items()}
    with pytest.raises(ValueError):
        FFNNScorer.from_numpy(arrays, device=CPU)          # default blocking
    with pytest.raises(ValueError):
        FFNNScorer.from_numpy({"scorer.W1": arrays["scorer.W1"]},
                              device=CPU, **BLOCKING)


class TestResilience:
    def test_over_max_pending_sheds_fast(self):
        server, sc = port_server(max_pending=2)
        rng = np.random.default_rng(0)
        kept = [server.submit(sc.random_payload(rng)) for _ in range(2)]
        shed = server.submit(sc.random_payload(rng))
        assert shed.done()
        with pytest.raises(ServerOverloaded, match="shed"):
            shed.result(timeout=0)
        assert shed.span.outcome == "shed"
        assert server.counters["shed"] == 1 and server._pending == 2
        server.run_until_idle()
        for h in kept:
            np.testing.assert_allclose(h.result(timeout=0),
                                       sc.oracle(h.payload), atol=1e-5)
        assert_drained(server)

    def test_max_queue_wait_sheds_stale_requests(self):
        t = [0.0]
        server, sc = port_server(meter=SpanMeter(clock=lambda: t[0]),
                                 max_queue_wait_s=1.0)
        rng = np.random.default_rng(1)
        stale = server.submit(sc.random_payload(rng))
        t[0] = 2.0
        fresh = server.submit(sc.random_payload(rng))
        server.run_until_idle()
        with pytest.raises(ServerOverloaded, match="max_queue_wait"):
            stale.result(timeout=0)
        np.testing.assert_allclose(fresh.result(timeout=0),
                                   sc.oracle(fresh.payload), atol=1e-5)
        assert_drained(server)

    def test_deadline_expires_in_queue(self):
        t = [0.0]
        server, sc = port_server(meter=SpanMeter(clock=lambda: t[0]))
        rng = np.random.default_rng(2)
        doomed = server.submit(sc.random_payload(rng), deadline_s=1.0)
        ok = server.submit(sc.random_payload(rng), deadline_s=10.0)
        t[0] = 2.0
        server.run_until_idle()
        with pytest.raises(DeadlineExceeded, match="missed its deadline"):
            doomed.result(timeout=0)
        assert server.counters["deadline_expired"] == 1
        np.testing.assert_allclose(ok.result(timeout=0),
                                   sc.oracle(ok.payload), atol=1e-5)
        assert_drained(server)

    def test_cancel_while_queued_fails_immediately(self):
        server, sc = port_server()
        h = server.submit(sc.random_payload(np.random.default_rng(3)))
        assert h.cancel() and h.done() and h.cancelled()
        with pytest.raises(RequestCancelled, match="while queued"):
            h.result(timeout=0)
        assert h.cancel() is False
        assert server.counters["cancelled"] == 1
        assert_drained(server)

    def test_failed_dispatch_fails_handles_not_server(self):
        server, sc = port_server()
        bad = server.submit(np.zeros(3, np.float32))   # wrong feature dim
        server.step()
        with pytest.raises(ValueError):
            bad.result(timeout=0)
        good = sc.random_payload(np.random.default_rng(4))
        np.testing.assert_allclose(server.serve([good])[0], sc.oracle(good),
                                   atol=1e-5)
        assert_drained(server)

    def test_background_thread_serving(self):
        server, sc = port_server()
        server.start(watchdog_timeout_s=30.0)
        try:
            payloads = scorer_mix(sc, np.random.default_rng(5), 5)
            handles = [server.submit(p) for p in payloads]
            for p, h in zip(payloads, handles):
                np.testing.assert_allclose(h.result(timeout=30.0),
                                           sc.oracle(p), atol=1e-5)
        finally:
            server.stop()
        assert server.health()["status"] == "stopped"
        assert server.counters["watchdog_trips"] == 0

    def test_scheduler_crash_fails_inflight(self):
        server, sc = port_server()

        def boom(now):
            raise RuntimeError("scheduler bug")

        server._step_batch = boom
        h = server.submit(sc.random_payload(np.random.default_rng(6)))
        server.start()
        with pytest.raises(RuntimeError, match="abandoned"):
            h.result(timeout=30.0)
        deadline = time.monotonic() + 30.0
        while server.health()["status"] != "stopped":
            assert time.monotonic() < deadline
            time.sleep(0.01)
        server.stop()
        assert server.counters["scheduler_crashes"] == 1

    def test_stats_report_artifacts_and_dispatches(self):
        server, sc = port_server("jit")
        server.serve(scorer_mix(sc, np.random.default_rng(7), 3))
        stats = server.stats()
        assert stats["servable"] == "ffnn-scorer"
        assert stats["cache_misses_since_warmup"] == 0
        assert sum(a["dispatches"] for a in stats["artifacts"]) == 1
        assert stats["requests"] == 3


class TestMeteringAndLoadgen:
    def test_percentiles_and_spans(self):
        ps = percentiles(list(range(1, 101)))
        assert ps["p50"] == pytest.approx(50.5)
        assert ps["p99"] == pytest.approx(99.01)
        t = [0.0]
        meter = SpanMeter(clock=lambda: t[0])
        span = meter.open("request")
        t[0] = 2.0
        meter.start(span)
        t[0] = 5.0
        meter.complete(span, tokens=6)
        s = meter.summary()
        assert s["queue_wait_ms"]["p50"] == pytest.approx(2000.0)
        assert s["service_ms"]["p50"] == pytest.approx(3000.0)

    def test_poisson_arrivals_match_jax(self):
        a = poisson_arrivals(np.random.default_rng(7), 50, 100.0)
        b = jserve.poisson_arrivals(np.random.default_rng(7), 50, 100.0)
        np.testing.assert_array_equal(a, b)

    def test_open_loop_serves_all(self):
        server, sc = port_server("jit")
        rng = np.random.default_rng(8)
        payloads = scorer_mix(sc, rng, 16)
        rep = open_loop(server, payloads,
                        poisson_arrivals(rng, 16, rate_per_s=4000.0))
        assert rep.requests == 16 and rep.errors == 0
        for p, r in zip(payloads, rep.results):
            np.testing.assert_allclose(r, sc.oracle(p), atol=1e-5)
        assert server.cache_misses_since_warmup == 0

    def test_closed_loop_counts_errors(self):
        server, sc = port_server()
        good = sc.random_payload(np.random.default_rng(9))
        bad = np.zeros(2, np.float32)
        rep = closed_loop(server, lambda i: bad if i == 1 else good,
                          n_requests=4, concurrency=2)
        assert rep.requests == 4 and rep.errors >= 1
        assert server.idle()


def test_step_servables_wait_for_the_decode_slice():
    class Lm(tserve.StepServable):
        pass

    with pytest.raises(NotImplementedError, match="slice 3"):
        TraServer(Engine(device=CPU), Lm())
