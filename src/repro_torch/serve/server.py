"""TraServer — continuous batching over long-lived compiled TRA plans.

Port of ``repro.serve.server``: the server owns an
:class:`~repro_torch.core.engine.Engine` plus one servable
(:mod:`repro_torch.serve.servable`) and turns the engine's structural
compile cache into a serving artifact store:

* at :meth:`warmup` every program the servable declares is compiled once
  and **pinned** (``Engine.pin``), so the steady state dispatches against a
  fixed artifact set — the acceptance invariant is *zero cache misses
  after warmup* no matter how request shapes interleave;
* requests enter through a thread-safe queue (:meth:`submit` returns a
  :class:`RequestHandle` the caller blocks on) and the scheduler
  (:meth:`step`) packs whatever is waiting into batched tensor relations:

  - **batch servables** (stateless scoring): drain up to the largest
    bucket, pad to the smallest fitting bucket with zero rows
    (:func:`~repro_torch.core.tra.pack_rows`), dispatch, and unpack the
    first *k* rows — the batch key dim is never contracted, so padding is
    inert;
  - **step servables** (LM decode): token-level continuous batching over
    a fixed-capacity slot-keyed state relation.  Each tick admits pending
    requests into free slots, feeds every active slot one token (its next
    prompt token while prefilling, its last sampled token while decoding),
    dispatches ONE compiled step for all slots, rethreads ``state``
    out→in by name, and evicts finished sequences — zeroing their state
    rows — before the next tick.

Resilience, as in the JAX server: admission control (``max_pending``
sheds fast with :class:`ServerOverloaded`; ``max_queue_wait_s`` sheds
stale requests), cancellation and deadlines (mid-decode too: the slot is
freed and its state row zeroed), transient-fault retry
(:func:`repro_torch.core.faults.is_transient`) with capped exponential
backoff under a per-request budget — on the decode path the state is
copied to the host after every good tick and restored on a fault, so a
fault rewinds the *tick*, not the sequences' progress —, crash containment
of the background scheduler, a tick watchdog, :meth:`health` and
:meth:`stats`.  On the card each decode tick synchronises twice with the
host: the logits it copies for sampling and the state snapshot, the
recovery point.  The background scheduler is one thread, so its CUDA work
stays on one stream.

Per-request admission→completion spans are metered through
:class:`~repro_torch.launch.metering.SpanMeter`, splitting queue wait from
service time, tagging each request with the artifact ids that served it
and its outcome (ok / shed / cancelled / deadline / failed).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.engine import CompiledExpr, Engine
from repro_torch.core.faults import is_transient
from repro_torch.core.tra import TensorRelation, zero_rows
from repro_torch.launch.metering import RequestSpan, SpanMeter
from repro_torch.serve.servable import (BatchServable, LmRequest, Servable,
                                        StepServable, pick_bucket)


class ServerOverloaded(RuntimeError):
    """Request shed by admission control (queue full / waited too long)."""


class ServerStopped(RuntimeError):
    """The server is stopped (scheduler crashed or watchdog tripped)."""


class RequestCancelled(RuntimeError):
    """The request was withdrawn via :meth:`RequestHandle.cancel`."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before it completed; its pending
    count and any decode slot were released."""


class RetryBudgetExceeded(RuntimeError):
    """Transient-fault retries exhausted; the last fault is ``__cause__``."""


class RequestHandle:
    """Caller-side future for one submitted request."""

    def __init__(self, rid: int, payload: Any, span: RequestSpan,
                 server: Optional["TraServer"] = None,
                 deadline: Optional[float] = None):
        self.rid = rid
        self.payload = payload
        self.span = span
        self.deadline = deadline          # absolute meter-clock seconds
        self.retries = 0                  # transient faults charged so far
        self._server = server
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self._counted = False             # holds one pending-count unit
        self._final_lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def cancelled(self) -> bool:
        return isinstance(self._error, RequestCancelled)

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until served; raises the server-side error if it failed.

        A timeout here only stops *waiting* — to actually withdraw the
        request (freeing its pending count and decode slot) call
        :meth:`cancel`, or submit with ``deadline_s=`` so the scheduler
        enforces the bound server-side.
        """
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done")
        if self._error is not None:
            raise self._error
        return self._result

    def cancel(self) -> bool:
        """Withdraw the request; returns False if it already finished.

        Still-queued requests fail immediately with
        :class:`RequestCancelled`; a request mid-decode is evicted at
        the next scheduler tick (slot freed, state row zeroed).
        """
        if self.done():
            return False
        self._cancelled = True
        if self._server is not None:
            self._server._on_cancel(self)
        return True

    def _complete(self, result: Any) -> None:
        self._result = result
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._event.set()


class _Seq:
    """One in-flight decode sequence occupying a slot."""

    def __init__(self, handle: RequestHandle, req: LmRequest):
        self.handle = handle
        self.req = req
        self.pos = 0                      # prompt tokens consumed
        self.generated: List[int] = []
        self.logits: List[np.ndarray] = []

    def next_input_token(self) -> int:
        if self.pos < len(self.req.prompt):
            return int(self.req.prompt[self.pos])     # prefill
        return self.generated[-1]                     # decode

    @property
    def finished(self) -> bool:
        return len(self.generated) >= self.req.max_new_tokens


_COUNTERS = ("shed", "cancelled", "deadline_expired", "retries",
             "transient_faults", "recovered", "retry_exhausted",
             "watchdog_trips", "scheduler_crashes")


class TraServer:
    """Serve one servable over one engine with continuous batching."""

    def __init__(self, engine: Engine, servable: Servable, *,
                 collect_logits: bool = False,
                 meter: Optional[SpanMeter] = None,
                 max_pending: Optional[int] = None,
                 max_queue_wait_s: Optional[float] = None,
                 max_retries: int = 3,
                 retry_backoff_s: float = 0.001,
                 retry_backoff_max_s: float = 0.05,
                 degraded_window_s: float = 5.0):
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.engine = engine
        self.servable = servable
        self.collect_logits = collect_logits
        self.meter = meter if meter is not None else SpanMeter()
        self.max_pending = max_pending
        self.max_queue_wait_s = max_queue_wait_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_max_s = retry_backoff_max_s
        self.degraded_window_s = degraded_window_s
        self._waiting: Deque[RequestHandle] = deque()
        self._queue_lock = threading.Lock()
        self._pending = 0                 # admitted, not yet finalized
        self._pending_lock = threading.Lock()
        self._step_lock = threading.RLock()
        self._next_rid = 0
        self.artifacts: Dict[str, CompiledExpr] = {}
        self.dispatches: Dict[str, int] = {}
        self.warmup_misses: Optional[int] = None
        self.counters: Dict[str, int] = {k: 0 for k in _COUNTERS}
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._stopped = False             # explicit stop() happened
        self._crashed: Optional[BaseException] = None
        self._last_tick: Optional[float] = None
        self._last_fault: Optional[float] = None
        self._decode_attempt = 0          # consecutive failed decode ticks
        if isinstance(servable, StepServable):
            self._state: TensorRelation = servable.init_state()
            self._slots: List[Optional[_Seq]] = [None] * servable.capacity
            self._state_snapshot = servable.snapshot_state(self._state)
        elif not isinstance(servable, BatchServable):
            raise TypeError(f"unsupported servable {type(servable).__name__}")

    # -- admission ---------------------------------------------------------
    def submit(self, payload: Any,
               deadline_s: Optional[float] = None) -> RequestHandle:
        """Enqueue one request; returns a handle to block on.

        ``deadline_s`` (relative seconds) arms scheduler-enforced expiry.
        Over ``max_pending``, the returned handle is already failed with
        :class:`ServerOverloaded` (fast-fail shedding) — it never enters
        the queue.  Raises :class:`ServerStopped` if the scheduler
        crashed or the watchdog tripped.
        """
        if self._crashed is not None:
            raise ServerStopped(
                f"server stopped: {self._crashed!r}") from self._crashed
        if isinstance(self.servable, StepServable) and \
                not isinstance(payload, LmRequest):
            raise TypeError("step servables take LmRequest payloads")
        span = self.meter.open("request")
        deadline = None if deadline_s is None else span.t_submit + deadline_s
        with self._pending_lock:
            rid = self._next_rid
            self._next_rid += 1
            admitted = self.max_pending is None \
                or self._pending < self.max_pending
            if admitted:
                self._pending += 1
        handle = RequestHandle(rid, payload, span, server=self,
                               deadline=deadline)
        handle._counted = admitted
        if not admitted:
            self._finalize(handle, error=ServerOverloaded(
                f"request {rid} shed: {self.max_pending} requests "
                f"already pending"), outcome="shed")
            self.counters["shed"] += 1
            return handle
        with self._queue_lock:
            self._waiting.append(handle)
        return handle

    def _on_cancel(self, handle: RequestHandle) -> None:
        """Called from :meth:`RequestHandle.cancel`.  Queued (never
        scheduled) requests finalize immediately; scheduled ones are
        evicted by the scheduler at the next tick."""
        if handle.span.t_start is not None:
            return
        if self._finalize(handle, error=RequestCancelled(
                f"request {handle.rid} cancelled while queued"),
                outcome="cancelled"):
            self.counters["cancelled"] += 1
        with self._queue_lock:
            try:
                self._waiting.remove(handle)
            except ValueError:
                pass

    # -- artifact lifecycle ------------------------------------------------
    def warmup(self) -> Dict[str, CompiledExpr]:
        """Compile and pin every program the servable declares, and
        dispatch each once: a batch servable's buckets on its warmup
        payload, a step servable's step on a zero state with every slot
        free.

        The dispatch is a port addition: on the card, compiling touches no
        device, and the first run of each program pays CUDA's lazy kernel
        loading and the allocator's growth — without it the first requests
        after warmup wait tens of milliseconds.  It goes through
        :meth:`CompiledExpr.warm`, past the engine's fault injector and
        numerics guard, and is not counted in :attr:`dispatches`.  After
        this returns, steady-state dispatch must be hit-only:
        :attr:`cache_misses_since_warmup` staying 0 is the serving
        acceptance invariant.
        """
        sv = self.servable
        if isinstance(sv, StepServable):
            for prog in sv.programs():
                compiled = self.engine.compile(prog)
                self.engine.pin(compiled)
                self.artifacts[compiled.artifact_id] = compiled
                compiled.warm(**sv.step_inputs([None] * sv.capacity),
                              **sv.weights(),
                              **{"lm.state": sv.init_state()})
        else:
            warm = sv.warmup_payload()
            for bucket in sv.buckets:
                compiled = self.engine.compile(sv.program(bucket))
                self.engine.pin(compiled)
                self.artifacts[compiled.artifact_id] = compiled
                if warm is not None:
                    compiled.warm(**sv.pack([warm] * bucket, bucket),
                                  **sv.weights())
        self.warmup_misses = self.engine.cache_misses
        return dict(self.artifacts)

    @property
    def cache_misses_since_warmup(self) -> int:
        if self.warmup_misses is None:
            return self.engine.cache_misses
        return self.engine.cache_misses - self.warmup_misses

    # -- scheduling --------------------------------------------------------
    def idle(self) -> bool:
        with self._pending_lock:
            return self._pending == 0

    def step(self) -> int:
        """One scheduler tick; returns how many requests made progress."""
        with self._step_lock:
            now = self.meter.now()
            swept = self._sweep_queue(now)
            if isinstance(self.servable, BatchServable):
                progressed = self._step_batch(now)
            else:
                progressed = self._step_decode(now)
            self._last_tick = self.meter.now()
            return swept + progressed

    def run_until_idle(self, max_steps: int = 100_000) -> int:
        """Drive ticks until every submitted request completed."""
        steps = 0
        while not self.idle():
            if steps >= max_steps:
                raise RuntimeError(f"not idle after {max_steps} steps")
            self.step()
            steps += 1
        return steps

    def serve(self, payloads: Sequence[Any],
              return_exceptions: bool = False) -> List[Any]:
        """Submit a batch of payloads, drive to idle, return results.

        With ``return_exceptions`` a failed/shed request yields its
        exception object instead of raising — the mixed-outcome mode.
        """
        handles = [self.submit(p) for p in payloads]
        self.run_until_idle()
        out: List[Any] = []
        for h in handles:
            try:
                out.append(h.result(timeout=0))
            except Exception as err:  # noqa: BLE001 — caller asked for it
                if not return_exceptions:
                    raise
                out.append(err)
        return out

    # -- background loop ---------------------------------------------------
    def start(self, tick_wait_s: float = 0.001,
              watchdog_timeout_s: Optional[float] = None) -> None:
        """Run the scheduler on a background thread (loadgen mode).

        An exception escaping :meth:`step` no longer dies silently on
        the daemon thread: it fails every pending/in-flight handle (the
        crash chained as ``__cause__``) and marks the server stopped.
        ``watchdog_timeout_s`` arms a watchdog thread that does the same
        when the scheduler goes quiet (hung dispatch / dead thread) for
        longer than the timeout while requests are pending — size it
        well above the worst-case tick (dispatch + full retry backoff).
        """
        if self._thread is not None:
            raise RuntimeError("server already started")
        if self._crashed is not None:
            raise ServerStopped(
                f"server stopped: {self._crashed!r}") from self._crashed
        self._stop.clear()
        self._stopped = False

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    progressed = self.step()
                except Exception as err:  # noqa: BLE001 — crash containment
                    self._on_scheduler_crash(err)
                    return
                if progressed == 0:
                    self._stop.wait(tick_wait_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="tra-server")
        self._thread.start()
        if watchdog_timeout_s is not None:
            self._start_watchdog(watchdog_timeout_s, self._thread)

    def _start_watchdog(self, timeout_s: float,
                        scheduler: threading.Thread) -> None:
        started_at = self.meter.now()

        def watch() -> None:
            interval = max(min(timeout_s / 4.0, 0.05), 1e-3)
            while not self._stop.wait(interval):
                if self.idle():
                    continue
                last = self._last_tick
                ref = last if last is not None else started_at
                dead = not scheduler.is_alive()
                hung = self.meter.now() - ref > timeout_s
                if not (dead or hung):
                    continue
                why = ("scheduler thread died" if dead else
                       f"no scheduler tick in {timeout_s}s")
                self.counters["watchdog_trips"] += 1
                self._crashed = RuntimeError(f"watchdog tripped: {why}")
                self._fail_all_inflight(lambda h: RuntimeError(
                    f"request {h.rid} stranded: {why} (watchdog)"))
                self._stop.set()
                return

        self._watchdog = threading.Thread(target=watch, daemon=True,
                                          name="tra-server-watchdog")
        self._watchdog.start()

    def _on_scheduler_crash(self, err: BaseException) -> None:
        """Satellite of the watchdog: contain a crash escaping step()."""
        self._crashed = err
        self.counters["scheduler_crashes"] += 1

        def make_err(h: RequestHandle) -> BaseException:
            diag: BaseException = RuntimeError(
                f"request {h.rid} abandoned: server scheduler crashed "
                f"({err!r})")
            diag.__cause__ = err
            return diag

        self._fail_all_inflight(make_err)
        self._stop.set()

    def _fail_all_inflight(
            self, make_err: Callable[[RequestHandle], BaseException]) -> int:
        """Fail every queued and slotted request (crash/watchdog path)."""
        failed = 0
        while True:
            with self._queue_lock:
                if not self._waiting:
                    break
                handle = self._waiting.popleft()
            if self._finalize(handle, error=make_err(handle),
                              outcome="failed"):
                failed += 1
        if isinstance(self.servable, StepServable):
            for i, seq in enumerate(self._slots):
                if seq is None:
                    continue
                if self._finalize(seq.handle, error=make_err(seq.handle),
                                  outcome="failed"):
                    failed += 1
                self._slots[i] = None
            self._state = self.servable.init_state()
            self._commit_state()
        return failed

    def stop(self, join_timeout_s: Optional[float] = 5.0) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(join_timeout_s)
        if self._watchdog is not None:
            self._watchdog.join(join_timeout_s)
            self._watchdog = None
        self._thread = None
        self._stopped = True

    # -- internals ---------------------------------------------------------
    def _finalize(self, handle: RequestHandle, *, result: Any = None,
                  error: Optional[BaseException] = None,
                  outcome: str = "ok", tokens: int = 0) -> bool:
        """First-wins completion: exactly one caller sets the result /
        error, completes the span, and releases the pending count — the
        scheduler, a deadline sweep, cancel(), and the watchdog can race
        on the same handle without double-counting."""
        with handle._final_lock:
            if handle.done():
                return False
            if error is not None:
                handle._fail(error)
            else:
                handle._complete(result)
        handle.span.outcome = outcome
        self.meter.complete(handle.span, tokens=tokens)
        if handle._counted:
            with self._pending_lock:
                self._pending -= 1
        return True

    def _finish(self, handle: RequestHandle, result: Any,
                tokens: int) -> None:
        if self._finalize(handle, result=result, tokens=tokens) \
                and handle.retries > 0:
            self.counters["recovered"] += 1

    def _fail(self, handle: RequestHandle, err: BaseException,
              outcome: str = "failed") -> bool:
        return self._finalize(handle, error=err, outcome=outcome)

    def _expire(self, handle: RequestHandle, now: float) -> bool:
        """Apply cancel/deadline/queue-wait policy to a queued handle;
        True if it was finalized (caller must skip it)."""
        if handle.done():
            return True
        if handle._cancelled:
            if self._fail(handle, RequestCancelled(
                    f"request {handle.rid} cancelled while queued"),
                    outcome="cancelled"):
                self.counters["cancelled"] += 1
            return True
        if handle.deadline is not None and now > handle.deadline:
            if self._fail(handle, DeadlineExceeded(
                    f"request {handle.rid} missed its deadline after "
                    f"{now - handle.span.t_submit:.3f}s in queue"),
                    outcome="deadline"):
                self.counters["deadline_expired"] += 1
            return True
        if self.max_queue_wait_s is not None \
                and now - handle.span.t_submit > self.max_queue_wait_s:
            if self._fail(handle, ServerOverloaded(
                    f"request {handle.rid} shed: queued longer than "
                    f"max_queue_wait_s={self.max_queue_wait_s}"),
                    outcome="shed"):
                self.counters["shed"] += 1
            return True
        return False

    def _sweep_queue(self, now: float) -> int:
        """Finalize expired/cancelled queued requests even when the
        schedulable window never reaches them (saturated server)."""
        with self._queue_lock:
            snapshot = list(self._waiting)
        finalized = 0
        for handle in snapshot:
            if not handle.done() and self._expire(handle, now):
                finalized += 1
        with self._queue_lock:
            done = [h for h in self._waiting if h.done()]
            for h in done:                # prune finalized entries
                self._waiting.remove(h)
        return finalized

    def _pop_next(self, now: float) -> Optional[RequestHandle]:
        """Next schedulable request, skipping finalized/expired ones."""
        while True:
            with self._queue_lock:
                if not self._waiting:
                    return None
                handle = self._waiting.popleft()
            if self._expire(handle, now):
                continue
            return handle

    def _backoff(self, attempt: int) -> None:
        delay = min(self.retry_backoff_max_s,
                    self.retry_backoff_s * (2.0 ** attempt))
        if delay > 0:
            time.sleep(delay)

    def _charge_retry(self, handle: RequestHandle,
                      fault: BaseException) -> bool:
        """Charge one transient fault to the handle's retry budget;
        False (and the handle failed, fault chained) if exhausted."""
        handle.retries += 1
        self.counters["retries"] += 1
        if handle.retries <= self.max_retries:
            return True
        err = RetryBudgetExceeded(
            f"request {handle.rid} failed after {self.max_retries} "
            f"retries; last fault: {fault!r}")
        err.__cause__ = fault
        if self._fail(handle, err):
            self.counters["retry_exhausted"] += 1
        return False

    def _record_dispatch(self, compiled: CompiledExpr,
                         spans: Sequence[RequestSpan]) -> None:
        aid = compiled.artifact_id or "unkeyed"
        self.dispatches[aid] = self.dispatches.get(aid, 0) + 1
        for sp in spans:
            if not sp.artifacts or sp.artifacts[-1] != aid:
                sp.artifacts.append(aid)

    def _step_batch(self, now: float) -> int:
        sv: BatchServable = self.servable  # type: ignore[assignment]
        batch: List[RequestHandle] = []
        while len(batch) < max(sv.buckets):
            handle = self._pop_next(now)
            if handle is None:
                break
            self.meter.start(handle.span)
            batch.append(handle)
        if not batch:
            return 0
        progressed = len(batch)
        attempt = 0
        while batch:
            bucket = pick_bucket(len(batch), sv.buckets)
            try:
                compiled = self.engine.compile(sv.program(bucket))
                self._record_dispatch(compiled, [h.span for h in batch])
                outs = compiled.run(**sv.pack([h.payload for h in batch],
                                              bucket), **sv.weights())
                results = sv.unpack(outs, len(batch))
            except Exception as err:  # noqa: BLE001 — classify and retry
                if not is_transient(err):
                    for h in batch:      # permanent: fail, keep serving
                        self._fail(h, err)
                    return progressed
                self.counters["transient_faults"] += 1
                self._last_fault = self.meter.now()
                batch = [h for h in batch if self._charge_retry(h, err)]
                self._backoff(attempt)
                attempt += 1
                continue
            for h, res in zip(batch, results):
                self._finish(h, res, tokens=1)
            break
        return progressed

    def _commit_state(self) -> None:
        """Host-copy recovery point: the state every retry rewinds to."""
        sv: StepServable = self.servable  # type: ignore[assignment]
        self._state_snapshot = sv.snapshot_state(self._state)

    def _reclaim_slots(self, now: float) -> int:
        """Evict cancelled / deadline-expired sequences: free the slot,
        zero the state row, fail the handle."""
        reclaimed: List[int] = []
        for i, seq in enumerate(self._slots):
            if seq is None:
                continue
            handle = seq.handle
            if handle._cancelled and not handle.done():
                if self._fail(handle, RequestCancelled(
                        f"request {handle.rid} cancelled mid-decode "
                        f"(slot {i} freed)"), outcome="cancelled"):
                    self.counters["cancelled"] += 1
            elif handle.deadline is not None and now > handle.deadline \
                    and not handle.done():
                if self._fail(handle, DeadlineExceeded(
                        f"request {handle.rid} missed its deadline "
                        f"mid-decode (slot {i} freed)"),
                        outcome="deadline"):
                    self.counters["deadline_expired"] += 1
            if handle.done():
                self._slots[i] = None
                reclaimed.append(i)
        if reclaimed:
            self._state = zero_rows(self._state, reclaimed)
            self._commit_state()
        return len(reclaimed)

    def _on_decode_failure(self, live, err: BaseException) -> None:
        """Fault-isolated decode recovery: restore the last good state
        snapshot, so surviving sequences resume from the previous tick
        instead of a full-state reset."""
        sv: StepServable = self.servable  # type: ignore[assignment]
        self._state = sv.restore_state(self._state_snapshot)
        if not is_transient(err):
            dead = []
            for i, seq in live:          # permanent: fail only the victims
                self._fail(seq.handle, err)
                self._slots[i] = None
                dead.append(i)
            self._state = zero_rows(self._state, dead)
            self._commit_state()
            return
        self.counters["transient_faults"] += 1
        self._last_fault = self.meter.now()
        dead = []
        for i, seq in live:
            if not self._charge_retry(seq.handle, err):
                self._slots[i] = None
                dead.append(i)
        if dead:
            self._state = zero_rows(self._state, dead)
        self._commit_state()
        self._backoff(self._decode_attempt)
        self._decode_attempt += 1

    def _step_decode(self, now: float) -> int:
        sv: StepServable = self.servable  # type: ignore[assignment]
        # 0. reclaim slots of cancelled / expired sequences
        reclaimed = self._reclaim_slots(now)
        # 1. admit pending requests into the lowest free slots
        for i in range(sv.capacity):
            if self._slots[i] is not None:
                continue
            handle = self._pop_next(now)
            if handle is None:
                break
            self.meter.start(handle.span)
            self._slots[i] = _Seq(handle, handle.payload)
        live = [(i, s) for i, s in enumerate(self._slots) if s is not None]
        if not live:
            return reclaimed
        # 2. one token per active slot: prompt token while prefilling,
        #    last sampled token while decoding
        tokens: List[Optional[int]] = [None] * sv.capacity
        for i, seq in live:
            tokens[i] = seq.next_input_token()
        # 3. ONE batched step for every slot; state threads out -> in
        try:
            compiled = self.engine.compile(sv.step_program())
            self._record_dispatch(compiled, [s.handle.span for _, s in live])
            outs = compiled.run(**sv.step_inputs(tokens), **sv.weights(),
                                **{"lm.state": self._state})
            logits = outs["logits"].data.cpu().numpy()
        except Exception as err:  # noqa: BLE001 — classify and retry
            self._on_decode_failure(live, err)
            return reclaimed + len(live)
        self._state = outs["state"]
        self._decode_attempt = 0
        # 4. advance sequences; sample once prefill is done
        evicted: List[int] = []
        for i, seq in live:
            seq.pos += 1
            if seq.pos >= len(seq.req.prompt):
                row = logits[i].reshape(-1)
                seq.generated.append(sv.next_token(row))
                if self.collect_logits:
                    seq.logits.append(row.copy())
            if seq.finished:
                result = {"tokens": list(seq.generated)}
                if self.collect_logits:
                    result["logits"] = list(seq.logits)
                self._finish(seq.handle, result,
                             tokens=len(seq.generated))
                self._slots[i] = None
                evicted.append(i)
        # 5. zero evicted state rows so reused slots start clean, then
        #    commit the post-tick state as the new recovery point
        if evicted:
            self._state = zero_rows(self._state, evicted)
        self._commit_state()
        return reclaimed + len(live)

    # -- reporting ---------------------------------------------------------
    def health(self) -> Dict[str, Any]:
        """Liveness snapshot: status, depths, ages, resilience counters."""
        now = self.meter.now()
        with self._queue_lock:
            queued = [h for h in self._waiting if not h.done()]
        submits = [h.span.t_submit for h in queued]
        if isinstance(self.servable, StepServable):
            submits += [s.handle.span.t_submit for s in self._slots
                        if s is not None and not s.handle.done()]
        with self._pending_lock:
            pending = self._pending
        if self._crashed is not None or self._stopped:
            status = "stopped"
        elif self._last_fault is not None \
                and now - self._last_fault < self.degraded_window_s:
            status = "degraded"
        else:
            status = "live"
        return {
            "status": status,
            "queue_depth": len(queued),
            "pending": pending,
            "oldest_request_age_s":
                round(now - min(submits), 6) if submits else None,
            "last_tick_age_s":
                round(now - self._last_tick, 6)
                if self._last_tick is not None else None,
            "counters": dict(self.counters),
        }

    def stats(self) -> Dict[str, Any]:
        """Serving report: artifacts, dispatch counts, health, spans."""
        cache = [{
            "artifact_id": e.artifact_id,
            "executor": e.executor,
            "hits": e.hits,
            "pinned": e.pinned,
            "degraded": e.degraded,
            "dispatches": self.dispatches.get(e.artifact_id, 0),
        } for e in self.engine.cache_info()]
        return {
            "servable": self.servable.name,
            "executor": self.engine.executor,
            "cache_misses_since_warmup": self.cache_misses_since_warmup,
            "artifacts": cache,
            "health": self.health(),
            **self.meter.summary(),
        }
