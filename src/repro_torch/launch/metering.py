"""Request-span metering for the serving layer: admission → completion.

Port of the request-span part of ``repro.launch.metering``
(``RequestSpan``, ``percentiles``, ``SpanMeter``), which the server needs.
The structural roofline meters of the JAX module (and its ``StreamStats``
for the out-of-core store) price TPU cells and come with later slices.

Spans are split into queue wait (submit → first scheduled step) and
service (first step → completion), so a serving run reports latency
percentiles instead of one whole-process wall clock that hides queueing.
Times are host ``time.perf_counter`` seconds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence


@dataclasses.dataclass
class RequestSpan:
    """One request's lifecycle timestamps (``time.perf_counter`` seconds).

    ``t_submit`` is stamped at queue admission, ``t_start`` when the
    scheduler first packs the request into a batch (or allocates its
    decode slot), ``t_complete`` when the result is handed back.
    ``tokens`` counts produced output units (generated tokens for decode
    servables, scored rows for stateless ones); ``artifacts`` records the
    compile-cache ``artifact_id`` of every program dispatch that served
    this request.  ``outcome`` is the request's fate — ``"ok"`` or one of
    the resilience outcomes (``shed`` / ``cancelled`` / ``deadline`` /
    ``failed``); shed spans complete without ever starting, so their
    ``t_start`` stays ``None``.
    """

    rid: int
    kind: str = "request"
    t_submit: float = 0.0
    t_start: Optional[float] = None
    t_complete: Optional[float] = None
    tokens: int = 0
    artifacts: list = dataclasses.field(default_factory=list)
    outcome: str = "ok"

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_start is None:
            return None
        return self.t_start - self.t_submit

    @property
    def service_s(self) -> Optional[float]:
        if self.t_start is None or self.t_complete is None:
            return None
        return self.t_complete - self.t_start

    @property
    def total_s(self) -> Optional[float]:
        if self.t_complete is None:
            return None
        return self.t_complete - self.t_submit


def percentiles(values: Sequence[float],
                qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` by linear interpolation."""
    out: Dict[str, float] = {}
    xs = sorted(float(v) for v in values)
    for q in qs:
        name = f"p{int(q) if float(q).is_integer() else q}"
        if not xs:
            out[name] = float("nan")
            continue
        pos = (len(xs) - 1) * (q / 100.0)
        lo, hi = int(math.floor(pos)), int(math.ceil(pos))
        out[name] = xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
    return out


class SpanMeter:
    """Collects :class:`RequestSpan`\\ s and summarizes them.

    The serving layer owns exactly one meter per server; spans are opened
    at ``submit`` time and closed by the scheduler, so queue wait and
    compute are metered per request instead of folded into one
    whole-process wall clock.
    """

    def __init__(self, clock=None) -> None:
        import time
        self._clock = clock or time.perf_counter
        self.spans: list = []
        self._next_rid = 0

    def now(self) -> float:
        return self._clock()

    def open(self, kind: str = "request") -> RequestSpan:
        span = RequestSpan(rid=self._next_rid, kind=kind,
                           t_submit=self.now())
        self._next_rid += 1
        self.spans.append(span)
        return span

    def start(self, span: RequestSpan) -> None:
        if span.t_start is None:
            span.t_start = self.now()

    def complete(self, span: RequestSpan, tokens: int = 0) -> None:
        span.t_complete = self.now()
        span.tokens += tokens

    # -- reporting --------------------------------------------------------
    def completed(self) -> list:
        return [s for s in self.spans if s.t_complete is not None]

    def summary(self) -> Dict[str, object]:
        """Percentile latencies (ms) + aggregate throughput (tokens/s).

        Latency percentiles cover the spans that were actually
        *scheduled* (``t_start`` set) — shed requests fail before ever
        starting, so folding them in would deflate queue-wait and
        service numbers; they are tallied in ``outcomes`` instead.
        """
        done = self.completed()
        if not done:
            return {"requests": 0}
        served = [s for s in done if s.t_start is not None]
        outcomes: Dict[str, int] = {}
        for s in done:
            outcomes[s.outcome] = outcomes.get(s.outcome, 0) + 1
        t0 = min(s.t_submit for s in done)
        t1 = max(s.t_complete for s in done)
        window = max(t1 - t0, 1e-9)
        tokens = sum(s.tokens for s in done)
        ms = 1e3
        return {
            "requests": len(done),
            "tokens": tokens,
            "window_s": round(window, 6),
            "tokens_per_s": round(tokens / window, 3),
            "outcomes": outcomes,
            "total_ms": {k: round(v * ms, 3) for k, v in percentiles(
                [s.total_s for s in served]).items()},
            "queue_wait_ms": {k: round(v * ms, 3) for k, v in percentiles(
                [s.queue_wait_s for s in served]).items()},
            "service_ms": {k: round(v * ms, 3) for k, v in percentiles(
                [s.service_s for s in served]).items()},
        }
