"""Load generation for :class:`~repro_torch.serve.server.TraServer`.

Port of ``repro.serve.loadgen`` (``poisson_arrivals``, ``scorer_mix``,
``LoadReport``, ``open_loop``, ``closed_loop``).  Two drive modes, both
running the scheduler *in-thread* so a run is deterministic modulo the
clock:

* :func:`open_loop` — requests arrive on a pre-drawn schedule
  (:func:`poisson_arrivals` for a Poisson process at a target rate);
  whatever is due gets submitted before each tick.  Latency here is the
  honest serving number: queue wait under burst + service time.
* :func:`closed_loop` — a fixed number of outstanding requests; each
  completion immediately resubmits (peak-throughput mode).

Both return a :class:`LoadReport` built from the server's
:class:`~repro_torch.launch.metering.SpanMeter` summary.  ``lm_mix`` (the
decode diet) and ``chaos_injector`` (fault schedules) come with the
decode (3) and guards-and-faults (5) slices, see ``ROADMAP.md``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.serve.servable import BatchServable
from repro_torch.serve.server import (RequestHandle, ServerOverloaded,
                                      TraServer)


def poisson_arrivals(rng: np.random.Generator, n: int,
                     rate_per_s: float) -> List[float]:
    """Cumulative arrival offsets (seconds) of a Poisson process."""
    if rate_per_s <= 0:
        raise ValueError("rate_per_s must be > 0")
    gaps = rng.exponential(1.0 / rate_per_s, size=n)
    return list(np.cumsum(gaps))


def scorer_mix(sv: BatchServable, rng: np.random.Generator,
               n: int) -> List[np.ndarray]:
    """Random feature-vector payloads for a batch servable."""
    return [sv.random_payload(rng) for _ in range(n)]


@dataclasses.dataclass
class LoadReport:
    """One load run: meter summary + outcome counts + wall time.

    ``results`` holds the per-request responses in submission order
    (``None`` where the request failed or was shed) so callers can
    cross-check served outputs against an oracle.  ``errors`` counts
    admitted requests that failed; ``shed`` counts admission-control
    fast-fails (:class:`~repro_torch.serve.server.ServerOverloaded`) — kept
    apart because the goodput SLO is defined over admitted requests.
    """

    mode: str
    requests: int
    errors: int
    wall_s: float
    summary: Dict[str, Any]
    results: List[Any] = dataclasses.field(default_factory=list)
    shed: int = 0

    @property
    def admitted(self) -> int:
        return self.requests - self.shed

    @property
    def goodput(self) -> float:
        """Fraction of *admitted* requests that completed with a result."""
        if self.admitted <= 0:
            return 1.0
        return (self.admitted - self.errors) / self.admitted

    @property
    def tokens_per_s(self) -> float:
        return float(self.summary.get("tokens_per_s", 0.0))

    def to_json(self) -> Dict[str, Any]:
        return {"mode": self.mode, "requests": self.requests,
                "errors": self.errors, "shed": self.shed,
                "goodput": round(self.goodput, 6),
                "wall_s": round(self.wall_s, 4),
                **self.summary}


def _collect(handles: List[Optional[RequestHandle]]) -> tuple:
    errors, shed, results = 0, 0, []
    for h in handles:
        try:
            results.append(h.result(timeout=0) if h is not None else None)
        except ServerOverloaded:
            shed += 1
            results.append(None)
        except Exception:  # noqa: BLE001 — tallied, surfaced via report
            errors += 1
            results.append(None)
    return errors, shed, results


def open_loop(server: TraServer, payloads: List[Any],
              arrivals: List[float],
              clock: Optional[Callable[[], float]] = None,
              deadline_s: Optional[float] = None) -> LoadReport:
    """Drive a timed arrival schedule; tick whenever work is pending."""
    if len(payloads) != len(arrivals):
        raise ValueError("payloads and arrivals must align")
    order = np.argsort(arrivals, kind="stable")
    clock = clock or time.perf_counter
    t0 = clock()
    handles: List[Optional[RequestHandle]] = [None] * len(payloads)
    nxt = 0
    while nxt < len(payloads) or not server.idle():
        now = clock() - t0
        while nxt < len(payloads) and arrivals[order[nxt]] <= now:
            handles[order[nxt]] = server.submit(payloads[order[nxt]],
                                                deadline_s=deadline_s)
            nxt += 1
        if server.step() == 0 and nxt < len(payloads):
            # idle gap before the next arrival: sleep it off
            time.sleep(min(1e-3, max(0.0,
                                     arrivals[order[nxt]] - (clock() - t0))))
    wall = clock() - t0
    errors, shed, results = _collect(handles)
    return LoadReport("open_loop", len(payloads), errors, wall,
                      server.meter.summary(), results, shed=shed)


def closed_loop(server: TraServer, make_payload: Callable[[int], Any],
                n_requests: int, concurrency: int,
                clock: Optional[Callable[[], float]] = None) -> LoadReport:
    """Keep ``concurrency`` requests in flight until ``n_requests`` done."""
    if concurrency < 1:
        raise ValueError("concurrency must be >= 1")
    clock = clock or time.perf_counter
    t0 = clock()
    handles: List[RequestHandle] = []
    submitted = 0
    inflight: List[RequestHandle] = []
    while len(handles) - sum(h.done() for h in handles) > 0 \
            or submitted < n_requests:
        while submitted < n_requests and len(inflight) < concurrency:
            h = server.submit(make_payload(submitted))
            handles.append(h)
            inflight.append(h)
            submitted += 1
        server.step()
        inflight = [h for h in inflight if not h.done()]
    wall = clock() - t0
    errors, shed, results = _collect(handles)
    return LoadReport("closed_loop", len(handles), errors, wall,
                      server.meter.summary(), results, shed=shed)
