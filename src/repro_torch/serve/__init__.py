"""TRA serving engine of the port — continuous batching over compiled
relational plans (the counterpart of ``repro.serve``).

* :class:`~repro_torch.serve.server.TraServer` — admission queue,
  bucket-batching and continuous-batching decode schedulers, pinned
  compile-cache artifacts, and the resilience layer (shedding,
  cancellation/deadlines, transient-fault retry with decode-state
  snapshots, crash containment, watchdog, ``health``).
* :class:`~repro_torch.serve.servable.FFNNScorer` /
  :class:`~repro_torch.serve.servable.RecurrentLM` — the paper-native §5.3
  scorer and the smoke step-decode LM.
* :mod:`repro_torch.serve.loadgen` — Poisson / closed-loop drivers, the
  payload mixes, and :func:`chaos_injector` for fault-schedule runs.
"""
from repro_torch.serve.loadgen import (LoadReport, chaos_injector,
                                       closed_loop, lm_mix, open_loop,
                                       poisson_arrivals, scorer_mix)
from repro_torch.serve.servable import (BatchServable, FFNNScorer, LmRequest,
                                        RecurrentLM, Servable, StepServable,
                                        pick_bucket)
from repro_torch.serve.server import (DeadlineExceeded, RequestCancelled,
                                      RequestHandle, RetryBudgetExceeded,
                                      ServerOverloaded, ServerStopped,
                                      TraServer)

__all__ = [
    "LoadReport", "chaos_injector", "closed_loop", "lm_mix", "open_loop",
    "poisson_arrivals", "scorer_mix",
    "BatchServable", "FFNNScorer", "LmRequest", "RecurrentLM",
    "Servable", "StepServable", "pick_bucket",
    "DeadlineExceeded", "RequestCancelled", "RequestHandle",
    "RetryBudgetExceeded", "ServerOverloaded", "ServerStopped",
    "TraServer",
]
