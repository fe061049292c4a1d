"""TRA serving engine of the port — continuous batching over compiled
relational plans (the counterpart of ``repro.serve``).

* :class:`~repro_torch.serve.server.TraServer` — admission queue,
  bucket-batching scheduler, pinned compile-cache artifacts, and the
  resilience layer (shedding, cancellation/deadlines, transient-fault
  retry, crash containment, watchdog, ``health``).
* :class:`~repro_torch.serve.servable.FFNNScorer` — the paper-native §5.3
  scorer.
* :mod:`repro_torch.serve.loadgen` — Poisson / closed-loop drivers.

``RecurrentLM``, ``LmRequest``, ``lm_mix`` and ``chaos_injector`` come
with later slices (see ``ROADMAP.md``).
"""
from repro_torch.serve.loadgen import (LoadReport, closed_loop, open_loop,
                                       poisson_arrivals, scorer_mix)
from repro_torch.serve.servable import (BatchServable, FFNNScorer, Servable,
                                        StepServable, pick_bucket)
from repro_torch.serve.server import (DeadlineExceeded, RequestCancelled,
                                      RequestHandle, RetryBudgetExceeded,
                                      ServerOverloaded, ServerStopped,
                                      TraServer)

__all__ = [
    "LoadReport", "closed_loop", "open_loop", "poisson_arrivals",
    "scorer_mix",
    "BatchServable", "FFNNScorer", "Servable", "StepServable",
    "pick_bucket",
    "DeadlineExceeded", "RequestCancelled", "RequestHandle",
    "RetryBudgetExceeded", "ServerOverloaded", "ServerStopped",
    "TraServer",
]
