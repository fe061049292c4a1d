"""The fault taxonomy of TRA execution (what the server retries).

Port of the classification half of ``repro.core.faults``: the fault types
(``FaultError``, ``SimulatedFailure``, ``DeviceOOM``, ``CompileFailure``)
and :func:`is_transient`.  ``FaultInjector`` — the scripted fault source
the Engine threads through its executors — comes with the guards-and-faults
slice (5, see ``ROADMAP.md``).
"""
from __future__ import annotations

import torch


class FaultError(RuntimeError):
    """Base class of all injected faults."""


class SimulatedFailure(FaultError):
    """A simulated site/node failure (the checkpoint/restart trigger)."""


class DeviceOOM(FaultError):
    """Simulated device out-of-memory in the fused contraction path."""


class CompileFailure(FaultError):
    """Simulated executor compile failure (degradation-ladder trigger)."""


#: The transient half of the taxonomy: failures a retry can clear because
#: they name a condition of the *attempt* (a site died, a device filled,
#: an executor's build flaked) rather than of the request.  Everything
#: else — type errors, bad payloads, shape mismatches — is permanent:
#: retrying replays the same deterministic rejection.
TRANSIENT_FAULTS = (SimulatedFailure, DeviceOOM, CompileFailure)


def is_transient(err: BaseException) -> bool:
    """Classify an execution failure against the fault taxonomy.

    True for the injected transient kinds (:data:`TRANSIENT_FAULTS`), for
    real device failures — ``torch.OutOfMemoryError`` and CUDA runtime
    errors (``torch.AcceleratorError``), where the JAX package keys on
    ``XlaRuntimeError`` — and for numeric-guard trips
    (:class:`repro_torch.core.guards.NumericsError`).
    """
    if isinstance(err, TRANSIENT_FAULTS):
        return True
    if isinstance(err, torch.OutOfMemoryError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(err, accel):
        return True
    from repro_torch.core.guards import NumericsError
    return isinstance(err, NumericsError)
