"""Device-memory calibration and fused-contraction chunk autotuning.

Port of ``repro.store.autotune``.  ``Engine(chunk="auto")`` sizes the
chunked contraction's chunk from a live-slice bytes model instead of the
fixed 16 MiB ``DEFAULT_CHUNK_BYTES`` guess:

    live(chunk) ≈ chunk · slice_bytes  +  2 · out_bytes

— ``chunk`` grid slices in flight plus the output accumulator and the
merged partial.  The budget it solves against is, in order of preference:
an explicit ``Engine(memory_budget=...)``, the
``REPRO_DEVICE_MEMORY_BUDGET`` environment override, the device's memory
scaled by a safety fraction (calibrated once per device), and finally
``DEFAULT_CHUNK_BYTES`` so CPU-only environments keep the pre-autotune
behavior.

Deviation: on a CUDA device :func:`device_memory_budget` reads
``torch.cuda.get_device_properties(d).total_memory``, the counterpart of
XLA's ``memory_stats()['bytes_limit']``; the CPU reports ``None``, as JAX's
CPU backend does.  ``torch.cuda.set_per_process_memory_fraction`` does not
change ``total_memory``: a process capped that way must say its budget
through ``REPRO_DEVICE_MEMORY_BUDGET`` or ``memory_budget``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

ENV_BUDGET = "REPRO_DEVICE_MEMORY_BUDGET"
SAFETY_FRACTION = 0.25      # fraction of device memory the live set may use

_calibrated: dict = {}


def device_memory_budget(device=None) -> Optional[int]:
    """Total device memory in bytes, or None when the device won't say.

    The ``REPRO_DEVICE_MEMORY_BUDGET`` env var overrides (useful to
    simulate a small device); otherwise the answer is calibrated once per
    ``(type, index)``.  ``device`` defaults to the current CUDA device when
    there is one, else the CPU.
    """
    env = os.environ.get(ENV_BUDGET)
    if env:
        try:
            return max(1, int(float(env)))
        except ValueError:
            pass
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = ("cuda", index)
    if key not in _calibrated:
        _calibrated[key] = int(
            torch.cuda.get_device_properties(index).total_memory) or None
    return _calibrated[key]


def stream_budget_bytes(budget: Optional[int] = None, device=None) -> int:
    """Resolve the live-bytes budget streaming paths plan against."""
    if budget is not None:
        return max(1, int(budget))
    dev = device_memory_budget(device)
    if dev:
        return max(1, int(dev * SAFETY_FRACTION))
    from repro_torch.core.tra import DEFAULT_CHUNK_BYTES
    return DEFAULT_CHUNK_BYTES


def chunk_slices(slice_bytes: int, out_bytes: int,
                 budget: Optional[int] = None, device=None) -> int:
    """Chunk count solving the live-slice model against the budget."""
    b = stream_budget_bytes(budget, device)
    return max(1, (b - 2 * out_bytes) // max(1, slice_bytes))
