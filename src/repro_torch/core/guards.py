"""Numeric guards: the error type and the OOM classifier.

Port of the parts of ``repro.core.guards`` the server needs:
:class:`NumericsError` and :func:`is_oom_error`.  ``ExecContext``, the
finite-flag machinery and ``Engine(check_numerics=...)`` come with the
guards-and-faults slice (5, see ``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Optional

import torch


class NumericsError(RuntimeError):
    """A NaN/Inf was produced, attributed to a plan node when possible."""

    def __init__(self, msg: str, node_label: Optional[str] = None):
        super().__init__(msg)
        self.node_label = node_label


def is_oom_error(exc: BaseException) -> bool:
    """True for injected DeviceOOM and real device out-of-memory errors
    (``torch.OutOfMemoryError``, where the JAX package matches XLA's
    ``RESOURCE_EXHAUSTED``)."""
    from repro_torch.core.faults import DeviceOOM
    if isinstance(exc, (DeviceOOM, torch.OutOfMemoryError)):
        return True
    return "out of memory" in str(exc).lower()
