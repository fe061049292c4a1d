"""Device selection shared by the port's entry points.

Entry points (``Engine``, ``FFNNScorer``, the launchers) take a ``device``
that defaults to ``"cuda"``.  Without a card that default raises: the port
runs on the CPU only when the caller asks for it (``device="cpu"``, as the
tests do), never as a silent fallback.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            f"pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    if dev.type == "cuda" and dev.index is None:
        # tensors report "cuda:N": compare like with like
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
