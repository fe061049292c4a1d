"""Run one phase of ``chip_smoke.py`` alone on a card, and name what it
leaves allocated for the process.

    python3 tools/smoke_phase_alone.py mesh     # or ckpt; on a machine with a card

Runs the smoke's ``device`` and ``build`` phases, then the warm product
with the caching allocator's history recorded (C++ and Python frames), and
prints one JSON line: the blocks it left allocated, each with its size and
the frames that name cuBLAS.  Then the phase itself, with the history
recorded (Python frames), which must leave 0 bytes on the card by its own
count (``chip_smoke.phase_allocated``) when it runs first; last, the
blocks still allocated that were not there before the phase, each with
its size and innermost frames.
"""
from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402


def live_blocks() -> dict:
    """address → (size, frames) of every block the allocator holds for a
    tensor."""
    out = {}
    for seg in torch.cuda.memory._snapshot()["segments"]:
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                out[b["address"]] = (b["size"], b.get("frames", []))
    return out


def named(frames) -> list:
    names = [f"{f.get('name', '')} ({os.path.basename(f.get('filename', ''))})"
             for f in frames]
    blas = [n for n in names if "blas" in n.lower()]
    return blas[:6] or names[:8]


def main() -> int:
    phase = sys.argv[1] if len(sys.argv) > 1 else "mesh"
    if not torch.cuda.is_available():
        print("smoke_phase_alone: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smoke.phase_device(device)
    smoke.phase_build()
    before = live_blocks()
    torch.cuda.memory._record_memory_history(enabled="all", context="all",
                                             stacks="all")
    warm = smoke.cublas_warm(device)
    warmed = live_blocks()
    torch.cuda.memory._record_memory_history(enabled=None)
    new = {a: v for a, v in warmed.items() if a not in before}
    print(json.dumps({"phase": "alone.warm", "nvidia_smi": smi,
                      "cublas_warm_bytes": warm,
                      "blocks": [{"size": size, "frames": named(frames)}
                                 for size, frames in new.values()]}),
          flush=True)
    torch.cuda.memory._record_memory_history(enabled="all",
                                             context="alloc",
                                             stacks="python")
    rc = 0
    try:
        if phase == "mesh":
            smoke.phase_mesh(device, smi)
        else:
            smoke.phase_ckpt(device)
    except SystemExit as exc:
        rc = exc.code or 1
    left = {a: v for a, v in live_blocks().items() if a not in warmed}
    torch.cuda.memory._record_memory_history(enabled=None)
    print(json.dumps({"phase": "alone.left", "of": phase,
                      "bytes_left": sum(v[0] for v in left.values()),
                      "blocks": [{"size": size, "frames": named(frames)}
                                 for size, frames in left.values()]}),
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
