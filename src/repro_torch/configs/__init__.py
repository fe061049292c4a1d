"""Configurations of the port: the paper's §5.3 FFNN configs
(:mod:`.ffnn_paper`) and the dense, ssm and hybrid families of the model
zoo.

``get_config("gemma2-2b")`` / ``--arch`` as in ``repro.configs``.  The
model configs are copies of the JAX package's (same fields, same values).
Deviation: ``list_archs()`` lists only the ported archs; any other arch of
the JAX registry raises ``NotImplementedError`` naming the slice that
ports it (``ROADMAP.md``), an unknown one ``KeyError``.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (gemma2_2b, mamba2_130m, minitron_4b,
                                 qwen2_5_14b, qwen2_7b, zamba2_7b)
from repro_torch.configs.base import ModelConfig, ShapeSpec

_MODULES = {
    "qwen2.5-14b": qwen2_5_14b,
    "qwen2-7b": qwen2_7b,
    "gemma2-2b": gemma2_2b,
    "minitron-4b": minitron_4b,
    "mamba2-130m": mamba2_130m,
    "zamba2-7b": zamba2_7b,
}

#: archs of the JAX registry that the port does not serve yet -> the slice
#: that brings them (ROADMAP.md)
UNPORTED: Dict[str, str] = {
    "llama4-scout-17b-a16e": "the MoE slice (ROADMAP A8)",
    "deepseek-v2-lite-16b": "the MoE/MLA slice (ROADMAP A8)",
    "musicgen-large": "the audio/vlm embedding-input slice (ROADMAP A8)",
    "internvl2-2b": "the audio/vlm embedding-input slice (ROADMAP A8)",
}

CONFIGS: Dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKES: Dict[str, ModelConfig] = {k: m.SMOKE for k, m in _MODULES.items()}


def list_archs() -> List[str]:
    return sorted(CONFIGS)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in UNPORTED:
        raise NotImplementedError(f"arch {arch!r} is not ported to "
                                  f"repro_torch yet: {UNPORTED[arch]}")
    table = SMOKES if smoke else CONFIGS
    try:
        return table[arch]
    except KeyError as exc:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}") \
            from exc


__all__ = ["ModelConfig", "ShapeSpec", "CONFIGS", "SMOKES", "UNPORTED",
           "list_archs", "get_config"]
