"""AdamW from scratch (decoupled weight decay).

Port of ``repro.optim.adamw``.  Mixed precision: model params may be bf16;
the optimizer keeps float32 master copies plus float32 first/second
moments.  Update math runs in f32.

State layout (a dict mirroring the params at every leaf):
    {"step": int32 0-d tensor, "master": f32 params, "m": f32, "v": f32}

The port's params are dicts of tensors by the model's dotted names
(``blocks.3.attn.wq``, ``final_norm.scale``: :class:`~repro_torch.models.
model.DenseLM`'s ``named_parameters``), which mirror the JAX tree's paths,
so :func:`_decayable` reads the last part of a name as JAX reads the last
key of a path.

Deviations:

* :func:`apply` updates ``state`` **in place**, one leaf at a time — the
  step counter, each master copy and both moments — and returns the same
  tensors.  This is the counterpart of the JAX trainer's
  ``donate_argnums=(0,)`` (``src/repro/runtime/trainer.py:226-236``): at
  gemma2-2b's full width the f32 master, m and v take 31.4 GB, and a second
  copy of them would not fit on the card beside the model.  The caller
  must not read the old state after the call.  A leaf's temporaries (its
  gradient in f32 and the update) live only while that leaf is updated;
* :class:`AdamWConfig` has no ``compression`` field: the JAX optimizer
  never reads it, and :mod:`repro_torch.optim.compression` is called
  directly where gradients would cross a mesh (ROADMAP A7.2b);
* :func:`params_from_state` copies the master params into the model's
  tensors in place (``like``: a module or a dict of tensors) and returns
  them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0           # global-norm clip; 0 disables


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init(params) -> Dict:
    """Fresh state on the params' device: f32 master copies, zero moments,
    step 0.  ``params``: a module or a dict of tensors by name."""
    named = _named(params)
    device = next(iter(named.values())).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "master": {n: p.detach().to(torch.float32, copy=True)
                   for n, p in named.items()},
        "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in named.items()},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in named.items()},
    }


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    total = None
    for leaf in tree.values():
        f = leaf.to(torch.float32).reshape(-1)
        sq = torch.dot(f, f)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """(grads in f32 scaled to at most ``max_norm`` in global norm, the
    norm before scaling)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g.to(torch.float32) * scale for n, g in grads.items()}, norm


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def _decayable(name: str) -> bool:
    """No weight decay on norms/scales/biases/1-d leaves."""
    return name.split(".")[-1] not in ("scale", "bq", "bk", "bv", "a_log",
                                       "dt_bias", "d_skip", "conv_bx",
                                       "conv_bbc")


def apply(state: Dict, grads: Mapping[str, torch.Tensor], cfg: AdamWConfig,
          lr_scale: torch.Tensor | float = 1.0) -> Tuple[Dict, Dict, Dict]:
    """One AdamW step, in place.  Returns (state, its master params,
    metrics) — the same tensors as ``state`` holds."""
    if cfg.grad_clip > 0:
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, cfg.grad_clip)
    else:
        gnorm, scale = global_norm(grads), None

    state["step"].add_(1)
    step = state["step"].to(torch.float32)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
    lr = cfg.lr * lr_scale

    for name, grad in grads.items():
        g = grad.to(torch.float32)
        g = g * scale if scale is not None else g
        m, v, master = state["m"][name], state["v"][name], \
            state["master"][name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_(g.square().mul_(1 - b2))
        del g
        delta = torch.div(m, bc1)
        delta.div_(torch.div(v, bc2).sqrt_().add_(cfg.eps))
        if cfg.weight_decay and _decayable(name):
            delta.add_(cfg.weight_decay * master)
        master.sub_(lr * delta)
    metrics = {"grad_norm": gnorm,
               "lr": torch.as_tensor(lr, dtype=torch.float32)}
    return state, state["master"], metrics


def params_from_state(state: Dict, like):
    """Copy the master params into ``like``'s tensors (a module or a dict
    of tensors by name), each cast to its own dtype; returns ``like``."""
    named = _named(like)
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(state["master"][name])
    return like
