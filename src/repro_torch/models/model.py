"""Decoder LM of the dense family (gemma2, qwen2, qwen2.5, minitron).

Port of the dense path of ``repro.models.model`` (``model.py:60-192,
234-290, 312-451``).  The weights live in :class:`DenseLM`, an
``nn.Module`` whose parameter names mirror the JAX tree (``embed.w``,
``blocks.<layer>.attn.wq``, ``final_norm.scale``, ``lm_head.w``); the
module-level functions keep the JAX names and signatures and call its
methods, with the module in the place of the JAX ``params`` tree:

* :func:`forward`      — full sequence → logits (B, S, vocab) in f32
* :func:`prefill`      — full sequence → (last-position logits, KV cache)
* :func:`decode_step`  — one token + cache → (logits, cache)

Deviations from the JAX module:

* ``jax.lax.scan`` over groups of ``group_size`` layers becomes a Python
  loop over the layers; layer ``l`` takes the window of sub-layer
  ``l % group_size`` (gemma2: even layers local, odd layers global), as
  the scan does;
* the cache is ``{"blocks": [{"k", "v"} per layer], "pos": int}`` (JAX
  stacks it as (G, group_size, …)); :func:`decode_step` updates its
  tensors in place and returns them under a new dict with ``pos + 1`` —
  the cache handed in must not be used again;
* ``unembed`` multiplies in the weights' dtype and casts the logits to
  f32 (JAX asks its dot for an f32 result), so bf16 logits are rounded to
  bf16 before the final soft-cap;
* no ``shard`` argument, remat policy or ``loss_fn``/``param_shapes``/
  ``cache_spec`` (training and the dry-run are later slices);
* :attr:`DenseLM.attn_impl` (``"auto"``) is handed to every prefill
  attention: ``"plain"`` runs the model with the kernel's plain version.

MLA, MoE (and ``first_dense_layers``), the ssm and hybrid families and
embedding inputs (audio, vlm) raise ``NotImplementedError`` naming the
slice that ports them (``ROADMAP.md``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import dtype_of

Cache = Dict[str, object]


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family (Mamba2 layers) comes with "
            f"the SSD-scan slice (ROADMAP B3)")
    if cfg.family == "moe" or cfg.n_experts or cfg.first_dense_layers:
        raise NotImplementedError(f"{cfg.name}: MoE blocks come with the MoE "
                                  f"slice (ROADMAP A8)")
    if cfg.use_mla:
        raise NotImplementedError(f"{cfg.name}: MLA attention comes with the "
                                  f"MoE/MLA slice (ROADMAP A8)")
    if cfg.family != "dense" or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.family} embedding inputs come with the "
            f"audio/vlm slice (ROADMAP A8)")


# ==========================================================================
# Block = attention + mlp, pre-norm residual
# ==========================================================================

def _params(tensors: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


def _attn_block_init(gen: Optional[torch.Generator], cfg: ModelConfig,
                     device) -> nn.ModuleDict:
    d = cfg.d_model
    p = {"ln1": _params(L.rmsnorm_init(d, device)),
         "ln2": _params(L.rmsnorm_init(d, device)),
         "attn": _params(L.gqa_init(gen, cfg, device)),
         "mlp": _params(L.mlp_init(gen, d, cfg.d_ff, dtype_of(cfg.dtype),
                                   device))}
    if cfg.post_block_norm:
        p["post_ln1"] = _params(L.rmsnorm_init(d, device))
        p["post_ln2"] = _params(L.rmsnorm_init(d, device))
    return nn.ModuleDict(p)


def _attn_block(p, cfg: ModelConfig, x: torch.Tensor, *, window: int,
                mode: str, cache=None, pos: Optional[int] = None,
                impl: str = "auto"):
    """mode ∈ {train, prefill, decode}; returns (x, new_cache_or_None).
    In prefill mode ``cache`` is the cache length, as in JAX."""
    h = L.rmsnorm(p["ln1"], x, cfg.rms_eps)
    new_cache = None
    if mode == "train":
        a = L.gqa_attention(p["attn"], cfg, h, window=window, impl=impl)
    elif mode == "prefill":
        a, new_cache = L.gqa_prefill(p["attn"], cfg, h, window=window,
                                     cache_len=cache, impl=impl)
    else:
        a, new_cache = L.gqa_decode(p["attn"], cfg, h, cache, pos,
                                    window=window)
    if cfg.post_block_norm:
        a = L.rmsnorm(p["post_ln1"], a, cfg.rms_eps)
    x = x + a
    h = L.rmsnorm(p["ln2"], x, cfg.rms_eps)
    m = L.mlp(p["mlp"], h)
    if cfg.post_block_norm:
        m = L.rmsnorm(p["post_ln2"], m, cfg.rms_eps)
    return x + m, new_cache


# ==========================================================================
# Group structure (what one JAX scan step covers)
# ==========================================================================

def group_size(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.mamba_per_group
    if cfg.local_global_period:
        return cfg.local_global_period
    return 1


def n_scan_groups(cfg: ModelConfig) -> int:
    n = cfg.n_layers - cfg.first_dense_layers
    g = group_size(cfg)
    if n % g:
        raise ValueError(f"{cfg.name}: {n} layers not divisible by "
                         f"group size {g}")
    return n // g


def _window_for(cfg: ModelConfig, idx_in_group: int) -> int:
    """Static sliding-window size for sub-layer ``idx_in_group``."""
    if cfg.local_global_period and idx_in_group % 2 == 0:
        return cfg.attn_window
    return cfg.attn_window if not cfg.local_global_period else 0


# ==========================================================================
# The module
# ==========================================================================

class DenseLM(nn.Module):
    """The weights of a dense-family LM and its three entry points.

    ``gen`` draws the random weights on ``device`` (``None`` with
    ``device="meta"`` builds shapes only: :func:`count_params`,
    :func:`repro_torch.weights.model_from_numpy`)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device):
        super().__init__()
        _check_dense(cfg)
        n_scan_groups(cfg)
        self.cfg = cfg
        self.attn_impl = "auto"
        dt = dtype_of(cfg.dtype)
        d, V = cfg.d_model, cfg.vocab_size
        self.embed = _params({"w": (torch.randn(
            (V, d), generator=gen, dtype=torch.float32, device=device)
            * (d ** -0.5)).to(dt)})
        self.blocks = nn.ModuleList([_attn_block_init(gen, cfg, device)
                                     for _ in range(cfg.n_layers)])
        self.final_norm = _params(L.rmsnorm_init(d, device))
        if not cfg.tie_embeddings:
            self.lm_head = _params({"w": L.dense_init(gen, d, V, dt,
                                                      device=device)})

    def _layers(self):
        gsz = group_size(self.cfg)
        for i, blk in enumerate(self.blocks):
            yield blk, _window_for(self.cfg, i % gsz)

    def embed_in(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed["w"][tokens]
        if self.cfg.scale_embeddings:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype)
        return x.to(dtype_of(self.cfg.dtype))

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = L.rmsnorm(self.final_norm, x, cfg.rms_eps)
        if cfg.tie_embeddings:
            logits = F.linear(x, self.embed["w"]).float()
        else:
            logits = (x @ self.lm_head["w"]).float()
        if cfg.logit_softcap > 0.0:
            logits = cfg.logit_softcap * torch.tanh(
                logits / cfg.logit_softcap)
        return logits

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed_in(tokens)
        for blk, window in self._layers():
            x, _ = _attn_block(blk, self.cfg, x, window=window, mode="train",
                               impl=self.attn_impl)
        return self.unembed(x)

    def prefill(self, tokens: torch.Tensor,
                cache_len: int) -> Tuple[torch.Tensor, Cache]:
        x = self.embed_in(tokens)
        blocks: List[Dict[str, torch.Tensor]] = []
        for blk, window in self._layers():
            x, c = _attn_block(blk, self.cfg, x, window=window,
                               mode="prefill", cache=cache_len,
                               impl=self.attn_impl)
            blocks.append(c)
        logits = self.unembed(x[:, -1:, :])
        return logits, {"blocks": blocks, "pos": tokens.shape[1]}

    def decode_step(self, cache: Cache,
                    token: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        x = self.embed_in(token)
        pos = cache["pos"]
        for (blk, window), c in zip(self._layers(), cache["blocks"]):
            x, _ = _attn_block(blk, self.cfg, x, window=window,
                               mode="decode", cache=c, pos=pos)
        return self.unembed(x), {"blocks": cache["blocks"], "pos": pos + 1}


# ==========================================================================
# init / count
# ==========================================================================

def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: DeviceLike = "cuda") -> DenseLM:
    """Random weights from ``seed`` on ``device`` (a ``torch.Generator`` on
    that device; the numbers differ from JAX's for the same seed)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return DenseLM(cfg, gen, dev)


def count_params(cfg: ModelConfig) -> int:
    return sum(p.numel() for p in DenseLM(cfg, None, "meta").parameters())


# ==========================================================================
# forward / serving, with the JAX signatures
# ==========================================================================

def _module(cfg: ModelConfig, params: DenseLM) -> DenseLM:
    if params.cfg != cfg:
        raise ValueError(f"model built for {params.cfg.name} called with "
                         f"config {cfg.name}")
    return params


def _tokens(batch: Dict, *keys: str) -> torch.Tensor:
    for k in keys:
        if k in batch:
            return batch[k]
    raise NotImplementedError(f"batch {sorted(batch)}: embedding inputs come "
                              f"with the audio/vlm slice (ROADMAP A8)")


def embed_in(cfg: ModelConfig, params: DenseLM, batch: Dict) -> torch.Tensor:
    return _module(cfg, params).embed_in(_tokens(batch, "tokens", "token"))


def unembed(cfg: ModelConfig, params: DenseLM,
            x: torch.Tensor) -> torch.Tensor:
    return _module(cfg, params).unembed(x)


def forward(cfg: ModelConfig, params: DenseLM, batch: Dict) -> torch.Tensor:
    """Full-sequence forward → logits (B, S, vocab) in f32."""
    return _module(cfg, params)(_tokens(batch, "tokens"))


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: DeviceLike = "cuda") -> Cache:
    """Fixed-capacity decode cache, all-zero, position 0."""
    _check_dense(cfg)
    dev = resolve_device(device)
    dt = dtype_of(cfg.kv_cache_dtype or cfg.dtype)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"blocks": [{"k": torch.zeros(shape, dtype=dt, device=dev),
                        "v": torch.zeros(shape, dtype=dt, device=dev)}
                       for _ in range(cfg.n_layers)],
            "pos": 0}


def prefill(cfg: ModelConfig, params: DenseLM, batch: Dict,
            cache_len: int) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence prefill → (last-position logits, primed cache)."""
    return _module(cfg, params).prefill(_tokens(batch, "tokens"), cache_len)


def decode_step(cfg: ModelConfig, params: DenseLM, cache: Cache,
                batch: Dict) -> Tuple[torch.Tensor, Cache]:
    """One decode step: batch holds "token" (B, 1)."""
    return _module(cfg, params).decode_step(cache, _tokens(batch, "token"))


__all__ = ["DenseLM", "count_params", "decode_step", "embed_in",
           "forward", "group_size", "init_cache", "init_params",
           "n_scan_groups", "prefill", "unembed"]
