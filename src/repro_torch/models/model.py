"""Decoder LM of the dense family (gemma2, qwen2, qwen2.5, minitron), the
ssm family (mamba2) and the hybrid family (zamba2).

Port of the dense, ssm and hybrid paths of ``repro.models.model``
(``model.py:60-192, 234-290, 312-451``).  The weights live in
:class:`DenseLM` (dense as in ``--dense-oracle``: one card, no sharding),
an ``nn.Module`` whose parameter names mirror the JAX tree (``embed.w``,
``blocks.<layer>.attn.wq``, ``blocks.<layer>.mix.norm.scale``,
``shared.<s>.attn.wq``, ``final_norm.scale``, ``lm_head.w``); the
module-level functions keep the JAX names and signatures and call its
methods, with the module in the place of the JAX ``params`` tree:

* :func:`forward`      — full sequence → logits (B, S, vocab) in f32
* :func:`prefill`      — full sequence → (last-position logits, KV cache)
* :func:`decode_step`  — one token + cache → (logits, cache)

Deviations from the JAX module:

* ``jax.lax.scan`` over groups of ``group_size`` layers becomes a Python
  loop over the layers; layer ``l`` takes the window of sub-layer
  ``l % group_size`` (gemma2: even layers local, odd layers global), as
  the scan does.  The hybrid family's layers are its Mamba2 blocks
  (``blocks``, layer ``g·mamba_per_group + i``); after group ``g`` comes
  the shared attention block ``shared[g % n_shared_blocks]``
  (``_select_shared``), window 0, as in JAX;
* the cache is ``{"blocks": [per layer], "pos": int}`` (JAX stacks it as
  (G, group_size, …)); a layer's entry is ``{"k", "v"}`` (dense) or
  ``{"conv_x", "conv_bc", "ssm"}`` (ssm).  The hybrid cache is
  ``{"blocks": [per group {"mamba": [group_size Mamba entries], "attn":
  {"k", "v"}}], "pos": int}`` (JAX stacks the same tree as
  (G, group_size, …) / (G, …)).  :func:`decode_step` updates
  the dense tensors in place and returns them under a new dict with
  ``pos + 1`` — the cache handed in must not be used again;
* ``unembed`` gives f32 logits of the bf16 product, as JAX's dot with
  ``preferred_element_type=float32`` does: on the card one
  ``torch.mm(…, out_dtype=torch.float32)`` (f32 accumulation, no bf16
  rounding of the logits), on the CPU — where ``aten::mm.dtype`` has no
  kernel — the same product taken in f32.  ``aten::mm.dtype`` has no
  derivative, so on the card the product is :class:`_F32Logits`, whose
  backward takes the f32 logit gradient as three bf16 terms (their sum is
  the f32 value to ~2^-24) through the same bf16 product with f32
  outputs: the gradient JAX's dot gives (f32 products of the f32
  cotangent and the bf16 operand, cast to the operand's dtype) at the
  tensor cores' bf16 rate.  On the CPU autograd differentiates the f32
  product;
* no ``shard`` argument and no ``cache_spec`` (the dry-run slice);
* no remat policy (``cfg.remat``): the backward keeps what autograd saves.
  gemma2-2b at batch 8 × 128 tokens needs no recomputation on an 80 GB
  card;
* :func:`param_shapes` gives the parameters as ``meta`` tensors by their
  dotted names (JAX: a ``ShapeDtypeStruct`` tree);
* :attr:`DenseLM.attn_impl` and :attr:`DenseLM.ssd_impl` (``"auto"``)
  are handed to every prefill attention and every SSD scan: ``"plain"``
  runs the model with that kernel's plain version.

MLA, MoE (and ``first_dense_layers``) and embedding inputs (audio, vlm)
raise ``NotImplementedError`` naming the slice that ports them
(``ROADMAP.md``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import dtype_of

Cache = Dict[str, object]


def _bf16_terms(x: torch.Tensor) -> List[torch.Tensor]:
    """f32 ``x`` as three bf16 terms, largest first, each the rounding of
    what the earlier ones leave: they sum to ``x`` within ~2^-24 of it."""
    terms, rest = [], x
    for _ in range(3):
        terms.append(rest.to(torch.bfloat16))
        rest = rest - terms[-1].float()
    return terms


class _F32Logits(torch.autograd.Function):
    """``x2 @ w`` as f32 on the card (``torch.mm(…, out_dtype=float32)``),
    with its gradient.  For bf16 operands the f32 cotangent goes through
    the same product as three bf16 terms, summed in f32, smallest first;
    the gradients are cast to the operands' dtypes."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.float()
        terms = [g] if x2.dtype == torch.float32 else _bf16_terms(g)[::-1]

        def summed(pairs):
            out = None
            for a, b in pairs:
                part = torch.mm(a, b, out_dtype=torch.float32)
                out = part if out is None else out.add_(part)
            return out

        dx = summed((t, w.t()) for t in terms).to(x2.dtype) \
            if ctx.needs_input_grad[0] else None
        dw = summed((x2.t(), t) for t in terms).to(w.dtype) \
            if ctx.needs_input_grad[1] else None
        return dx, dw


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family == "moe" or cfg.n_experts or cfg.first_dense_layers:
        raise NotImplementedError(f"{cfg.name}: MoE blocks come with the MoE "
                                  f"slice (ROADMAP A8)")
    if cfg.use_mla:
        raise NotImplementedError(f"{cfg.name}: MLA attention comes with the "
                                  f"MoE/MLA slice (ROADMAP A8)")
    if cfg.family not in ("dense", "ssm", "hybrid") \
            or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.family} embedding inputs come with the "
            f"audio/vlm slice (ROADMAP A8)")


# ==========================================================================
# Block = (attention + mlp) | mamba, pre-norm residual
# ==========================================================================

class ParamTree(nn.Module):
    """A nested dict of tensors as a module: ``p["w_z"]`` is a parameter,
    ``p["norm"]`` a subtree, and the parameter names follow the keys
    (``mix.norm.scale``)."""

    def __init__(self, tree: Mapping[str, object]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)


def _attn_block_init(gen: Optional[torch.Generator], cfg: ModelConfig,
                     device) -> ParamTree:
    d = cfg.d_model
    p = {"ln1": L.rmsnorm_init(d, device), "ln2": L.rmsnorm_init(d, device),
         "attn": L.gqa_init(gen, cfg, device),
         "mlp": L.mlp_init(gen, d, cfg.d_ff, dtype_of(cfg.dtype), device)}
    if cfg.post_block_norm:
        p["post_ln1"] = L.rmsnorm_init(d, device)
        p["post_ln2"] = L.rmsnorm_init(d, device)
    return ParamTree(p)


def _mamba_block_init(gen: Optional[torch.Generator], cfg: ModelConfig,
                      device) -> ParamTree:
    return ParamTree({"ln": L.rmsnorm_init(cfg.d_model, device),
                      "mix": L.mamba2_init(gen, cfg, device)})


def _mamba_block(p, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
                 cache=None, impl: str = "auto"):
    h = L.rmsnorm(p["ln"], x, cfg.rms_eps)
    if mode == "train":
        return x + L.mamba2_forward(p["mix"], cfg, h, impl=impl), None
    if mode == "prefill":
        y, c = L.mamba2_prefill(p["mix"], cfg, h, impl=impl)
    else:
        y, c = L.mamba2_decode(p["mix"], cfg, h, cache)
    return x + y, c


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
    """The weights of a dense-, ssm- or hybrid-family LM and its three
    entry points.

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
        self.ssd_impl = "auto"
        dt = dtype_of(cfg.dtype)
        d, V = cfg.d_model, cfg.vocab_size
        self.embed = ParamTree({"w": (torch.randn(
            (V, d), generator=gen, dtype=torch.float32, device=device)
            * (d ** -0.5)).to(dt)})
        block_init = _attn_block_init if cfg.family == "dense" \
            else _mamba_block_init
        self.blocks = nn.ModuleList([block_init(gen, cfg, device)
                                     for _ in range(cfg.n_layers)])
        if cfg.family == "hybrid":
            self.shared = nn.ModuleList([
                _attn_block_init(gen, cfg, device)
                for _ in range(cfg.n_shared_blocks)])
        self.final_norm = ParamTree(L.rmsnorm_init(d, device))
        if not cfg.tie_embeddings:
            self.lm_head = ParamTree({"w": L.dense_init(gen, d, V, dt,
                                                        device=device)})

    def _block(self, i: int, x: torch.Tensor, mode: str, cache=None,
               pos: Optional[int] = None):
        """Layer ``i`` in ``mode``; ``cache`` is the cache length in prefill
        mode, as in JAX.  Returns (x, new_cache_or_None)."""
        cfg, blk = self.cfg, self.blocks[i]
        if cfg.family != "dense":
            return _mamba_block(blk, cfg, x, mode=mode, cache=cache,
                                impl=self.ssd_impl)
        return _attn_block(blk, cfg, x,
                           window=_window_for(cfg, i % group_size(cfg)),
                           mode=mode, cache=cache, pos=pos,
                           impl=self.attn_impl)

    def _select_shared(self, g: int) -> ParamTree:
        return self.shared[g % self.cfg.n_shared_blocks]

    def _layers(self, x: torch.Tensor, mode: str, cache=None,
                pos: Optional[int] = None):
        """Every layer in ``mode``, in order, and after each group of the
        hybrid family its shared attention block: (x, the cache's
        ``blocks``).  ``cache`` is the cache length in prefill mode and the
        ``blocks`` of the cache in decode mode."""
        cfg = self.cfg
        gsz, hybrid = group_size(cfg), cfg.family == "hybrid"
        decode = mode == "decode"
        blocks: List[object] = []
        for g in range(n_scan_groups(cfg)):
            entry = cache[g] if decode and hybrid else None
            group = []
            for j in range(gsz):
                i = g * gsz + j
                if entry is not None:
                    c = entry["mamba"][j]
                else:
                    c = cache[i] if decode else cache
                x, nc = self._block(i, x, mode, cache=c, pos=pos)
                group.append(nc)
            if not hybrid:
                blocks += group
                continue
            x, ac = _attn_block(self._select_shared(g), cfg, x, window=0,
                                mode=mode,
                                cache=entry["attn"] if entry else cache,
                                pos=pos, impl=self.attn_impl)
            blocks.append({"mamba": group, "attn": ac})
        return x, blocks

    def embed_in(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed["w"][tokens]
        if self.cfg.scale_embeddings:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype)
        return x.to(dtype_of(self.cfg.dtype))

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        return self.logits(L.rmsnorm(self.final_norm, x, self.cfg.rms_eps))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits of the final-normed ``x``: the unembedding product,
        then the soft-cap."""
        cfg = self.cfg
        w = self.embed["w"].t() if cfg.tie_embeddings else self.lm_head["w"]
        x2 = x.reshape(-1, x.shape[-1])
        if x.device.type == "cuda":
            logits = _F32Logits.apply(x2, w)
        else:
            logits = x2.float() @ w.float()
        logits = logits.reshape(*x.shape[:-1], w.shape[1])
        if cfg.logit_softcap > 0.0:
            logits = cfg.logit_softcap * torch.tanh(
                logits / cfg.logit_softcap)
        return logits

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x, _ = self._layers(self.embed_in(tokens), "train")
        return self.unembed(x)

    def prefill(self, tokens: torch.Tensor,
                cache_len: int) -> Tuple[torch.Tensor, Cache]:
        x, blocks = self._layers(self.embed_in(tokens), "prefill",
                                 cache=cache_len)
        logits = self.unembed(x[:, -1:, :])
        return logits, {"blocks": blocks, "pos": tokens.shape[1]}

    def decode_step(self, cache: Cache,
                    token: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        pos = cache["pos"]
        x, blocks = self._layers(self.embed_in(token), "decode",
                                 cache=cache["blocks"], pos=pos)
        return self.unembed(x), {"blocks": blocks, "pos": pos + 1}


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


def param_shapes(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The parameters as ``meta`` tensors (shape and dtype, no storage) by
    their dotted names."""
    return dict(DenseLM(cfg, None, "meta").named_parameters())


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of ``cfg``; ``active_only`` counts only the routed
    experts a token uses.  The ported families route no experts (MoE
    raises in :class:`DenseLM`), so both counts are the total."""
    del active_only
    return sum(p.numel() for p in param_shapes(cfg).values())


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


def loss_fn(cfg: ModelConfig, params: DenseLM,
            batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token NLL plus 1e-4 of the mean squared log-normalizer
    (the z-loss, which keeps the softmax normalizer bounded in bf16), and
    the metrics ``nll``, ``zloss`` and ``accuracy``."""
    logits = forward(cfg, params, batch)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (logz - gold).mean()
    zloss = 1e-4 * logz.square().mean()
    accuracy = (logits.argmax(-1) == labels).float().mean()
    return nll + zloss, {"nll": nll, "zloss": zloss, "accuracy": accuracy}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: DeviceLike = "cuda") -> Cache:
    """Fixed-capacity decode cache, all-zero, position 0."""
    _check_dense(cfg)
    dev = resolve_device(device)
    dt = dtype_of(cfg.kv_cache_dtype or cfg.dtype)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)

    def attn():
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    if cfg.family == "ssm":
        return {"blocks": [L.mamba2_init_cache(cfg, batch, dt, dev)
                           for _ in range(cfg.n_layers)], "pos": 0}
    if cfg.family == "hybrid":
        return {"blocks": [{"mamba": [L.mamba2_init_cache(cfg, batch, dt, dev)
                                      for _ in range(group_size(cfg))],
                            "attn": attn()}
                           for _ in range(n_scan_groups(cfg))], "pos": 0}
    return {"blocks": [attn() for _ in range(cfg.n_layers)], "pos": 0}


def prefill(cfg: ModelConfig, params: DenseLM, batch: Dict,
            cache_len: int) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence prefill → (last-position logits, primed cache)."""
    return _module(cfg, params).prefill(_tokens(batch, "tokens"), cache_len)


def decode_step(cfg: ModelConfig, params: DenseLM, cache: Cache,
                batch: Dict) -> Tuple[torch.Tensor, Cache]:
    """One decode step: batch holds "token" (B, 1)."""
    return _module(cfg, params).decode_step(cache, _tokens(batch, "token"))


__all__ = ["DenseLM", "count_params", "decode_step", "embed_in",
           "forward", "group_size", "init_cache", "init_params", "loss_fn",
           "n_scan_groups", "param_shapes", "prefill", "unembed"]
