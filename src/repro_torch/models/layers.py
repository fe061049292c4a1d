"""Model layers of the dense and ssm families: RMSNorm, RoPE, GQA
attention, SwiGLU and the Mamba2 block.

Port of the dense and Mamba2 parts of ``repro.models.layers``
(``layers.py:42-206, 330-343, 461-592``), with the same names and
conventions: parameters are
dictionaries of tensors (``p["wq"]``), weights are in ``cfg.dtype`` and
norm scales in f32, activations keep the JAX layout ((B, S, d), caches
(B, Smax, KV, hd)).  Deviations:

* init functions take an explicit ``torch.Generator`` (its device is the
  device of the weights; ``None`` draws from the default generator, for
  models built on the ``meta`` device) in place of a PRNG key;
* no ``shard`` argument: the model zoo runs on one card (its sharding,
  ``--mesh``, is ROADMAP A7.2b's);
* ``gqa_attention``/``gqa_prefill`` take ``impl`` and hand it to
  :func:`repro_torch.kernels.flash_attention.ops.attention`: ``"auto"``
  runs a CUDA kernel for CUDA tensors (bf16 on the tensor cores, f32 on
  FFMA), ``"plain"`` its plain version;
* ``gqa_decode`` writes the new key/value into the cache in place and
  returns the same cache (JAX builds a new one), and attends over the
  cached positions only (``[pos - window + 1, pos]``, or ``[0, pos]``)
  where JAX masks the whole capacity: the masked positions weigh exactly
  0, so the function is the same.  ``pos`` is a Python int.

* ``mamba2_forward``/``mamba2_prefill`` take ``impl`` and hand it to
  :func:`repro_torch.kernels.ssd_scan.ops.ssd_scan` in the same way;
  ``mamba2_prefill`` left-pads its conv cache with zeros when the prompt
  is shorter than the conv's ``W - 1`` taps (JAX's slice then comes out
  short and its decode fails), copies those taps out of the projections
  (a slice of a torch tensor keeps the whole (B, S, d_inner) projection
  alive: 18 GB over zamba2-7b's 78 layers at 2×8192 tokens), and takes
  the final SSM state from the scan's own launch (``return_final_state``)
  where JAX recomputes it with ``ssd_final_state``.

The projections, the decode attention (an einsum against the cache), the
depthwise causal conv (f32, as in JAX; no cuDNN), the SSD decode step and
everything else here are plain torch, as the JAX package computes them
outside Pallas.  MLA and MoE layers belong to later slices.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.ssd_scan.ops import ssd_decode_step, ssd_scan

Params = Mapping[str, torch.Tensor]


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype a config names (``"bfloat16"``, ``"float32"``, …)."""
    return getattr(torch, name)


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int,
               dtype: torch.dtype, scale: float = 1.0,
               device=None) -> torch.Tensor:
    std = scale / math.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                        device=device) * std).to(dtype)


# ==========================================================================
# RMSNorm
# ==========================================================================

def rmsnorm_init(d: int, device=None) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


# ==========================================================================
# RoPE
# ==========================================================================

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, D) with positions (S,) or (B, S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (D/2,)
    ang = positions[..., None].float() * freqs               # (..., S, D/2)
    # broadcast ang across any head dims between batch and S
    while ang.dim() < x.dim():
        ang = ang.unsqueeze(-3)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ==========================================================================
# GQA attention
# ==========================================================================

def gqa_init(gen: Optional[torch.Generator], cfg: ModelConfig,
             device=None) -> Dict[str, torch.Tensor]:
    dt = dtype_of(cfg.dtype)
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, H * hd, dt, device=device),
        "wk": dense_init(gen, d, KV * hd, dt, device=device),
        "wv": dense_init(gen, d, KV * hd, dt, device=device),
        "wo": dense_init(gen, H * hd, d, dt, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((KV * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((KV * hd,), dtype=dt, device=device)
    return p


def _qkv(p: Params, cfg: ModelConfig, x: torch.Tensor):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
            v.reshape(B, S, KV, hd))


def _attend(p: Params, cfg: ModelConfig, x: torch.Tensor, window: int,
            positions: Optional[torch.Tensor], impl: str):
    """Roped q/k, v as (B, heads, S, hd) views, and the attention output
    (B, S, H·hd) before the output projection."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    pos = positions if positions is not None else torch.arange(
        S, device=x.device)
    qr = apply_rope(q.transpose(1, 2), pos, cfg.rope_theta)   # (B,H,S,hd)
    kr = apply_rope(k.transpose(1, 2), pos, cfg.rope_theta)   # (B,KV,S,hd)
    vr = v.transpose(1, 2)
    o = attention(qr, kr, vr, causal=True, window=window,
                  softcap=cfg.attn_softcap, impl=impl)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    return kr, vr, o


def gqa_attention(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                  window: int = 0, positions: Optional[torch.Tensor] = None,
                  impl: str = "auto") -> torch.Tensor:
    """Full-sequence causal attention (training / prefill)."""
    _, _, o = _attend(p, cfg, x, window, positions, impl)
    return o @ p["wo"]


def gqa_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                window: int = 0, cache_len: int, impl: str = "auto"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: returns output and a right-padded KV cache."""
    B, S, _ = x.shape
    kr, vr, o = _attend(p, cfg, x, window, None, impl)
    cdt = dtype_of(cfg.kv_cache_dtype or cfg.dtype)
    shape = (B, cache_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=cdt, device=x.device),
             "v": torch.zeros(shape, dtype=cdt, device=x.device)}
    cache["k"][:, :S] = kr.transpose(1, 2)
    cache["v"][:, :S] = vr.transpose(1, 2)
    return o @ p["wo"], cache


def gqa_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], pos: int, *,
               window: int = 0
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against a fixed-capacity cache.

    ``x`` (B, 1, d); ``cache["k"/"v"]`` (B, Smax, KV, hd); ``pos`` — the
    index this token writes at (number of tokens already cached).  The
    cache is updated in place.
    """
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(p, cfg, x)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q.transpose(1, 2), posv, cfg.rope_theta)   # (B,H,1,hd)
    k = apply_rope(k.transpose(1, 2), posv, cfg.rope_theta)   # (B,KV,1,hd)
    cache["k"][:, pos] = k[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
    lo = max(0, pos - window + 1) if window > 0 else 0
    group = H // KV
    kk = cache["k"][:, lo:pos + 1].transpose(1, 2).float()   # (B,KV,L,hd)
    vv = cache["v"][:, lo:pos + 1].transpose(1, 2).float()
    qf = q.reshape(B, KV, group, hd).float()
    s = torch.einsum("bkgd,bksd->bkgs", qf, kk) * (hd ** -0.5)
    if cfg.attn_softcap > 0.0:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", pr, vv).reshape(B, 1, H * hd)
    o = o.to(x.dtype)
    return o @ p["wo"], cache


# ==========================================================================
# SwiGLU MLP
# ==========================================================================

def mlp_init(gen: Optional[torch.Generator], d: int, d_ff: int,
             dtype: torch.dtype, device=None) -> Dict[str, torch.Tensor]:
    return {
        "wi": dense_init(gen, d, d_ff, dtype, device=device),       # up
        "wg": dense_init(gen, d, d_ff, dtype, device=device),       # gate
        "wo": dense_init(gen, d_ff, d, dtype, device=device),       # down
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


# ==========================================================================
# Mamba2 block
# ==========================================================================

def mamba2_init(gen: Optional[torch.Generator], cfg: ModelConfig,
                device=None) -> Dict[str, object]:
    """The split projections (z / x / BC / dt) of the JAX package, its conv
    taps, and ``a_log``, ``dt_bias``, ``d_skip`` and the norm in f32."""
    dt = dtype_of(cfg.dtype)
    d, di = cfg.d_model, cfg.d_inner
    g, n, h, W = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_conv_width

    def taps(c):
        return (torch.randn((W, c), generator=gen, dtype=torch.float32,
                            device=device) / math.sqrt(W)).to(dt)
    return {
        "w_z": dense_init(gen, d, di, dt, device=device),
        "w_x": dense_init(gen, d, di, dt, device=device),
        "w_bc": dense_init(gen, d, 2 * g * n, dt, device=device),
        "w_dt": dense_init(gen, d, h, dt, device=device),
        "conv_wx": taps(di),
        "conv_bx": torch.zeros((di,), dtype=dt, device=device),
        "conv_wbc": taps(2 * g * n),
        "conv_bbc": torch.zeros((2 * g * n,), dtype=dt, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=device)),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=device),
        "norm": rmsnorm_init(di, device),
        "w_out": dense_init(gen, di, d, dt, device=device),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with taps (W, C), in f32."""
    W, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    wf = w.float()
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(W):
        out += pad[:, i:i + S, :].float() * wf[i]
    return (out + b.float()).to(xbc.dtype)


def _mamba_proj(p: Params, x: torch.Tensor):
    return x @ p["w_z"], x @ p["w_x"], x @ p["w_bc"], x @ p["w_dt"]


def _mamba_mix(p: Params, cfg: ModelConfig, x: torch.Tensor, impl: str,
               final_state: bool):
    """The full-sequence Mamba2 mixer: (output, projections, SSD inputs and
    the final SSM state when ``final_state``)."""
    B, S, _ = x.shape
    di, gn, h, hp = (cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state,
                     cfg.ssm_heads, cfg.ssm_head_dim)
    z, xr, bc, dtr = _mamba_proj(p, x)
    xc = F.silu(_causal_conv(xr, p["conv_wx"], p["conv_bx"]))
    bcc = F.silu(_causal_conv(bc, p["conv_wbc"], p["conv_bbc"]))
    xs = xc.reshape(B, S, h, hp)
    Bm, Cm = bcc[..., :gn], bcc[..., gn:]         # read in place by strides
    dt = F.softplus(dtr.float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    y = ssd_scan(xs, dt, A, Bm, Cm, chunk=min(cfg.ssm_chunk, S), impl=impl,
                 return_final_state=final_state)
    y, hfin = y if final_state else (y, None)
    y = y + xs * p["d_skip"][None, None, :, None].to(xs.dtype)
    y = y.reshape(B, S, di) * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.rms_eps)
    return y @ p["w_out"], xr, bc, hfin


def mamba2_forward(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                   impl: str = "auto") -> torch.Tensor:
    return _mamba_mix(p, cfg, x, impl, final_state=False)[0]


def _conv_tail(t: torch.Tensor, W: int) -> torch.Tensor:
    """The last ``W - 1`` positions of (B, S, C), zero-padded on the left
    when S is shorter: a copy, so that the cache does not keep all of
    ``t`` alive."""
    if t.shape[1] < W - 1:
        t = F.pad(t, (0, 0, W - 1 - t.shape[1], 0))
    return t[:, t.shape[1] - (W - 1):, :].clone()


def mamba2_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                   impl: str = "auto"
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward that also returns the decode cache."""
    out, xr, bc, hfin = _mamba_mix(p, cfg, x, impl, final_state=True)
    W = cfg.ssm_conv_width
    return out, {"conv_x": _conv_tail(xr, W), "conv_bc": _conv_tail(bc, W),
                 "ssm": hfin}


def mamba2_init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                      device=None) -> Dict[str, torch.Tensor]:
    W = cfg.ssm_conv_width
    gn = cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv_x": torch.zeros((batch, W - 1, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros((batch, W - 1, 2 * gn), dtype=dtype,
                               device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                            cfg.ssm_head_dim), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """O(1) decode step: x (B, 1, d) → (output, new cache)."""
    B = x.shape[0]
    di, gn, h, hp = (cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state,
                     cfg.ssm_heads, cfg.ssm_head_dim)
    z, xr, bc, dtr = _mamba_proj(p, x)
    hist_x = torch.cat([cache["conv_x"], xr], dim=1)          # (B, W, di)
    hist_bc = torch.cat([cache["conv_bc"], bc], dim=1)
    conv_x = (hist_x.float() * p["conv_wx"].float()).sum(1) \
        + p["conv_bx"].float()
    conv_bc = (hist_bc.float() * p["conv_wbc"].float()).sum(1) \
        + p["conv_bbc"].float()
    xt = F.silu(conv_x).to(x.dtype).reshape(B, h, hp)
    bcc = F.silu(conv_bc).to(x.dtype)
    Bt, Ct = bcc[:, :gn], bcc[:, gn:]
    dt = F.softplus(dtr[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    y, hnew = ssd_decode_step(cache["ssm"], xt, dt, A, Bt, Ct)
    y = y + xt * p["d_skip"][None, :, None].to(xt.dtype)
    y = y.reshape(B, 1, di) * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.rms_eps)
    return y @ p["w_out"], {"conv_x": hist_x[:, 1:], "conv_bc": hist_bc[:, 1:],
                            "ssm": hnew}
