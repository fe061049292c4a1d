"""Architecture + shape configuration system of the port.

A plain copy of ``repro.configs.base``'s dataclasses (the port imports
nothing of ``repro``): :class:`ModelConfig` and :class:`ShapeSpec`.  Left
out: ``input_specs``, ``SHAPES`` and ``supports_shape`` (the dry-run's
shape cells; the port has no dry-run yet) and ``active_param_count`` (MoE
only; the port serves the dense family).

Families:
  dense   — GQA transformer (qwen2.5/qwen2/gemma2/minitron) — ported
  moe     — mixture-of-experts transformer (llama4-scout, deepseek-v2-lite)
  ssm     — attention-free Mamba2/SSD stack (mamba2-130m)
  hybrid  — Mamba2 + shared attention blocks (zamba2-7b)
  audio   — decoder-only LM over EnCodec frames (musicgen-large)
  vlm     — ViT+LM (internvl2-2b)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    vocab_size: int
    # -- attention ---------------------------------------------------------
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_window: int = 0           # sliding-window size (0 = full)
    local_global_period: int = 0   # gemma2: every even layer is windowed
    attn_softcap: float = 0.0      # gemma2 attention-logit soft cap
    logit_softcap: float = 0.0     # gemma2 final-logit soft cap
    post_block_norm: bool = False  # gemma2 post-attn/post-mlp RMSNorms
    # -- MLA (deepseek) ----------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # -- MLP / MoE ---------------------------------------------------------
    d_ff: int = 0                  # dense MLP hidden size
    n_experts: int = 0             # routed experts (0 = dense MLP)
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0    # deepseek: layer 0 stays dense
    moe_capacity_factor: float = 1.25
    # -- SSM (mamba2) ------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    # -- hybrid (zamba2) ---------------------------------------------------
    mamba_per_group: int = 0       # mamba layers between shared-attn blocks
    n_shared_blocks: int = 0       # alternating shared attention weight sets
    # -- io / numerics -----------------------------------------------------
    input_mode: str = "tokens"     # tokens | embeddings
    tie_embeddings: bool = False
    scale_embeddings: bool = False # gemma2: x *= sqrt(d_model)
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"
    kv_cache_dtype: str = ""       # "" = model dtype; "float8_e4m3fn" halves
                                   # decode cache traffic (§Perf, beyond-paper)
    # -- remat policy (perf knob, see EXPERIMENTS.md §Perf) -----------------
    remat: str = "dots_saveable"   # none | full | dots_saveable

    # -- derived -----------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_dim(self) -> int:
        if self.use_mla:
            return self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.n_heads * self.head_dim

    @property
    def has_attention(self) -> bool:
        return self.family not in ("ssm",)

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch decode at 500k context without a quadratic prefill
        or an unbounded per-layer KV cache?  SSM and hybrid families only."""
        return self.family in ("ssm", "hybrid")

    @property
    def n_param_layers(self) -> int:
        """Number of distinct weight-bearing blocks (scan length)."""
        return self.n_layers

    def param_count(self) -> int:
        """Exact parameter count (used for MODEL_FLOPS = 6·N·D)."""
        from repro_torch.models.model import count_params
        return count_params(self)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch

