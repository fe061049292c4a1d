"""zamba2-7b — hybrid Mamba2 stack + shared attention blocks.

[arXiv:2411.15242; unverified]  81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64.  Structure here: 13 groups of 6 Mamba2 layers,
each group followed by one application of a *shared* attention+MLP block
(two alternating shared weight sets, as in the paper) — 78 Mamba layers +
13 shared-block applications ≈ the 81-block stack (the exact interleave
offsets differ from the HF release; see DESIGN.md §Arch-applicability).
d_inner = 7168, ssm head_dim 64 → 112 SSD heads.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=78,                 # mamba layers (13 groups × 6)
    d_model=3_584,
    vocab_size=32_000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14_336,                 # shared block MLP hidden
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    ssm_conv_width=4,
    ssm_chunk=128,
    mamba_per_group=6,
    n_shared_blocks=2,
)

SMOKE = dataclasses.replace(
    CONFIG, name="zamba2-smoke", n_layers=4, d_model=64, vocab_size=128,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, ssm_state=16,
    ssm_head_dim=32, ssm_chunk=16, mamba_per_group=2, n_shared_blocks=2)
