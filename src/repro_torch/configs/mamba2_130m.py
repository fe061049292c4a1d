"""mamba2-130m — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  24L d_model=768 d_ff=0 vocab=50280,
ssm_state=128.  d_inner = 2·768 = 1536, head_dim 64 → 24 SSD heads.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    vocab_size=50_280,
    d_ff=0,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    ssm_conv_width=4,
    ssm_chunk=128,
    tie_embeddings=True,
    rope_theta=0.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-smoke", n_layers=2, d_model=64, vocab_size=128,
    ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
