"""qwen2-7b — dense GQA transformer with QKV bias.

[arXiv:2407.10671; hf]  28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064.  head_dim = 3584/28 = 128.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3_584,
    vocab_size=152_064,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2-smoke", n_layers=2, d_model=56, vocab_size=256,
    n_heads=4, n_kv_heads=2, head_dim=14, d_ff=112)
