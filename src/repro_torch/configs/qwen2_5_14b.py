"""qwen2.5-14b — dense GQA transformer with QKV bias.

[hf:Qwen/Qwen2.5-0.5B (family); hf]  48L d_model=5120 40H (GQA kv=8)
d_ff=13824 vocab=152064.  head_dim = 5120/40 = 128.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5_120,
    vocab_size=152_064,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13_824,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2.5-smoke", n_layers=2, d_model=64, vocab_size=256,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128)
