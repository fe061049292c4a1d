"""minitron-4b — dense GQA transformer (pruned nemotron).

[arXiv:2407.14679; hf]  32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000.  head_dim = 3072/24 = 128.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3_072,
    vocab_size=256_000,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9_216,
)

SMOKE = dataclasses.replace(
    CONFIG, name="minitron-smoke", n_layers=2, d_model=48, vocab_size=256,
    n_heads=4, n_kv_heads=2, head_dim=12, d_ff=96)
