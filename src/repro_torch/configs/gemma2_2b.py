"""gemma2-2b — dense GQA with local+global alternating attention + softcaps.

[arXiv:2408.00118; hf]  26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000.  head_dim=256 (8·256 = 2048 ≠ d_model — gemma2 projects).
Even layers use a 4096-token sliding window; odd layers are global.
Attention logits capped at 50, final logits at 30; post-block RMSNorms.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2_304,
    vocab_size=256_000,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9_216,
    attn_window=4_096,
    local_global_period=2,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_block_norm=True,
    tie_embeddings=True,
    scale_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma2-smoke", n_layers=2, d_model=64, vocab_size=256,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, attn_window=8)
