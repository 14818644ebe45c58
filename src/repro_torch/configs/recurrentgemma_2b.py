"""RecurrentGemma-2B / Griffin [arXiv:2402.19427]: 26L, d=2560,
10H GQA(kv=1), head_dim 256, d_ff=7680 GeGLU, lru_width=2560,
pattern (rec, rec, local-attn) — 1 attention per 2 recurrent blocks,
window 2048.  Hybrid ⇒ long_500k eligible (O(1) recurrent state +
ring KV)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256_000,
    pattern=("rec", "rec", "local"), window=2048,
    lru_width=2560,
    mlp="geglu", tie_embeddings=True,
    shard_mode="fsdp_sp", sub_quadratic=True,
))
