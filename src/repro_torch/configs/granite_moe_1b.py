"""Granite-3.0 1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base]: 24L,
d=1024, 16H GQA(kv=8), MoE 32 experts top-8, expert d_ff=512, vocab 49155."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49_155,
    pattern=("full",),
    n_experts=32, top_k=8,
    mlp="swiglu", tie_embeddings=True,
    shard_mode="tp", sub_quadratic=False,
))
