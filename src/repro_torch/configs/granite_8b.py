"""Granite-8B code [arXiv:2405.04324]: llama-arch, 36L, d=4096, 32H
GQA(kv=8), d_ff=14336 SwiGLU, vocab 49152.  Pure full attention ⇒
long_500k skipped (DESIGN.md §Arch-applicability)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-8b", family="lm",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14_336, vocab=49_152,
    pattern=("full",),
    mlp="swiglu", tie_embeddings=True,
    shard_mode="tp", sub_quadratic=False,
))
