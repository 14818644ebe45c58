"""Gemma-2 27B [arXiv:2408.00118]: 46L, d=4608, 32H GQA(kv=16),
head_dim 128, d_ff=36864 GeGLU, vocab 256000, 1:1 local:global, softcaps.
32 heads ⇒ Megatron TP on the model axis."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-27b", family="lm",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36_864, vocab=256_000,
    pattern=("local", "global"), window=4096,
    attn_softcap=50.0, logit_softcap=30.0,
    mlp="geglu", post_norms=True, tie_embeddings=True,
    shard_mode="tp", sub_quadratic=False,
))
