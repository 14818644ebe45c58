"""Gemma-2 2B [arXiv:2408.00118]: 26L, d=2304, 8H GQA(kv=4), head_dim 256,
d_ff=9216 GeGLU, vocab 256000, 1:1 local:global (window 4096), attn/logit
softcaps, post-norms.  8 heads < 16 ⇒ fsdp_sp sharding; predominantly-
sliding hybrid ⇒ eligible for long_500k (ring KV on local layers)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-2b", family="lm",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256_000,
    pattern=("local", "global"), window=4096,
    attn_softcap=50.0, logit_softcap=30.0,
    mlp="geglu", post_norms=True, tie_embeddings=True,
    shard_mode="fsdp_sp", sub_quadratic=True,
    remat_policy="nothing",
))
