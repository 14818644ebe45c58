"""Gemma-3 1B [hf:google/gemma-3-1b-pt]: 26L, d=1152, 4H GQA(kv=1),
head_dim 256, d_ff=6912 GeGLU, vocab 262144, 5:1 local:global (window 512),
128k context.  No softcaps (gemma3 uses qk-norm; modeled without)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-1b", family="lm",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262_144,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=512, rope_theta=1_000_000.0,
    mlp="geglu", post_norms=True, tie_embeddings=True,
    shard_mode="fsdp_sp", sub_quadratic=True,
))
