"""Mamba-2 780M [arXiv:2405.21060]: 48L SSD blocks, d=1536 (attn-free,
d_ff=0), d_inner=3072, 48 SSD heads (head_dim 64), state N=128, vocab
50280.  48 heads % 16 == 0 ⇒ TP over SSD heads; O(1) state ⇒ long_500k."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab=50_280,
    pattern=("ssm",),
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_groups=1,
    ssm_chunk=256,
    mlp="gelu", tie_embeddings=True,
    shard_mode="tp", sub_quadratic=True,
))
