"""DeepSeek-MoE 16B [arXiv:2401.06066]: 28L, d=2048, 16H (kv=16),
fine-grained MoE: 64 routed top-6 + 2 shared experts, expert d_ff=1408,
first layer dense (d_ff = 8*1408 ≈ paper's 10944 — noted), vocab 102400."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=102_400,
    pattern=("full",),
    n_experts=64, n_shared_experts=2, top_k=6, first_dense_layers=1,
    mlp="swiglu", tie_embeddings=True,
    shard_mode="tp", sub_quadratic=False,
))
