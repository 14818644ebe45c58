"""Llama-3.2 Vision 90B [hf:meta-llama/Llama-3.2-11B-Vision, scaled]:
100L backbone, d=8192, 64H GQA(kv=8), d_ff=28672 SwiGLU, vocab 128256;
cross-attention to image-patch embeddings every 5th layer.  Vision frontend
is a STUB — input_specs() supplies precomputed patch embeddings."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28_672, vocab=128_256,
    pattern=("full", "full", "full", "full", "cross"),
    n_image_tokens=1024,
    mlp="swiglu", tie_embeddings=False, rope_theta=500_000.0,
    shard_mode="tp", sub_quadratic=False,
))
