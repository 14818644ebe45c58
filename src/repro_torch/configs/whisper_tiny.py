"""Whisper-tiny [arXiv:2212.04356]: enc-dec, 4+4L, d=384, 6H, d_ff=1536
GELU, LayerNorm, vocab 51865.  Conv frontend is a STUB — input_specs()
supplies 1500 precomputed frame embeddings.  Decoder natively caps at 448
positions; the assigned decode_32k cell lowers with an extended position
range (RoPE adaptation, noted in DESIGN.md).  long_500k skipped."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab=51_865,
    pattern=("cross",),
    encoder_layers=4, encoder_seq=1500,
    mlp="gelu", norm="layernorm", tie_embeddings=True,
    shard_mode="fsdp_sp", sub_quadratic=False,
))
