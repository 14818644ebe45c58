"""Config system: one dataclass drives model build and serving.

The port's copy of ``repro.configs.base``, as plain data: every assigned
architecture is a ``ModelConfig`` in its own module
(``repro_torch/configs/<id>.py``, the reference's literature values) and
registers itself in ``ARCH_REGISTRY``; ``reduced()`` derives the CPU
smoke-test variant.  ``get_config`` answers the reference's names with
the reference's fields.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

Family = Literal["lm", "moe", "vlm", "hybrid", "audio", "ssm"]
ShardMode = Literal["tp", "fsdp_sp"]

# Block kinds usable in a layer pattern.
#   full   — causal full attention
#   local  — sliding-window causal attention
#   global — full attention (gemma naming; softcap per config)
#   cross  — cross-attention to encoder/image memory (+ self full)
#   rec    — RG-LRU recurrent block (recurrentgemma)
#   ssm    — Mamba-2 SSD block
BlockKind = Literal["full", "local", "global", "cross", "rec", "ssm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 → d_model // n_heads
    pattern: tuple[BlockKind, ...] = ("full",)
    window: int = 4096                 # sliding-window size for "local"
    rope_theta: float = 10_000.0
    # gemma-style softcaps (None → off)
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    mlp: Literal["geglu", "swiglu", "gelu"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    post_norms: bool = False           # gemma2 post-attn/post-ffn norms
    tie_embeddings: bool = True
    # --- MoE -------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0        # deepseek: leading dense FFN layers
    moe_dispatch: str = "cumsum"       # cumsum (baseline) | scan (§Perf)
    # --- SSM (mamba2 SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1
    ssm_chunk: int = 256
    # --- RG-LRU (recurrentgemma) -------------------------------------------
    lru_width: int = 0
    # --- enc-dec / multimodal stubs ----------------------------------------
    encoder_layers: int = 0            # whisper encoder depth
    encoder_seq: int = 0               # frames after conv stub (whisper 1500)
    n_image_tokens: int = 0            # vlm patch-embedding stub length
    max_decode_len: int = 0            # 0 → unlimited (position table size)
    # --- distribution --------------------------------------------------------
    shard_mode: ShardMode = "tp"
    sub_quadratic: bool = False        # eligible for long_500k
    remat_policy: str = "nothing"      # nothing|dots|full — hillclimb lever
    bf16_einsum: bool = False          # §Perf: bf16 inputs + f32 accum in
                                       # attention/unembed einsums (kills
                                       # f32 activation gathers)
    scan_layers: bool = True           # False → unroll (exact cost_analysis)
    notes: str = ""

    # -- derived -------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        # Pad the vocab to a multiple of 256 so the embedding table shards
        # evenly on the 16-way model axis (standard production practice —
        # MaxText/Megatron do the same; padded rows never receive tokens).
        if self.vocab % 256:
            object.__setattr__(self, "vocab_unpadded", self.vocab)
            object.__setattr__(self, "vocab",
                               -(-self.vocab // 256) * 256)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:          # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def memory_len(self) -> int:
        """Length of the encoder/image memory a cross block attends to
        (the reference attaches this in ``models/transformer.py``)."""
        if self.family == "audio":
            return self.encoder_seq
        if self.family == "vlm":
            return self.n_image_tokens
        return 0

    def n_groups(self) -> tuple[int, int]:
        """(full scan groups, remainder layers)."""
        p = len(self.pattern)
        return self.n_layers // p, self.n_layers % p

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for roofline
        MODEL_FLOPS = 6·N·D."""
        d, v = self.d_model, self.vocab
        total = v * d                           # embedding (tied)
        if not self.tie_embeddings:
            total += v * d
        per_layer: dict[BlockKind, int] = {}
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        dense_ffn = (3 if self.mlp in ("geglu", "swiglu") else 2) * d * self.d_ff
        moe_ffn = (self.n_experts + self.n_shared_experts) * 3 * d * self.d_ff \
            + d * self.n_experts if self.n_experts else 0
        ffn = moe_ffn if self.n_experts else dense_ffn
        for kind in set(self.pattern):
            if kind in ("full", "local", "global"):
                per_layer[kind] = attn + ffn
            elif kind == "cross":
                per_layer[kind] = 2 * attn + ffn   # self + cross attention
            elif kind == "rec":
                w = self.lru_width or d
                per_layer[kind] = (2 * d * w + w * d      # in/out projections
                                   + 2 * w                 # a-gate, i-gate
                                   + self.ssm_conv * w     # conv1d
                                   + dense_ffn)
            elif kind == "ssm":
                di, ns = self.d_inner, self.ssm_state
                per_layer[kind] = (d * (2 * di + 2 * self.ssm_groups * ns
                                        + self.ssm_heads)
                                   + self.ssm_conv * (di + 2 * self.ssm_groups * ns)
                                   + 2 * self.ssm_heads + di * d + di)
        g, rem = self.n_groups()
        count = 0
        for i, kind in enumerate(self.pattern):
            count += per_layer[kind] * (g + (1 if i < rem else 0))
        total += count
        if self.encoder_layers:
            total += self.encoder_layers * (attn + dense_ffn)
        return total

    def active_param_count(self) -> int:
        """MoE: only routed-active experts count toward useful FLOPs."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        all_experts = self.n_experts * 3 * d * self.d_ff
        active = (self.top_k + self.n_shared_experts) * 3 * d * self.d_ff
        return self.param_count() - self._moe_layers() * (all_experts -
                                                          active + 0)

    def _moe_layers(self) -> int:
        return self.n_layers - self.first_dense_layers if self.n_experts else 0

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/pattern, tiny dims."""
        p = len(self.pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(p, 2 if p == 1 else p),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=128 if not self.n_experts else 32,
            vocab=256,
            window=32,
            n_experts=min(self.n_experts, 4),
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2),
            # no-drop capacity: capacity-based MoE is batch-dependent by
            # design; smoke tests need decode == forward exactly.
            capacity_factor=float(max(self.n_experts, 1)),
            first_dense_layers=min(self.first_dense_layers, 1),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=8,
            lru_width=64 if self.lru_width else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 24) if self.encoder_seq else 0,
            n_image_tokens=min(self.n_image_tokens, 8),
            rope_theta=10_000.0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned input-shape cell."""

    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeCell("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeCell("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeCell("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeCell("long_500k", "decode", 524_288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

ARCH_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from . import ALL_ARCHS  # noqa: F401  (populate registry)
    return ARCH_REGISTRY[name]


def cells_for(cfg: ModelConfig) -> list[ShapeCell]:
    """The shape cells this arch runs (long_500k only if sub-quadratic)."""
    cells = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        cells.append(LONG_500K)
    return cells
