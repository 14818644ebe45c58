"""Assigned-architecture configs (the port's copy of ``repro.configs``).
Import this package to populate ARCH_REGISTRY; ``get_config(name)``
fetches one."""
from .base import (ALL_SHAPES, ARCH_REGISTRY, DECODE_32K, LONG_500K,
                   ModelConfig, PREFILL_32K, ShapeCell, TRAIN_4K, cells_for,
                   get_config)
from . import (gemma2_2b, gemma3_1b, gemma2_27b, granite_8b, granite_moe_1b,
               deepseek_moe_16b, llama32_vision_90b, recurrentgemma_2b,
               whisper_tiny, mamba2_780m)

ALL_ARCHS = tuple(ARCH_REGISTRY)
