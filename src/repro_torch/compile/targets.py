"""Hardware target descriptors.

Counterpart of the :class:`Target` record of
:mod:`repro.compile.targets`, so that the ``target`` entry of a plan
artifact loads as ``Target(**payload["target"])``.  The target registry
comes with the compile pipeline, in a later slice.
"""
from __future__ import annotations

import dataclasses

from ..core.vpool import SEG_WIDTH

#: Requantization idioms the reference codegen annotates.
REQUANT_IDIOMS = ("smlad", "mve", "none")


@dataclasses.dataclass(frozen=True)
class Target:
    """One deployment target's hardware envelope + planning defaults.

    ``seg_width``/``block_rows`` are the executed ring geometry;
    ``kernel_block_rows`` caps the rows a kernel fuses per step (an
    execution knob, never plan geometry); ``sram_bytes`` gates the
    byte-granular deployable bottleneck.
    """

    name: str
    cpu: str
    sram_bytes: int
    flash_bytes: int
    seg_width: int = SEG_WIDTH
    block_rows: int | None = 1    # DMA block alignment (None = tight)
    kernel_block_rows: int = 8    # rows fused per kernel step
    simd_bits: int = 32
    requant_idiom: str = "smlad"  # one of REQUANT_IDIOMS
    default_dtype: str = "int8"
    default_backend: str = "jnp"  # the reference executor's default

    def __post_init__(self):
        if self.requant_idiom not in REQUANT_IDIOMS:
            raise ValueError(f"unknown requant idiom "
                             f"{self.requant_idiom!r}; known: "
                             f"{REQUANT_IDIOMS}")
        if self.sram_bytes <= 0 or self.flash_bytes <= 0:
            raise ValueError(f"target {self.name!r} needs positive "
                             "sram/flash budgets")

    def fits_sram(self, bytes_: int) -> bool:
        return bytes_ <= self.sram_bytes

    def sram_margin(self, bytes_: int) -> int:
        return self.sram_bytes - bytes_
