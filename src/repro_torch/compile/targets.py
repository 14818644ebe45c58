"""Hardware target descriptors and their registry.

Counterpart of :mod:`repro.compile.targets`.  A :class:`Target` holds
what the compile pipeline gates and plans against: the SRAM/flash
budgets, the executed ring geometry (segment width + DMA block
alignment), the SIMD width and requantization idiom the emitted C is
annotated for, and the default pool dtype.  The ``target`` entry of a
plan artifact loads as ``Target(**payload["target"])``.

The registry ships the reference's four descriptors (``cortex-m4``,
``cortex-m7``, ``cortex-m55``, ``host-sim``) field for field, so a plan
the port compiles saves the same ``target`` entry as the reference's;
:func:`register_target` adds new boards.
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

    # -- planner knobs (ONE definition site) ------------------------------
    @property
    def plan_kwargs(self) -> dict:
        """The executed-ring ``plan_net`` geometry of this target."""
        return {"seg_width": self.seg_width, "block_rows": self.block_rows}

    @property
    def byte_ring_kwargs(self) -> dict:
        """The paper's byte-granular geometry (Fig. 9/10 metric): one
        byte per segment, tight Eq.-(1)/(2) pointers.  Shared by every
        target — int8 bytes are int8 bytes on any MCU."""
        return {"seg_width": 1, "block_rows": None}

    # -- budgets -----------------------------------------------------------
    def fits_sram(self, bytes_: int) -> bool:
        return bytes_ <= self.sram_bytes

    def sram_margin(self, bytes_: int) -> int:
        return self.sram_bytes - bytes_


_REGISTRY: dict[str, Target] = {}
_ALIASES: dict[str, str] = {}


def register_target(target: Target, *aliases: str,
                    overwrite: bool = False) -> Target:
    """Add ``target`` (and optional alias names) to the registry."""
    if target.name in _REGISTRY and not overwrite:
        raise ValueError(f"target {target.name!r} already registered")
    _REGISTRY[target.name] = target
    for a in aliases:
        _ALIASES[a] = target.name
    return target


def get_target(target: str | Target) -> Target:
    """Resolve a target name (or pass a Target descriptor through)."""
    if isinstance(target, Target):
        return target
    name = _ALIASES.get(target, target)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown target {target!r}; known: "
                         f"{list_targets()}") from None


def list_targets() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# The stock descriptors.
# ---------------------------------------------------------------------------

# The paper's evaluation boards: STM32F446RE (Cortex-M4, 128 KB SRAM —
# the deployment story of examples/mcu_plan.py) and an M7-class part
# with the larger 320 KB SRAM tier.  Both requantize via the dual-MAC
# __SMLAD idiom; int8 is the deployment dtype.
register_target(Target(
    name="cortex-m4", cpu="Arm Cortex-M4 (STM32F446RE)",
    sram_bytes=128_000, flash_bytes=512_000,
    simd_bits=32, requant_idiom="smlad", default_dtype="int8"))

register_target(Target(
    name="cortex-m7", cpu="Arm Cortex-M7 (STM32F746ZG)",
    sram_bytes=320_000, flash_bytes=1_024_000,
    simd_bits=64, requant_idiom="smlad", default_dtype="int8"))

# Helium/MVE-class part: 128-bit vector requant (VMLADAVA.S8 + VQRDMULH).
register_target(Target(
    name="cortex-m55", cpu="Arm Cortex-M55 (Helium MVE)",
    sram_bytes=256_000, flash_bytes=2_048_000,
    simd_bits=128, requant_idiom="mve", default_dtype="int8"))

# Development target: the float ring with an effectively unbounded
# budget — every pass runs, nothing gates.  Its ``cpu`` and
# ``default_backend`` strings are the reference's, kept so that a saved
# artifact's ``target`` entry is the reference's byte for byte; the port
# runs it on the CUDA card like every other target.
register_target(Target(
    name="host-sim", cpu="host (XLA cpu/tpu; Pallas interpret)",
    sram_bytes=1 << 40, flash_bytes=1 << 40,
    simd_bits=128 * 32, requant_idiom="none",
    default_dtype="float32"))
