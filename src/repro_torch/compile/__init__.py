"""The compile pipeline: target descriptors, pass driver, artifacts —
counterparts of ``repro.compile``.

``repro_torch.compile(net, target)`` (the function re-exported at the
package root) is the one-call deployment front door; this package holds
its parts:

  * ``targets``  — the :class:`Target` descriptor registry (SRAM/flash
                   budgets, ring geometry, SIMD width, requant idiom),
  * ``driver``   — the named pass pipeline (build -> schedule -> plan ->
                   budget -> quantize -> lint -> certify) and
                   :class:`CompiledNet`,
  * ``artifact`` — the JSON plan-artifact codec.
"""
from .targets import (REQUANT_IDIOMS, Target, get_target, list_targets,
                      register_target)
from .driver import (PASS_NAMES, CompileError, CompiledNet, PassRecord,
                     SRAMBudgetError, available_nets, compile, load)

__all__ = [
    "REQUANT_IDIOMS", "Target", "get_target", "list_targets",
    "register_target",
    "PASS_NAMES", "CompileError", "CompiledNet", "PassRecord",
    "SRAMBudgetError", "available_nets", "compile", "load",
]
