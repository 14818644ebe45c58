"""Plan linter — the budget and byte-accounting checks of one program.

Counterpart of :func:`repro.analysis.lint.lint_program` (the compile
driver's ``lint`` pass): the target envelope (SRAM/flash budgets,
``VMCU301``/``VMCU302``, and the ``VMCU303`` advisory) and the
program's own byte accounting (``elem_bytes`` vs dtype, per-op
``segment_bytes`` vs geometry, ``VMCU401``/``VMCU402``).  The artifact
and emitted-C lints come with Slice F.
"""
from __future__ import annotations

from typing import Any

from ..core.program import PLAN_ONLY_KINDS, PoolProgram, dtype_itemsize
from .verifier import CODES, Diagnostic


def _diag(code: str, detail: str, *, severity: str = "error",
          op_index: int | None = None) -> Diagnostic:
    return Diagnostic(code=code, message=f"{CODES[code]}: {detail}",
                      severity=severity, op_index=op_index)


# ---------------------------------------------------------------------------
# Program-level lint (budgets + byte-accounting consistency).
# ---------------------------------------------------------------------------

def lint_program(program: PoolProgram, target: Any = None, *,
                 deploy_bytes: int | None = None,
                 bottleneck_group: str | None = None,
                 partial_slices: int | None = None) -> list[Diagnostic]:
    """Budget + byte-accounting findings for one program.

    ``target`` (a :class:`repro_torch.compile.targets.Target`, a registry
    name, or ``None`` to skip the budget checks) supplies the SRAM and
    flash envelopes.  ``deploy_bytes`` is the byte-granular deployable
    bottleneck the SRAM gate judges (the paper's Fig.-9/10 metric — the
    executed ring is a host-side float/int8 structure, deliberately NOT
    what lands on the MCU); without it the SRAM check is skipped.  SRAM
    overrun is an error; flash overrun is a *warning* — without the
    artifact payload the parameter size is an analytic estimate.

    ``bottleneck_group`` names the fusion group pinning the overflow in
    the VMCU301 finding; ``partial_slices`` (the reference driver's
    ``repro.partial.estimate_slices`` result) adds a VMCU303
    advisory: the overflow is resolvable by partial execution.
    """
    diags: list[Diagnostic] = []
    plan_only = program.ops and program.ops[0].kind in PLAN_ONLY_KINDS

    try:
        eb = dtype_itemsize(program.dtype)
    except ValueError:
        diags.append(_diag("VMCU401",
                           f"unknown pool dtype {program.dtype!r}"))
        eb = None
    if eb is not None and program.elem_bytes != eb:
        diags.append(_diag(
            "VMCU401", f"elem_bytes={program.elem_bytes} but dtype "
            f"{program.dtype!r} is {eb} B/element"))
    if not plan_only and eb is not None:
        want = program.seg_width * program.elem_bytes
        for i, op in enumerate(program.ops):
            if op.segment_bytes != want:
                diags.append(_diag(
                    "VMCU402",
                    f"segment_bytes={op.segment_bytes} but seg_width="
                    f"{program.seg_width} x elem_bytes="
                    f"{program.elem_bytes} = {want}", op_index=i))
                break  # one geometry finding per program is enough

    if target is not None:
        from ..compile.targets import get_target

        t = get_target(target)
        if deploy_bytes is not None and deploy_bytes > t.sram_bytes:
            who = (f" (pinned by fusion group {bottleneck_group!r})"
                   if bottleneck_group else "")
            diags.append(_diag(
                "VMCU301", f"deployable bottleneck {deploy_bytes} B > "
                f"{t.sram_bytes} B SRAM on {t.name!r}{who}"))
            if partial_slices is not None:
                diags.append(_diag(
                    "VMCU303", f"overflow is resolvable by partial "
                    f"execution: est. {partial_slices} slice(s) — "
                    "recompile with partial='auto'",
                    severity="warning"))
        flash = _flash_estimate(program)
        if flash > t.flash_bytes:
            diags.append(_diag(
                "VMCU302", f"~{flash} B parameters (analytic estimate) "
                f"> {t.flash_bytes} B flash on {t.name!r}",
                severity="warning"))
    return diags


def _flash_estimate(program: PoolProgram) -> int:
    """Analytic parameter bytes (the driver's fp32 shapes, scaled by the
    program dtype's itemsize for quantized plans)."""
    from ..compile.driver import _flash_param_bytes

    est = _flash_param_bytes(program)
    if program.quantized:
        est //= 4  # int8 weights; biases/tables add back a little
    return est


__all__ = ["lint_program"]
