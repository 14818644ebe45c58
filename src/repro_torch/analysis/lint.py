"""Plan linter — budget/consistency checks over programs, artifacts and
emitted C (the ``VMCU3xx``/``VMCU4xx``/``VMCU5xx`` half of the table).

:func:`verify_program` proves the *ring* safe; this module checks
everything around the ring that can still sink a deployment:

  * :func:`lint_program` — the target envelope (SRAM/flash budgets,
    ``VMCU301``/``VMCU302``) and the program's own byte accounting
    (``elem_bytes`` vs dtype, per-op ``segment_bytes`` vs geometry,
    ``VMCU401``/``VMCU402``),
  * :func:`lint_artifact` — a saved ``.save()`` plan artifact: the
    embedded safety certificate's content hash (``VMCU403`` — the plan
    changed after it was certified), the quantization payload vs the
    program dtype (``VMCU404``), then the full static ring proof and
    budget lint of the loaded program,
  * :func:`lint_c_dir` — previously emitted C units vs a fresh
    geometry-only emission of the same plan (``VMCU501`` drift /
    ``VMCU502`` missing / ``VMCU503`` stray unit): catches the
    "re-planned the net, forgot to re-emit" staleness class.

Everything here is pure inspection — no execution, no parameter decode
(flash accounting reads array byte sizes straight off the encoded
``{"__array__", dtype, shape}`` envelopes).

The port's copy of :mod:`repro.analysis.lint`: the same findings, in
the same order, with the same text (``tests/test_torch_lint.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from ..core.program import PLAN_ONLY_KINDS, PoolProgram, dtype_itemsize
from .verifier import CODES, Diagnostic, VerifyResult, verify_program


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


# ---------------------------------------------------------------------------
# Artifact lint (certificate hash, quant payload, then the ring proof).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ArtifactReport:
    """One linted artifact: identity + the merged verdict."""

    path: str
    net: str
    dtype: str
    target: str
    result: VerifyResult

    @property
    def clean(self) -> bool:
        return self.result.safe is not False and not self.result.errors


def _encoded_nbytes(obj: Any) -> int:
    """Array bytes of an :mod:`repro_torch.compile.artifact` encoded payload,
    read off the envelopes without decoding."""
    if isinstance(obj, dict):
        if "__array__" in obj:
            n = math.prod(obj["shape"]) if obj["shape"] else 1
            return n * _itemsize(obj["dtype"])
        if "__tuple__" in obj:
            return sum(_encoded_nbytes(v) for v in obj["__tuple__"])
        return sum(_encoded_nbytes(v) for v in obj.values())
    if isinstance(obj, list):
        return sum(_encoded_nbytes(v) for v in obj)
    return 0


def _itemsize(dtype_name: str) -> int:
    import numpy as np

    try:
        return np.dtype(dtype_name).itemsize
    except TypeError:
        return 2 if "16" in dtype_name else 4


def lint_artifact(path: str) -> ArtifactReport:
    """Lint one saved plan artifact (``CompiledNet.save`` JSON).

    Checks, in order: the certificate's embedded ``program_sha256``
    against a fresh hash of the stored program (``VMCU403``), the
    quantization payload against the program dtype (``VMCU404``), the
    static ring proof (``verify_program`` — the full ``VMCU1xx``/
    ``VMCU2xx`` surface), and the target budgets with *exact* flash
    accounting from the encoded parameter payload.
    """
    from ..compile import artifact
    from ..compile.targets import Target

    payload = artifact.load(path)
    program = PoolProgram.from_json_dict(payload["program"])
    target = Target(**payload["target"])
    diags: list[Diagnostic] = []

    cert = payload.get("certificate")
    if cert is not None and "program_sha256" in cert:
        have = artifact.program_sha256(program)
        if cert["program_sha256"] != have:
            diags.append(_diag(
                "VMCU403", f"certificate hashes "
                f"{cert['program_sha256'][:12]}..., stored program "
                f"hashes {have[:12]}..."))

    quant = payload.get("quant")
    if quant is not None and program.dtype != "int8":
        diags.append(_diag(
            "VMCU404", f"artifact carries requant tables but the "
            f"program dtype is {program.dtype!r}"))
    if quant is not None and cert is not None:
        n_cert = cert.get("n_segments")
        if n_cert is not None and n_cert != program.n_segments:
            diags.append(_diag(
                "VMCU403", f"certificate ring n_segments={n_cert} != "
                f"program n_segments={program.n_segments}"))

    res = verify_program(program)
    diags.extend(res.diagnostics)

    diags.extend(lint_program(program))  # byte accounting, no budgets
    mcu = payload.get("mcu") or {}
    deploy = mcu.get("deploy_bytes", mcu.get("mcu_bottleneck_bytes"))
    if deploy is not None and deploy > target.sram_bytes:
        who = mcu.get("bottleneck_group")
        who = f" (pinned by fusion group {who!r})" if who else ""
        diags.append(_diag(
            "VMCU301", f"deployable bottleneck {deploy} B > "
            f"{target.sram_bytes} B SRAM on {target.name!r}{who}"))
    flash = (_encoded_nbytes(quant["qparams"]) if quant is not None
             else _encoded_nbytes(payload.get("params")))
    if flash > target.flash_bytes:
        diags.append(_diag(
            "VMCU302", f"{flash} B parameter payload > "
            f"{target.flash_bytes} B flash on {target.name!r}",
            severity="warning"))

    safe = False if any(d.severity == "error" for d in diags) else res.safe
    return ArtifactReport(
        path=path, net=payload.get("net", "?"), dtype=payload["dtype"],
        target=target.name,
        result=VerifyResult(safe=safe, diagnostics=diags,
                            stats=res.stats))


# ---------------------------------------------------------------------------
# Emitted-C staleness lint.
# ---------------------------------------------------------------------------

def lint_c_dir(program: PoolProgram, c_dir: Any, name: str = "net",
               idiom: str | None = None) -> list[Diagnostic]:
    """Diff previously emitted C units against a fresh geometry-only
    emission of ``program`` — the deterministic ring skeleton, so the
    comparison is idiom/dtype/requant-independent.

    ``VMCU501``: a unit exists but its ring geometry diverged (the plan
    was re-solved after emission).  ``VMCU502``: a planned op's unit is
    missing.  ``VMCU503``: a ``.c``/``.h`` file in ``c_dir`` corresponds
    to no planned op (a stale unit a linker could still pick up).

    A unit passes if it is byte-identical to the geometry-only emission
    (``emit_c(geometry_only=True)`` goldens) OR carries the same *ring
    signature* — POOL_SEGS plus every solved ``WRAP(...)`` pointer
    expression, in order — so full quantized/idiom-bannered emissions of
    the SAME plan lint clean while a re-solved ring is always caught.
    """
    import pathlib

    from ..core.codegen import emit_program

    if program.ops and program.ops[0].kind in PLAN_ONLY_KINDS:
        return [_diag("VMCU105", "plan-only program has no emitted C",
                      severity="warning")]
    want = emit_program(program.with_dtype("byte"), name, idiom=idiom)
    d = pathlib.Path(c_dir)
    have = {p.name for p in d.glob("*.c")} | {p.name for p in d.glob("*.h")}
    diags: list[Diagnostic] = []
    for fname, src in sorted(want.items()):
        if fname not in have:
            diags.append(_diag("VMCU502", f"{fname} not found in {d}"))
            continue
        text = (d / fname).read_text()
        if text != src and _ring_signature(text) != _ring_signature(src):
            diags.append(_diag(
                "VMCU501", f"{fname} solved ring geometry differs from "
                f"the plan (stale — re-run emit_c)"))
    for fname in sorted(have - set(want)):
        diags.append(_diag(
            "VMCU503", f"{fname} matches no op of this plan",
            severity="warning"))
    return diags


def _ring_signature(src: str) -> tuple:
    """The solved ring baked into one C unit: POOL_SEGS + every
    ``WRAP(...)`` pointer expression, in emission order.  Deliberately
    excludes SEG_BYTES (dtype-scaled) and requant constants."""
    import re

    pool = re.search(r"#define POOL_SEGS (\d+)", src)
    wraps = tuple(dict.fromkeys(re.findall(r"WRAP\(([^)]*)\)", src)))
    return (pool.group(1) if pool else None, wraps)


__all__ = ["ArtifactReport", "lint_artifact", "lint_c_dir",
           "lint_program"]
