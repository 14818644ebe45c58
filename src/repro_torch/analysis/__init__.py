"""Static ring-safety verification and plan linting — counterpart of
``repro.analysis``, in plain Python and numpy.

The planner *solves* the Eq.-(1)/(2) segment-ring offsets; this package
*proves* them, without executing anything:

  * :mod:`repro_torch.analysis.verifier` — the abstract interpreter
    (:func:`verify_program`): live-record domain over the same row
    schedules the sim oracle replays; emits a machine-checkable safety
    certificate or a ``VMCU1xx``/``VMCU2xx`` diagnostic with the exact
    first clobbered byte and step,
  * :mod:`repro_torch.analysis.lint` — budget / byte-accounting /
    artifact / emitted-C findings (``VMCU3xx``–``VMCU5xx``),
  * :mod:`repro_torch.analysis.mutate` — deterministic plan corruptions
    for the differential fault-injection tests,
  * :mod:`repro_torch.analysis.cli` — the lint command line
    (``python -m repro_torch.analysis.cli``).

``repro_torch.compile`` surfaces all of this as the ``lint`` pass and
the ``certify="static"`` mode (DESIGN.md §11).
"""
from .lint import (ArtifactReport, lint_artifact, lint_c_dir,
                   lint_program)
from .mutate import Mutation, break_plan, mutations
from .verifier import (CODES, Diagnostic, VerifyResult, verify_program)

__all__ = [
    "ArtifactReport",
    "CODES",
    "Diagnostic",
    "Mutation",
    "VerifyResult",
    "break_plan",
    "lint_artifact",
    "lint_c_dir",
    "lint_program",
    "mutations",
    "verify_program",
]
