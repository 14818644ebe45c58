"""Diagnostic records of the static ring-safety verifier.

Counterpart of the data half of :mod:`repro.analysis.verifier`: the
stable ``VMCUxxx`` code table (:data:`CODES`), one structured finding
(:class:`Diagnostic`) and a verdict (:class:`VerifyResult`), which the
lint pass (:mod:`repro_torch.analysis.lint`) reports through.  The
abstract interpreter itself (``verify_program``, ``certify="static"``)
is Slice F; until then the compile driver certifies with the sim
oracle.
"""
from __future__ import annotations

import dataclasses

#: Stable diagnostic codes (DESIGN.md §11 carries the full table).
CODES = {
    "VMCU101": "write clobbers the op's own streaming input "
               "(solved offset too small)",
    "VMCU102": "write clobbers a live segment of another tensor "
               "(held input / residual source / survivor)",
    "VMCU103": "tensor wraps the ring onto itself "
               "(span exceeds n_segments)",
    "VMCU104": "final outputs do not survive the ring",
    "VMCU105": "static proof unavailable for this program "
               "(fall back to the sim oracle)",
    "VMCU201": "chained input pointer does not reach the producer's "
               "live record",
    "VMCU202": "input tensor is not live "
               "(freed too early, or a bad branch/hold index)",
    "VMCU203": "residual pointer does not reach the residual source's "
               "live record",
    "VMCU204": "residual source tensor is not live",
    "VMCU211": "persistent stream state clobbered by frame traffic "
               "(staged input or an op's output overwrites live state)",
    "VMCU212": "stream state extent wrong — the step cannot write the "
               "full state back",
    "VMCU213": "stale-state read (state region wraps the ring or "
               "overlaps another op's state)",
    "VMCU301": "pool exceeds the target's SRAM budget",
    "VMCU302": "parameter payload exceeds the target's flash budget",
    "VMCU303": "SRAM overflow resolvable by partial execution "
               "(re-compile with partial='auto')",
    "VMCU401": "program elem_bytes inconsistent with its dtype",
    "VMCU402": "op segment_bytes inconsistent with the program geometry",
    "VMCU403": "artifact certificate does not match the program "
               "(stale or tampered plan)",
    "VMCU404": "artifact quantization payload inconsistent with the "
               "program dtype",
    "VMCU501": "emitted C unit diverges from the plan's ring geometry",
    "VMCU502": "emitted C unit missing for a planned op",
    "VMCU503": "emitted C unit does not correspond to any planned op",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One structured finding, with a stable ``VMCUxxx`` code."""

    code: str
    message: str
    severity: str = "error"          # "error" | "warning"
    op_index: int | None = None
    step: int | None = None
    segment: int | None = None       # pool slot (mod n_segments)
    byte: int | None = None          # first affected pool byte

    def __str__(self) -> str:
        loc = []
        if self.op_index is not None:
            loc.append(f"op {self.op_index}")
        if self.step is not None:
            loc.append(f"step {self.step}")
        if self.segment is not None:
            loc.append(f"slot {self.segment}")
        if self.byte is not None:
            loc.append(f"byte {self.byte}")
        where = f" [{', '.join(loc)}]" if loc else ""
        return f"{self.code}{where}: {self.message}"


@dataclasses.dataclass
class VerifyResult:
    """Outcome of the static verifier (``repro.analysis.verify_program``;
    the port's comes with Slice F).

    ``safe`` is ``True`` (proven clobber-free), ``False`` (a concrete
    first clobber/read failure was derived) or ``None`` (the program is
    outside the decidable fragment — fall back to the sim oracle).
    ``stats`` mirrors the sim pool counters exactly when ``safe``."""

    safe: bool | None
    diagnostics: list[Diagnostic]
    stats: dict | None = None

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    def certificate(self, program_sha256: str | None = None) -> dict:
        """The machine-checkable safety certificate (requires safe)."""
        if not self.safe or self.stats is None:
            raise ValueError("no certificate: program not proven safe")
        cert = {"clobbers": 0, **self.stats}
        if program_sha256 is not None:
            cert["program_sha256"] = program_sha256
        return cert
