"""Plan analysis — counterpart of ``repro.analysis``: the lint pass
(:func:`lint_program`) and the verifier's diagnostic records."""
from .lint import lint_program
from .verifier import CODES, Diagnostic, VerifyResult

__all__ = ["CODES", "Diagnostic", "VerifyResult", "lint_program"]
