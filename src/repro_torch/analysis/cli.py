"""The lint command line — static ring-safety verification of plans.

    python -m repro_torch.analysis.cli vww.plan.json other.plan.json
    python -m repro_torch.analysis.cli vww.plan.json --c-dir out/
    python -m repro_torch.analysis.cli --smoke     # self-contained gate

Per artifact: the certificate content hash (VMCU403), the quantization
payload (VMCU404), the full static clobber-freedom proof (VMCU1xx/2xx
with the exact first clobbered byte and step), and the target budgets
(VMCU3xx).  Exit 0 iff every artifact is clean (warnings don't gate),
1 on any error finding, 2 on usage errors.

``--smoke`` needs no inputs: it compiles MCUNet-VWW for cortex-m4 with
``certify="static"``, asserts the saved artifact lints clean, then
corrupts the plan two ways — a :func:`repro_torch.analysis.break_plan`
offset nudge (asserting the static verdict matches the sim clobber
oracle) and a tampered artifact (asserting lint rejects it with a VMCU
code) — so an unsound verifier fails loudly.

The port's counterpart of ``vmcu-lint`` (:mod:`repro.analysis.cli`):
the same arguments, exit codes and standard output.
"""
from __future__ import annotations

import argparse
import sys
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .lint import ArtifactReport


def _print_report(rep: "ArtifactReport") -> None:
    verdict = ("CLEAN" if rep.clean
               else "UNSAFE" if rep.result.safe is False else "UNPROVEN")
    print(f"{rep.path}: {verdict}  ({rep.net}, {rep.dtype}, "
          f"{rep.target})")
    if rep.result.stats:
        s = rep.result.stats
        print(f"  proof: zero clobbers; peak {s['peak_live']}/"
              f"{s['n_segments']} segments live, {s['reads']} reads / "
              f"{s['writes']} writes")
    for d in rep.result.diagnostics:
        print(f"  {'WARN ' if d.severity == 'warning' else 'ERROR'} {d}")


def _smoke() -> int:
    """The CI gate: prove a clean plan, catch two corrupted ones."""
    import json
    import tempfile
    from pathlib import Path

    from ..compile.driver import compile as _compile
    from ..core.executors import run_program_sim
    from ..core.pool import PoolClobberError
    from .lint import lint_artifact
    from .mutate import break_plan
    from .verifier import verify_program

    cn = _compile("mcunet-5fps-vww", "cortex-m4", quantize=False,
                  certify="static")
    cert = dict(cn.certificate)
    if cert.get("clobbers") != 0 or "program_sha256" not in cert:
        print(f"smoke FAILED: bad static certificate {cert}",
              file=sys.stderr)
        return 1
    note = next(p.note for p in cn.passes if p.name == "certify")
    if "static proof" not in note:
        print(f"smoke FAILED: certify pass fell back to sim ({note})",
              file=sys.stderr)
        return 1

    with tempfile.TemporaryDirectory() as td:
        path = str(Path(td) / "vww.plan.json")
        cn.save(path)
        rep = lint_artifact(path)
        if not rep.clean:
            print("smoke FAILED: clean artifact lints dirty:",
                  file=sys.stderr)
            _print_report(rep)
            return 1
        print(f"clean plan: static proof OK ({cert['peak_live']}/"
              f"{cert['n_segments']} segments peak live)")

        # corruption 1: a planner-bug-shaped offset nudge — the static
        # verdict must agree with the sim clobber oracle
        mut = break_plan(cn.program)
        res = verify_program(mut.program)
        try:
            run_program_sim(mut.program)
            sim_safe = True
        except PoolClobberError:
            sim_safe = False
        if res.safe is not False or sim_safe:
            print(f"smoke FAILED: {mut.tag}: static={res.safe} "
                  f"sim_safe={sim_safe} (must both be unsafe)",
                  file=sys.stderr)
            return 1
        print(f"broken plan ({mut.tag}): static and sim agree UNSAFE — "
              f"{res.diagnostics[0]}")

        # corruption 2: a tampered artifact must fail lint with a code
        payload = json.loads(Path(path).read_text())
        payload["program"]["ops"][0]["out_ptr"] += 1
        Path(path).write_text(json.dumps(payload))
        rep = lint_artifact(path)
        codes = sorted({d.code for d in rep.result.errors})
        if rep.clean or not codes:
            print("smoke FAILED: tampered artifact lints clean",
                  file=sys.stderr)
            return 1
        print(f"tampered artifact rejected: {', '.join(codes)}")
    print("vmcu-lint smoke OK")
    return 0


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.cli",
        description="Statically verify vMCU plan artifacts: prove "
                    "clobber-freedom, check certificates, budgets and "
                    "emitted C — without executing anything.")
    ap.add_argument("artifacts", nargs="*",
                    help="saved plan artifacts (CompiledNet.save JSON)")
    ap.add_argument("--c-dir", metavar="DIR",
                    help="also diff DIR's emitted C units against each "
                         "artifact's solved ring (VMCU5xx)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: prove a fresh MCUNet-VWW plan, then "
                         "assert two corrupted variants are rejected")
    args = ap.parse_args(argv)

    if args.smoke:
        if args.artifacts:
            print("--smoke is self-contained; drop the artifact "
                  "arguments", file=sys.stderr)
            return 2
        return _smoke()
    if not args.artifacts:
        ap.print_usage(file=sys.stderr)
        print(f"{ap.prog}: need at least one artifact (or --smoke)",
              file=sys.stderr)
        return 2

    from ..core.program import PoolProgram
    from .lint import lint_artifact, lint_c_dir

    bad = 0
    for path in args.artifacts:
        try:
            rep = lint_artifact(path)
        except (OSError, ValueError, KeyError) as e:
            print(f"{path}: ERROR not a readable plan artifact: {e}",
                  file=sys.stderr)
            bad += 1
            continue
        if args.c_dir:
            import json

            with open(path) as f:
                payload = json.load(f)
            program = PoolProgram.from_json_dict(payload["program"])
            rep.result.diagnostics.extend(
                lint_c_dir(program, args.c_dir, name=rep.net))
        _print_report(rep)
        if not rep.clean or rep.result.errors:
            bad += 1
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
