"""The compile command line — the deployment driver, run as
``python -m repro_torch.cli``.

    python -m repro_torch.cli mcunet-5fps-vww --target cortex-m4 \
        --dtype int8 --emit-c out/ --save vww.plan.json

Compiles a registered net for a target (build -> schedule -> plan ->
budget -> quantize -> certify), prints the report, and optionally emits
the intrinsic-C units and/or the JSON plan artifact.  ``--smoke`` is
the CI gate: compile MCUNet-VWW, enforce the SRAM budget, and diff the
emitted ring-geometry C against the committed goldens.

The port's counterpart of ``vmcu-compile`` (:mod:`repro.cli`): the same
options, defaults, exit codes and standard output, ``--partial auto|N``
(partial execution) included.
"""
from __future__ import annotations

import argparse
import pathlib
import sys


def _print_report(rep: dict) -> None:
    passes = rep.pop("passes", [])
    cert = rep.pop("certificate", None)
    for k, v in rep.items():
        if isinstance(v, float):
            v = f"{v:.4f}"
        print(f"  {k:28s} {v}")
    if cert is not None:
        print(f"  {'certificate':28s} {cert}")
    for name, secs, note in passes:
        print(f"    pass {name:9s} {secs:8.3f}s  {note}")


def _diff_goldens(units: dict[str, str], golden_dir: pathlib.Path) -> int:
    """Compare emitted units against the committed goldens; return the
    number of drifted/missing files (0 = clean)."""
    bad = 0
    names = {p.name for p in golden_dir.glob("*.c")}
    for name, src in units.items():
        golden = golden_dir / name
        if not golden.exists():
            print(f"  MISSING golden {golden}", file=sys.stderr)
            bad += 1
        elif golden.read_text() != src:
            print(f"  DRIFT vs golden {golden}", file=sys.stderr)
            bad += 1
    for stale in names - set(units):
        print(f"  STALE golden {golden_dir / stale} (no longer emitted)",
              file=sys.stderr)
        bad += 1
    return bad


def main(argv=None) -> int:
    import repro_torch

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cli",
        description="One-call vMCU deployment: net in, segment-ring plan "
                    "+ MCU kernels out.")
    ap.add_argument("net", nargs="?", default=None,
                    help="registered net name (default mcunet-5fps-vww) "
                         "or artifact path with --from-artifact")
    ap.add_argument("--target", default=None,
                    help="target descriptor ("
                         f"{', '.join(repro_torch.list_targets())}); default "
                         "host-sim, or cortex-m4 under --smoke")
    ap.add_argument("--dtype", default=None,
                    help="pool dtype (default: the target's)")
    ap.add_argument("--emit-c", metavar="DIR",
                    help="write one intrinsic-C unit per op into DIR")
    ap.add_argument("--save", metavar="FILE",
                    help="write the solved plan artifact (JSON)")
    ap.add_argument("--from-artifact", action="store_true",
                    help="treat NET as a saved artifact and load it "
                         "instead of compiling")
    ap.add_argument("--certify", choices=("sim", "static"), default="sim",
                    help="certification mode: replay the sim clobber "
                         "oracle, or statically prove clobber-freedom "
                         "(repro_torch.analysis; falls back to sim "
                         "outside "
                         "the decidable fragment)")
    ap.add_argument("--no-certify", action="store_true",
                    help="skip the certification pass entirely")
    ap.add_argument("--no-budget", action="store_true",
                    help="record the SRAM verdict without gating")
    ap.add_argument("--partial", default="off", metavar="MODE",
                    help="partial execution: 'auto' slices over-budget "
                         "fusion groups until the deployable ring fits "
                         "SRAM, an integer forces that many slices on "
                         "the pinning group, 'off' (default) keeps the "
                         "hard budget gate")
    ap.add_argument("--no-quantize", action="store_true",
                    help="int8 planner-only compile: solve the ring "
                         "and budgets without calibrating qparams")
    ap.add_argument("--list-targets", action="store_true")
    ap.add_argument("--list-nets", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: compile MCUNet-VWW for the target, "
                         "enforce the SRAM budget, diff emitted "
                         "ring-geometry C against --golden-dir")
    ap.add_argument("--golden-dir", default="tests/golden/vww",
                    help="golden C directory for --smoke")
    args = ap.parse_args(argv)

    if args.list_targets:
        for name in repro_torch.list_targets():
            t = repro_torch.get_target(name)
            print(f"{name:12s} {t.cpu}  sram={t.sram_bytes} "
                  f"flash={t.flash_bytes} idiom={t.requant_idiom} "
                  f"dtype={t.default_dtype}")
        return 0
    if args.list_nets:
        print("\n".join(repro_torch.available_nets()))
        return 0

    # --smoke pins the whole configuration (net AND int8 MCU target) so
    # the gate is self-contained; otherwise host-sim is the default.
    target = args.target or ("cortex-m4" if args.smoke else "host-sim")
    if args.smoke and args.net not in (None, "mcunet-5fps-vww"):
        print(f"--smoke gates MCUNet-VWW only; drop the {args.net!r} "
              "argument (or run without --smoke)", file=sys.stderr)
        return 2

    if args.from_artifact:
        if args.net is None:
            print("--from-artifact needs an artifact path",
                  file=sys.stderr)
            return 2
        cn = repro_torch.load(args.net)
        print(f"loaded {args.net} ({cn.net_name} for {cn.target.name})")
    else:
        net = args.net or "mcunet-5fps-vww"
        partial = args.partial
        if partial not in ("off", "auto"):
            try:
                partial = int(partial)
            except ValueError:
                print(f"--partial must be 'off', 'auto' or an integer "
                      f"slice count, got {partial!r}", file=sys.stderr)
                return 2
        try:
            cn = repro_torch.compile(net, target=target, dtype=args.dtype,
                                     certify=(False if args.no_certify
                                              else args.certify),
                                     check_budget=not args.no_budget,
                                     quantize=not args.no_quantize,
                                     partial=partial)
        except repro_torch.SRAMBudgetError as e:
            print(f"SRAM budget gate FAILED: {e}", file=sys.stderr)
            return 2
    _print_report(cn.report())

    if args.emit_c:
        units = cn.emit_c(args.emit_c)
        print(f"wrote {len(units)} C units to {args.emit_c}")
    if args.save:
        cn.save(args.save)
        print(f"wrote plan artifact {args.save}")

    if args.smoke:
        golden_dir = pathlib.Path(args.golden_dir)
        if not golden_dir.is_dir():
            print(f"golden dir {golden_dir} not found (run from the repo "
                  "root or pass --golden-dir)", file=sys.stderr)
            return 2
        units = cn.emit_c(geometry_only=True, name="vww")
        bad = _diff_goldens(units, golden_dir)
        if bad:
            print(f"smoke FAILED: {bad} golden mismatches (regenerate "
                  "with tests/golden/regen.py if intentional)",
                  file=sys.stderr)
            return 1
        print(f"smoke OK: SRAM gate passed, {len(units)} C units match "
              f"{golden_dir}")
        cn.emit_c()  # exercise the full requant-table emission too
    return 0


if __name__ == "__main__":
    sys.exit(main())
