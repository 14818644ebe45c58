"""The trace command line — ring telemetry, run as
``python -m repro_torch.obs.cli``.

    python -m repro_torch.obs.cli ds-cnn                # compile + sim-trace
    python -m repro_torch.obs.cli vww.trace.json        # render a saved trace
    python -m repro_torch.obs.cli vww.plan.json         # trace a saved plan
    python -m repro_torch.obs.cli ds-cnn --backend cuda # per-op times, card
    python -m repro_torch.obs.cli ds-cnn --chrome out.json   # Perfetto
    python -m repro_torch.obs.cli --diff a.trace.json b.trace.json
    python -m repro_torch.obs.cli --smoke               # self-contained gate

Renders the ASCII memory-map timeline (one row per op: output interval,
live tensors, free slots, watermark at the bottom) plus the traffic
totals; ``--save`` writes the schema-versioned trace JSON, ``--chrome``
the Chrome trace-event export.  ``--diff`` compares two traces: exit 1
iff they differ structurally (wall-time drift alone never gates).

``--smoke`` needs no inputs: it compiles MCUNet-VWW for cortex-m4
(planner-only, ``certify="static"``), traces one sim-oracle execution,
and asserts the telemetry invariants — measured byte counts equal the
safety certificate's reads/writes BIT-EXACTLY, the occupancy watermark
equals the plan's ``pool_bytes``, and the saved trace + Chrome export
round-trip — then leaves ``vww.trace.json`` / ``vww.chrome.json`` on
disk for CI artifact upload.  Exit 0/1, 2 on usage errors.

The port's counterpart of ``vmcu-trace`` (:mod:`repro.obs.cli`): the
same arguments, exit codes and standard output, but ``--backend``, which
names where a numeric trace runs (``cuda``, the card, or ``cpu``, the
plain versions) where the reference names its ``jnp`` and ``pallas``
executors.
"""
from __future__ import annotations

import argparse
import json
import sys


def _sim_trace(program, *, net=None, target=None, spans=None):
    from ..core.executors import run_program_sim
    from .tracer import RingTracer, build_trace

    tracer = RingTracer()
    run_program_sim(program, tracer=tracer)
    return build_trace(program, tracer=tracer, net=net, target=target,
                       spans=spans)


def _trace_from_spec(spec: str, *, target: str, dtype: str | None,
                     backend: str):
    """Resolve a positional spec to a TraceArtifact.

    A readable JSON file is a saved trace (rendered as-is) or a saved
    plan artifact (traced now); anything else is a registered net name
    (compiled for ``target`` first).
    """
    from pathlib import Path

    from .artifact import TRACE_SCHEMA, TraceArtifact

    if Path(spec).is_file():
        with open(spec) as f:
            payload = json.load(f)
        if payload.get("schema") == TRACE_SCHEMA:
            return TraceArtifact.from_dict(payload, source=spec)
        from ..compile.driver import CompiledNet

        cn = CompiledNet.load(spec)
        if backend == "sim":
            return _sim_trace(cn.program, net=cn.net_name,
                              target=cn.target.name, spans=cn.spans)
        return cn.profile(device=backend)

    from ..compile.driver import compile as _compile

    cn = _compile(spec, target, dtype=dtype, quantize=backend != "sim",
                  certify="static")
    if backend == "sim":
        return _sim_trace(cn.program, net=cn.net_name,
                          target=cn.target.name, spans=cn.spans)
    return cn.profile(device=backend)


def _render(art, width: int) -> None:
    print(art.ascii_timeline(width=width))
    t = art.totals
    line = (f"traffic: {t['bytes_loaded']} B loaded / "
            f"{t['bytes_stored']} B stored, {t['macs']} MACs "
            f"({t['arithmetic_intensity']:.2f} MAC/B)")
    if "wall_us" in t:
        line += f", {t['wall_us'] / 1e3:.2f} ms wall"
    print(line)
    if art.spans:
        print("compile pipeline:")
        for s in art.spans:
            _print_span(s, 1)


def _print_span(s: dict, depth: int) -> None:
    attrs = "".join(f" {k}={v}" for k, v in s.get("attrs", {}).items())
    print(f"{'  ' * depth}{s['name']}: {s['seconds'] * 1e3:.1f} ms{attrs}")
    for c in s.get("children", []):
        _print_span(c, depth + 1)


def _diff(path_a: str, path_b: str) -> int:
    from .artifact import TraceArtifact, diff_traces

    d = diff_traces(TraceArtifact.load(path_a), TraceArtifact.load(path_b))
    for line in d["structural"]:
        print(f"STRUCT {line}")
    for line in d["wall"]:
        print(f"wall   {line}")
    if d["structural"]:
        print(f"{len(d['structural'])} structural difference(s)")
        return 1
    print("traces structurally identical"
          + (f" ({len(d['wall'])} wall-time rows)" if d["wall"] else ""))
    return 0


def _smoke() -> int:
    """The CI gate: trace VWW through the sim oracle and assert the
    telemetry invariants against the independent safety certificate."""
    from ..compile.driver import compile as _compile
    from .artifact import TraceArtifact

    cn = _compile("mcunet-5fps-vww", "cortex-m4", quantize=False,
                  certify="static")
    art = _sim_trace(cn.program, net=cn.net_name, target=cn.target.name,
                     spans=cn.spans)
    cert = cn.certificate

    # measured bytes == certificate reads/writes, bit-exactly
    seg_bytes = cn.program.seg_width * cn.program.elem_bytes
    t = art.totals
    if (t["bytes_loaded"] != cert["reads"] * seg_bytes
            or t["bytes_stored"] != cert["writes"] * seg_bytes
            or t["sim"]["reads"] != cert["reads"]
            or t["sim"]["writes"] != cert["writes"]):
        print(f"smoke FAILED: traced traffic {t['segs_read']}r/"
              f"{t['segs_written']}w != certificate {cert['reads']}r/"
              f"{cert['writes']}w", file=sys.stderr)
        return 1
    print(f"traffic OK: {cert['reads']} segment reads / "
          f"{cert['writes']} writes, measured == certified")

    # occupancy watermark == the plan's pool allocation
    if art.watermark_bytes != cn.program.pool_bytes:
        print(f"smoke FAILED: watermark {art.watermark_bytes} B != "
              f"pool_bytes {cn.program.pool_bytes} B", file=sys.stderr)
        return 1
    print(f"watermark OK: {art.watermark_bytes} B == plan pool_bytes")

    # the artifact + Chrome export must round-trip
    art.save("vww.trace.json")
    reloaded = TraceArtifact.load("vww.trace.json")
    if reloaded.canonical() != art.canonical():
        print("smoke FAILED: trace artifact does not round-trip",
              file=sys.stderr)
        return 1
    chrome = art.to_chrome_trace()
    with open("vww.chrome.json", "w") as f:
        json.dump(chrome, f)
    with open("vww.chrome.json") as f:
        chrome = json.load(f)
    xs = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
    if not xs or any("dur" not in e or "ts" not in e for e in xs):
        print("smoke FAILED: Chrome export has no well-formed complete "
              "events", file=sys.stderr)
        return 1
    print(f"exports OK: vww.trace.json + vww.chrome.json "
          f"({len(xs)} complete events)")
    print(art.ascii_timeline().splitlines()[-1])
    print("vmcu-trace smoke OK")
    return 0


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.cli",
        description="Trace vMCU ring executions: per-op byte/MAC "
                    "counters, pool-occupancy timelines, wall times and "
                    "compile-pipeline spans — rendered as an ASCII "
                    "memory map or exported for Perfetto.")
    ap.add_argument("spec", nargs="?",
                    help="a net name (compiled then traced), a saved "
                         "plan artifact, or a saved .trace.json")
    ap.add_argument("--target", default="cortex-m4",
                    help="target descriptor for net-name specs "
                         "(default: cortex-m4)")
    ap.add_argument("--dtype", default=None,
                    help="pool dtype override (default: the target's)")
    ap.add_argument("--backend", default="sim",
                    choices=("sim", "cuda", "cpu"),
                    help="what to trace (default: sim — measured "
                         "segment traffic, no numerics; cuda: the ring "
                         "kernels on the card; cpu: their plain versions)")
    ap.add_argument("--width", type=int, default=64,
                    help="ASCII timeline width in columns (default 64)")
    ap.add_argument("--save", metavar="PATH",
                    help="write the trace artifact JSON")
    ap.add_argument("--chrome", metavar="PATH",
                    help="write Chrome trace-event JSON (Perfetto)")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"),
                    help="compare two saved traces; exit 1 iff they "
                         "differ structurally")
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: sim-trace MCUNet-VWW and assert the "
                         "telemetry invariants against the certificate")
    args = ap.parse_args(argv)

    if args.smoke:
        if args.spec or args.diff:
            print("--smoke is self-contained; drop the other arguments",
                  file=sys.stderr)
            return 2
        return _smoke()
    if args.diff:
        if args.spec:
            print("--diff takes exactly two traces; drop the spec",
                  file=sys.stderr)
            return 2
        return _diff(*args.diff)
    if not args.spec:
        ap.print_usage(file=sys.stderr)
        print("python -m repro_torch.obs.cli: need a net name, plan "
              "artifact or trace (or --diff / --smoke)", file=sys.stderr)
        return 2

    try:
        art = _trace_from_spec(args.spec, target=args.target,
                               dtype=args.dtype, backend=args.backend)
    except (OSError, ValueError, KeyError) as e:
        print(f"{args.spec}: ERROR {e}", file=sys.stderr)
        return 1
    _render(art, args.width)
    if args.save:
        print(f"trace written to {art.save(args.save)}")
    if args.chrome:
        with open(args.chrome, "w") as f:
            json.dump(art.to_chrome_trace(), f)
        print(f"chrome trace written to {args.chrome}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
