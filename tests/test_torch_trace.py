"""Ring telemetry in the port (``repro_torch.obs``) held against the
reference's (``repro.obs``) on the CPU.

  * The golden: the port's sim trace of ``tests/test_trace.py``'s 3-op
    program has the canonical form ``tests/golden/mini.trace.json``.
  * Counters, on every committed plan (the 13 assets and the sliced
    ImageNet plan): the sim oracle's measured traffic equals the
    certificate's reads and writes, op by op it equals the schedule's
    counters, and (streams aside, whose state traffic the schedule does
    not count) so do the trace's byte totals; the watermark is the
    reference's, and equals ``pool_bytes`` (but on ToyADMOS and the
    streams, as in the reference); the canonical trace equals the
    reference's.  A run
    traced on the CPU has the static trace's canonical form, the
    ``backend`` set aside.
  * Batched counters are the certificate times the batch; a traced
    stream's counters after N steps are init + N·step.
  * Behaviour: a traced output is the untraced one, bit for bit, and
    ``trace=False`` makes no tracer; the artifact round trip, the Chrome
    export, the ASCII timeline, ``diff_traces``, ``profile`` and the
    command line's render / save / diff / smoke against the reference's
    standard output.
"""
import json
import pathlib
import re

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import ConvDWSpec as RefConvDWSpec
from repro.core import ConvPWSpec as RefConvPWSpec
from repro.core import GemmSpec as RefGemmSpec
from repro.core import execute as ref_execute
from repro.core import plan_program as ref_plan_program
from repro.core.program import PoolProgram as RefPoolProgram
from repro.obs import RingTracer as RefRingTracer
from repro.obs import TraceArtifact as RefTraceArtifact
from repro.obs import build_trace as ref_build_trace
from repro.obs import diff_traces as ref_diff_traces
from repro.obs.cli import main as ref_trace_main
from repro_torch.compile import artifact
from repro_torch.core.executors import run_program_sim
from repro_torch.core.program import (ConvDWSpec, ConvPWSpec, GemmSpec,
                                      PoolProgram, plan_program)
from repro_torch.obs import (TRACE_SCHEMA, RingTracer, TraceArtifact,
                             build_trace, diff_traces, op_counters,
                             pool_timeline, program_totals)
from repro_torch.obs.cli import main as trace_main

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "mini.trace.json"
ASSETS = pathlib.Path(artifact.__file__).parents[1] / "assets"
PLANS = sorted(p.name for p in ASSETS.glob("*.json"))
STREAMS = ("ds-cnn-stream", "kws-gru-chain")
N_STEPS = 5
_MS = re.compile(r"\d+\.\d+ ms")


def _mini(specs, plan):
    H, C = 4, 8
    return plan(H * H, C, [specs[0](H, H, C, 16, activation="relu"),
                           specs[1](H, H, 16, rs=3, activation="relu"),
                           specs[2](4)], block_rows=1)


def _sim_trace(program, **kw):
    tracer = RingTracer()
    run_program_sim(program, tracer=tracer)
    return build_trace(program, tracer=tracer, **kw)


def _ref_sim_trace(program, **kw):
    tracer = RefRingTracer()
    ref_execute(program, backend="sim", tracer=tracer)
    return ref_build_trace(program, tracer=tracer, **kw)


def _mini_traces():
    have = _sim_trace(_mini((ConvPWSpec, ConvDWSpec, GemmSpec),
                            plan_program), net="mini")
    want = _ref_sim_trace(_mini((RefConvPWSpec, RefConvDWSpec, RefGemmSpec),
                                ref_plan_program), net="mini")
    return have, want


def _unbacked(payload: dict) -> dict:
    return dict(payload, backend=None)


# ---------------------------------------------------------------------------
# The golden and the reference's traces.
# ---------------------------------------------------------------------------

def test_the_mini_trace_is_the_golden():
    have, want = _mini_traces()
    assert have.schema == TRACE_SCHEMA == "vmcu-trace/1"
    assert have.canonical() == json.loads(GOLDEN.read_text())
    assert have.canonical() == want.canonical()
    assert any("sim" in e for e in have.canonical()["events"])
    assert have.backend == "sim" and len(have.events) == 5


@pytest.mark.parametrize("name", PLANS)
def test_traced_traffic_equals_the_certificate(name):
    payload = artifact.load(ASSETS / name)
    prog = PoolProgram.from_json_dict(payload["program"])
    cert = payload["certificate"]
    tracer = RingTracer()
    run_program_sim(prog, tracer=tracer)
    art = build_trace(prog, tracer=tracer, net=payload["net"],
                      target="cortex-m4")
    sim = art.totals["sim"]
    assert (sim["reads"], sim["writes"], sim["peak_live"]) == \
        (cert["reads"], cert["writes"], cert["peak_live"])
    for c, op in zip(op_counters(prog), prog.ops):
        # measured == schedule-derived, a stream op's state read and
        # rewritten besides
        got = tracer.sim_counts[c.index]
        assert (got["reads"], got["writes"]) == \
            (c.segs_read + op.state_segments,
             c.segs_written + op.state_segments), (name, c.index)
    seg_bytes = prog.seg_width * prog.elem_bytes
    state = sum(op.state_segments for op in prog.ops)
    tot = program_totals(prog)
    # the schedule counts frame traffic; a stream's state is read and
    # rewritten each step and read once more at its end, and written once
    # before the first
    assert tot["segs_read"] + 2 * state == cert["reads"]
    assert tot["segs_written"] + 2 * state == cert["writes"]
    if not state:
        assert art.totals["bytes_loaded"] == cert["reads"] * seg_bytes
        assert art.totals["bytes_stored"] == cert["writes"] * seg_bytes
    ref_prog = RefPoolProgram.from_json_dict(payload["program"])
    want = _ref_sim_trace(ref_prog, net=payload["net"], target="cortex-m4")
    assert art.canonical() == want.canonical()
    tl = pool_timeline(prog)
    assert len(tl.residencies) == len(prog.ops) + 1
    assert art.watermark_bytes == tl.watermark_bytes == want.watermark_bytes
    if payload["net"] == "ad-toyadmos":
        # the reference's occupancy model counts each FC's output
        # interval beside its live input: 6 segments over a 5-segment
        # ring, in the reference as here
        assert tl.watermark_segments == prog.pool_segments + 1
    elif state:
        # the model holds no state record: the frame program's span
        assert tl.watermark_segments + state <= prog.pool_segments
    else:
        assert art.watermark_bytes == prog.pool_bytes


@pytest.mark.parametrize("name", [p for p in PLANS if "whisper" not in p
                                  and not p.startswith(STREAMS)])
def test_a_cpu_trace_is_the_static_trace(name):
    """A run traced on the CPU (one golden input) has the static trace's
    counters and timeline, a wall time for every op, and the untraced
    run's outputs, bit for bit."""
    cn = repro_torch.load(ASSETS / name)
    with np.load(ASSETS / name.replace(".json", ".golden.npz")) as g:
        x = g["x"][0]
    y, art = cn.run(x, device="cpu", trace=True)
    assert torch.equal(y, cn.run(x, device="cpu"))
    assert art.backend == "cpu" and art.net == cn.net_name
    static = build_trace(cn.program, net=cn.net_name,
                         target=cn.target.name, spans=cn.spans)
    assert _unbacked(art.canonical()) == _unbacked(static.canonical())
    ops = [e for e in art.events if 0 <= e["index"] < len(cn.program.ops)]
    assert len(ops) == len(cn.program.ops)
    assert all(e["wall_us"] > 0 for e in ops)
    assert art.totals["wall_us"] == pytest.approx(
        sum(e["wall_us"] for e in ops))
    assert art.watermark_bytes == pool_timeline(cn.program).watermark_bytes


def test_batched_counters_are_the_certificate_times_the_batch():
    cn = repro_torch.load(ASSETS / "ds-cnn.cortex-m4.int8.json")
    with np.load(ASSETS / "ds-cnn.cortex-m4.int8.golden.npz") as g:
        x = g["x"][:3]
    y1, art1 = cn.run(x[0], device="cpu", trace=True)
    yb, artb = cn.run(x, device="cpu", trace=True)
    assert torch.equal(yb, cn.run(x, device="cpu"))
    assert torch.equal(yb[0], y1) and artb.totals["batch"] == 3
    cert = cn.certificate
    seg_bytes = cn.program.seg_width * cn.program.elem_bytes
    assert artb.totals["bytes_loaded"] == 3 * cert["reads"] * seg_bytes
    assert artb.totals["bytes_stored"] == 3 * cert["writes"] * seg_bytes
    for k in ("segs_read", "segs_written", "macs", "requants"):
        assert artb.totals[k] == 3 * art1.totals[k], k
    for e1, eb in zip(art1.events, artb.events):
        for k in ("segs_read", "segs_written", "bytes_loaded",
                  "bytes_stored"):
            if k in e1:
                assert eb[k] == 3 * e1[k], (e1["name"], k)
    assert artb.totals["wall_us"] > 0 and artb.backend == "cpu"


@pytest.mark.parametrize("name", STREAMS)
def test_stream_counters_after_n_steps_are_init_plus_n_steps(name):
    """The sim session's measured counters after k steps are init +
    k·step (init: the state written once; step: the certificate's reads,
    and its writes but that first state write), as in the reference; a
    session traced on the CPU counts the same: each step its frame
    traffic plus the state's read, rewrite and survival read."""
    cn = repro_torch.load(ASSETS / f"{name}.cortex-m4.int8.json")
    cert = cn.certificate
    state = cert["state_segments"]
    sim = cn.stream(backend="sim", trace=True)
    cpu = cn.stream(device="cpu", trace=True)
    with np.load(ASSETS / f"{name}.cortex-m4.int8.golden.npz") as g:
        frames, want = g["x_q"][:N_STEPS], g["y_q"][:N_STEPS]
    reads, writes = 0, state
    for k, (f, w) in enumerate(zip(frames, want), start=1):
        c = sim.step()
        assert (c["reads"], c["writes"]) == \
            (k * cert["reads"], state + k * (cert["writes"] - state))
        assert sim.traces[-1].totals["sim"]["reads"] == c["reads"]
        assert np.array_equal(cpu.step(torch.from_numpy(f)).numpy(), w)
        t = cpu.traces[-1].totals
        reads += t["segs_read"] + 2 * state
        writes += t["segs_written"] + state
        assert (reads, writes) == (c["reads"], c["writes"])
    assert len(cpu.traces) == len(sim.traces) == N_STEPS
    assert all(t.backend == "cpu" for t in cpu.traces)
    assert _unbacked(cpu.traces[0].canonical()) == \
        _unbacked(cpu.traces[-1].canonical())


def test_trace_false_makes_no_tracer(monkeypatch):
    import repro_torch.obs as obs

    cn = repro_torch.load(ASSETS / "resnet-8.host-sim.float32.json")
    with np.load(ASSETS / "resnet-8.host-sim.float32.golden.npz") as g:
        x = g["x"][0]
    y_traced, _ = cn.run(x, device="cpu", trace=True)

    def refuse(*_a, **_k):
        raise AssertionError("a tracer was made on the untraced path")

    monkeypatch.setattr(obs, "RingTracer", refuse)
    assert torch.equal(cn.run(x, device="cpu"), y_traced)


# ---------------------------------------------------------------------------
# Artifact surfaces.
# ---------------------------------------------------------------------------

def test_the_artifact_round_trips_and_checks_its_schema(tmp_path):
    art, _ = _mini_traces()
    p = tmp_path / "mini.trace.json"
    art.save(str(p))
    assert TraceArtifact.load(str(p)).to_dict() == art.to_dict()
    # the reference reads the port's trace and the port the reference's
    assert RefTraceArtifact.load(str(p)).to_dict() == art.to_dict()
    payload = json.loads(p.read_text())
    payload["schema"] = "vmcu-trace/999"
    p.write_text(json.dumps(payload))
    with pytest.raises(ValueError) as have:
        TraceArtifact.load(str(p))
    with pytest.raises(ValueError) as want:
        RefTraceArtifact.load(str(p))
    assert str(have.value) == str(want.value)


def _no_time(chrome: dict) -> dict:
    evs = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
           for e in chrome["traceEvents"]]
    for e in evs:
        e.get("args", {}).pop("wall_us", None)
    return dict(chrome, traceEvents=evs)


def test_the_chrome_export_is_the_references():
    have, want = _mini_traces()
    chrome = json.loads(json.dumps(have.to_chrome_trace()))
    xs = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(have.events)
    assert all(e["dur"] > 0 and e["ts"] >= 0 for e in xs)
    assert [e["ts"] for e in xs] == sorted(e["ts"] for e in xs)
    assert _no_time(chrome) == _no_time(want.to_chrome_trace())
    static = build_trace(_mini((ConvPWSpec, ConvDWSpec, GemmSpec),
                               plan_program), net="mini")
    assert static.to_chrome_trace() == RefTraceArtifact.from_dict(
        static.to_dict()).to_chrome_trace()


@pytest.mark.parametrize("width", [40, 64, 200])
def test_the_ascii_timeline_is_the_references(width):
    have, want = _mini_traces()
    text = have.ascii_timeline(width=width)
    assert text == want.ascii_timeline(width=width)
    assert text.splitlines()[-1].startswith("watermark:")
    assert len(text.splitlines()) == len(have.timeline["ops"]) + 2
    payload = artifact.load(ASSETS / "mcunet-5fps-vww.cortex-m4.int8.json")
    prog = PoolProgram.from_json_dict(payload["program"])
    art = build_trace(prog, net="vww")
    assert art.ascii_timeline(width=width) == RefTraceArtifact.from_dict(
        art.to_dict()).ascii_timeline(width=width)


def test_diff_traces_is_the_references():
    a, _ = _mini_traces()
    b, _ = _mini_traces()
    assert diff_traces(a, b)["structural"] == []
    b.events[1]["bytes_loaded"] += 1
    del b.totals["macs"]
    b.timeline["ops"].pop()
    have = diff_traces(a, b)
    want = ref_diff_traces(RefTraceArtifact.from_dict(a.to_dict()),
                           RefTraceArtifact.from_dict(b.to_dict()))
    assert have == want and len(have["structural"]) == 3
    assert any("bytes_loaded" in line for line in have["structural"])


def test_profile():
    """A float net profiles on the CPU with wall times; a planner-only
    int8 compile through the sim oracle, as the reference's does."""
    cn = repro_torch.compile("ds-cnn", "cortex-m4", dtype="float32",
                             quantize=False, certify=False)
    art = cn.profile(device="cpu")
    assert art.backend == "cpu" and art.totals["wall_us"] > 0
    assert art.watermark_bytes == cn.program.pool_bytes
    cn8 = repro_torch.compile("ds-cnn", "cortex-m4", dtype="int8",
                              quantize=False, certify=False)
    art8 = cn8.profile()
    ref8 = repro.compile("ds-cnn", "cortex-m4", dtype="int8", quantize=False,
                         certify=False).profile()
    assert art8.backend == "sim" and art8.totals["sim"]["reads"] > 0
    assert art8.canonical()["events"] == ref8.canonical()["events"]
    assert art8.canonical()["totals"] == ref8.canonical()["totals"]


def test_the_sliced_plan_traces_on_the_cpu():
    """The sliced plan traced on the CPU: bitwise the untraced run, its
    traffic the certificate's, its watermark the ring's."""
    cn = repro_torch.load(
        ASSETS / "mcunet-320kb-imagenet.cortex-m4.int8.sliced.json")
    with np.load(ASSETS / "mcunet-320kb-imagenet.cortex-m4.int8.sliced."
                          "golden.npz") as g:
        x, want = g["x"][0], g["y"][0]
    y, art = cn.run(x, device="cpu", trace=True)
    assert np.array_equal(y.numpy(), want)
    seg_bytes = cn.program.seg_width * cn.program.elem_bytes
    assert art.totals["bytes_loaded"] == cn.certificate["reads"] * seg_bytes
    assert art.totals["bytes_stored"] == \
        cn.certificate["writes"] * seg_bytes
    assert art.watermark_bytes == cn.program.pool_bytes
    assert sum(e.get("wall_us", 0) > 0 for e in art.events) == 158


# ---------------------------------------------------------------------------
# The command line.
# ---------------------------------------------------------------------------

def _run(main, argv, capsys):
    rc = main(argv)
    out, _ = capsys.readouterr()
    return rc, _MS.sub("<ms>", out)


def test_the_cli_renders_saves_and_diffs_as_the_reference(tmp_path, capsys,
                                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    t1, t2 = str(tmp_path / "a.trace.json"), str(tmp_path / "b.trace.json")
    r1, r2 = str(tmp_path / "ra.trace.json"), str(tmp_path / "rb.trace.json")
    have = _run(trace_main, ["ds-cnn", "--save", t1], capsys)
    want = _run(ref_trace_main, ["ds-cnn", "--save", r1], capsys)
    assert have == (want[0], want[1].replace(r1, t1))
    assert have[0] == 0 and "watermark:" in have[1] \
        and "compile pipeline:" in have[1]
    chrome = tmp_path / "c.json"
    assert _run(trace_main, [t1, "--chrome", str(chrome)], capsys)[1] == \
        _run(ref_trace_main, [t1, "--chrome", str(chrome)], capsys)[1]
    assert any(e.get("ph") == "X"
               for e in json.loads(chrome.read_text())["traceEvents"])
    # a plan artifact the reference loads (its int8 assets lack the
    # ``params`` key its loader needs)
    plan = str(ASSETS / "ds-cnn.host-sim.float32.json")
    assert _run(trace_main, [plan], capsys) == \
        _run(ref_trace_main, [plan], capsys)
    assert _run(trace_main, ["ds-cnn", "--save", t2], capsys)[0] == 0
    assert _run(ref_trace_main, ["ds-cnn", "--save", r2], capsys)[0] == 0
    assert _run(trace_main, ["--diff", t1, t2], capsys) == \
        _run(ref_trace_main, ["--diff", t1, t2], capsys)
    assert _run(trace_main, ["--diff", t1, r2], capsys)[0] == 0
    payload = json.loads(pathlib.Path(t2).read_text())
    payload["events"][1]["segs_read"] += 1
    pathlib.Path(t2).write_text(json.dumps(payload))
    have = _run(trace_main, ["--diff", t1, t2], capsys)
    assert have == _run(ref_trace_main, ["--diff", t1, t2], capsys)
    assert have[0] == 1
    for argv in ([], ["--smoke", "ds-cnn"], ["--diff", t1, t2, "ds-cnn"]):
        assert _run(trace_main, argv, capsys)[0] == \
            _run(ref_trace_main, argv, capsys)[0] == 2


def test_the_cli_smoke_is_the_references(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    have = _run(trace_main, ["--smoke"], capsys)
    files = {p.name: json.loads(p.read_text())
             for p in tmp_path.glob("*.json")}
    want = _run(ref_trace_main, ["--smoke"], capsys)
    assert have == want and have[0] == 0
    assert have[1].splitlines()[-1] == "vmcu-trace smoke OK"
    assert sorted(files) == ["vww.chrome.json", "vww.trace.json"]
    assert TraceArtifact.from_dict(files["vww.trace.json"]).canonical() == \
        RefTraceArtifact.load(str(tmp_path / "vww.trace.json")).canonical()
