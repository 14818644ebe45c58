"""The port's static ring-safety verifier (``repro_torch.analysis``) held
against the reference's (``repro.analysis``) on the CPU.

  * The interval algebra: the reference's unit cases, and the port's
    primitives equal to the reference's on a grid and on random draws.
  * Fast-path vs generic frontier extraction: identical ``_SchedInfo``
    for every op of the DS-CNN and ResNet-8 plans (fp32 and int8).
  * ``verify_program``: the same verdict, the same diagnostics (code,
    severity, location and text), the same stats and certificate on
    every mutant the mutator makes of the cortex-m4 planner-only plans
    of DS-CNN, ResNet-8 and MCUNet-VWW, on the 13 committed plans, on
    every registered net x target and on the DS-CNN stream; the port's
    ``mutations()`` yields the reference's tags and programs.
  * ``repro_torch.compile(..., certify="static")``: the reference's
    program, certificate, pass notes and spans (but for seconds) on
    every registered net x target and on the DS-CNN int8 compile from
    the reference's params and calibration inputs; an unsafe plan raises
    the reference's message, and a plan outside the proof's fragment
    falls back to the sim oracle with the reference's note.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro
import repro_torch
from repro.analysis import break_plan as ref_break_plan
from repro.analysis import mutations as ref_mutations
from repro.analysis import verify_program as ref_verify
from repro.analysis import CODES as REF_CODES
from repro.analysis import intervals as ref_intervals
from repro.compile.artifact import program_sha256 as ref_sha256
from repro.compile.driver import CompileError as RefCompileError
from repro.compile.driver import SRAMBudgetError as RefSRAMBudgetError
from repro.core.program import PoolProgram as RefPoolProgram
from repro_torch.analysis import (Diagnostic, VerifyResult, break_plan,
                                  mutations, verify_program)
from repro_torch.analysis import verifier
from repro_torch.analysis.intervals import (first_static_clash,
                                            first_stream_clash, overlap)
from repro_torch.compile import artifact
from repro_torch.compile.driver import CompileError, SRAMBudgetError
from repro_torch.core.executors import run_program_sim
from repro_torch.core.pool import PoolClobberError
from repro_torch.core.program import PoolProgram
from repro_torch.core.rowsched import schedule_for_op
from repro_torch.graph.ir import build_ds_cnn, build_resnet8
from repro_torch.graph.netplan import _plan_net

from test_torch_compile import _same_compile

TARGETS = ("cortex-m4", "cortex-m7", "host-sim")
ASSETS = pathlib.Path(artifact.__file__).parents[1] / "assets"
PLANS = sorted(ASSETS.glob("*.json"))
MUTATED = ("ds-cnn", "resnet-8", "mcunet-5fps-vww")


def _port(program) -> PoolProgram:
    return PoolProgram.from_json_dict(program.to_json_dict())


def _ref(program) -> RefPoolProgram:
    return RefPoolProgram.from_json_dict(program.to_json_dict())


def _diags(res) -> list:
    return [(d.code, d.severity, d.op_index, d.step, d.segment, d.byte,
             d.message, str(d)) for d in res.diagnostics]


def _same_result(have, want) -> None:
    assert have.safe is want.safe
    assert _diags(have) == _diags(want)
    assert have.stats == want.stats
    if want.safe:
        assert have.certificate("ab" * 32) == want.certificate("ab" * 32)
    else:
        with pytest.raises(ValueError) as w:
            want.certificate()
        with pytest.raises(ValueError) as h:
            have.certificate()
        assert str(h.value) == str(w.value)


def _sim_safe(program) -> bool:
    try:
        run_program_sim(program)
        return True
    except PoolClobberError:
        return False


@pytest.fixture(scope="module")
def planner_only():
    """The reference's cortex-m4 planner-only programs of ``MUTATED``."""
    return {net: repro.compile(net, "cortex-m4", quantize=False,
                               certify=False).program for net in MUTATED}


# ---------------------------------------------------------------------------
# Interval algebra.
# ---------------------------------------------------------------------------

def test_overlap_modular():
    assert overlap(0, 3, 2, 3, 10)          # [0,3) x [2,5)
    assert not overlap(0, 3, 3, 3, 10)      # [0,3) x [3,6)
    assert overlap(8, 4, 0, 2, 10)          # [8,12) wraps onto [0,2)
    assert not overlap(8, 2, 0, 2, 10)
    assert overlap(0, 10, 5, 1, 10)         # full ring hits everything
    assert not overlap(0, 0, 0, 5, 10)      # empty run hits nothing


def test_first_static_clash_exact():
    assert first_static_clash(8, 3, 5, 16) == (5, 0)
    assert first_static_clash(8, 3, 9, 16) is None
    assert first_static_clash(8, 3, 14, 16) == (0, 2)


def test_first_stream_clash_respects_frees():
    we, lo = np.array([2, 4]), np.array([0, 3])
    assert first_stream_clash(we, lo, 4, 3, 32) is None
    assert first_stream_clash(we, np.array([0, 0]), 4, 3, 32) == (1, 3, 0)


def test_interval_primitives_equal_the_reference_on_a_grid():
    for n in (1, 2, 5, 16):
        for a in range(-n, 2 * n):
            for la in range(0, n + 2):
                for lb in range(0, n + 2):
                    args = (a, la, 3, lb, n)
                    assert overlap(*args) == ref_intervals.overlap(*args)
                    args = (la, lb, a % n, n)
                    assert first_static_clash(*args) \
                        == ref_intervals.first_static_clash(*args)


@settings(derandomize=True, database=None, max_examples=200, deadline=None)
@given(n=st.integers(1, 40), steps=st.integers(1, 8), data=st.data())
def test_first_stream_clash_equals_the_reference(n, steps, data):
    counts = data.draw(st.lists(st.integers(0, 6), min_size=steps,
                                max_size=steps), label="writes")
    we = np.cumsum(np.asarray(counts, np.int64))
    hi = data.draw(st.integers(0, 3 * n), label="hi")
    lo = np.sort(np.asarray(data.draw(st.lists(
        st.integers(0, hi), min_size=steps, max_size=steps), label="lo"),
        np.int64))
    delta = data.draw(st.integers(0, n - 1), label="delta")
    assert first_stream_clash(we, lo, hi, delta, n) \
        == ref_intervals.first_stream_clash(we, lo, hi, delta, n)


# ---------------------------------------------------------------------------
# Fast-path frontier extraction == generic event replay.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("builder", [build_ds_cnn, build_resnet8])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_fast_path_matches_generic(builder, dtype):
    program = _plan_net(builder(), dtype=dtype).program
    for op in program.ops:
        rows = op.rows_in or program.m_rows
        fast = verifier._sched_info_build(op, program.seg_width,
                                          program.m_rows)
        gen = verifier._sched_info_build_generic(
            schedule_for_op(op, program.seg_width, m_rows=rows))
        assert fast.monotone_error is None
        for f in dataclasses.fields(fast):
            a, b = getattr(fast, f.name), getattr(gen, f.name)
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b), (op.kind, f.name)
            else:
                assert a == b, (op.kind, f.name)


def test_sched_cache_is_geometry_keyed_and_bounded():
    verifier._SCHED_CACHE.clear()
    program = _plan_net(build_ds_cnn()).program
    verify_program(program)
    n1 = len(verifier._SCHED_CACHE)
    assert 0 < n1 <= len(program.ops)
    verify_program(_plan_net(build_ds_cnn(), dtype="int8").program)
    assert len(verifier._SCHED_CACHE) == n1      # same geometry
    # the backstop: a full cache is emptied before its next new entry
    verifier._SCHED_CACHE.update({("filler", i): None for i in range(4096)})
    resnet = _plan_net(build_resnet8()).program
    verify_program(resnet)
    assert not any(k[0] == "filler" for k in verifier._SCHED_CACHE)
    assert 0 < len(verifier._SCHED_CACHE) <= len(resnet.ops)


# ---------------------------------------------------------------------------
# verify_program against the reference's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", MUTATED)
def test_every_mutant_gets_the_reference_result(planner_only, net):
    """158 / 220 / 578 mutants: the port's mutator makes the reference's
    tags and programs, and the port's verifier gives the reference's
    result on each."""
    want_prog = planner_only[net]
    have = list(mutations(_port(want_prog)))
    want = list(ref_mutations(want_prog))
    assert [m.tag for m in have] == [m.tag for m in want]
    n_unsafe = 0
    for h, w in zip(have, want):
        assert artifact.program_sha256(h.program) \
            == ref_sha256(w.program), h.tag
        res = verify_program(h.program)
        _same_result(res, ref_verify(w.program))
        n_unsafe += res.safe is False
    print(f"{net}: {len(have)} mutants, {n_unsafe} unsafe")
    assert len(have) == {"ds-cnn": 158, "resnet-8": 220,
                         "mcunet-5fps-vww": 578}[net]
    assert 0 < n_unsafe < len(have)


@pytest.mark.parametrize("net", ["ds-cnn", "resnet-8"])
def test_every_mutant_verdict_is_the_port_sims(planner_only, net):
    """The port's verifier and the port's sim oracle agree on every
    mutant: no false-safe, no false-unsafe."""
    for m in mutations(_port(planner_only[net])):
        res = verify_program(m.program)
        assert res.safe is not None, m.tag
        assert res.safe == _sim_safe(m.program), m.tag


@settings(derandomize=True, database=None, max_examples=60, deadline=None)
@given(data=st.data())
def test_random_corruption_gets_the_reference_result(data):
    program = _plan_net(build_ds_cnn()).program
    i = data.draw(st.integers(0, len(program.ops) - 1), label="op")
    field = data.draw(st.sampled_from(
        ["in_ptr", "out_ptr", "aux_ptr", "hold_input", "in_op",
         "n_segments"]), label="field")
    shift = data.draw(st.integers(-2 * program.n_segments,
                                  2 * program.n_segments), label="shift")
    op = program.ops[i]
    if field == "n_segments":
        mutant = dataclasses.replace(
            program, n_segments=max(1, program.n_segments + shift))
    else:
        value = (not op.hold_input if field == "hold_input"
                 else getattr(op, field) + shift)
        ops = list(program.ops)
        ops[i] = dataclasses.replace(op, **{field: value})
        mutant = dataclasses.replace(program, ops=tuple(ops))
    _same_result(verify_program(mutant), ref_verify(_ref(mutant)))


@pytest.mark.parametrize("path", PLANS, ids=lambda p: p.stem)
def test_committed_plans_prove_safe_as_in_the_reference(path):
    """All 13 committed plans: proven safe, with the certificate the
    artifact stores, key for key."""
    payload = json.loads(path.read_text())
    have = verify_program(PoolProgram.from_json_dict(payload["program"]))
    want = ref_verify(RefPoolProgram.from_json_dict(payload["program"]))
    _same_result(have, want)
    assert have.safe is True
    cert = have.certificate(payload["certificate"]["program_sha256"])
    assert cert == payload["certificate"]


def test_zoo_plans_prove_safe_as_in_the_reference():
    """Every registered net on every target (the over-budget one
    ungated) and the DS-CNN stream."""
    n = 0
    for net in repro.available_nets() + ("stream",):
        for t in TARGETS:
            kw = dict(quantize=False, certify=False, lint=False,
                      check_budget=False)
            if net == "stream":
                want = repro.compile("ds-cnn", t, streaming=True, **kw)
            else:
                want = repro.compile(net, t, **kw)
            have = verify_program(_port(want.program))
            _same_result(have, ref_verify(want.program))
            assert have.safe is True, (net, t)
            n += 1
    assert n == 3 * (len(repro.available_nets()) + 1)


def test_plan_only_program_is_inconclusive_as_in_the_reference():
    from repro.core.graph_planner import MCUNET_5FPS_VWW as REF_VWW
    from repro.core.program import plan_module_program as ref_module
    from repro_torch.core.graph_planner import MCUNET_5FPS_VWW
    from repro_torch.core.program import plan_module_program

    have = verify_program(plan_module_program(MCUNET_5FPS_VWW[1]))
    _same_result(have, ref_verify(ref_module(REF_VWW[1])))
    assert [d.code for d in have.diagnostics] == ["VMCU105"]
    assert have.diagnostics[0].severity == "warning"
    empty = dataclasses.replace(_plan_net(build_ds_cnn()).program, ops=())
    _same_result(verify_program(empty), ref_verify(_ref(empty)))
    zero = dataclasses.replace(empty, n_segments=0)
    _same_result(verify_program(zero), ref_verify(_ref(zero)))


@pytest.mark.parametrize("net", MUTATED)
def test_break_plan_is_the_references(planner_only, net):
    have = break_plan(_port(planner_only[net]))
    want = ref_break_plan(planner_only[net])
    assert have.tag == want.tag
    assert artifact.program_sha256(have.program) == ref_sha256(want.program)
    res = verify_program(have.program)
    assert res.safe is False and not _sim_safe(have.program)
    _same_result(res, ref_verify(want.program))


def test_a_slack_plan_breaks_by_shrinking_the_ring_as_in_the_reference():
    """A plan no offset nudge breaks: both shrink the ring to half."""
    from repro.core.program import GemmSpec as RefGemm
    from repro.core.program import plan_program as ref_plan_program
    from repro_torch.core.program import GemmSpec, plan_program

    prog = plan_program(4, 16, [GemmSpec(16)], block_rows=1)
    prog = dataclasses.replace(prog, n_segments=prog.n_segments + 64)
    ref = ref_plan_program(4, 16, [RefGemm(16)], block_rows=1)
    ref = dataclasses.replace(ref, n_segments=ref.n_segments + 64)
    have, want = break_plan(prog), ref_break_plan(ref)
    assert have.tag == want.tag
    assert artifact.program_sha256(have.program) == ref_sha256(want.program)


def test_diagnostic_and_result_records():
    d = Diagnostic(code="VMCU101", message="m", op_index=3, step=7,
                   segment=11, byte=1408)
    assert str(d) == "VMCU101 [op 3, step 7, slot 11, byte 1408]: m"
    r = VerifyResult(safe=None, diagnostics=[
        Diagnostic(code="VMCU105", message="w", severity="warning")])
    assert r.errors == []
    assert verifier.CODES == REF_CODES


# ---------------------------------------------------------------------------
# certify="static" through the compile driver.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("net", repro.available_nets())
def test_static_compiles_equal_the_reference(net, target):
    try:
        want = repro.compile(net, target, quantize=False, certify="static")
    except RefSRAMBudgetError as e:
        with pytest.raises(SRAMBudgetError) as have:
            repro_torch.compile(net, target, quantize=False,
                                certify="static")
        assert str(have.value) == str(e)
        return
    have = repro_torch.compile(net, target, quantize=False,
                               certify="static")
    _same_compile(have, want)
    note = next(p.note for p in have.passes if p.name == "certify")
    assert note.startswith("static proof: zero clobbers; peak ")
    sim = repro_torch.compile(net, target, quantize=False, certify="sim")
    assert have.certificate == sim.certificate


@pytest.mark.parametrize("target", TARGETS)
def test_the_static_stream_compile_equals_the_reference(target):
    kw = dict(streaming=True, quantize=False, certify="static")
    have = repro_torch.compile("ds-cnn", target, **kw)
    _same_compile(have, repro.compile("ds-cnn", target, **kw))
    assert have.certificate["stream_horizon"] == "unbounded"


def test_the_static_int8_ds_cnn_compile_equals_the_reference():
    """From the reference's params and calibration inputs: the committed
    artifact's plan and certificate, and the reference's static compile
    pass for pass."""
    from repro_torch.compile.artifact import read_compile_inputs

    params, calib = read_compile_inputs(
        ASSETS / "ds-cnn.cortex-m4.int8.compile.npz")
    have = repro_torch.compile("ds-cnn", "cortex-m4", params=params,
                               calib=calib, certify="static")
    want = repro.compile("ds-cnn", "cortex-m4", params=params, calib=calib,
                         certify="static")
    _same_compile(have, want)
    stored = json.loads(
        (ASSETS / "ds-cnn.cortex-m4.int8.json").read_text())
    assert have.certificate == stored["certificate"]
    assert next(p.note for p in have.passes if p.name == "certify") \
        .startswith("static proof")


def _broken_planner(monkeypatch, module, mutate):
    real = module._plan_net

    def plan(*args, **kwargs):
        p = real(*args, **kwargs)
        return dataclasses.replace(p, program=mutate(p.program).program)
    monkeypatch.setattr(module, "_plan_net", plan)


def test_an_unsafe_plan_raises_the_references_message(monkeypatch):
    from repro.compile import driver as ref_driver
    from repro_torch.compile import driver

    _broken_planner(monkeypatch, ref_driver, ref_break_plan)
    _broken_planner(monkeypatch, driver, break_plan)
    for net in MUTATED:
        with pytest.raises(RefCompileError) as want:
            repro.compile(net, "host-sim", certify="static")
        with pytest.raises(CompileError) as have:
            repro_torch.compile(net, "host-sim", certify="static")
        assert str(have.value) == str(want.value)
        assert str(have.value).startswith("certify: VMCU1")


def test_outside_the_fragment_certify_falls_back_to_the_sim(monkeypatch):
    """Where the proof is inconclusive (VMCU105) both drivers replay the
    plan through the sim oracle and say so in the pass note."""
    import repro.analysis as ref_analysis
    import repro_torch.analysis as analysis

    monkeypatch.setattr(ref_analysis, "verify_program",
                        lambda p: ref_verify(dataclasses.replace(
                            p, n_segments=0)))
    monkeypatch.setattr(analysis, "verify_program",
                        lambda p: verify_program(dataclasses.replace(
                            p, n_segments=0)))
    have = repro_torch.compile("resnet-8", "cortex-m4", quantize=False,
                               certify="static")
    want = repro.compile("resnet-8", "cortex-m4", quantize=False,
                         certify="static")
    _same_compile(have, want)
    note = next(p.note for p in have.passes if p.name == "certify")
    assert note.startswith("sim fallback (VMCU105); zero clobbers")
