"""Partial execution in the port (``repro_torch.partial``) held against the
reference's (``repro.partial``) on the CPU.

  * Geometry: ``even_bounds``, ``chain_range``, ``chain_steps``,
    ``slice_layout``, ``candidate``, ``pareto``, ``live_spans`` /
    ``recompute_spans``, ``estimate_slices`` and ``plan_partial`` (auto on
    ImageNet for the M4, ``force=4`` on VWW, the infeasible
    ``force=10**6`` with its ``PartialPlanError``) equal the reference's
    on the byte plans, and so do the lowering's errors.
  * Compile: ``compile(..., partial="auto", quantize=False,
    certify="static")`` on ImageNet for the M4 and the M7, ``partial=4``
    on VWW and the refusals: program sha256, summary, certificate, pass
    notes and messages byte for byte; the sliced plan's static
    certificate equals the sim oracle's.
  * Lint and CLI: the VMCU301 / VMCU303 messages, and CI's partial smoke
    line and ``--partial sideways``: stdout and exit code.
  * Sliced execution: the committed sliced ImageNet plan, loaded by the
    port and run on the CPU, bitwise equal to the reference's golden
    (outputs, int8 outputs, final pools); every sliced op within the
    checks of its kernel and its tiling (``tests/test_torch_sliced_tiles.py``
    holds them on the CPU models of the kernels).  Port only: VWW int8 sliced with ``force=4`` bitwise equal to
    unsliced under shared qparams; ResNet-8 fp32 with ``partial=4``
    within the fp32 tolerance of unsliced.
"""
import contextlib
import dataclasses
import hashlib
import io
import pathlib
import re

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.analysis import lint_program as ref_lint_program
from repro.cli import main as ref_compile_main
from repro.compile.driver import _resolve_net as ref_resolve_net
from repro.graph.netplan import _plan_net as ref_plan_net
from repro.partial import (PartialLowerError as RefPartialLowerError,
                           PartialPlanError as RefPartialPlanError)
from repro.partial import apply_partial as ref_apply_partial
from repro.partial import candidate as ref_candidate
from repro.partial import chain_range as ref_chain_range
from repro.partial import chain_steps as ref_chain_steps
from repro.partial import estimate_slices as ref_estimate_slices
from repro.partial import live_spans as ref_live_spans
from repro.partial import pareto as ref_pareto
from repro.partial import plan_partial as ref_plan_partial
from repro.partial import slice_group_ops as ref_slice_group_ops
from repro.partial import slice_layout as ref_slice_layout
from repro.partial.slicer import even_bounds as ref_even_bounds
from repro_torch.analysis import lint_artifact, verify_program
from repro_torch.analysis.lint import lint_program
from repro_torch.cli import main as compile_main
from repro_torch.compile import artifact
from repro_torch.compile.driver import (CompileError, SRAMBudgetError,
                                        _resolve_net)
from repro_torch.core.executors import op_kernel_call, run_program
from repro_torch.graph.netplan import _plan_net
from repro_torch.graph.run import QuantizedNet, certify_net
from repro_torch.kernels import PLAIN
from repro_torch.kernels.conv2d import conv_tiling
from repro_torch.kernels.quantized import add_needs_barrier, pool_q_tiling
from repro_torch.partial import (PartialLowerError, PartialPlanError,
                                 apply_partial, candidate, chain_range,
                                 chain_steps, estimate_slices, live_spans,
                                 pareto, plan_partial, program_macs,
                                 recompute_spans, slice_group_ops,
                                 slice_layout)
from repro_torch.partial.slicer import even_bounds
from repro_torch.quant.qtensor import QParams, quantize

ASSETS = pathlib.Path(artifact.__file__).parents[1] / "assets"
SLICED = ASSETS / "mcunet-320kb-imagenet.cortex-m4.int8.sliced"
M4 = repro_torch.get_target("cortex-m4")
RTOL, ATOL_REL = 3e-4, 3e-5
#: CI's partial-execution smoke (``.github/workflows/ci.yml``), the
#: port's twin of ``vmcu-compile``'s arguments.
CI_PARTIAL = ["mcunet-320kb-imagenet", "--target", "cortex-m7", "--dtype",
              "int8", "--partial", "auto", "--no-quantize", "--certify",
              "static"]
_SECONDS = re.compile(r"(?m)^(    pass \S+)\s+\d+\.\d+s ")


def _byte_plans(net):
    """The port's and the reference's int8 byte-ring plans of ``net`` on
    the M4 (the geometry the partial policy slices)."""
    kw = dict(dtype="int8", fused_exec=False, **M4.byte_ring_kwargs)
    return (_plan_net(_resolve_net(net), **kw),
            ref_plan_net(ref_resolve_net(net), **kw))


def _ranges(plan):
    return [(g.op_lo, g.op_hi) for g in plan.groups]


@pytest.fixture(scope="module")
def vww():
    return _byte_plans("mcunet-5fps-vww")


@pytest.fixture(scope="module")
def imagenet():
    """The one ImageNet reference fixture of this file: both byte plans,
    and both ``plan_partial(..., "auto")`` results on the M4."""
    have, want = _byte_plans("mcunet-320kb-imagenet")
    return (have, want, plan_partial(have.program, _ranges(have),
                                     M4.sram_bytes),
            ref_plan_partial(want.program, _ranges(want), M4.sram_bytes))


def _asdict(obj):
    return dataclasses.asdict(obj) if obj is not None else None


# ---------------------------------------------------------------------------
# Geometry: windows, halos, frontier.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,n", [(32, 4), (17, 3), (7, 7), (44, 9), (5, 2)])
def test_even_bounds_equal_the_reference(h, n):
    assert even_bounds(h, n) == ref_even_bounds(h, n)


@pytest.mark.parametrize("net", ["vww", "imagenet"])
def test_chain_ranges_equal_the_reference(net, vww, imagenet):
    have, want = (vww if net == "vww" else imagenet)[:2]
    assert have.program.to_json_dict() == want.program.to_json_dict()
    assert _ranges(have) == _ranges(want)
    sliceable = 0
    for lo, hi in _ranges(want):
        got = chain_range(have.program, lo, hi)
        assert got == ref_chain_range(want.program, lo, hi), (lo, hi)
        sliceable += not isinstance(got, str)
    assert sliceable >= 3


def test_slice_layouts_and_frontiers_equal_the_reference(imagenet):
    """Every sliceable ImageNet chain: its steps, the layout of every
    slice count up to 12, each candidate and the Pareto frontier."""
    have, want = imagenet[:2]
    hp, wp = have.program, want.program
    n_layouts = 0
    for lo, hi in _ranges(want):
        if isinstance(ref_chain_range(wp, lo, hi), str):
            assert pareto(hp, lo, hi) == [] and candidate(hp, lo, hi, 2) \
                is None
            continue
        clo, chi = ref_chain_range(wp, lo, hi)
        steps, ref_steps = chain_steps(hp.ops[clo:chi]), \
            ref_chain_steps(wp.ops[clo:chi])
        assert [dataclasses.asdict(s) for s in steps] == \
            [dataclasses.asdict(s) for s in ref_steps]
        for n in range(1, 13):
            lay, ref_lay = slice_layout(steps, n), \
                ref_slice_layout(ref_steps, n)
            assert _asdict(lay) == _asdict(ref_lay), (lo, n)
            if lay is not None:
                n_layouts += 1
                assert (lay.extra_macs, lay.chain_macs, lay.extra_in_rows) \
                    == (ref_lay.extra_macs, ref_lay.chain_macs,
                        ref_lay.extra_in_rows)
            assert _asdict(candidate(hp, lo, hi, n)) == \
                _asdict(ref_candidate(wp, lo, hi, n))
        for cap in (None, 6):
            assert [c.as_dict() for c in pareto(hp, lo, hi, max_slices=cap)] \
                == [c.as_dict() for c in ref_pareto(wp, lo, hi,
                                                    max_slices=cap)]
        assert candidate(hp, lo, hi, 10 ** 6) is None
    assert n_layouts > 20


@pytest.mark.parametrize("net", ["vww", "imagenet"])
def test_spans_and_estimates_equal_the_reference(net, vww, imagenet):
    have, want = (vww if net == "vww" else imagenet)[:2]
    assert live_spans(have.program.ops) == ref_live_spans(want.program.ops)
    assert recompute_spans(have.program.ops) == \
        have.program.pool_segments
    for sram in (M4.sram_bytes, 100_000, 150_000, 60_000, 10_000):
        assert estimate_slices(have.program, _ranges(have), sram) == \
            ref_estimate_slices(want.program, _ranges(want), sram), sram
        assert estimate_slices(have.program, _ranges(have), sram,
                               max_slices=4) == \
            ref_estimate_slices(want.program, _ranges(want), sram,
                                max_slices=4), sram
    if net == "imagenet":
        assert estimate_slices(have.program, _ranges(have),
                               M4.sram_bytes) >= 2
    else:
        assert estimate_slices(have.program, _ranges(have),
                               M4.sram_bytes) is None


# ---------------------------------------------------------------------------
# Policy: plan_partial auto / force.
# ---------------------------------------------------------------------------

def _same_plan(have, want) -> None:
    assert have.program.to_json_dict() == want.program.to_json_dict()
    assert have.parents == want.parents and have.choices == want.choices
    assert have.summary() == want.summary()
    assert (have.extra_macs, have.extra_read_segments, have.mac_overhead,
            have.net_macs) == (want.extra_macs, want.extra_read_segments,
                               want.mac_overhead, want.net_macs)


def test_plan_partial_auto_on_imagenet_equals_the_reference(imagenet):
    have_plan, _, have, want = imagenet
    _same_plan(have, want)
    s = have.summary()
    assert (s["n_sliced_groups"], s["total_slices"], s["ring_bytes_before"],
            s["ring_bytes_after"]) == (5, 36, 196_416, 125_312)
    assert have.ring_bytes_after <= M4.sram_bytes < have.ring_bytes_before
    assert round(have.mac_overhead, 4) == 0.0722
    assert have.net_macs == program_macs(have_plan.program)
    ops = have.program.ops
    kinds = [op.kind for op in ops]
    assert len(ops) == 158 and {k: kinds.count(k) for k in set(kinds)} == \
        {"conv_pw": 98, "conv_dw": 48, "add": 10, "pool_avg": 1, "gemm": 1}
    assert sum(op.in_row0 > 0 for op in ops) == 31
    assert sum(op.out_op >= 0 for op in ops) == 36
    for i, par in enumerate(have.parents):
        assert ops[i].kind == have_plan.program.ops[par].kind


def test_plan_partial_none_when_the_net_fits(vww):
    have, want = vww
    assert plan_partial(have.program, _ranges(have), M4.sram_bytes) is None
    assert ref_plan_partial(want.program, _ranges(want),
                            M4.sram_bytes) is None


@pytest.mark.parametrize("force", [2, 3, 4, 7])
def test_plan_partial_force_on_vww_equals_the_reference(force, vww):
    have, want = vww
    hp = plan_partial(have.program, _ranges(have), M4.sram_bytes,
                      force=force)
    _same_plan(hp, ref_plan_partial(want.program, _ranges(want),
                                    M4.sram_bytes, force=force))
    assert list(hp.choices.values()) == [force]
    res = verify_program(hp.program)
    assert res.safe is True, [str(d) for d in res.diagnostics]
    sim = certify_net(hp.program)
    assert {k: res.stats[k] for k in ("peak_live", "reads", "writes")} == \
        {"peak_live": sim.peak_live, "reads": sim.reads,
         "writes": sim.writes}


def test_plan_partial_errors_equal_the_reference(vww):
    have, want = vww
    with pytest.raises(PartialPlanError) as got:
        plan_partial(have.program, _ranges(have), M4.sram_bytes,
                     force=10 ** 6)
    with pytest.raises(RefPartialPlanError) as ref:
        ref_plan_partial(want.program, _ranges(want), M4.sram_bytes,
                         force=10 ** 6)
    assert str(got.value) == str(ref.value)
    assert "cannot slice any group" in str(got.value)
    assert issubclass(PartialPlanError, PartialLowerError)
    lo, hi = _ranges(want)[0]
    for args in ((lo, hi, 2), (*_ranges(want)[3], 10 ** 6)):
        with pytest.raises(PartialLowerError) as got:
            slice_group_ops(have.program, *args)
        with pytest.raises(RefPartialLowerError) as ref:
            ref_slice_group_ops(want.program, *args)
        assert str(got.value) == str(ref.value)


def test_apply_partial_equals_the_reference_on_several_groups(imagenet):
    have, want = imagenet[:2]
    chains = [r for r in _ranges(want)
              if not isinstance(ref_chain_range(want.program, *r), str)]
    choices = {chains[0]: 3, chains[-1]: 5}
    hp, hpar = apply_partial(have.program, choices)
    wp, wpar = ref_apply_partial(want.program, choices)
    assert hp.to_json_dict() == wp.to_json_dict() and hpar == wpar


# ---------------------------------------------------------------------------
# The compile pipeline's partial pass, lint and the CLI.
# ---------------------------------------------------------------------------

def _same_compile(have, want) -> None:
    assert have.program.to_json_dict() == want.program.to_json_dict()
    if want.certificate is not None:
        assert artifact.program_sha256(have.program) == \
            want.certificate["program_sha256"]
    assert have.certificate == want.certificate
    assert have.partial == want.partial and have.mcu == want.mcu
    assert [(p.name, p.note) for p in have.passes] == \
        [(p.name, p.note) for p in want.passes]
    hr, wr = have.report(), want.report()
    for r in (hr, wr):
        r["passes"] = [[n, note] for n, _s, note in r["passes"]]
    assert hr == wr
    assert have.flash_bytes_used == want.flash_bytes_used


@pytest.mark.parametrize("target", ["cortex-m4", "cortex-m7"])
def test_partial_compile_of_imagenet_equals_the_reference(target):
    kw = dict(quantize=False, certify="static", partial="auto")
    have = repro_torch.compile("mcunet-320kb-imagenet", target, **kw)
    _same_compile(have, repro.compile("mcunet-320kb-imagenet", target,
                                      **kw))
    note = next(p.note for p in have.passes if p.name == "partial")
    if target == "cortex-m7":
        assert have.partial is None and note.startswith("not needed")
        return
    assert note == ("5 group(s) -> 36 slices; ring 196416 -> 125312 B, "
                    "+7.2% MACs")
    assert have.mcu["partial"]["total_slices"] == 36
    assert have.report()["fits_sram"] is True
    assert have.certificate["clobbers"] == 0
    assert len(have.program.ops) == 158


def test_forced_partial_compile_of_vww_equals_the_reference(tmp_path):
    """VWW fits, yet ``partial=4`` slices its pinning group; the sliced
    plan is proven statically, saved, linted clean and loaded back."""
    kw = dict(quantize=False, certify="static", partial=4)
    have = repro_torch.compile("mcunet-5fps-vww", "cortex-m4", **kw)
    _same_compile(have, repro.compile("mcunet-5fps-vww", "cortex-m4", **kw))
    assert have.partial["total_slices"] == 4
    path = str(tmp_path / "vww.sliced.json")
    have.save(path)
    rep = lint_artifact(path)
    assert rep.clean and rep.result.safe is True
    back = repro_torch.load(path)
    assert back.partial == have.partial
    assert back.certificate == have.certificate
    assert back.report()["deploy_bytes"] == have.report()["deploy_bytes"]


def test_compile_refusals_equal_the_reference():
    cases = [("ds-cnn", "cortex-m4", dict(dtype="int8", quantize=False,
                                          partial="sideways")),
             ("ds-cnn", "cortex-m4", dict(dtype="float32", fused_exec=True,
                                          partial="auto")),
             ("mcunet-5fps-vww", "cortex-m4", dict(quantize=False,
                                                   partial=10 ** 6)),
             ("mcunet-320kb-imagenet", "cortex-m4", dict(quantize=False))]
    errors = (ValueError, CompileError, SRAMBudgetError, SRAMBudgetError)
    for (net, target, kw), err in zip(cases, errors):
        with pytest.raises(err) as have:
            repro_torch.compile(net, target, **kw)
        with pytest.raises(Exception) as want:
            repro.compile(net, target, **kw)
        assert type(have.value).__name__ == type(want.value).__name__
        assert str(have.value) == str(want.value)
    assert "partial='auto'" in str(have.value)


def test_lint_vmcu301_and_vmcu303_messages_equal_the_reference(vww,
                                                               imagenet):
    """The advisory through ``lint_program`` and through the compile's
    lint pass on unsliced ImageNet in the byte geometry with the gate
    off, where the estimate is the partial policy's (36 slices)."""
    have, want = vww
    for est in (7, None):
        kw = dict(deploy_bytes=200_000, bottleneck_group="mb5",
                  partial_slices=est)
        got = [str(d) for d in lint_program(have.program, "cortex-m4", **kw)]
        assert got == [str(d) for d in ref_lint_program(want.program,
                                                        "cortex-m4", **kw)]
        assert any("VMCU301" in d and "fusion group 'mb5'" in d for d in got)
        assert any("VMCU303" in d and "est. 7 slice(s)" in d
                   for d in got) == (est == 7)
    kw = dict(seg_width=1, block_rows=None, quantize=False,
              check_budget=False, certify=False)
    h = repro_torch.compile("mcunet-320kb-imagenet", "cortex-m4", **kw)
    w = repro.compile("mcunet-320kb-imagenet", "cortex-m4", **kw)
    _same_compile(h, w)
    note = next(p.note for p in h.passes if p.name == "lint")
    est = estimate_slices(imagenet[0].program, _ranges(imagenet[0]),
                          M4.sram_bytes)
    assert "VMCU301" in note and "VMCU303" in note
    assert est == 36 and f"est. {est} slice(s)" in note


def _call(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, _SECONDS.sub(r"\1 ", out.getvalue()), err.getvalue()


@pytest.mark.parametrize("argv,code", [
    (CI_PARTIAL, 0), (CI_PARTIAL[:2] + ["cortex-m4"] + CI_PARTIAL[3:], 0),
    (["--partial", "sideways"], 2)], ids=["ci", "m4-auto", "sideways"])
def test_cli_partial_lines_equal_the_reference(argv, code):
    have, want = _call(compile_main, argv), _call(ref_compile_main, argv)
    assert have[:2] == want[:2], (have[2], want[2])
    assert have[0] == code
    if code == 2:
        assert "--partial" in have[2]
    else:
        assert "pass partial" in have[1] and "static proof" in have[1]


# ---------------------------------------------------------------------------
# Sliced execution.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sliced():
    cn = repro_torch.load(str(SLICED) + ".json")
    with np.load(str(SLICED) + ".golden.npz") as g:
        return cn, {k: g[k] for k in g.files}


def test_the_sliced_asset_runs_bitwise_equal_to_its_golden(sliced):
    cn, g = sliced
    y = cn.run(g["x"], device="cpu")
    assert np.array_equal(y.numpy(), g["y"])
    qparams = artifact.to_device(cn.qnet.qparams, "cpu")
    for i, xi in enumerate(torch.from_numpy(g["x"])):
        y_q, pool = run_program(cn.program,
                                quantize(xi, QParams(scale=cn.qnet.in_scale)),
                                qparams,
                                kernel_block_rows=cn.target.kernel_block_rows)
        assert np.array_equal(y_q.numpy(), g["y_q"][i])
        assert hashlib.sha256(pool.array.numpy().tobytes()).hexdigest() \
            == g["pool_sha256"][i]
    assert cn.partial["total_slices"] == 36
    assert cn.report()["fits_sram"] is True


def test_every_sliced_op_passes_its_kernel_checks_and_tiling(sliced):
    """Each window op's base (``in_row0`` rows past its source, possibly
    at or past ``n_segments``) meets its wrapper's alignment checks (the
    plain version runs them), its pw row block does not wrap, and its
    tiling takes it; the adds need no barrier and the pool fits one
    CTA."""
    cn, _ = sliced
    prog = cn.program
    n = prog.n_segments
    params = artifact.to_device(cn.qnet.qparams, "cpu")
    windows = 0
    for op, p in zip(prog.ops, params):
        name, args, kw = op_kernel_call(
            prog, op, p, kernel_block_rows=cn.target.kernel_block_rows)
        PLAIN[name](torch.zeros((n, prog.seg_width), dtype=torch.int8),
                    *args, **kw)
        if name in ("ring_conv_pw_q", "ring_conv_dw_q"):
            assert conv_tiling(name, kw).ctas >= 4
        if name == "ring_conv_pw_q" and kw["row_block"] > 1:
            ic = op.w_in * -(-op.d_in // prog.seg_width)
            assert n % (kw["row_block"] * ic) == 0
            assert kw["in_ptr"] % (kw["row_block"] * ic) == 0
        if name == "ring_add_q":
            assert not add_needs_barrier(n, kw["rows"], kw["d"],
                                         kw["in_ptr"] % n,
                                         kw["aux_ptr"] % n,
                                         kw["out_ptr"] % n)
        if name == "ring_avgpool_q":
            assert pool_q_tiling(kw["h"], kw["w"], kw["c"]).threads > 0
        if op.in_row0:
            windows += 1
            assert kw["in_ptr"] == op.in_ptr + op.in_row0 * op.w_in * \
                -(-op.d_in // prog.seg_width)
    assert windows == 31


def _vww_sliced_pair():
    """The VWW int8 asset and its sliced twin: ``force=4`` on the port's
    byte plan, applied to the asset's program, each op's qparams shared
    across its slices."""
    cn = repro_torch.load(str(ASSETS / "mcunet-5fps-vww.cortex-m4.int8.json"))
    plan = _byte_plans("mcunet-5fps-vww")[0]
    pp = plan_partial(plan.program, _ranges(plan), M4.sram_bytes, force=4)
    prog, parents = apply_partial(cn.qnet.program, pp.choices)
    q = cn.qnet
    sliced = QuantizedNet(plan=None, program=prog, params=None,
                          qparams=[q.qparams[i] for i in parents],
                          act_scales=q.act_scales)
    return cn, dataclasses.replace(cn, program=prog, qnet=sliced)


def test_int8_vww_sliced_is_bitwise_the_unsliced():
    cn, sl = _vww_sliced_pair()
    assert len(sl.program.ops) > len(cn.program.ops)
    assert certify_net(sl.program).peak_live > 0      # zero clobbers
    with np.load(ASSETS / "mcunet-5fps-vww.cortex-m4.int8.golden.npz") as g:
        x, want = g["x"][:3], g["y"][:3]
    ys = sl.run(x, device="cpu").numpy()
    assert np.array_equal(ys, cn.run(x, device="cpu").numpy())
    assert np.array_equal(ys, want)


def test_fp32_resnet_8_sliced_is_within_the_tolerance_of_unsliced():
    """``partial=4`` on ResNet-8's k x k chain: the slices' halos
    recompute the boundary rows.  The port's CPU path also gives the
    same bits (the reference's test asks for that of its own
    backends)."""
    kw = dict(dtype="float32", fused_exec=False, certify=False,
              check_budget=False)
    u = repro_torch.compile("resnet-8", "cortex-m4", **kw)
    s = repro_torch.compile("resnet-8", "cortex-m4", partial=4, **kw)
    assert s.partial["total_slices"] == 4
    x = np.random.default_rng(0).standard_normal(
        (u.program.in_rows, u.program.in_dim), np.float32)
    yu = u.run(x, device="cpu").numpy()
    ys = s.run(x, device="cpu").numpy()
    np.testing.assert_allclose(ys, yu, rtol=RTOL,
                               atol=ATOL_REL * np.abs(yu).max())
    assert np.array_equal(ys, yu)
