"""The port's C code generator (``repro_torch.core.codegen``) and
``CompiledNet.emit_c`` held against the reference's on the CPU, byte for
byte.

  * The goldens under ``tests/golden/``: ``mini_*``, ``fused_*`` and
    ``qmini_*`` from the programs and qparams ``tests/test_codegen.py``
    builds (rebuilt here by the port's planner, which must give the same
    programs), and ``vww/`` and ``resnet8/`` from the port's own
    planner-only compiles, with no unit missing and none left over.
  * The reference's ``emit_c()`` with requant tables on each committed
    int8 plan, loaded by both packages (the reference's tables, since the
    port's own calibration is not bitwise), and its
    ``emit_c(geometry_only=True)`` on every registered net x target.
  * ``emit_fc_kernel`` / ``validate_kernel_source`` on the reference's
    grid, ``emit_c(outdir)`` writing the same files, and the reference's
    errors.
"""
import dataclasses
import json
import pathlib

import pytest
from hypothesis import given, settings, strategies as st

import repro
import repro_torch
from repro.core import codegen as ref_codegen
from repro.core.planner import plan_gemm as ref_plan_gemm
from repro.core.program import PoolProgram as RefPoolProgram
from repro_torch.compile import artifact
from repro_torch.compile.driver import CompileError
from repro_torch.core.codegen import (INTRINSICS, emit_fc_kernel,
                                      emit_program, validate_kernel_source)
from repro_torch.core.graph_planner import MCUNET_5FPS_VWW
from repro_torch.core.planner import plan_gemm
from repro_torch.core.program import (AvgPoolSpec, ConvDWSpec, ConvPWSpec,
                                      ElementwiseSpec, FusedMLPSpec,
                                      GemmSpec, IBModuleSpec, PoolProgram,
                                      ResidualAddSpec, plan_module_program,
                                      plan_program)

import test_codegen as ref_tests

GOLDEN = pathlib.Path(__file__).parent / "golden"
ASSETS = pathlib.Path(artifact.__file__).parents[1] / "assets"
INT8_PLANS = sorted(ASSETS.glob("*.cortex-m4.int8.json"))
TARGETS = ("cortex-m4", "cortex-m7", "host-sim")


def _mini_net_program():
    """The port's build of ``test_codegen._mini_net_program``."""
    H, C, CM = 6, 32, 48
    return plan_program(H * H, C,
                        [ConvPWSpec(H, H, C, CM, activation="relu"),
                         ConvDWSpec(H, H, CM, rs=3, activation="relu"),
                         ConvPWSpec(H, H, CM, C),
                         ResidualAddSpec(3),
                         AvgPoolSpec(H, H, C),
                         GemmSpec(4)],
                        block_rows=1)


def _fused_program():
    return plan_program(400, 16, [IBModuleSpec(MCUNET_5FPS_VWW[0])],
                        block_rows=1)


def _same_golden_dir(units: dict, golden_dir: pathlib.Path) -> None:
    assert {p.name for p in golden_dir.glob("*.c")} == set(units)
    for name, src in units.items():
        assert src == (golden_dir / name).read_text(), name


def _ref_load(path: pathlib.Path, tmp: pathlib.Path):
    """The reference's ``load`` of a committed int8 plan, which it reads
    with the fp32 ``params`` key back (as ``None``)."""
    payload = json.loads(path.read_text())
    payload.setdefault("params", None)
    copy = tmp / path.name
    copy.write_text(json.dumps(payload))
    return repro.load(str(copy))


# ---------------------------------------------------------------------------
# The goldens.
# ---------------------------------------------------------------------------

def test_the_port_builds_the_golden_programs_of_the_reference():
    assert _mini_net_program().to_json_dict() \
        == ref_tests._mini_net_program().to_json_dict()
    assert _fused_program().to_json_dict() \
        == ref_tests._fused_program().to_json_dict()


def test_mini_and_fused_units_match_the_golden_files():
    units = emit_program(_mini_net_program(), "mini")
    units.update(emit_program(_fused_program(), "fused"))
    assert len(units) == 7
    for name, src in units.items():
        assert src == (GOLDEN / name).read_text(), name


def test_quantized_units_match_the_golden_files():
    ref_prog, qparams = ref_tests._quantized_program_and_qparams()
    prog = _mini_net_program().with_dtype("int8")
    assert prog.to_json_dict() == ref_prog.to_json_dict()
    units = emit_program(prog, "qmini", quant=qparams)
    assert len(units) == 6
    for name, src in units.items():
        assert src == (GOLDEN / name).read_text(), name
    assert "static const int32_t op00_conv_pw_mult[48]" \
        in units["qmini_op00_conv_pw.c"]


@pytest.mark.parametrize("net,name", [("mcunet-5fps-vww", "vww"),
                                      ("resnet-8", "resnet8")])
def test_net_geometry_units_match_the_golden_dirs(net, name):
    cn = repro_torch.compile(net, "cortex-m4", quantize=False,
                             certify=False)
    _same_golden_dir(cn.emit_c(geometry_only=True, name=name),
                     GOLDEN / name)


# ---------------------------------------------------------------------------
# emit_c against the reference's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", INT8_PLANS, ids=lambda p: p.stem)
def test_requant_units_of_the_committed_int8_plans_are_the_references(
        path, tmp_path):
    have_cn = repro_torch.load(str(path))
    want_cn = _ref_load(path, tmp_path)
    have, want = have_cn.emit_c(), want_cn.emit_c()
    assert list(have) == list(want)
    assert have == want
    assert any("_mult[" in src for src in have.values())
    assert have_cn.emit_c(idiom=None, name="x") \
        == want_cn.emit_c(idiom=None, name="x")
    assert have_cn.emit_c(geometry_only=True) \
        == want_cn.emit_c(geometry_only=True)


@pytest.mark.parametrize("target", TARGETS)
def test_geometry_units_of_the_zoo_are_the_references(target):
    n = 0
    kw = dict(quantize=False, certify=False, check_budget=False,
              lint=False)
    for net in repro.available_nets() + ("stream",):
        if net == "stream":
            have = repro_torch.compile("ds-cnn", target, streaming=True, **kw)
            want = repro.compile("ds-cnn", target, streaming=True, **kw)
        else:
            have = repro_torch.compile(net, target, **kw)
            want = repro.compile(net, target, **kw)
        assert have.emit_c(geometry_only=True) \
            == want.emit_c(geometry_only=True), net
        n += 1
    assert n == len(repro.available_nets()) + 1


def test_float_units_are_the_references():
    """A float plan emits its full units without requant tables."""
    have = repro_torch.compile("ds-cnn", "host-sim", certify=False)
    want = repro.compile("ds-cnn", "host-sim", certify=False)
    assert have.emit_c() == want.emit_c()
    assert have.emit_c(idiom="mve") == want.emit_c(idiom="mve")


def test_emit_c_writes_the_reference_files(tmp_path):
    path = ASSETS / "resnet-8.cortex-m4.int8.json"
    have = repro_torch.load(str(path)).emit_c(tmp_path / "port")
    want = _ref_load(path, tmp_path).emit_c(tmp_path / "ref")
    assert have == want
    files = {p.name: p.read_text() for p in (tmp_path / "port").iterdir()}
    assert files == {p.name: p.read_text()
                     for p in (tmp_path / "ref").iterdir()}
    assert files == have


def test_emit_c_refuses_as_the_reference():
    """A planner-only int8 compile has no requant tables to bake; a
    plan-only program has no kernel loop; a quantized program needs one
    qparam entry per op; an unknown idiom is named."""
    have = repro_torch.compile("ds-cnn", "cortex-m4", quantize=False)
    want = repro.compile("ds-cnn", "cortex-m4", quantize=False)
    with pytest.raises(CompileError) as h:
        have.emit_c()
    with pytest.raises(Exception) as w:
        want.emit_c()
    assert str(h.value) == str(w.value)
    from repro.core.graph_planner import MCUNET_5FPS_VWW as REF_VWW
    from repro.core.program import plan_module_program as ref_module

    ref_prog, qparams = ref_tests._quantized_program_and_qparams()
    prog = PoolProgram.from_json_dict(ref_prog.to_json_dict())
    cases = [
        ((plan_module_program(MCUNET_5FPS_VWW[0]),), {},
         (ref_module(REF_VWW[0]),), {}),
        ((prog, "q"), {}, (ref_prog, "q"), {}),
        ((prog, "q"), dict(quant=qparams[:-1]),
         (ref_prog, "q"), dict(quant=qparams[:-1])),
        ((_mini_net_program(),), dict(idiom="thumb"),
         (ref_tests._mini_net_program(),), dict(idiom="thumb")),
    ]
    for args, kw, ref_args, ref_kw in cases:
        with pytest.raises(ValueError) as h:
            emit_program(*args, **kw)
        with pytest.raises(ValueError) as w:
            ref_codegen.emit_program(*ref_args, **ref_kw)
        assert str(h.value) == str(w.value)


def test_fused_mlp_and_elementwise_units_are_the_references():
    from repro.core.program import ElementwiseSpec as RefEw
    from repro.core.program import FusedMLPSpec as RefMlp
    from repro.core.program import plan_program as ref_plan_program

    prog = plan_program(8, 256, [FusedMLPSpec(512, ff_tile=256),
                                 ElementwiseSpec("relu")], block_rows=8)
    ref = ref_plan_program(8, 256, [RefMlp(512, ff_tile=256),
                                    RefEw("relu")], block_rows=8)
    units = emit_program(prog, "mlp")
    assert units == ref_codegen.emit_program(ref, "mlp")
    assert "d_ff=512" in units["mlp_op00_fused_mlp.c"]


def test_a_sliced_op_bakes_its_row_window_as_the_reference():
    """Fields of partial execution (a row window of a held source) are
    formatted as the reference formats them."""
    prog = _mini_net_program()
    ops = list(prog.ops)
    ops[0] = dataclasses.replace(ops[0], in_row0=2, hold_input=True)
    ops[1] = dataclasses.replace(ops[1], in_row0=1)
    prog = dataclasses.replace(prog, ops=tuple(ops))
    ref = RefPoolProgram.from_json_dict(prog.to_json_dict())
    assert emit_program(prog, "s") == ref_codegen.emit_program(ref, "s")


# ---------------------------------------------------------------------------
# The Fig.-4 FC kernel.
# ---------------------------------------------------------------------------

def test_emitted_fc_kernel_structure():
    plan = plan_gemm(4, 2, 3, segment_bytes=16)
    src = emit_fc_kernel(plan, 4, 2, 3)
    assert validate_kernel_source(src)
    for name in INTRINSICS:
        assert name in src
    assert f"In@{plan.delta}" in src and "Out@0" in src
    assert src == ref_codegen.emit_fc_kernel(
        ref_plan_gemm(4, 2, 3, segment_bytes=16), 4, 2, 3)
    with pytest.raises(ValueError) as h:
        emit_fc_kernel(plan, 5, 2, 3)
    with pytest.raises(ValueError) as w:
        ref_codegen.emit_fc_kernel(ref_plan_gemm(4, 2, 3, segment_bytes=16),
                                   5, 2, 3)
    assert str(h.value) == str(w.value)


@settings(derandomize=True, database=None, max_examples=40, deadline=None)
@given(st.integers(1, 6), st.integers(1, 6), st.integers(1, 6),
       st.sampled_from([8, 16]), st.sampled_from([(16, 2), (4, 4)]))
def test_fc_kernel_equals_the_reference_for_any_plan(m, n, k, seg, lanes):
    src = emit_fc_kernel(plan_gemm(m, n, k, segment_bytes=seg), m, n, k,
                         lane_ki=lanes[0], lane_ni=lanes[1])
    want = ref_codegen.emit_fc_kernel(
        ref_plan_gemm(m, n, k, segment_bytes=seg), m, n, k,
        lane_ki=lanes[0], lane_ni=lanes[1])
    assert src == want
    assert validate_kernel_source(src)
    assert INTRINSICS == ref_codegen.INTRINSICS


def test_validate_kernel_source_is_the_references():
    good = emit_fc_kernel(plan_gemm(2, 2, 2, segment_bytes=8), 2, 2, 2)
    sources = [good, good.replace("RAMFree", "Free"),
               good.replace("WRAP(", "("), "",
               good.replace("RAMStore(Pool", "Store(Pool"),
               "RAMFree(Pool, WRAP(0)) RAMStore(Pool, WRAP(0)) "
               "RAMLoad(Pool, WRAP(0)) RegAlloc FlashLoad Dot"]
    sources += list(emit_program(_mini_net_program(), "mini").values())
    for src in sources:
        assert validate_kernel_source(src) \
            == ref_codegen.validate_kernel_source(src)
    assert validate_kernel_source(good)
    assert not validate_kernel_source(sources[-7])
