"""The port's artifact and emitted-C lints (``repro_torch.analysis.lint``)
held against the reference's on the CPU.

  * ``lint_artifact`` on every committed plan, and on a VWW int8
    artifact the reference compiles and saves once for this module: the
    clean one, a tampered one (VMCU403), one retyped to float32 with its
    requant tables kept (VMCU404), and one whose certificate names
    another ring size (VMCU403 on ``n_segments``) — the same
    ``ArtifactReport``: verdict, findings and their text, statistics.
  * ``lint_c_dir`` on the emitted C of that artifact: clean for its
    geometry-only and its full units, then VMCU501/502/503 on a stale, a
    missing and an extra unit, as the reference reports them; VMCU105 on
    a plan-only program.
"""
import json
import pathlib

import pytest

import repro
from repro.analysis import lint_artifact as ref_lint_artifact
from repro.analysis import lint_c_dir as ref_lint_c_dir
from repro_torch.analysis import ArtifactReport, lint_artifact, lint_c_dir
from repro_torch.compile import artifact
from repro_torch.core.program import PoolProgram

ASSETS = pathlib.Path(artifact.__file__).parents[1] / "assets"
PLANS = sorted(ASSETS.glob("*.json"))


def _findings(diags) -> list:
    return [(d.code, d.severity, d.op_index, d.step, d.segment, d.byte,
             str(d)) for d in diags]


def _same_report(have: ArtifactReport, want) -> None:
    assert (have.path, have.net, have.dtype, have.target) \
        == (want.path, want.net, want.dtype, want.target)
    assert have.clean == want.clean
    assert have.result.safe is want.result.safe
    assert _findings(have.result.diagnostics) \
        == _findings(want.result.diagnostics)
    assert _findings(have.result.errors) == _findings(want.result.errors)
    assert have.result.stats == want.result.stats


def _lint_both(path) -> ArtifactReport:
    have = lint_artifact(str(path))
    _same_report(have, ref_lint_artifact(str(path)))
    return have


@pytest.fixture(scope="module")
def vww_int8(tmp_path_factory):
    """The reference's calibrated VWW int8 cortex-m4 compile, certified
    statically and saved once."""
    cn = repro.compile("mcunet-5fps-vww", "cortex-m4", certify="static")
    path = tmp_path_factory.mktemp("vww") / "vww.plan.json"
    cn.save(str(path))
    return cn, path


def _edited(path, tmp_path, name, edit) -> pathlib.Path:
    payload = json.loads(pathlib.Path(path).read_text())
    edit(payload)
    out = tmp_path / name
    out.write_text(json.dumps(payload))
    return out


@pytest.mark.parametrize("path", PLANS, ids=lambda p: p.stem)
def test_committed_plans_lint_clean_as_in_the_reference(path):
    rep = _lint_both(path)
    assert rep.clean and rep.result.safe is True


def test_the_reference_vww_int8_artifact_lints_clean(vww_int8):
    _, path = vww_int8
    rep = _lint_both(path)
    assert rep.clean and rep.result.safe is True
    assert (rep.dtype, rep.net) == ("int8", "mcunet-5fps-vww")


@pytest.mark.parametrize("op", [0, 2, 17])
def test_a_tampered_artifact_is_rejected_as_in_the_reference(vww_int8,
                                                             tmp_path, op):
    def edit(p):
        p["program"]["ops"][op]["out_ptr"] += 1
    rep = _lint_both(_edited(vww_int8[1], tmp_path, "tampered.json", edit))
    codes = {d.code for d in rep.result.errors}
    assert not rep.clean and "VMCU403" in codes


def test_requant_tables_on_a_float_program_are_vmcu404(vww_int8, tmp_path):
    def edit(p):
        p["dtype"] = p["program"]["dtype"] = "float32"
        p["program"]["elem_bytes"] = 4
        for op in p["program"]["ops"]:
            op["segment_bytes"] = 4 * p["program"]["seg_width"]
        p["certificate"] = None
    rep = _lint_both(_edited(vww_int8[1], tmp_path, "retyped.json", edit))
    assert "VMCU404" in {d.code for d in rep.result.errors}


def test_a_certificate_for_another_ring_size_is_vmcu403(vww_int8, tmp_path):
    def edit(p):
        p["certificate"]["n_segments"] += 4
    rep = _lint_both(_edited(vww_int8[1], tmp_path, "ring.json", edit))
    assert [d.code for d in rep.result.errors] == ["VMCU403"]
    assert "n_segments" in str(rep.result.errors[0])


def test_byte_accounting_and_budgets_are_the_references(vww_int8,
                                                        tmp_path):
    """Wrong elem_bytes (VMCU401), a short segment (VMCU402), a deploy
    ring over the SRAM (VMCU301) and a payload over the flash (VMCU302,
    a warning)."""
    def edit(p):
        p["program"]["elem_bytes"] = 2
        p["program"]["ops"][3]["segment_bytes"] -= 1
        p["mcu"]["deploy_bytes"] = p["target"]["sram_bytes"] + 1
        p["target"]["flash_bytes"] = 1000
        p["certificate"] = None
    rep = _lint_both(_edited(vww_int8[1], tmp_path, "budget.json", edit))
    codes = [d.code for d in rep.result.diagnostics]
    assert {"VMCU401", "VMCU402", "VMCU301", "VMCU302"} <= set(codes)


def test_an_unsafe_ring_is_reported_as_by_the_reference(vww_int8,
                                                         tmp_path):
    """A plan edited past its certificate's hash check (the certificate
    dropped): the static proof's own first clobber."""
    def edit(p):
        p["program"]["ops"][0]["out_ptr"] += 1
        p["certificate"] = None
    rep = _lint_both(_edited(vww_int8[1], tmp_path, "unsafe.json", edit))
    assert rep.result.safe is False
    assert rep.result.errors[0].code.startswith("VMCU1")


def test_unreadable_artifacts_raise_as_in_the_reference(tmp_path):
    bad = tmp_path / "x.json"
    for text in ("{}", json.dumps({"kind": "vmcu-compiled-net",
                                   "schema": 9})):
        bad.write_text(text)
        with pytest.raises(ValueError) as h:
            lint_artifact(str(bad))
        with pytest.raises(ValueError) as w:
            ref_lint_artifact(str(bad))
        assert str(h.value) == str(w.value)


def test_emitted_c_lints_as_in_the_reference(vww_int8, tmp_path):
    cn, path = vww_int8
    program = PoolProgram.from_json_dict(cn.program.to_json_dict())
    cdir = tmp_path / "c"
    cn.emit_c(str(cdir), geometry_only=True)
    assert lint_c_dir(program, cdir, name=cn.net_name) == []
    cn.emit_c(str(cdir))                 # full requant units, same plan
    assert lint_c_dir(program, cdir, name=cn.net_name) == []
    assert ref_lint_c_dir(cn.program, cdir, name=cn.net_name) == []

    units = sorted(cdir.glob("*.c"))
    units[0].write_text(units[0].read_text().replace("POOL_SEGS 900",
                                                     "POOL_SEGS 896"))
    units[1].unlink()
    (cdir / "stale_extra_op.c").write_text("// leftover\n")
    (cdir / "stale_extra.h").write_text("// leftover\n")
    have = lint_c_dir(program, cdir, name=cn.net_name)
    want = ref_lint_c_dir(cn.program, cdir, name=cn.net_name)
    assert _findings(have) == _findings(want)
    assert [d.code for d in have] == ["VMCU501", "VMCU502", "VMCU503",
                                      "VMCU503"]
    # another net name: every unit is missing and every file is stray
    have = lint_c_dir(program, cdir, name="other", idiom="mve")
    want = ref_lint_c_dir(cn.program, cdir, name="other", idiom="mve")
    assert _findings(have) == _findings(want)


def test_a_plan_only_program_has_no_c_to_lint(tmp_path):
    from repro.core.graph_planner import MCUNET_5FPS_VWW as REF_VWW
    from repro.core.program import plan_module_program as ref_module
    from repro_torch.core.graph_planner import MCUNET_5FPS_VWW
    from repro_torch.core.program import plan_module_program

    have = lint_c_dir(plan_module_program(MCUNET_5FPS_VWW[1]), tmp_path)
    want = ref_lint_c_dir(ref_module(REF_VWW[1]), tmp_path)
    assert _findings(have) == _findings(want)
    assert [d.code for d in have] == ["VMCU105"]
