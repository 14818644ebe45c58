"""The port's ring addressing, plan IR, target record and artifact loader
against the reference: the same staged segments, the same fields, the
same JSON, the same ``program_sha256``, and the same VMCU403 refusal of
a plan changed after certification."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import repro
from repro.compile import artifact as ref_artifact
from repro.compile.targets import Target as RefTarget
from repro.core import program as ref_program
from repro.core import vpool as ref_vpool
from repro_torch import load
from repro_torch.compile import artifact
from repro_torch.compile.driver import CompileError
from repro_torch.compile.targets import Target
from repro_torch.core import program, vpool

ASSET = (pathlib.Path(__file__).resolve().parents[1] / "src"
         / "repro_torch" / "assets" / "ds-cnn.cortex-m4.int8.json")


def _payload() -> dict:
    return json.loads(ASSET.read_text())


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("port, ref", [
    (program.PoolOp, ref_program.PoolOp),
    (program.PoolProgram, ref_program.PoolProgram),
    (Target, RefTarget),
    (program.ConvPWSpec, ref_program.ConvPWSpec),
    (program.ConvDWSpec, ref_program.ConvDWSpec),
    (program.ConvK2DSpec, ref_program.ConvK2DSpec),
    (program.AvgPoolSpec, ref_program.AvgPoolSpec),
    (program.GemmSpec, ref_program.GemmSpec),
])
def test_dataclass_fields_and_defaults_equal_the_reference(port, ref):
    assert _fields(port) == _fields(ref)


def test_program_json_roundtrip_and_sha_equal_the_reference():
    d = _payload()["program"]
    prog = program.PoolProgram.from_json_dict(d)
    assert prog.to_json_dict() == d
    ref = ref_program.PoolProgram.from_json_dict(d)
    assert json.dumps(prog.to_json_dict()) == json.dumps(ref.to_json_dict())
    sha = artifact.program_sha256(prog)
    assert sha == ref_artifact.program_sha256(ref)
    assert sha == _payload()["certificate"]["program_sha256"]


def test_sha_of_a_program_with_partial_fields_equals_the_reference():
    ref = ref_program.PoolProgram.from_json_dict(_payload()["program"])
    ops = list(ref.ops)
    ops[1] = dataclasses.replace(ops[1], in_row0=3, h_src=25, out_op=4,
                                 out_row0=2, free_src=True)
    ops[4] = dataclasses.replace(ops[4], in_row0=1, h_src=25,
                                 padding="same_mid")
    ref = dataclasses.replace(ref, ops=tuple(ops))
    prog = program.PoolProgram.from_json_dict(ref.to_json_dict())
    assert prog.ops[1].free_src and prog.ops[1].out_op == 4
    assert prog.ops[1].rows_src == ref.ops[1].rows_src == 125
    assert artifact.program_sha256(prog) == ref_artifact.program_sha256(ref)
    assert artifact.program_sha256(prog) != \
        _payload()["certificate"]["program_sha256"]


def test_program_geometry_equals_the_reference():
    d = _payload()["program"]
    prog = program.PoolProgram.from_json_dict(d)
    ref = ref_program.PoolProgram.from_json_dict(d)
    for name in ("executable", "quantized", "pool_bytes",
                 "physical_pool_bytes", "in_dim", "out_dim", "in_rows",
                 "out_rows", "input_ptr", "output_ptr"):
        assert getattr(prog, name) == getattr(ref, name), name
    spec = prog.spec()
    assert (spec.n_segments, spec.seg_width, spec.nbytes) == (500, 128,
                                                              64_000)
    for op, rop in zip(prog.ops, ref.ops):
        assert prog.op_blocks(op) == ref.op_blocks(rop)
        assert op.span_segments == rop.span_segments
        for rb in (1, 5, 25):
            try:
                want = ref_program.op_grid_steps(rop, rb)
            except ValueError:
                with pytest.raises(ValueError):
                    program.op_grid_steps(op, rb)
                continue
            assert program.op_grid_steps(op, rb) == want


def test_load_matches_the_reference_load(tmp_path):
    """The port's artifacts drop the fp32 ``params`` entry, which the
    reference's loader reads; it gets the same artifact with that entry
    null."""
    ref_copy = tmp_path / "with-null-params.json"
    ref_copy.write_text(json.dumps({**_payload(), "params": None}))
    cn, ref = load(ASSET), repro.load(str(ref_copy))
    assert cn.target == Target(**dataclasses.asdict(ref.target))
    assert cn.qnet.act_scales == ref.qnet.act_scales
    assert cn.report() == ref.report()


def test_load_refuses_a_plan_changed_after_certification(tmp_path):
    payload = _payload()
    payload["program"]["ops"][3]["out_ptr"] += 5
    bad = tmp_path / "tampered.json"
    bad.write_text(json.dumps(payload))
    with pytest.raises(CompileError, match="VMCU403"):
        load(bad)
    with pytest.raises(Exception, match="VMCU403"):
        repro.load(str(bad))


def test_load_refuses_other_artifact_kinds(tmp_path):
    payload = _payload()
    payload["kind"] = "something-else"
    bad = tmp_path / "other.json"
    bad.write_text(json.dumps(payload))
    with pytest.raises(ValueError, match="artifact"):
        load(bad)


@pytest.mark.parametrize("ptr, m, d", [(0, 3, 64), (7, 4, 200), (9, 2, 1)])
def test_vpool_stage_and_fetch_equal_the_reference(ptr, m, d):
    rng = np.random.default_rng(ptr)
    pool = rng.integers(-128, 128, (10, 128), dtype=np.int8)
    rows = rng.integers(-128, 128, (m, d), dtype=np.int8)
    want = np.asarray(ref_vpool.stage_rows(pool, rows, ptr))
    got = vpool.stage_rows(torch.from_numpy(pool.copy()),
                           torch.from_numpy(rows), ptr)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        vpool.fetch_rows(got, ptr, m, d).numpy(),
        np.asarray(ref_vpool.fetch_rows(want, ptr, m, d)))
