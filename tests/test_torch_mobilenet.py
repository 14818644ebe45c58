"""MobileNetV1-0.25 on the port's main path, against the reference on
the CPU.

The committed assets (``tests/test_torch_assets.py --zoo
mobilenetv1-0.25`` writes them) are the reference's
``repro.compile("mobilenetv1-0.25", "cortex-m4")`` (int8: 29 ops on a
9,216-segment ring of 1,179,648 B) and its ``host-sim`` fp32 twin (the
same 29 ops, 4,718,592 B), each with a golden of 2 seeded inputs and the
reference's ``run(x, backend="jnp")`` outputs.  Held here:

* each asset is a fresh reference compile's and each golden a fresh
  reference run's (the reference compiles the two plans once for the
  module: about 21 s and 0.1 s, and runs its goldens in about 15 s);
* the port's plain path, ``load(artifact).run(x, device="cpu")``: the
  int8 float outputs, int8 outputs and final-pool sha256 bitwise; the
  fp32 outputs within rtol 3e-4, atol 3e-5 * max (max |y| is about
  0.0027, so atol is about 8e-8) and each final pool within it of the
  reference's on the live channels, exact on channel tails and
  unwritten lanes.

``chip_smoke.py`` serves both plans on the card against the same goldens.
"""
import pytest

from test_torch_assets import (FLOAT_TARGET, compile_float_reference,
                               compile_reference, hold_fresh_zoo_assets,
                               hold_port_zoo_float, hold_port_zoo_int8,
                               op_kinds)

NET = "mobilenetv1-0.25"


@pytest.fixture(scope="module")
def reference():
    """The reference's int8 and fp32 compiles of the net, made once."""
    return compile_reference(NET), compile_float_reference(NET)


def test_the_assets_are_a_fresh_reference_compile_and_run(reference):
    hold_fresh_zoo_assets(NET, *reference)


def test_the_plans_are_mobilenet_for_the_m4_and_the_host(reference):
    ref_q, ref_f = reference
    kinds = {"conv_dw": 13, "conv_k2d": 1, "conv_pw": 13, "gemm": 1,
             "pool_avg": 1}
    assert op_kinds(ref_q) == op_kinds(ref_f) == kinds
    assert (ref_q.target.name, ref_q.dtype) == ("cortex-m4", "int8")
    assert (ref_f.target.name, ref_f.dtype) == (FLOAT_TARGET, "float32")
    for cn, ring in ((ref_q, 1_179_648), (ref_f, 4_718_592)):
        assert cn.program.n_segments == 9_216
        assert cn.program.pool_bytes == ring


def test_the_port_runs_the_int8_plan_bitwise():
    hold_port_zoo_int8(NET)


def test_the_port_runs_the_fp32_plan_within_the_tolerance(reference):
    hold_port_zoo_float(NET, reference[1])
