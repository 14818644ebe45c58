"""The port's fp32 ring path against the reference, on the CPU.

* Each fp32 plain version (``repro_torch.kernels.PLAIN``: ``ring_gemm``,
  ``ring_conv_pw``, ``ring_conv_dw``, ``ring_conv_k2d``, ``ring_add``,
  ``ring_avgpool``) against the reference's Pallas kernel in interpret
  mode, from the same seeded pool and weights: on every op of the fp32
  ``host-sim`` plans of DS-CNN, ResNet-8 and ToyADMOS (ten FC layers,
  nine in place), with their real weights, and on ``F32_EDGE_CASES``.
* ``ACTIVATIONS`` against the reference's (``jax.nn``) over a grid.
* The three whole nets: ``repro_torch.load(asset).run(x, device="cpu")`` and
  its final pool against the reference's Pallas path on the same
  artifact, and the port's ``reference_forward`` against the JAX one.

Tolerance, everywhere: ``|got - want| <= 3e-5 * max|want| + 3e-4 *
|want|`` (``repro_torch.kernels.cases.RTOL``/``ATOL_REL``, the
reference's conformance-matrix rule) on the live channels; channel
tails and lanes no op writes are held exactly.
"""
import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core.executors import _pw_row_block as ref_pw_row_block
from repro.core.executors import run_program as ref_run_program
from repro.core.program import ACTIVATIONS as REF_ACTIVATIONS
from repro.graph.run import reference_forward as ref_reference_forward
from repro.kernels import conv2d as ref_conv2d
from repro.kernels import segment_matmul as ref_segment_matmul
from repro_torch import load
from repro_torch.compile.artifact import to_device
from repro_torch.core.executors import _pw_row_block, execute, run_program
from repro_torch.core.program import ACTIVATIONS, PoolOp, PoolProgram, \
    resolve_activation
from repro_torch.graph.run import reference_forward
from repro_torch.kernels import KERNELS, PLAIN, launch_counts
from repro_torch.kernels.cases import (ATOL_REL, F32_EDGE_CASES, RTOL,
                                       case_inputs, compare_f32, live_lanes,
                                       output_regions, program_cases,
                                       program_live_lanes)
from repro_torch.kernels.segment_matmul import aligned_pool_geometry

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
NETS = ("ds-cnn", "resnet-8", "ad-toyadmos")
F32_KERNELS = ("ring_gemm", "ring_conv_pw", "ring_conv_dw", "ring_conv_k2d",
               "ring_add", "ring_avgpool")


def _artifact(name):
    return ASSETS / f"{name}.host-sim.float32.json"


def _golden(name):
    with np.load(ASSETS / f"{name}.host-sim.float32.golden.npz") as g:
        return {k: g[k] for k in g.files}


def _plan_cases(name):
    cn = load(_artifact(name))
    return program_cases(cn.program, cn.params,
                         kernel_block_rows=cn.target.kernel_block_rows,
                         prefix=f"{name}_f32_")


PLAN_CASES = {n: _plan_cases(n) for n in NETS}
CASES = F32_EDGE_CASES + sum(PLAN_CASES.values(), ())


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL_REL * scale)


def _reference_kernel(name):
    return getattr(ref_conv2d, name, None) \
        or getattr(ref_segment_matmul, name)


def _plain_pool(case, pool, params):
    p = torch.from_numpy(pool.copy())
    PLAIN[case.kernel](p, *(torch.from_numpy(a) for a in params),
                       **case.kwargs)
    return p.numpy()


# ---------------------------------------------------------------------------
# Activations.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(REF_ACTIVATIONS))
def test_activation_matches_the_reference(name):
    x = np.concatenate([np.linspace(-12, 12, 4801, dtype=np.float32),
                        np.float32([0.0, -0.0, 1e-6, -1e-6, 88.0, -88.0])])
    want = np.asarray(REF_ACTIVATIONS[name](jnp.asarray(x)))
    got = ACTIVATIONS[name](torch.from_numpy(x)).numpy()
    # Tighter than the kernels' tolerance, so that the erf gelu (up to
    # 1.5e-4 away) fails; the 1e-6 floor covers the cancellation in
    # gelu's 1 + tanh(z) far below 0, where each library's tanh rounds
    # to its own last bit.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[4801] == 0.0           # 0 -> 0 keeps segment padding zero


def test_gelu_is_the_tanh_approximation_and_names_resolve():
    x = torch.tensor([1.5])
    tanh = torch.nn.functional.gelu(x, approximate="tanh")
    erf = torch.nn.functional.gelu(x)
    assert resolve_activation("gelu")(x) == tanh != erf
    assert resolve_activation(None) is ACTIVATIONS["identity"]
    with pytest.raises(ValueError, match="unknown activation"):
        resolve_activation("tanh")


# ---------------------------------------------------------------------------
# Kernels: plain versions against the Pallas kernels.
# ---------------------------------------------------------------------------

def test_cases_cover_the_six_kernels_every_op_and_every_activation():
    assert {c.kernel for c in CASES} == set(F32_KERNELS)
    assert set(F32_KERNELS) <= set(KERNELS) == set(PLAIN)
    assert [len(PLAN_CASES[n]) for n in NETS] == [11, 14, 10]
    assert {c.kernel for c in PLAN_CASES["ds-cnn"]} == set(F32_KERNELS) \
        - {"ring_add"}
    assert {c.kernel for c in PLAN_CASES["resnet-8"]} == set(F32_KERNELS) \
        - {"ring_conv_dw"}
    acts = {(c.kernel, c.kwargs.get("activation")) for c in F32_EDGE_CASES}
    for kernel in ("ring_gemm", "ring_conv_pw", "ring_add"):
        assert {"gelu", "silu", "square"} <= {a for k, a in acts
                                              if k == kernel}
    # the stem's input read wraps the 500-segment ring
    stem = PLAN_CASES["ds-cnn"][0].kwargs
    assert stem["in_ptr"] + stem["h_in"] * stem["w_in"] > 500


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_plain_version_matches_pallas_kernel(case):
    pool, params = case_inputs(case, seed=0)
    assert pool.dtype == np.float32
    fn = _reference_kernel(case.kernel)
    want = np.asarray(fn(jnp.asarray(pool), *(jnp.asarray(a) for a in params),
                         **case.kwargs, interpret=True))
    got = _plain_pool(case, pool, params)
    assert not np.array_equal(want, pool), "the kernel stored nothing"
    live = live_lanes(case.n_seg, output_regions(case.kernel, case.kwargs))
    err, bad = compare_f32(got, want, live)
    assert bad is None, bad


def test_compare_f32_holds_tails_and_unwritten_lanes_exactly():
    (case,) = [c for c in F32_EDGE_CASES if c.name == "f32_gemm_wrap_silu"]
    pool, params = case_inputs(case, seed=0)
    want = _plain_pool(case, pool, params)
    live = live_lanes(case.n_seg, output_regions(case.kernel, case.kwargs))
    assert compare_f32(want, want, live) == (0.0, None)
    for seg, lane, what in ((4, 3, "a live lane"),
                            (4, 100, "a channel tail"),
                            (0, 0, "an unwritten lane")):
        got = want.copy()
        got[seg, lane] = want[seg, lane] + 1e-3 if what == "a live lane" \
            else np.nextafter(want[seg, lane], np.float32(np.inf))
        _, bad = compare_f32(got, want, live)
        assert bad is not None and f"segment {seg}" in bad
    got = want.copy()
    got[4, 3] *= 1 + RTOL / 2          # inside the tolerance
    assert compare_f32(got, want, live)[1] is None


@pytest.mark.parametrize("case", F32_EDGE_CASES[::3],
                         ids=lambda c: c.name)
def test_wrapper_refuses_cpu_tensors(case):
    pool, params = case_inputs(case, seed=0)
    p = torch.from_numpy(pool.copy())
    before = launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        KERNELS[case.kernel](p, *(torch.from_numpy(a) for a in params),
                             **case.kwargs)
    np.testing.assert_array_equal(p.numpy(), pool)   # no plain fallback
    assert launch_counts() == before


@pytest.mark.parametrize("case", [
    c for c in F32_EDGE_CASES if c.name in (
        "f32_gemm_block_rows_gelu", "f32_pw_stride2_gelu", "f32_dw_valid_s2",
        "f32_k2d_k3_wrap", "f32_add_shifted_gelu", "f32_avgpool_wrap")],
    ids=lambda c: c.kernel)
def test_alignment_errors_match_the_reference(case):
    kernel = case.kernel
    bad = dict(case.kwargs, in_ptr=case.kwargs["in_ptr"] + 1)
    pool, params = case_inputs(case, seed=0)
    with pytest.raises(ValueError, match="align"):
        _reference_kernel(kernel)(jnp.asarray(pool),
                                  *(jnp.asarray(a) for a in params), **bad,
                                  interpret=True)
    for fn in (KERNELS[kernel], PLAIN[kernel]):
        with pytest.raises(ValueError, match="align"):
            fn(torch.from_numpy(pool.copy()),
               *(torch.from_numpy(a) for a in params), **bad)


def test_aligned_pool_geometry_matches_the_reference():
    for args in ((8, 200, 130, 5, 4), (6, 64, 12, 9, 2), (1, 1000, 240, 0, 1)):
        assert aligned_pool_geometry(*args) == \
            ref_segment_matmul.aligned_pool_geometry(*args)


# ---------------------------------------------------------------------------
# Whole nets.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=NETS)
def net(request):
    """``(name, port CompiledNet, reference CompiledNet, golden)``."""
    name = request.param
    return (name, load(_artifact(name)), repro.load(str(_artifact(name))),
            _golden(name))


def test_float_artifacts_load_with_their_params(net):
    name, cn, ref, golden = net
    assert not cn.quantized and cn.qnet is None and cn.dtype == "float32"
    assert cn.target.name == "host-sim" and cn.target.kernel_block_rows == 8
    assert len(cn.params) == len(cn.program.ops)
    assert cn.flash_bytes_used == ref.flash_bytes_used
    assert cn.report()["flash_bytes_used"] == ref.report()["flash_bytes_used"]
    assert "params" in json.loads(_artifact(name).read_text())
    for op, p in zip(cn.program.ops, cn.params):
        if op.kind == "conv_pw":
            iptr = op.in_ptr
            assert _pw_row_block(op, cn.program.n_segments, iptr, 128, 8) \
                == ref_pw_row_block(op, cn.program.n_segments, iptr, 128, 8)


def test_run_and_final_pool_match_the_reference_pallas_path(net):
    """One input through the reference's Pallas kernels (interpret mode)
    and through the port's plain versions, from the same artifact."""
    name, cn, ref, golden = net
    x = golden["x"][0]
    kbr = cn.target.kernel_block_rows
    y_ref, pool_ref = ref_run_program(ref.program, jnp.asarray(x),
                                      ref.params, backend="pallas",
                                      kernel_block_rows=kbr)
    params = to_device(cn.params, "cpu")
    y, pool = run_program(cn.program, torch.from_numpy(x), params,
                          kernel_block_rows=kbr)
    _close(y.numpy(), np.asarray(y_ref))
    _close(np.asarray(y_ref), golden["y"][0])
    live = program_live_lanes(cn.program, cn.params, kernel_block_rows=kbr)
    err, bad = compare_f32(pool.array.numpy(), np.asarray(pool_ref.array),
                           live)
    assert bad is None, bad
    # the channel tails of every live row are exact zeros
    assert not pool.array.numpy()[~live].any()
    assert torch.equal(cn.run(x, device="cpu"), y)


def test_batched_run_matches_golden(net):
    name, cn, ref, golden = net
    y = cn.run(golden["x"], device="cpu")
    assert y.dtype == torch.float32 and y.device.type == "cpu"
    assert tuple(y.shape) == golden["y"].shape
    _close(y.numpy(), golden["y"])


def test_reference_forward_matches_the_jax_one(net):
    name, cn, ref, golden = net
    x = golden["x"][1]
    want = np.asarray(ref_reference_forward(ref.program, jnp.asarray(x),
                                            ref.params))
    got = reference_forward(cn.program, torch.from_numpy(x),
                            to_device(cn.params, "cpu"))
    _close(got.numpy(), want)
    _close(got.numpy(), golden["y"][1])


def test_float_run_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cn = load(_artifact("ds-cnn"))
    x = _golden("ds-cnn")["x"][0]
    with pytest.raises(RuntimeError, match="CUDA"):
        cn.run(x)
    with pytest.raises(RuntimeError, match="CUDA"):
        cn.run(x, device="cuda")
    with pytest.raises(ValueError, match="no stream state"):
        cn.stream(device="cpu")


def test_fp32_executor_refuses_kinds_of_later_slices():
    """Every executable fp32 kind has its kernel now: the elementwise op
    that the port once refused runs (gelu over its whole segment), and a
    plan-only kind is still refused."""
    op = PoolOp(kind="elementwise", in_ptr=0, out_ptr=0, delta=0,
                in_segments=1, out_segments=1, segment_bytes=512, d_in=128,
                d_out=128, activation="gelu")
    program = PoolProgram(m_rows=1, seg_width=128, block_rows=1,
                          n_segments=1, pool_segments=1, elem_bytes=4,
                          ops=(op,))
    x = torch.linspace(-4, 4, 128)[None]
    pool = x.clone()
    execute(program, pool, [None])
    assert torch.equal(pool, ACTIVATIONS["gelu"](x))
    plan_only = dataclasses.replace(
        program, ops=(dataclasses.replace(op, kind="fused_chain"),))
    with pytest.raises(NotImplementedError, match="plan-only"):
        execute(plan_only, torch.zeros((1, 128)), [None])
