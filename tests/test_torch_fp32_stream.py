"""The port's fused inverted bottleneck and fp32 streams against the
reference, on the CPU.

* The plain versions of ``ring_inverted_bottleneck``,
  ``ring_conv_stream`` and ``ring_gru_cell`` against the reference's
  Pallas kernels in interpret mode, from the same seeded pool and
  weights: on every ``ib_fused``, ``conv_stream`` and ``gru_cell`` op of
  the fp32 ``host-sim`` plans of MCUNet-5fps-VWW, the DS-CNN stream and
  the GRU chain, with their real weights, and on
  ``F32_FUSED_STREAM_EDGE_CASES``.
* ``gru_update`` and ``inverted_bottleneck_ref`` against the reference's.
* fp32 VWW served: ``load(asset).run(x, device="cpu")`` and its final
  pool against the reference's Pallas path and the golden, and the
  port's ``reference_forward`` against the JAX one.
* Both fp32 streams: ``load(asset).stream(device="cpu")`` stepped over
  the golden's 60 frames, and reset replays.

Tolerance, everywhere: ``|got - want| <= 3e-5 * max|want| + 3e-4 *
|want|`` (``repro_torch.kernels.cases.RTOL``/``ATOL_REL``) on the live
channels; channel tails and lanes no op writes are held exactly.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.executors import run_program as ref_run_program
from repro.graph.run import reference_forward as ref_reference_forward
from repro.kernels import inverted_bottleneck as ref_ib
from repro.kernels import stream as ref_stream
from repro.quant.requant import gru_update as ref_gru_update
from repro_torch import load
from repro_torch.compile.artifact import to_device
from repro_torch.core.executors import run_program
from repro_torch.graph.run import reference_forward
from repro_torch.kernels import KERNELS, PLAIN, launch_counts
from repro_torch.kernels.cases import (ATOL_REL, F32_FUSED_STREAM_EDGE_CASES,
                                       RTOL, case_inputs, compare_f32,
                                       live_lanes, output_regions,
                                       program_cases, program_live_lanes)
from repro_torch.kernels.inverted_bottleneck import inverted_bottleneck_ref
from repro_torch.quant.requant import gru_update

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
VWW = "mcunet-5fps-vww"
STREAMS = ("ds-cnn-stream", "kws-gru-chain")
KINDS = ("ib_fused", "conv_stream", "gru_cell")
NEW_KERNELS = ("ring_inverted_bottleneck", "ring_conv_stream",
               "ring_gru_cell")


def _artifact(name):
    return ASSETS / f"{name}.host-sim.float32.json"


def _golden(name):
    with np.load(ASSETS / f"{name}.host-sim.float32.golden.npz") as g:
        return {k: g[k] for k in g.files}


def _plan_cases(name):
    cn = load(_artifact(name))
    return program_cases(cn.program, cn.params,
                         kernel_block_rows=cn.target.kernel_block_rows,
                         prefix=f"{name}_f32_", kinds=KINDS)


PLAN_CASES = {n: _plan_cases(n) for n in (VWW,) + STREAMS}
CASES = F32_FUSED_STREAM_EDGE_CASES + sum(PLAN_CASES.values(), ())


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL_REL * scale)


def _reference_kernel(name):
    return getattr(ref_ib, name, None) or getattr(ref_stream, name)


def _plain_pool(case, pool, params):
    p = torch.from_numpy(pool.copy())
    PLAIN[case.kernel](p, *(torch.from_numpy(a) for a in params),
                       **case.kwargs)
    return p.numpy()


# ---------------------------------------------------------------------------
# Kernels: plain versions against the Pallas kernels.
# ---------------------------------------------------------------------------

def test_cases_cover_the_three_kernels_and_every_op_of_their_plans():
    assert {c.kernel for c in CASES} == set(NEW_KERNELS)
    assert set(NEW_KERNELS) <= set(KERNELS) == set(PLAIN)
    assert [c.kernel for c in PLAN_CASES[VWW]] == \
        ["ring_inverted_bottleneck"] * 6
    assert [c.kernel for c in PLAN_CASES["ds-cnn-stream"]] == \
        ["ring_conv_stream"]
    assert [c.kernel for c in PLAN_CASES["kws-gru-chain"]] == \
        ["ring_conv_stream", "ring_gru_cell"]
    ib = [c.kwargs for c in PLAN_CASES[VWW]]
    # every VWW op runs in place; one narrows without a residual
    assert all(kw["in_ptr"] == kw["out_ptr"] for kw in ib)
    assert any(not kw["residual"] and kw["C_in"] != kw["C_out"]
               for kw in ib)
    # the DS-CNN stream's output run covers the frame it appends
    kw = PLAN_CASES["ds-cnn-stream"][0].kwargs
    assert kw["out_ptr"] <= kw["in_ptr"] < kw["out_ptr"] \
        + kw["h_out"] * kw["w_out"]


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


@pytest.mark.parametrize("case", F32_FUSED_STREAM_EDGE_CASES[::2],
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


@pytest.mark.parametrize("change, match", [
    (dict(C_in=129, C_out=129), "segment geometry"),
    (dict(C_mid=1025), "segment geometry")])
def test_ib_refuses_widths_beyond_the_segment_like_the_reference(change,
                                                                 match):
    case = F32_FUSED_STREAM_EDGE_CASES[1]
    pool, params = case_inputs(case, seed=0)
    bad = dict(case.kwargs, **change)
    with pytest.raises(ValueError, match=match):
        ref_ib.ring_inverted_bottleneck(jnp.asarray(pool),
                                        *(jnp.asarray(a) for a in params),
                                        **bad, interpret=True)
    for fn in (KERNELS[case.kernel], PLAIN[case.kernel]):
        with pytest.raises(ValueError, match=match):
            fn(torch.from_numpy(pool.copy()),
               *(torch.from_numpy(a) for a in params), **bad)


@pytest.mark.parametrize("case", [
    c for c in F32_FUSED_STREAM_EDGE_CASES
    if c.kernel == "ring_conv_stream" or c.kwargs.get("d_in", 0) > 128],
    ids=lambda c: c.name)
def test_stream_geometry_errors_match_the_reference(case):
    """A misaligned pointer and a state region that would wrap the ring
    are refused by the reference, the plain version and the wrapper (a
    GRU input of one segment has no misaligned pointer)."""
    pool, params = case_inputs(case, seed=0)
    gru = case.kernel == "ring_gru_cell"
    kw = case.kwargs
    for bad, match in (
            (dict(kw, in_ptr=kw["in_ptr"] + 1), "align"),
            (dict(kw, state_ptr=case.n_seg if gru
                  else case.n_seg - kw["w_in"]), "wrap")):
        with pytest.raises(ValueError, match=match):
            _reference_kernel(case.kernel)(
                jnp.asarray(pool), *(jnp.asarray(a) for a in params), **bad,
                interpret=True)
        for fn in (KERNELS[case.kernel], PLAIN[case.kernel]):
            with pytest.raises(ValueError, match=match):
                fn(torch.from_numpy(pool.copy()),
                   *(torch.from_numpy(a) for a in params), **bad)


def test_gru_update_matches_the_reference():
    rng = np.random.default_rng(3)
    d_h = 40
    gx, gh = (rng.standard_normal((5, 3 * d_h), np.float32) * 4
              for _ in range(2))
    h = rng.uniform(-1, 1, (5, d_h)).astype(np.float32)
    want = np.asarray(ref_gru_update(jnp.asarray(gx), jnp.asarray(gh),
                                     jnp.asarray(h), d_h))
    got = gru_update(torch.from_numpy(gx), torch.from_numpy(gh),
                     torch.from_numpy(h), d_h).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the hard gates both clip and pass on these inputs
    z = np.clip(0.25 * (gx[:, :d_h] + gh[:, :d_h]) + 0.5, 0, 1)
    assert (z == 0).any() and (z == 1).any() and ((z > 0) & (z < 1)).any()


@pytest.mark.parametrize("residual", [True, False])
def test_inverted_bottleneck_ref_matches_the_reference(residual):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((6, 5, 16), np.float32)
    w1 = rng.standard_normal((16, 48), np.float32) / 4
    wd = rng.standard_normal((3, 3, 48), np.float32) / 3
    w2 = rng.standard_normal((48, 16), np.float32) / 7
    want = np.asarray(ref_ib.inverted_bottleneck_ref(
        *(jnp.asarray(t) for t in (a, w1, wd, w2)), residual=residual))
    got = inverted_bottleneck_ref(*(torch.from_numpy(t)
                                    for t in (a, w1, wd, w2)),
                                  residual=residual)
    _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# fp32 MCUNet-5fps-VWW served.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vww():
    import repro

    return load(_artifact(VWW)), repro.load(str(_artifact(VWW))), \
        _golden(VWW)


def test_vww_run_and_final_pool_match_the_reference_pallas_path(vww):
    """One input through the reference's Pallas kernels (interpret mode)
    and through the port's plain versions, from the same artifact; the
    batch against the golden."""
    cn, ref, golden = vww
    x = golden["x"][0]
    kbr = cn.target.kernel_block_rows
    y_ref, pool_ref = ref_run_program(ref.program, jnp.asarray(x),
                                      ref.params, backend="pallas",
                                      kernel_block_rows=kbr)
    params = to_device(cn.params, "cpu")
    y, pool = run_program(cn.program, torch.from_numpy(x), params,
                          kernel_block_rows=kbr)
    _close(y.numpy(), np.asarray(y_ref))
    live = program_live_lanes(cn.program, cn.params, kernel_block_rows=kbr)
    err, bad = compare_f32(pool.array.numpy(), np.asarray(pool_ref.array),
                           live)
    assert bad is None, bad
    assert not pool.array.numpy()[~live].any()
    before = launch_counts()
    yb = cn.run(golden["x"], device="cpu")
    assert launch_counts() == before        # the CPU ran plain versions
    assert yb.dtype == torch.float32 and tuple(yb.shape) == (8, 1, 2)
    _close(yb.numpy(), golden["y"])
    assert torch.equal(yb[0], y)


def test_vww_reference_forward_matches_the_jax_one(vww):
    cn, ref, golden = vww
    x = golden["x"][2]
    want = np.asarray(ref_reference_forward(ref.program, jnp.asarray(x),
                                            ref.params))
    got = reference_forward(cn.program, torch.from_numpy(x),
                            to_device(cn.params, "cpu"))
    _close(got.numpy(), want)
    _close(got.numpy(), golden["y"][2])


# ---------------------------------------------------------------------------
# fp32 streams.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", STREAMS)
def test_float_stream_equals_its_golden_step_by_step(name):
    cn, golden = load(_artifact(name)), _golden(name)
    assert not cn.quantized
    s = cn.stream(device="cpu")
    assert not s.quantized and s.state_bytes == s.state_segments * 512
    before = launch_counts()
    first = None
    for i, f in enumerate(golden["x"]):
        y = s.step(torch.from_numpy(f))
        assert y.dtype == torch.float32 and y.device.type == "cpu"
        _close(y.numpy(), golden["y"][i])
        first = y if first is None else first
    assert launch_counts() == before        # the CPU ran plain versions
    assert s.steps == len(golden["x"]) == 60
    # the window's channel tails stay exact zeros
    op = cn.program.ops[0]
    win = s.pool.array[op.state_ptr:op.state_ptr + op.state_segments]
    assert not win[:, op.d_in:].any() and win[:, :op.d_in].any()
    assert s.reset() is s and s.steps == 0 and not s.pool.array.any()
    assert torch.equal(s.step(golden["x"][0]), first)
    s.reset()
    _close(s.run(golden["x"][:5]).numpy(), golden["y"][4])
