"""The port's whole-network compiler held against the reference's: the
IR and its builders (``graph/ir.py``), operator reordering and fusion
groups (``graph/schedule.py``), the one-ring net planner
(``graph/netplan.py``), the streaming conversion (``stream/convert.py``),
int8 calibration's arithmetic (``quant/qtensor.py``) and the compile
half of ``graph/run.py`` (``reference_forward``'s taps and stream
branches, ``init_net_params``, ``calibrate_scales``, ``quantize_ops``).

Structures, orders, plans and requant tables must be equal exactly; the
float forward is held within the fp32 tolerance (rtol 3e-4, atol
3e-5·max) and activation scales within rtol 1e-5 (the port's sums are
torch's, not XLA's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro
from repro.compile.driver import _NET_BUILDERS as REF_BUILDERS
from repro.configs import get_config as ref_get_config
from repro.core.program import (AvgPoolSpec as RAvg, ConvStreamSpec as RCS,
                                GRUCellSpec as RGRU,
                                plan_program as ref_plan_program)
from repro.graph import ir as ref_ir
from repro.graph import netplan as ref_netplan
from repro.graph import run as ref_run
from repro.graph import schedule as ref_schedule
from repro.quant import qtensor as ref_q
from repro.stream import convert as ref_convert
from repro_torch.compile.driver import _NET_BUILDERS
from repro_torch.configs import get_config
from repro_torch.core.program import (AvgPoolSpec, ConvStreamSpec,
                                      GRUCellSpec, plan_program)
from repro_torch.graph import ir, netplan, run, schedule
from repro_torch.quant import qtensor as q
from repro_torch.stream import convert

NETS = tuple(sorted(REF_BUILDERS))
RTOL, ATOL_REL = 3e-4, 3e-5
SCALE_RTOL = 1e-5
LM_CONFIGS = ("whisper-tiny", "gemma3-1b", "mamba2-780m")


def _graph_dict(g) -> dict:
    return {"name": g.name, "elem_bytes": g.elem_bytes,
            "nodes": [dataclasses.asdict(n) for n in g.nodes.values()],
            "modules": {k: dataclasses.asdict(v)
                        for k, v in g.modules.items()}}


def _graph_equal(have, want) -> None:
    assert _graph_dict(have) == _graph_dict(want)
    assert have.topo_order() == want.topo_order()
    assert (have.input_id(), have.output_id()) \
        == (want.input_id(), want.output_id())


def _host(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(v) for v in tree)
    return None if tree is None else np.asarray(tree)


def _within(got, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL_REL * (np.abs(want).max() or 1.0))


# ---------------------------------------------------------------------------
# IR + builders.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", NETS)
def test_registered_builders_build_the_reference_graphs(net):
    have, want = _NET_BUILDERS[net](), REF_BUILDERS[net]()
    have.validate()
    _graph_equal(have, want)


@pytest.mark.parametrize("cfg_name", LM_CONFIGS)
@pytest.mark.parametrize("m_rows,elem_bytes", [(8, 2), (1500, 4)])
def test_mlp_tower_builder_builds_the_reference_graph(cfg_name, m_rows,
                                                      elem_bytes):
    have = ir.build_mlp_tower(get_config(cfg_name), m_rows=m_rows,
                              n_layers=3, elem_bytes=elem_bytes)
    want = ref_ir.build_mlp_tower(ref_get_config(cfg_name), m_rows=m_rows,
                                  n_layers=3, elem_bytes=elem_bytes)
    _graph_equal(have, want)


@pytest.mark.parametrize("builder,kwargs", [
    ("build_ds_cnn", {"num_classes": 4, "c": 32}),
    ("build_mobilenet_v1", {"hw": 64, "num_classes": 10}),
    ("build_ad_autoencoder", {"d_in": 128, "d_hidden": 64}),
    ("build_resnet8", {"num_classes": 3, "elem_bytes": 4}),
])
def test_builder_options_build_the_reference_graphs(builder, kwargs):
    _graph_equal(getattr(ir, builder)(**kwargs),
                 getattr(ref_ir, builder)(**kwargs))


def test_the_ir_refuses_what_the_reference_refuses():
    g = ir.Graph("bad")
    g.add("in", "input", [], ir.Tensor(rows=4, d=8))
    with pytest.raises(ValueError, match="duplicate"):
        g.add("in", "input", [], ir.Tensor(rows=4, d=8))
    with pytest.raises(ValueError, match="unknown input"):
        g.add("x", "fc", ["nope"], ir.Tensor(rows=4, d=8))
    g.add("f", "flatten", ["in"], ir.Tensor(rows=1, d=32))
    with pytest.raises(ValueError, match="flatten"):
        g.validate()


# ---------------------------------------------------------------------------
# schedule + netplan.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", NETS)
def test_reorder_and_groups_equal_the_reference(net):
    have, want = _NET_BUILDERS[net](), REF_BUILDERS[net]()
    order, peak = schedule.reorder(have)
    r_order, r_peak = ref_schedule.reorder(want)
    assert (order, peak) == (r_order, r_peak)
    assert schedule.peak_live_bytes(have, order) \
        == ref_schedule.peak_live_bytes(want, r_order)
    assert schedule.tensor_lifetimes(have, order) \
        == ref_schedule.tensor_lifetimes(want, r_order)
    for sw in (128, 1):
        groups = schedule.select_groups(have, order, seg_width=sw)
        r_groups = ref_schedule.select_groups(want, r_order, seg_width=sw)
        assert [dataclasses.asdict(g) for g in groups] \
            == [dataclasses.asdict(g) for g in r_groups]


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("geometry", [
    dict(dtype="int8", fused_exec=False),
    dict(dtype="float32", fused_exec=True),
    dict(dtype="int8", fused_exec=False, seg_width=1, block_rows=None)])
def test_net_plans_equal_the_reference(net, geometry):
    have = netplan._plan_net(_NET_BUILDERS[net](), **geometry)
    want = ref_netplan._plan_net(REF_BUILDERS[net](), **geometry)
    assert have.program.to_json_dict() == want.program.to_json_dict()
    assert have.order == want.order and have.name == want.name
    assert [dataclasses.asdict(g) for g in have.groups] \
        == [dataclasses.asdict(g) for g in want.groups]
    for key in ("mcu_pool_bytes", "mcu_bottleneck_bytes",
                "tinyengine_bottleneck_bytes", "hmcos_bottleneck_bytes",
                "reduction_vs_tinyengine", "reduction_vs_hmcos",
                "pool_bytes", "physical_pool_bytes"):
        assert getattr(have, key) == getattr(want, key), key
    assert have.bottleneck_group().name == want.bottleneck_group().name
    assert have.deployable(128_000) == want.deployable(128_000)


def test_the_plan_net_shim_warns_as_the_reference():
    with pytest.warns(DeprecationWarning, match="compile"):
        have = netplan.plan_net(ir.build_ds_cnn())
    with pytest.warns(DeprecationWarning):
        want = ref_netplan.plan_net(ref_ir.build_ds_cnn())
    assert have.program.to_json_dict() == want.program.to_json_dict()


@pytest.mark.parametrize("hop", [1, 2])
def test_streaming_conversion_equals_the_reference(hop):
    have = convert.to_streaming(ir.build_ds_cnn(), hop=hop)
    want = ref_convert.to_streaming(ref_ir.build_ds_cnn(), hop=hop)
    _graph_equal(have, want)
    _graph_equal(convert.to_full(have), ref_convert.to_full(want))
    _graph_equal(convert.to_full(have), ir.build_ds_cnn())


# ---------------------------------------------------------------------------
# quant arithmetic.
# ---------------------------------------------------------------------------

_ARR = st.integers(0, 2 ** 32 - 1).map(
    lambda s: np.random.default_rng(s).standard_normal(
        (3, 4, 5)).astype(np.float32) * np.float32(10.0 ** (s % 7 - 3)))


@settings(derandomize=True, database=None, max_examples=40, deadline=None)
@given(x=_ARR, axis=st.sampled_from([None, 0, 1, 2]),
       s_in=st.floats(1e-4, 1.0), s_out=st.floats(1e-4, 1.0))
def test_calibration_arithmetic_equals_the_reference_bitwise(x, axis, s_in,
                                                             s_out):
    have, want = q.calibrate(x, axis=axis), ref_q.calibrate(x, axis=axis)
    np.testing.assert_array_equal(np.asarray(have.scale),
                                  np.asarray(want.scale))
    assert have.axis == want.axis and have.per_channel == want.per_channel
    w_q = q.quantize_array(x, have)
    assert w_q.dtype == np.int8
    np.testing.assert_array_equal(w_q, np.asarray(ref_q.quantize(x, want)))
    np.testing.assert_array_equal(
        q.quantize(torch.from_numpy(x), have).numpy(), w_q)
    if axis is not None:
        b = x.reshape(-1)[:x.shape[axis]]
        bq = q.quantize_bias(b, s_in, have)
        assert bq.dtype == np.int32
        np.testing.assert_array_equal(
            bq, np.asarray(ref_q.quantize_bias(b, s_in, want)))
    m, s = q.requant_pair(s_in, have, s_out)
    rm, rs = ref_q.requant_pair(s_in, want, s_out)
    assert m.dtype == s.dtype == np.int32
    np.testing.assert_array_equal(m, np.asarray(rm))
    np.testing.assert_array_equal(s, np.asarray(rs))
    assert q.requant_scalar(s_in / s_out) == ref_q.requant_scalar(
        s_in / s_out)


def test_all_zero_tensors_calibrate_at_the_floor():
    z = np.zeros((4, 3), np.float32)
    assert q.calibrate(z).scale == ref_q.calibrate(z).scale == q.SCALE_FLOOR
    np.testing.assert_array_equal(q.calibrate(z, axis=1).scale,
                                  ref_q.calibrate(z, axis=1).scale)


# ---------------------------------------------------------------------------
# graph/run: reference_forward's taps and stream branches, init, calibration.
# ---------------------------------------------------------------------------

def _chain():
    """The keyword-spotting GRU chain (conv_stream -> avgpool -> GRU) and
    params drawn by the reference, as in the port's assets."""
    have = plan_program(10, 1, [
        ConvStreamSpec(49, 10, 1, 64, k=5, stride=2, hop=1,
                       activation="relu"),
        AvgPoolSpec(25, 5, 64), GRUCellSpec(64)], block_rows=1)
    want = ref_plan_program(10, 1, [
        RCS(49, 10, 1, 64, k=5, stride=2, hop=1, activation="relu"),
        RAvg(25, 5, 64), RGRU(64)], block_rows=1)
    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(7), 5)
    params = [(jax.random.normal(k1, (5, 5, 1, 64)) / 5,
               jax.random.normal(k2, (64,)) / 8), None,
              (jax.random.normal(k3, (64, 192)) / 8,
               jax.random.normal(k4, (64, 192)) / 8,
               jax.random.normal(k5, (192,)) / 8)]
    return have, want, params


@pytest.fixture(scope="module")
def ref_plans():
    """The reference's float plans of three nets (fp32, fused) and their
    params from ``PRNGKey(0)``."""
    out = {}
    for net in ("ds-cnn", "resnet-8", "mcunet-5fps-vww"):
        cn = repro.compile(net, "host-sim", quantize=False, lint=False,
                           certify=False)
        out[net] = (cn.program, _host(cn.ensure_params()))
    return out


@pytest.mark.parametrize("net", ["ds-cnn", "resnet-8", "mcunet-5fps-vww"])
def test_reference_forward_taps_equal_the_reference(ref_plans, net):
    """Every op's input tap and the output, the port's forward against
    the reference's, on the same params and input."""
    prog, params = ref_plans[net]
    x = np.random.default_rng(1).standard_normal(
        (prog.in_rows, prog.in_dim)).astype(np.float32)
    have, want = [], []
    y = run.reference_forward(prog, torch.from_numpy(x), params,
                              intermediates=have)
    ref_run.reference_forward(prog, jnp.asarray(x), params,
                              intermediates=want)
    assert len(have) == len(want) == len(prog.ops) + 1
    assert have[-1] is y
    for h, w in zip(have, want):
        _within(h.numpy(), w)


def test_stream_branches_of_reference_forward_equal_the_reference():
    """One streaming step from reset: the conv_stream window is the zero
    state with the frame appended, the GRU's hidden state zero."""
    have_p, want_p, params = _chain()
    assert have_p.to_json_dict() == want_p.to_json_dict()
    x = np.random.default_rng(2).standard_normal((10, 1)).astype(np.float32)
    taps, r_taps = [], []
    run.reference_forward(have_p, torch.from_numpy(x), _host(params),
                          intermediates=taps)
    ref_run.reference_forward(want_p, jnp.asarray(x), params,
                              intermediates=r_taps)
    for h, w in zip(taps, r_taps):
        _within(h.numpy(), w)


@pytest.mark.parametrize("net", ["ds-cnn", "resnet-8", "mcunet-5fps-vww"])
def test_init_net_params_draws_the_reference_shapes(ref_plans, net):
    """Same structure, shapes and dtypes as the reference's He-init, with
    the port's own (seeded, repeatable) draws, of the same scale."""
    prog, want = ref_plans[net]
    have = run.init_net_params(prog)
    again = run.init_net_params(prog, 0)
    other = run.init_net_params(prog, 1)
    assert len(have) == len(want)
    for h, w, a, o in zip(have, want, again, other):
        assert (h is None) == (w is None)
        if w is None:
            continue
        for hh, ww, aa, oo in zip(h, w, a, o):
            assert (hh is None) == (ww is None)
            if ww is None:
                continue
            assert hh.shape == ww.shape and hh.dtype == ww.dtype
            np.testing.assert_array_equal(hh, aa)
            assert not np.array_equal(hh, oo)
            if hh.size > 256:
                assert 0.8 < hh.std() / ww.std() < 1.25


def test_gru_chain_scales_and_tables_equal_the_reference():
    """The chain's activation scales (the GRU output pinned at 1/128)
    within rtol 1e-5 of the reference's, and ``quantize_ops`` on the
    reference's scales equal to its qparams bitwise."""
    have_p, want_p, params = _chain()
    calib = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 10, 1)))
    want = ref_run._quantize_net(want_p, params, calib=jnp.asarray(calib))
    scales = run.calibrate_scales(have_p, _host(params), calib)
    assert scales[-1] == want.act_scales[-1] == 1.0 / 128.0
    np.testing.assert_allclose(scales, want.act_scales, rtol=SCALE_RTOL)
    got = run.quantize_ops(have_p, _host(params), want.act_scales)
    for g, w in zip(got, want.qparams):
        for a, b in zip(g, w):
            assert type(a) is type(b) if isinstance(b, int) else \
                a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


def test_quantization_refuses_what_the_reference_refuses(ref_plans):
    prog, params = ref_plans["mcunet-5fps-vww"]
    with pytest.raises(ValueError, match="int8 execution path"):
        run._quantize_net(prog, params)
    with pytest.warns(DeprecationWarning, match="compile"):
        with pytest.raises(ValueError):
            run.quantize_net(prog, params)
