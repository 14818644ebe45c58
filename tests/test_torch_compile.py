"""``repro_torch.compile`` — the port's compile pipeline — held against
``repro.compile`` on the CPU.

  * Plans: every registered net on ``cortex-m4``, ``cortex-m7`` and
    ``host-sim`` (planner-only for int8, so no net is calibrated twice),
    the streaming DS-CNN and whisper-tiny's MLP tower graph: program
    (dict and sha256), certificate, ``mcu`` summary, report and every
    pass's name and note are the reference's, byte for byte;
    ``SRAMBudgetError`` is raised where the reference raises it, with
    its message.
  * int8 calibration: DS-CNN, ResNet-8, ToyADMOS and the DS-CNN stream,
    each compiled once by the reference (its params and calibration
    draws carried across): the port's activation scales within rtol
    1e-5 of the reference's (the largest difference seen is printed
    with ``-s``), ``quantize_ops`` on the reference's scales equal to
    its qparams bitwise, and ``save()`` writing the reference's payload
    key for key but for seconds.
  * ``partial``, the lint pass's VMCU303 estimate, ``certify="static"``
    and ``emit_c`` run as the reference's (``tests/test_torch_partial.py``,
    ``tests/test_torch_verifier.py`` and ``tests/test_torch_codegen.py``
    hold them against the reference in full).
  * A net made by ``dataclasses.replace`` with new params or qparams
    runs with them, not with the device copies of the net it came from.
"""
import dataclasses
import json
import pathlib
import tempfile

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.compile.driver import SRAMBudgetError as RefSRAMBudgetError
from repro.configs import get_config as ref_get_config
from repro.graph.ir import Tensor as RefTensor
from repro.graph.ir import build_mlp_tower as ref_build_mlp_tower
from repro_torch.compile import artifact
from repro_torch.compile.driver import CompileError, SRAMBudgetError
from repro_torch.configs import get_config
from repro_torch.graph.ir import Tensor, build_mlp_tower
from repro_torch.graph.run import quantize_ops

TARGETS = ("cortex-m4", "cortex-m7", "host-sim")
SCALE_RTOL = 1e-5
#: The calibrated reference compiles (net, compile kwargs).
CALIBRATED = {"ds-cnn": {}, "resnet-8": {}, "ad-toyadmos": {},
              "ds-cnn-stream": {"streaming": True}}
ASSETS = pathlib.Path(artifact.__file__).parents[1] / "assets"


def _host(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(v) for v in tree)
    if tree is None or isinstance(tree, (int, float)):
        return tree
    return np.asarray(tree)


def _untimed_spans(spans, drop=()):
    """A span forest without its seconds (and without the spans named in
    ``drop``)."""
    return [{"name": s["name"], "attrs": s["attrs"],
             "children": _untimed_spans(s["children"], drop)}
            for s in spans if s["name"] not in drop]


def _payload(cn, drop=()) -> dict:
    """What ``cn.save`` writes, its seconds taken out."""
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "a.json"
        cn.save(str(path))
        payload = json.loads(path.read_text())
    payload["passes"] = [[n, note] for n, _s, note in payload["passes"]]
    payload["spans"] = _untimed_spans(payload["spans"], drop)
    return payload


def _same_compile(have, want, drop=()) -> None:
    """``drop``: spans of the reference's tree the port has no reason to
    open (``init_params`` where the port was handed the params the
    reference drew)."""
    assert have.program.to_json_dict() == want.program.to_json_dict()
    if want.certificate is not None:
        assert artifact.program_sha256(have.program) \
            == want.certificate["program_sha256"]
    assert have.certificate == want.certificate
    assert have.mcu == want.mcu
    assert [(p.name, p.note) for p in have.passes] \
        == [(p.name, p.note) for p in want.passes]
    assert (have.net_name, have.dtype, dataclasses.asdict(have.target)) \
        == (want.net_name, want.dtype, dataclasses.asdict(want.target))
    hr, wr = have.report(), want.report()
    for r in (hr, wr):
        r["passes"] = [[n, note] for n, _s, note in r["passes"]]
    assert hr == wr
    assert _untimed_spans(have.spans) == _untimed_spans(want.spans, drop)


def _tower(tensor_cls, builder, get_cfg):
    cfg = get_cfg("whisper-tiny")
    g = builder(cfg, m_rows=cfg.encoder_seq, elem_bytes=4)
    g.add("gelu", "elementwise", [f"L{cfg.n_layers - 1}.mlp"],
          tensor_cls(rows=cfg.encoder_seq, d=cfg.d_model, elem_bytes=4),
          activation="gelu")
    g.validate()
    return g


# ---------------------------------------------------------------------------
# Plans over the zoo.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("net", repro.available_nets())
def test_plans_equal_the_reference(net, target):
    """Planner-only (int8 targets are not calibrated here): every pass
    the reference runs, lint and certify included."""
    assert repro_torch.available_nets() == repro.available_nets()
    try:
        want = repro.compile(net, target, quantize=False)
    except RefSRAMBudgetError as e:
        with pytest.raises(SRAMBudgetError) as have:
            repro_torch.compile(net, target, quantize=False)
        assert str(have.value) == str(e)
        return
    have = repro_torch.compile(net, target, quantize=False)
    _same_compile(have, want)
    assert have.params is None          # planner-only: nothing drawn
    assert have.flash_bytes_used == want.flash_bytes_used
    assert have.fits() == want.fits()


def test_the_over_budget_net_is_the_reference_one():
    """The one zoo combination over its SRAM: unsliced ImageNet on the
    M4 (196,416 B deployable).  Without the gate its plan is the
    reference's."""
    with pytest.raises(SRAMBudgetError, match="196416 B"):
        repro_torch.compile("mcunet-320kb-imagenet", "cortex-m4",
                            quantize=False)
    kw = dict(quantize=False, check_budget=False)
    _same_compile(repro_torch.compile("mcunet-imagenet", "cortex-m4", **kw),
                  repro.compile("mcunet-imagenet", "cortex-m4", **kw))


def test_lint_of_an_over_budget_plan_is_refused_by_name():
    """Where the recorded verdict is over the SRAM, the lint pass asks
    partial execution for an estimate (the VMCU303 advisory) as the
    reference's does: no longer refused, the pass notes and the plan are
    the reference's, with lint and without."""
    from repro.compile.targets import Target as RefTarget
    from repro_torch.compile.targets import Target

    fields = dict(name="tiny", cpu="a 4 KB part", sram_bytes=4_000,
                  flash_bytes=1 << 20)
    kw = dict(quantize=False, check_budget=False)
    have = repro_torch.compile("ds-cnn", Target(**fields), **kw)
    _same_compile(have, repro.compile("ds-cnn", RefTarget(**fields), **kw))
    assert "VMCU301" in next(p.note for p in have.passes
                             if p.name == "lint")
    _same_compile(repro_torch.compile("ds-cnn", Target(**fields), lint=False,
                                      **kw),
                  repro.compile("ds-cnn", RefTarget(**fields), lint=False,
                                **kw))


@pytest.mark.parametrize("target", TARGETS)
def test_the_streaming_ds_cnn_plan_equals_the_reference(target):
    have = repro_torch.compile("ds-cnn", target, streaming=True,
                               quantize=False)
    want = repro.compile("ds-cnn", target, streaming=True, quantize=False)
    _same_compile(have, want)
    assert have.certificate["stream_horizon"] == "unbounded"


@pytest.mark.parametrize("certify,lint", [(True, True), ("sim", False),
                                          (False, True)])
def test_the_whisper_tiny_tower_plan_equals_the_reference(certify, lint):
    have = repro_torch.compile(_tower(Tensor, build_mlp_tower, get_config),
                               "host-sim", certify=certify, lint=lint)
    want = repro.compile(_tower(RefTensor, ref_build_mlp_tower,
                                ref_get_config),
                         "host-sim", certify=certify, lint=lint)
    _same_compile(have, want)
    assert have.flash_bytes_used == want.flash_bytes_used


@pytest.mark.parametrize("kw", [dict(seg_width=1, block_rows=None),
                                dict(block_rows=None),
                                dict(dtype="float32", fused_exec=False),
                                dict(dtype="bfloat16"),
                                dict(check_budget=False)],
                         ids=lambda kw: ",".join(map(str, kw.items())))
def test_knobs_plan_as_the_reference(kw):
    for net in ("mcunet-5fps-vww", "resnet-8"):
        _same_compile(repro_torch.compile(net, "cortex-m4", quantize=False,
                                          **kw),
                      repro.compile(net, "cortex-m4", quantize=False, **kw))


def test_a_caller_order_plans_as_the_reference():
    order = repro.compile("ds-cnn", "cortex-m4", quantize=False).plan.order
    _same_compile(repro_torch.compile("dscnn", "cortex-m4", quantize=False,
                                      order=list(order)),
                  repro.compile("dscnn", "cortex-m4", quantize=False,
                                order=list(order)))


# ---------------------------------------------------------------------------
# What the driver refuses.
# ---------------------------------------------------------------------------

def test_what_this_slice_does_not_port_is_refused_by_name():
    """Nothing of the compile pipeline is refused any more: ``partial``
    plans as the reference's (not needed on DS-CNN, or forced), and the
    static proof and the C emission run."""
    for partial in ("auto", 2):
        kw = dict(quantize=False, partial=partial)
        _same_compile(repro_torch.compile("ds-cnn", "cortex-m4", **kw),
                      repro.compile("ds-cnn", "cortex-m4", **kw))
    cn = repro_torch.compile("ds-cnn", "cortex-m4", quantize=False,
                             certify="static")
    assert next(p.note for p in cn.passes if p.name == "certify") \
        .startswith("static proof")
    units = cn.emit_c(geometry_only=True)
    assert len(units) == len(cn.program.ops)
    assert all(name.startswith("ds-cnn_op") for name in units)


def test_bad_arguments_are_refused_as_by_the_reference():
    cases = [(dict(certify="maybe"), ValueError),
             (dict(partial="half"), ValueError),
             (dict(dtype="int4"), ValueError),
             (dict(fused_exec=True), CompileError)]
    for kw, err in cases:
        with pytest.raises(err) as have:
            repro_torch.compile("ds-cnn", "cortex-m4", **kw)
        with pytest.raises(Exception) as want:
            repro.compile("ds-cnn", "cortex-m4", **kw)
        assert str(have.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown net"):
        repro_torch.compile("lenet", "cortex-m4")
    with pytest.raises(ValueError, match="unknown target"):
        repro_torch.compile("ds-cnn", "cortex-m0")
    with pytest.raises(TypeError):
        repro_torch.compile(42)


def test_a_planner_only_int8_compile_does_not_run():
    cn = repro_torch.compile("ds-cnn", "cortex-m4", quantize=False)
    assert not cn.quantized and cn.program.quantized
    with pytest.raises(CompileError, match="planner-only"):
        cn.run(np.zeros((49, 10), np.float32), device="cpu")
    with pytest.raises(CompileError, match="planner-only"):
        repro_torch.compile("ds-cnn", "cortex-m4", streaming=True,
                            quantize=False).stream(device="cpu")


def test_targets_are_the_reference_descriptors():
    from repro.compile import targets as ref_targets
    from repro_torch.compile import targets

    assert targets.list_targets() == ref_targets.list_targets()
    for name in targets.list_targets():
        t, rt = targets.get_target(name), ref_targets.get_target(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(rt)
        assert (t.plan_kwargs, t.byte_ring_kwargs) \
            == (rt.plan_kwargs, rt.byte_ring_kwargs)
    with pytest.raises(ValueError, match="already"):
        targets.register_target(targets.get_target("host-sim"))


# ---------------------------------------------------------------------------
# Float compiles: lazy params, the reference's params carried across.
# ---------------------------------------------------------------------------

def test_a_float_compile_draws_its_params_lazily_and_runs():
    cn = repro_torch.compile("ds-cnn", key=3)
    assert cn.params is None and cn.target.name == "host-sim"
    x = np.random.default_rng(0).standard_normal((49, 10), np.float32)
    y = cn.run(x, device="cpu")
    assert cn.params is not None and y.shape == (1, 12)
    assert torch.isfinite(y).all()
    again = repro_torch.compile("ds-cnn", key=3).run(x, device="cpu")
    assert torch.equal(y, again)


@pytest.mark.parametrize("name", ["mcunet-5fps-vww", "ds-cnn-stream"])
def test_float_compiles_with_the_reference_params_save_the_asset(name):
    """Compiled with the committed asset's params, an fp32 plan saves the
    reference's payload (the asset) but for seconds, and serves its
    golden within the fp32 tolerance."""
    path = ASSETS / f"{name}.host-sim.float32.json"
    want = json.loads(path.read_text())
    params = artifact.decode(want["params"])
    net, kw = ("ds-cnn", {"streaming": True}) if name == "ds-cnn-stream" \
        else (name, {})
    cn = repro_torch.compile(net, "host-sim", params=params, **kw)
    have = _payload(cn)
    want["passes"] = [[n, note] for n, _s, note in want["passes"]]
    want["spans"] = _untimed_spans(want["spans"])
    assert have == want
    with np.load(ASSETS / f"{name}.host-sim.float32.golden.npz") as g:
        x, y = g["x"], g["y"]
    if kw:
        s = cn.stream(device="cpu")
        got = np.stack([s.step(torch.from_numpy(f)).numpy() for f in x[:8]])
        y = y[:8]
    else:
        got = cn.run(x, device="cpu").numpy()
    np.testing.assert_allclose(got, y, rtol=3e-4,
                               atol=3e-5 * np.abs(y).max())


# ---------------------------------------------------------------------------
# int8: calibration and requant tables.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrated():
    """The reference's default int8 ``cortex-m4`` compile of each net in
    ``CALIBRATED``, made once, with its params and calibration draws."""
    out = {}
    for name, kw in CALIBRATED.items():
        net = "ds-cnn" if name == "ds-cnn-stream" else name
        ref = repro.compile(net, "cortex-m4", **kw)
        prog = ref.plan.program
        calib = np.asarray(jax.random.normal(
            jax.random.PRNGKey(0), (2, prog.in_rows, prog.in_dim)))
        port = repro_torch.compile(net, "cortex-m4", params=_host(ref.params),
                                   calib=calib, **kw)
        out[name] = ref, port
    return out


@pytest.mark.parametrize("name", sorted(CALIBRATED))
def test_calibrated_plans_equal_the_reference(calibrated, name):
    ref, port = calibrated[name]
    _same_compile(port, ref, drop=("init_params",))
    assert port.quantized and port.qnet.program.dtype == "int8"


@pytest.mark.parametrize("name", sorted(CALIBRATED))
def test_activation_scales_hold_the_reference(calibrated, name):
    ref, port = calibrated[name]
    have = np.asarray(port.qnet.act_scales)
    want = np.asarray(ref.qnet.act_scales)
    rel = np.abs(have - want) / want
    print(f"{name}: largest relative activation-scale difference "
          f"{rel.max():.3g} over {len(want)} tensors")
    assert rel.max() <= SCALE_RTOL


@pytest.mark.parametrize("name", sorted(CALIBRATED))
def test_requant_tables_on_the_reference_scales_are_bitwise(calibrated,
                                                            name):
    ref, port = calibrated[name]
    got = quantize_ops(port.plan, _host(ref.params), ref.qnet.act_scales)
    want = _host(ref.qnet.qparams)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), i
        for a, b in zip(g, w):
            if isinstance(b, int):
                assert type(a) is int and a == b, i
            else:
                assert a.dtype == b.dtype and a.shape == b.shape, i
                np.testing.assert_array_equal(a, b, err_msg=str(i))


@pytest.mark.parametrize("name", sorted(CALIBRATED))
def test_save_writes_the_reference_payload(calibrated, name):
    """Key for key but for seconds, params included; ``quant`` compared
    with the reference's scales through ``quantize_ops``."""
    ref, port = calibrated[name]
    qnet = dataclasses.replace(
        port.qnet, act_scales=tuple(ref.qnet.act_scales),
        qparams=quantize_ops(port.plan, port.params, ref.qnet.act_scales))
    have = _payload(dataclasses.replace(port, qnet=qnet))
    want = _payload(ref, drop=("init_params",))
    assert sorted(have) == sorted(want)
    for key in sorted(want):
        assert have[key] == want[key], key


def test_a_port_calibrated_net_runs_within_one_step_of_the_reference(
        calibrated):
    """The port's own scales, run on the CPU: int8 outputs within one
    step of the reference ring's, float outputs within one step of the
    output scale."""
    ref, port = calibrated["ds-cnn"]
    x = np.random.default_rng(0).standard_normal((4, 49, 10), np.float32)
    have = port.run(x, device="cpu").numpy()
    want = np.asarray(ref.run(x, backend="jnp"))
    assert np.abs(have - want).max() <= port.qnet.out_scale * (1 + 1e-4)


def test_a_calibrated_stream_runs_and_certifies_on_the_sim(calibrated):
    ref, port = calibrated["ds-cnn-stream"]
    s = port.stream(backend="sim")
    r = ref.stream(backend="sim")
    for _ in range(3):
        assert s.step() == r.step()
    frames = np.random.default_rng(0).standard_normal((3, 1, 10), np.float32)
    out = port.stream(device="cpu").run(torch.from_numpy(f) for f in frames)
    assert out.shape == (1, 12) and torch.isfinite(out).all()


def test_saved_int8_compiles_load_in_the_port(calibrated, tmp_path):
    _ref, port = calibrated["resnet-8"]
    path = port.save(str(tmp_path / "r8.json"))
    back = repro_torch.load(path)
    x = np.random.default_rng(0).standard_normal((32 * 32, 3), np.float32)
    assert torch.equal(back.run(x, device="cpu"), port.run(x, device="cpu"))
    assert back.report()["flash_bytes_used"] == port.flash_bytes_used


# ---------------------------------------------------------------------------
# A replaced net runs with its own tables.
# ---------------------------------------------------------------------------

def _fresh(cn):
    """A net built anew from ``cn``'s fields (no device copies)."""
    return repro_torch.CompiledNet(**{
        f.name: getattr(cn, f.name)
        for f in dataclasses.fields(repro_torch.CompiledNet) if f.init})


def test_a_float_net_with_replaced_params_runs_them():
    cn = repro_torch.load(str(ASSETS / "ds-cnn.host-sim.float32.json"))
    x = np.random.default_rng(0).standard_normal((2, 49, 10), np.float32)
    first = cn.run(x, device="cpu")
    halved = [None if e is None else tuple(
        None if a is None else a * np.float32(0.5) for a in e)
        for e in cn.params]
    new = dataclasses.replace(cn, params=halved)
    second = new.run(x, device="cpu")
    assert torch.equal(second, _fresh(new).run(x, device="cpu"))
    assert not torch.equal(second, first)
    assert torch.equal(cn.run(x, device="cpu"), first)


def test_an_int8_net_with_replaced_qparams_runs_them(calibrated):
    """The port-calibrated DS-CNN, then the same net with the tables of
    twice its activation scales."""
    _ref, port = calibrated["ds-cnn"]
    x = np.random.default_rng(1).standard_normal((2, 49, 10), np.float32)
    first = port.run(x, device="cpu")
    scales = tuple(2 * s for s in port.qnet.act_scales)
    qnet = dataclasses.replace(
        port.qnet, act_scales=scales,
        qparams=quantize_ops(port.plan, port.params, scales))
    new = dataclasses.replace(port, qnet=qnet)
    second = new.run(x, device="cpu")
    assert torch.equal(second, _fresh(new).run(x, device="cpu"))
    assert not torch.equal(second, first)


def test_a_replaced_stream_steps_with_its_own_params():
    cn = repro_torch.load(str(ASSETS / "ds-cnn-stream.host-sim.float32.json"))
    frames = np.random.default_rng(2).standard_normal((4, 1, 10),
                                                      np.float32)

    def steps(net):
        s = net.stream(device="cpu")
        return torch.stack([s.step(torch.from_numpy(f)) for f in frames])
    first = steps(cn)
    doubled = [None if e is None else tuple(
        None if a is None else a * np.float32(2) for a in e)
        for e in cn.params]
    new = dataclasses.replace(cn, params=doubled)
    second = steps(new)
    assert torch.equal(second, steps(_fresh(new)))
    assert not torch.equal(second, first)
