"""The port on a CUDA card: each hand-written kernel against its plain
version (int8 bitwise, fp32 within the tolerance of
``repro_torch.kernels.cases.compare_f32``, with TF32 off; the decode
attention within ``cases.compare_decode``), the served and streaming
paths against the reference's goldens (the sliced ImageNet plan,
MobileNetV1-0.25 and the unsliced ImageNet plan for the cortex-m7
among them), traced runs against untraced ones, reduced gemma3-1b served
through one ``ring_decode_attention`` launch per layer per decode step,
and a reduced LM of each other block kind (rec, ssm, MoE, cross) served
through the decode kernel, kernel path against plain path.

These tests import neither JAX nor the reference package, so they run
on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card they skip (the decision is taken inside each test).
"""
import hashlib
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import load
from repro_torch.compile.artifact import to_device
from repro_torch.core.executors import run_program
from repro_torch.kernels import (KERNELS, PLAIN, launch_counts,
                                 reset_launch_counts)
from repro_torch.graph.run import reference_forward
from repro_torch.kernels.cases import (ATOL_REL, CARD_EDGE_CASES,
                                       EDGE_CASES, F32_EDGE_CASES,
                                       F32_FUSED_STREAM_EDGE_CASES,
                                       F32_MLP_EDGE_CASES, RTOL,
                                       case_inputs, compare_f32, live_lanes,
                                       int8_stem, output_regions,
                                       plain_pool, program_cases,
                                       program_live_lanes, seeded_float_net)
from repro_torch.quant.qtensor import QParams, quantize
from repro_torch.configs import get_config
from repro_torch.kernels.cases import (DECODE_CASES, LM_DECODE_CASES,
                                       SLICE_DECODE_CASES, compare_decode,
                                       compare_lse, decode_inputs,
                                       hold_lm_golden, lm_memory, lm_params,
                                       logits_close, route_codes,
                                       routed_apart)
from repro_torch.kernels import fused_mlp
from repro_torch.kernels.fused_mlp import MlpTiling, mlp_tiling
from repro_torch.kernels import stream as stream_kernels
from repro_torch.kernels.conv2d import conv_tiling
from repro_torch.kernels.inverted_bottleneck import ib_tiling
from repro_torch.kernels.quantized import add_needs_barrier, gemm_q_tiling
from repro_torch.kernels.stream import gru_q_tiling, gru_tiling
from repro_torch.kernels.ring_decode import (ring_decode_attention,
                                             ring_decode_attention_plain)
from repro_torch.models import build_model, params_from_reference
from repro_torch.serve import ServingEngine

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
NETS = ("ds-cnn", "resnet-8", "mcunet-5fps-vww", "ad-toyadmos")
STREAMS = ("ds-cnn-stream", "kws-gru-chain")
#: The zoo plans served beside them (int8 for their target in
#: ``cases.INT8_TARGETS``, fp32 for the host; goldens of 2 inputs), whose
#: kernel cases here are a few ops of each (``_few``).
ZOO = ("mobilenetv1-0.25", "mcunet-320kb-imagenet")


def _artifact(name):
    return ASSETS / f"{int8_stem(name)}.json"


def _golden(name):
    with np.load(ASSETS / f"{int8_stem(name)}.golden.npz") as g:
        return {k: g[k] for k in g.files}


def _few(cases, n_sm=132):
    """Of a plan's cases: the first and last op of each kernel, the conv
    op on the fewest CTAs and the bottleneck with the most shared memory
    (at ``n_sm`` SMs)."""
    keep = set()
    for kernel in {c.kernel for c in cases}:
        mine = [c for c in cases if c.kernel == kernel]
        keep |= {mine[0].name, mine[-1].name}
        if kernel.startswith("ring_conv"):
            keep.add(min(mine, key=lambda c: conv_tiling(
                kernel, c.kwargs, n_sm).ctas).name)
        if kernel == "ring_inverted_bottleneck":
            keep.add(max(mine, key=lambda c: ib_tiling(c.kwargs,
                                                       n_sm).smem).name)
    return tuple(c for c in cases if c.name in keep)


def _program_cases(name):
    cn = load(_artifact(name))
    return program_cases(cn.program, cn.qnet.qparams,
                         kernel_block_rows=cn.target.kernel_block_rows,
                         prefix=f"{name}_")


#: The sliced (partial-execution) ImageNet plan and its launches per
#: inference.
SLICED = "mcunet-320kb-imagenet"
SLICED_LAUNCHES = {"ring_conv_pw_q": 98, "ring_conv_dw_q": 48,
                   "ring_add_q": 10, "ring_avgpool_q": 1, "ring_gemm_q": 1}


def _sliced():
    cn = load(ASSETS / f"{SLICED}.cortex-m4.int8.sliced.json")
    with np.load(ASSETS / f"{SLICED}.cortex-m4.int8.sliced.golden.npz") as g:
        return cn, {k: g[k] for k in g.files}


def _sliced_cases():
    cn = _sliced()[0]
    return program_cases(cn.program, cn.qnet.qparams,
                         kernel_block_rows=cn.target.kernel_block_rows,
                         prefix=f"{SLICED}_sliced_")


CASES = EDGE_CASES + CARD_EDGE_CASES \
    + sum((_program_cases(n) for n in NETS + STREAMS), ()) \
    + _sliced_cases() + sum((_few(_program_cases(n)) for n in ZOO), ())
FLOAT_NETS = NETS


def _float_artifact(name):
    return ASSETS / f"{name}.host-sim.float32.json"


def _float_golden(name):
    with np.load(ASSETS / f"{name}.host-sim.float32.golden.npz") as g:
        return {k: g[k] for k in g.files}


def _float_program_cases(name):
    cn = load(_float_artifact(name))
    return program_cases(cn.program, cn.params,
                         kernel_block_rows=cn.target.kernel_block_rows,
                         prefix=f"{name}_f32_")


#: The whisper-tiny MLP tower: its artifact holds no params, its weights
#: come from ``mlp_tower_params`` of this seed.
TOWER, TOWER_SEED = "whisper-tiny-mlp", 0


def _tower():
    return seeded_float_net(_float_artifact(TOWER), TOWER_SEED)


def _tower_cases():
    cn = _tower()
    return program_cases(cn.program, cn.params,
                         kernel_block_rows=cn.target.kernel_block_rows,
                         prefix=f"{TOWER}_f32_")


F32_CASES = F32_EDGE_CASES + F32_FUSED_STREAM_EDGE_CASES \
    + F32_MLP_EDGE_CASES \
    + sum((_float_program_cases(n) for n in FLOAT_NETS + STREAMS), ()) \
    + _tower_cases() + sum((_few(_float_program_cases(n)) for n in ZOO), ())


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the plain versions' products must not run in TF32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_cuda_kernel_bitwise_equals_plain_on_card(case):
    _need_card()
    pool, params = case_inputs(case, seed=0)
    cuda_params = [torch.from_numpy(a).cuda() for a in params]
    want = torch.from_numpy(pool).cuda()
    PLAIN[case.kernel](want, *cuda_params, **case.kwargs)
    got = torch.from_numpy(pool).cuda()
    KERNELS[case.kernel](got, *cuda_params, **case.kwargs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


ADD_CASES = tuple(c for c in CASES if c.kernel == "ring_add_q")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ADD_CASES, ids=lambda c: c.name)
def test_add_takes_the_row_map_exactly_where_no_barrier_is_needed_on_card(
        case):
    """``ring_add_q`` maps the rows with no barrier on every plan's add
    and on the in-place edge cases, and reads first on the shifted ones;
    bitwise the plain version either way."""
    _need_card()
    kw, n = case.kwargs, case.n_seg
    need = add_needs_barrier(n, kw["rows"], kw["d"], kw["in_ptr"] % n,
                             kw["aux_ptr"] % n, kw["out_ptr"] % n)
    assert need == (case.name in (
        "add_shifted", "add_tiles_shifted", "add_shifted_uneven",
        "add_out_on_residual", "add_shifted_card"))
    pool, _ = case_inputs(case, seed=0)
    want = torch.from_numpy(pool).cuda()
    PLAIN[case.kernel](want, **kw)
    got = torch.from_numpy(pool).cuda()
    KERNELS[case.kernel](got, **kw)
    torch.cuda.synchronize()
    assert KERNELS[case.kernel].barrier is need
    assert torch.equal(got, want)


GEMM_CASES = tuple(c for c in CASES if c.kernel == "ring_gemm_q")


@pytest.mark.gpu
@pytest.mark.parametrize("case", GEMM_CASES, ids=lambda c: c.name)
def test_gemm_takes_the_mode_of_its_tiling_on_card(case):
    """``ring_gemm_q`` runs one CTA in an ordinary launch where
    ``quantized.gemm_q_tiling`` gives one, else its column tiles under a
    grid barrier (ToyADMOS's wider layers and the FC edge cases in place
    with a short last tile, ``gemm_q_inplace_uneven`` and
    ``gemm_q_widen``); bitwise the plain version either way."""
    _need_card()
    kw = case.kwargs
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    t = gemm_q_tiling(kw["m_rows"], kw["d_in"], kw["d_out"], n_sm)
    pool, params = case_inputs(case, seed=0)
    cuda_params = [torch.from_numpy(a).cuda() for a in params]
    want = torch.from_numpy(pool).cuda()
    PLAIN[case.kernel](want, *cuda_params, **kw)
    got = torch.from_numpy(pool).cuda()
    KERNELS[case.kernel](got, *cuda_params, **kw)
    torch.cuda.synchronize()
    assert KERNELS[case.kernel].barrier is t.barrier is (t.ctas > 1)
    assert torch.equal(got, want)


GRU_CASES = tuple(c for c in CASES if c.kernel == "ring_gru_cell_q")


@pytest.mark.gpu
@pytest.mark.parametrize("one", (True, False), ids=("one_cta", "tiles"))
@pytest.mark.parametrize("case", GRU_CASES, ids=lambda c: c.name)
def test_gru_in_each_mode_on_card(case, one, monkeypatch):
    """``ring_gru_cell_q`` bitwise the plain version in both modes of
    ``stream.gru_q_tiling`` (one CTA in an ordinary launch, channel tiles
    under a grid barrier), forced; and, unforced, in the mode its rule
    gives."""
    _need_card()
    kw = case.kwargs
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rule = gru_q_tiling(kw["d_in"], kw["d_h"], n_sm)
    pool, params = case_inputs(case, seed=0)
    cuda_params = [torch.from_numpy(a).cuda() for a in params]
    want = torch.from_numpy(pool).cuda()
    PLAIN[case.kernel](want, *cuda_params, **kw)
    got = torch.from_numpy(pool).cuda()
    KERNELS[case.kernel](got, *cuda_params, **kw)
    torch.cuda.synchronize()
    assert KERNELS[case.kernel].barrier is rule.barrier is (rule.ctas > 1)
    assert torch.equal(got, want)
    monkeypatch.setattr(stream_kernels, "gru_q_tiling",
                        lambda d_in, d_h, n: gru_q_tiling(d_in, d_h, n, one))
    got = torch.from_numpy(pool).cuda()
    KERNELS[case.kernel](got, *cuda_params, **kw)
    torch.cuda.synchronize()
    assert KERNELS[case.kernel].barrier is not one
    assert torch.equal(got, want)


#: Launches of ``run`` on the 8 golden inputs, per kernel.
SERVED_LAUNCHES = {
    "ds-cnn": {"ring_gemm_q": 8, "ring_conv_pw_q": 32, "ring_conv_dw_q": 32,
               "ring_conv_k2d_q": 8, "ring_avgpool_q": 8},
    "resnet-8": {"ring_gemm_q": 8, "ring_conv_pw_q": 16,
                 "ring_conv_k2d_q": 56, "ring_add_q": 24,
                 "ring_avgpool_q": 8},
    "mcunet-5fps-vww": {"ring_gemm_q": 8, "ring_conv_pw_q": 168,
                        "ring_conv_dw_q": 64, "ring_add_q": 56,
                        "ring_avgpool_q": 8},
    "ad-toyadmos": {"ring_gemm_q": 80},
    # the zoo plans' goldens hold 2 inputs
    "mobilenetv1-0.25": {"ring_gemm_q": 2, "ring_conv_pw_q": 26,
                         "ring_conv_dw_q": 26, "ring_conv_k2d_q": 2,
                         "ring_avgpool_q": 2},
    "mcunet-320kb-imagenet": {"ring_gemm_q": 2, "ring_conv_pw_q": 72,
                              "ring_conv_dw_q": 34, "ring_add_q": 20,
                              "ring_avgpool_q": 2},
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", NETS + ZOO)
def test_served_main_path_equals_golden_on_card(name):
    _need_card()
    cn, golden = load(_artifact(name)), _golden(name)
    reset_launch_counts()
    y = cn.run(golden["x"])
    torch.cuda.synchronize()
    assert y.device.type == "cuda"
    assert {k: n for k, n in launch_counts().items() if n} \
        == SERVED_LAUNCHES[name]
    np.testing.assert_array_equal(y.cpu().numpy(), golden["y"])
    qparams = to_device(cn.qnet.qparams, "cuda")
    for i, x in enumerate(golden["x"]):
        xq = quantize(torch.from_numpy(x).cuda(),
                      QParams(scale=cn.qnet.in_scale))
        y_q, pool = run_program(cn.program, xq, qparams)
        np.testing.assert_array_equal(y_q.cpu().numpy(), golden["y_q"][i])
        sha = hashlib.sha256(pool.array.cpu().numpy().tobytes()).hexdigest()
        assert sha == golden["pool_sha256"][i]


@pytest.mark.gpu
def test_sliced_plan_equals_golden_on_card():
    """The sliced plan served on the card: float outputs, int8 outputs
    and final pools bitwise the reference's golden, at exactly 98 pw, 48
    dw, 10 add, 1 pool and 1 FC launches an inference."""
    _need_card()
    cn, golden = _sliced()
    reset_launch_counts()
    y = cn.run(golden["x"])
    torch.cuda.synchronize()
    n = len(golden["x"])
    assert {k: c for k, c in launch_counts().items() if c} \
        == {k: c * n for k, c in SLICED_LAUNCHES.items()}
    np.testing.assert_array_equal(y.cpu().numpy(), golden["y"])
    qparams = to_device(cn.qnet.qparams, "cuda")
    for i, x in enumerate(golden["x"]):
        xq = quantize(torch.from_numpy(x).cuda(),
                      QParams(scale=cn.qnet.in_scale))
        y_q, pool = run_program(cn.program, xq, qparams)
        np.testing.assert_array_equal(y_q.cpu().numpy(), golden["y_q"][i])
        sha = hashlib.sha256(pool.array.cpu().numpy().tobytes()).hexdigest()
        assert sha == golden["pool_sha256"][i]


def _traced_plan(label):
    if label == SLICED:
        cn, g = _sliced()
    elif label.endswith("-f32"):
        cn = load(_float_artifact(label[:-4]))
        g = _float_golden(label[:-4])
    else:
        cn, g = load(_artifact(label)), _golden(label)
    return cn, g["x"][0]


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["ds-cnn", "mcunet-5fps-vww-f32", SLICED])
def test_a_traced_run_is_the_untraced_one_on_card(label):
    """``run(x, trace=True)`` on the card: the same bits as the untraced
    run, the certificate's traffic, the static trace's canonical form
    (the CPU's), and a time for every op from its CUDA events."""
    _need_card()
    cn, x = _traced_plan(label)
    y = cn.run(x)
    y_t, art = cn.run(x, trace=True)
    assert torch.equal(y_t, y) and art.backend == "cuda"
    seg_bytes = cn.program.seg_width * cn.program.elem_bytes
    assert art.totals["bytes_loaded"] == cn.certificate["reads"] * seg_bytes
    assert art.totals["bytes_stored"] == \
        cn.certificate["writes"] * seg_bytes
    assert art.watermark_bytes == cn.program.pool_bytes
    _, cpu = cn.run(x, device="cpu", trace=True)
    assert dict(art.canonical(), backend=None) == \
        dict(cpu.canonical(), backend=None)
    ops = [e for e in art.events if 0 <= e["index"] < len(cn.program.ops)]
    assert len(ops) == len(cn.program.ops)
    assert all(e["wall_us"] > 0 for e in ops)


@pytest.mark.gpu
def test_a_traced_stream_is_the_untraced_one_on_card():
    _need_card()
    cn, golden = load(_artifact("ds-cnn-stream")), _golden("ds-cnn-stream")
    plain, traced = cn.stream(), cn.stream(trace=True)
    for f in golden["x_q"][:10]:
        f = torch.from_numpy(f).cuda()
        assert torch.equal(traced.step(f), plain.step(f))
    assert len(traced.traces) == 10
    assert all(t.backend == "cuda" and t.totals["wall_us"] > 0
               for t in traced.traces)


#: Launches of 60 ``step`` calls, per kernel.
STREAM_LAUNCHES = {
    "ds-cnn-stream": {"ring_conv_stream_q": 60, "ring_conv_dw_q": 240,
                      "ring_conv_pw_q": 240, "ring_avgpool_q": 60,
                      "ring_gemm_q": 60},
    "kws-gru-chain": {"ring_conv_stream_q": 60, "ring_avgpool_q": 60,
                      "ring_gru_cell_q": 60},
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", STREAMS)
def test_stream_equals_golden_on_card(name):
    _need_card()
    cn, golden = load(_artifact(name)), _golden(name)
    s = cn.stream()
    reset_launch_counts()
    for i, f in enumerate(golden["x_q"]):
        y = s.step(torch.from_numpy(f).cuda())
        assert y.device.type == "cuda"
        np.testing.assert_array_equal(y.cpu().numpy(), golden["y_q"][i])
    torch.cuda.synchronize()
    assert {k: n for k, n in launch_counts().items() if n} \
        == STREAM_LAUNCHES[name]
    sha = hashlib.sha256(s.pool.array.cpu().numpy().tobytes()).hexdigest()
    assert sha == str(golden["pool_sha256"])


@pytest.mark.gpu
@pytest.mark.parametrize("case", F32_CASES, ids=lambda c: c.name)
def test_fp32_cuda_kernel_matches_plain_on_card(case):
    _need_card()
    pool, params = case_inputs(case, seed=0)
    cuda_params = [torch.from_numpy(a).cuda() for a in params]
    want = torch.from_numpy(pool).cuda()
    PLAIN[case.kernel](want, *cuda_params, **case.kwargs)
    got = torch.from_numpy(pool).cuda()
    KERNELS[case.kernel](got, *cuda_params, **case.kwargs)
    torch.cuda.synchronize()
    live = live_lanes(case.n_seg, output_regions(case.kernel, case.kwargs))
    err, bad = compare_f32(got.cpu().numpy(), want.cpu().numpy(), live)
    assert bad is None, bad


F32_GRU_CASES = tuple(c for c in F32_CASES if c.kernel == "ring_gru_cell")


@pytest.mark.gpu
@pytest.mark.parametrize("one", (True, False), ids=("one_cta", "tiles"))
@pytest.mark.parametrize("case", F32_GRU_CASES, ids=lambda c: c.name)
def test_f32_gru_in_each_mode_on_card(case, one, monkeypatch):
    """``ring_gru_cell`` within the tolerance of the plain version in both
    modes of ``stream.gru_tiling`` (one CTA in an ordinary launch where
    its W and U fit one CTA's shared memory, channel tiles under a grid
    barrier), forced; and, unforced, in the mode its rule gives."""
    _need_card()
    kw = case.kwargs
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rule = gru_tiling(kw["d_in"], kw["d_h"], n_sm)
    pool, params = case_inputs(case, seed=0)
    cuda_params = [torch.from_numpy(a).cuda() for a in params]
    want = torch.from_numpy(pool).cuda()
    PLAIN[case.kernel](want, *cuda_params, **kw)
    live = live_lanes(case.n_seg, output_regions(case.kernel, kw))
    got = torch.from_numpy(pool).cuda()
    KERNELS[case.kernel](got, *cuda_params, **kw)
    torch.cuda.synchronize()
    assert KERNELS[case.kernel].barrier is rule.barrier is (rule.ctas > 1)
    assert compare_f32(got.cpu().numpy(), want.cpu().numpy(), live)[1] \
        is None
    try:
        forced = gru_tiling(kw["d_in"], kw["d_h"], n_sm, one)
    except ValueError:            # W and U do not fit one CTA
        assert one and rule.barrier
        return
    monkeypatch.setattr(stream_kernels, "gru_tiling",
                        lambda d_in, d_h, n: forced)
    got = torch.from_numpy(pool).cuda()
    KERNELS[case.kernel](got, *cuda_params, **kw)
    torch.cuda.synchronize()
    assert KERNELS[case.kernel].barrier is not one
    assert compare_f32(got.cpu().numpy(), want.cpu().numpy(), live)[1] \
        is None


#: Launches of ``run`` on the 8 golden inputs of the fp32 plans.
FLOAT_LAUNCHES = {
    "ds-cnn": {"ring_gemm": 8, "ring_conv_pw": 32, "ring_conv_dw": 32,
               "ring_conv_k2d": 8, "ring_avgpool": 8},
    "resnet-8": {"ring_gemm": 8, "ring_conv_pw": 16, "ring_conv_k2d": 56,
                 "ring_add": 24, "ring_avgpool": 8},
    "mcunet-5fps-vww": {"ring_gemm": 8, "ring_conv_pw": 72,
                        "ring_conv_dw": 16, "ring_add": 16,
                        "ring_avgpool": 8, "ring_inverted_bottleneck": 48},
    "ad-toyadmos": {"ring_gemm": 80},
    "mobilenetv1-0.25": {"ring_gemm": 2, "ring_conv_pw": 26,
                         "ring_conv_dw": 26, "ring_conv_k2d": 2,
                         "ring_avgpool": 2},
    "mcunet-320kb-imagenet": {"ring_gemm": 2, "ring_conv_pw": 32,
                              "ring_conv_dw": 14, "ring_add": 2,
                              "ring_avgpool": 2,
                              "ring_inverted_bottleneck": 20},
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", FLOAT_NETS + ZOO)
def test_fp32_served_main_path_matches_golden_on_card(name):
    """The fp32 plan through its CUDA kernels: outputs within the
    tolerance of the golden, and each final pool within it of the final
    pool the plain versions leave on the card, channel tails zero."""
    _need_card()
    cn, golden = load(_float_artifact(name)), _float_golden(name)
    reset_launch_counts()
    y = cn.run(golden["x"])
    torch.cuda.synchronize()
    assert y.device.type == "cuda"
    assert {k: n for k, n in launch_counts().items() if n} \
        == FLOAT_LAUNCHES[name]
    scale = float(np.abs(golden["y"]).max())
    np.testing.assert_allclose(y.cpu().numpy(), golden["y"], rtol=RTOL,
                               atol=ATOL_REL * scale)
    params = to_device(cn.params, "cuda")
    kbr = cn.target.kernel_block_rows
    live = program_live_lanes(cn.program, cn.params, kernel_block_rows=kbr)
    for x in golden["x"][:2]:
        _, pool = run_program(cn.program, torch.from_numpy(x).cuda(),
                              params, kernel_block_rows=kbr)
        want = plain_pool(cn.program, torch.from_numpy(x).cuda(),
                          cn.params, kernel_block_rows=kbr)
        got = pool.array.cpu().numpy()
        err, bad = compare_f32(got, want.cpu().numpy(), live)
        assert bad is None, bad
        assert not got[~live].any()


#: Launches of 60 fp32 ``step`` calls, per kernel.
FLOAT_STREAM_LAUNCHES = {
    "ds-cnn-stream": {"ring_conv_stream": 60, "ring_conv_dw": 240,
                      "ring_conv_pw": 240, "ring_avgpool": 60,
                      "ring_gemm": 60},
    "kws-gru-chain": {"ring_conv_stream": 60, "ring_avgpool": 60,
                      "ring_gru_cell": 60},
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", STREAMS)
def test_fp32_stream_matches_golden_on_card(name):
    """The fp32 stream through its CUDA kernels: every step's output
    within the tolerance of the golden, and the last pool within it of
    the pool the plain versions leave on the card over the same frames,
    exact on channel tails, unwritten lanes and the window's copy."""
    _need_card()
    cn, golden = load(_float_artifact(name)), _float_golden(name)
    s = cn.stream()
    reset_launch_counts()
    frames = [torch.from_numpy(f).cuda() for f in golden["x"]]
    ys = [s.step(f) for f in frames]
    torch.cuda.synchronize()
    assert {k: n for k, n in launch_counts().items() if n} \
        == FLOAT_STREAM_LAUNCHES[name]
    scale = float(np.abs(golden["y"]).max())
    for i, y in enumerate(ys):
        assert y.device.type == "cuda"
        np.testing.assert_allclose(y.cpu().numpy(), golden["y"][i],
                                   rtol=RTOL, atol=ATOL_REL * scale,
                                   err_msg=f"step {i}")
    kbr = cn.target.kernel_block_rows
    want = plain_pool(cn.program, frames, cn.params, kernel_block_rows=kbr)
    live = program_live_lanes(cn.program, cn.params, kernel_block_rows=kbr)
    err, bad = compare_f32(s.pool.array.cpu().numpy(), want.cpu().numpy(),
                           live)
    assert bad is None, bad


@pytest.mark.gpu
def test_fp32_mlp_tower_matches_golden_on_card():
    """whisper-tiny's MLP tower through ``run(x)`` on the card, 2 inputs
    of 1,500 rows: 5 launches per inference (4 ``ring_fused_mlp``, 1
    ``ring_elementwise``); outputs within the tolerance of the golden
    rows and of ``reference_forward`` on every row; each final pool
    within it of the pool the plain versions leave, tails zero."""
    _need_card()
    cn, golden = _tower(), _float_golden(TOWER)
    x = np.random.default_rng(0).standard_normal(
        (2, cn.program.m_rows, cn.program.in_dim), np.float32)
    assert hashlib.sha256(x.tobytes()).hexdigest() == str(golden["x_sha256"])
    reset_launch_counts()
    y = cn.run(x)
    torch.cuda.synchronize()
    assert y.device.type == "cuda" and tuple(y.shape) == x.shape
    assert {k: n for k, n in launch_counts().items() if n} \
        == {"ring_fused_mlp": 8, "ring_elementwise": 2}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = KERNELS["ring_fused_mlp"].tiles
    assert tiles == mlp_tiling(1500, 384, 1536, 512, False, n_sm)
    assert 94 < tiles.ctas <= n_sm       # one wave, more than 94 blocks
    got = y.cpu().numpy()
    want = golden["y"]
    np.testing.assert_allclose(got[:, golden["rows"]], want, rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(want).max()))
    params = to_device(cn.params, "cuda")
    kbr = cn.target.kernel_block_rows
    live = program_live_lanes(cn.program, cn.params, kernel_block_rows=kbr)
    for i, xi in enumerate(x):
        xc = torch.from_numpy(xi).cuda()
        ref = reference_forward(cn.program, xc, params).cpu().numpy()
        np.testing.assert_allclose(got[i], ref, rtol=RTOL,
                                   atol=ATOL_REL * float(np.abs(ref).max()))
        _, pool = run_program(cn.program, xc, params, kernel_block_rows=kbr)
        plain = plain_pool(cn.program, xc, cn.params, kernel_block_rows=kbr)
        have = pool.array.cpu().numpy()
        err, bad = compare_f32(have, plain.cpu().numpy(), live)
        assert bad is None, bad
        assert not have[~live].any()


MLP_TILED = tuple(c for c in F32_MLP_EDGE_CASES if c.name in (
    "f32_mlp_gated_silu", "f32_mlp_uneven_rows", "f32_mlp_unaligned"))


@pytest.mark.gpu
@pytest.mark.parametrize("tm", range(1, 9))
@pytest.mark.parametrize("case", MLP_TILED, ids=lambda c: c.name)
def test_fused_mlp_every_row_block_matches_plain_on_card(case, tm,
                                                         monkeypatch):
    """Each of the kernel's row-block widths (16 to 128 rows) and sub-tile
    splits, forced, against the plain version."""
    _need_card()
    kw = case.kwargs
    # one sub-tile an ff tile at even TM, three (of a multiple of 4
    # columns, the last shorter) at odd TM
    sub = kw["ff_tile"] if tm % 2 == 0 else -(-kw["ff_tile"] // 12) * 4
    splits = -(-kw["ff_tile"] // sub)
    t = MlpTiling(kw["m_rows"], kw["d_model"], case.d_ff, kw["ff_tile"], tm,
                  sub, splits)
    monkeypatch.setattr(fused_mlp, "mlp_tiling", lambda *a, **k: t)
    pool, params = case_inputs(case, seed=0)
    cuda_params = [torch.from_numpy(a).cuda() for a in params]
    want = torch.from_numpy(pool).cuda()
    PLAIN[case.kernel](want, *cuda_params, **kw)
    got = torch.from_numpy(pool).cuda()
    KERNELS[case.kernel](got, *cuda_params, **kw)
    torch.cuda.synchronize()
    assert KERNELS[case.kernel].tiles is t
    live = live_lanes(case.n_seg, output_regions(case.kernel, kw))
    err, bad = compare_f32(got.cpu().numpy(), want.cpu().numpy(), live)
    assert bad is None, bad


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_CASES + LM_DECODE_CASES,
                         ids=lambda c: c.name)
def test_ring_decode_kernel_matches_plain_on_card(case):
    """fp32 within rtol and atol 2e-5, bf16 within one bf16 ulp of the
    output's scale; one launch per call, batch and all."""
    _need_card()
    q, k, v, seq = decode_inputs(case)
    dt = getattr(torch, case.dtype)
    args = [torch.from_numpy(a).cuda().to(dt) for a in (q, k, v)]
    seq = seq if isinstance(seq, int) else torch.from_numpy(seq).cuda()
    want = ring_decode_attention_plain(*args, seq, **case.kwargs)
    before = ring_decode_attention.launches
    got = ring_decode_attention(*args, seq, **case.kwargs)
    torch.cuda.synchronize()
    assert ring_decode_attention.launches == before + 1
    assert got.dtype == dt and got.shape == want.shape
    err, bad = compare_decode(got.float().cpu().numpy(),
                              want.float().cpu().numpy(), case.dtype)
    assert bad is None, bad


@pytest.mark.gpu
@pytest.mark.parametrize("case", SLICE_DECODE_CASES, ids=lambda c: c.name)
def test_ring_decode_return_lse_matches_plain_on_card(case):
    """``return_lse`` on a rank's slice of gemma3-1b's global cache and
    whisper-tiny's self caches (batch 4 and 1; part filled, full, empty,
    one of each in a batch of 4): the output within
    one bf16 ulp of the plain version's, an empty row 0; the log-sum-exp
    within rtol and atol 2e-5, ``-inf`` exactly on the empty rows; no
    NaN; one launch per call; and the call without the flag unchanged
    (the same output as the one with it where a row has valid slots)."""
    _need_card()
    q, k, v, seq = decode_inputs(case)
    args = [torch.from_numpy(a).cuda().to(torch.bfloat16) for a in (q, k, v)]
    seq = seq if isinstance(seq, int) else torch.from_numpy(seq).cuda()
    want, want_lse = ring_decode_attention_plain(*args, seq, **case.kwargs,
                                                 return_lse=True)
    before = ring_decode_attention.launches
    got, lse = ring_decode_attention(*args, seq, **case.kwargs,
                                     return_lse=True)
    plain_call = ring_decode_attention(*args, seq, **case.kwargs)
    torch.cuda.synchronize()
    assert ring_decode_attention.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert lse.dtype == torch.float32 and lse.shape == want_lse.shape
    assert not torch.isnan(got).any() and not torch.isnan(lse).any()
    err, bad = compare_decode(got.float().cpu().numpy(),
                              want.float().cpu().numpy(), case.dtype)
    assert bad is None, bad
    _, bad = compare_lse(lse.cpu().numpy(), want_lse.cpu().numpy())
    assert bad is None, bad
    live = torch.as_tensor(seq).expand(case.batch).cpu() >= 1
    assert torch.equal(got[live.cuda()], plain_call[live.cuda()])
    assert (got[~live.cuda()] == 0).all()


@pytest.mark.gpu
def test_reduced_gemma3_serves_through_the_decode_kernel_on_card():
    """Reduced gemma3-1b (6 layers, window 32) generates 8 tokens for 3
    prompts (one longer than the window) with exactly one
    ``ring_decode_attention`` launch per layer per decode step; its
    logits, teacher-forced on its tokens, are within the bf16 tolerance
    of the plain path's, and it holds the reduced golden."""
    _need_card()
    cfg = get_config("gemma3-1b").reduced()
    params = params_from_reference(cfg, lm_params(cfg, 0), "cuda")
    model, plain = build_model(cfg), build_model(cfg, plain=True)
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, n)]
               for n in (40, 9, 21)]
    reset_launch_counts()
    out = ServingEngine(model, params, cache_len=48).generate(prompts, 8)
    torch.cuda.synchronize()
    assert {k: n for k, n in launch_counts().items() if n} \
        == {"ring_decode_attention": cfg.n_layers * 8}
    toks = torch.tensor([[0] * (40 - len(p)) + p for p in prompts],
                        device="cuda")
    lk, ck, curk = model.prefill(params, toks, cache_len=48)
    lp, cp, curp = plain.prefill(params, toks, cache_len=48)
    for t in range(8):
        tok = torch.tensor([row[t] for row in out], device="cuda")
        assert lk.argmax(-1).tolist() == tok.tolist()
        lk, ck, curk = model.decode_step(params, ck, tok, curk)
        lp, cp, curp = plain.decode_step(params, cp, tok, curp)
        want = lp.float().cpu().numpy()
        err, ok = logits_close(lk.float().cpu().numpy(), want,
                               float(np.abs(want).max()))
        assert ok, (t, err)
    with np.load(ASSETS / f"{cfg.name}.golden.npz") as g:
        held = hold_lm_golden(model, params, dict(g))
    assert held["ok"], held


#: Each other block kind's reduced LM and its decode-kernel launches per
#: decode step (self-attention layers, plus cross layers' memory).
NEW_KIND_LMS = {"recurrentgemma-2b": 1, "mamba2-780m": 0,
                "granite-moe-1b-a400m": 2, "deepseek-moe-16b": 2,
                "whisper-tiny": 4, "llama-3.2-vision-90b": 6}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(NEW_KIND_LMS))
def test_reduced_new_kinds_serve_through_the_decode_kernel_on_card(name):
    """Each other block kind at reduced width (rec and a 32-slot ring the
    40-token prompt wraps; ssm; MoE; lead layers and a shared expert;
    cross-attention over encoder frames and image tokens; an untied
    unembedding) generates 8 tokens for 3 prompts with exactly the
    stated ``ring_decode_attention`` launches per decode step and no
    other kernel; its prefill and decode logits, teacher-forced on its
    tokens, are within the bf16 tolerance of the plain path's (a row of
    an MoE config that misses is let pass only from the step on where
    the two paths' routings, ``moe.Routing``, really sent one of its
    tokens to other experts); and it holds its reduced golden where one
    is committed."""
    _need_card()
    cfg = get_config(name).reduced()
    params = params_from_reference(cfg, lm_params(cfg, 0), "cuda")
    model, plain = build_model(cfg), build_model(cfg, plain=True)
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, n)]
               for n in (40, 9, 21)]
    mem = lm_memory(cfg, 0, 3)
    mem = None if mem is None else torch.from_numpy(mem).cuda()
    reset_launch_counts()
    out = ServingEngine(model, params, cache_len=48).generate(
        prompts, 8, memory=mem)
    torch.cuda.synchronize()
    per_step = NEW_KIND_LMS[name]
    assert {k: n for k, n in launch_counts().items() if n} \
        == ({"ring_decode_attention": per_step * 8} if per_step else {})
    toks = torch.tensor([[0] * (40 - len(p)) + p for p in prompts],
                        device="cuda")
    apart = np.zeros(3, bool)
    rk, rp = [], []
    lk, ck, curk = model.prefill(params, toks, cache_len=48, memory=mem,
                                 routes=rk)
    lp, cp, curp = plain.prefill(params, toks, cache_len=48, memory=mem,
                                 routes=rp)
    for t in range(9):
        if rk:
            apart |= routed_apart(route_codes(rk), route_codes(rp)).any(1)
            rk.clear()
            rp.clear()
        want = lp.float().cpu().numpy()
        scale = float(np.abs(want).max())
        got = lk.float().cpu().numpy()
        for b in range(3):
            err, ok = logits_close(got[b], want[b], scale)
            assert ok or apart[b], (t, b, err)
        if t == 8:
            break
        tok = torch.tensor([row[t] for row in out], device="cuda")
        assert lk.argmax(-1).tolist() == tok.tolist()
        lk, ck, curk = model.decode_step(params, ck, tok, curk, routes=rk)
        lp, cp, curp = plain.decode_step(params, cp, tok, curp, routes=rp)
    path = ASSETS / f"{cfg.name}.golden.npz"
    if path.exists():
        with np.load(path) as g:
            held = hold_lm_golden(model, params, dict(g))
        assert held["ok"], held


# ---------------------------------------------------------------------------
# Plans the port compiled itself (``repro_torch.compile``), on the card.
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_port_compiled_int8_ds_cnn_runs_on_card():
    """DS-CNN compiled by the port from the reference's params and
    calibration inputs: the committed artifact's program, the same
    launches as the artifact's plan on the golden inputs, outputs equal
    to the plain CPU path bitwise and within one int8 step of the
    output scale of the golden."""
    _need_card()
    from repro_torch import compile as port_compile
    from repro_torch.compile.artifact import read_compile_inputs

    params, calib = read_compile_inputs(
        ASSETS / "ds-cnn.cortex-m4.int8.compile.npz")
    cn = port_compile("ds-cnn", "cortex-m4", params=params, calib=calib)
    loaded, golden = load(_artifact("ds-cnn")), _golden("ds-cnn")
    assert cn.program == loaded.program
    assert cn.certificate == loaded.certificate
    counts = []
    for net in (loaded, cn):
        reset_launch_counts()
        y = net.run(golden["x"])
        torch.cuda.synchronize()
        counts.append({k: n for k, n in launch_counts().items() if n})
    assert counts[0] == counts[1] and len(counts[1]) == 5
    assert y.device.type == "cuda"
    assert torch.equal(y.cpu(), cn.run(golden["x"], device="cpu"))
    step = cn.qnet.out_scale
    assert np.abs(y.cpu().numpy() - golden["y"]).max() <= step * (1 + 1e-4)


@pytest.mark.gpu
def test_port_compiled_fp32_vww_runs_on_card():
    """VWW compiled by the port for ``host-sim`` with its artifact's
    params: the artifact's program, its exact launches, and outputs
    within the tolerance of the golden."""
    _need_card()
    from repro_torch import compile as port_compile
    from repro_torch.compile.artifact import decode, load as load_payload

    payload = load_payload(_float_artifact("mcunet-5fps-vww"))
    cn = port_compile("mcunet-5fps-vww", "host-sim",
                      params=decode(payload["params"]))
    assert cn.program.to_json_dict() == payload["program"]
    golden = _float_golden("mcunet-5fps-vww")
    reset_launch_counts()
    y = cn.run(golden["x"])
    torch.cuda.synchronize()
    assert {k: n for k, n in launch_counts().items() if n} \
        == FLOAT_LAUNCHES["mcunet-5fps-vww"]
    scale = float(np.abs(golden["y"]).max())
    np.testing.assert_allclose(y.cpu().numpy(), golden["y"], rtol=RTOL,
                               atol=ATOL_REL * scale)


@pytest.mark.gpu
def test_port_compiled_fp32_stream_runs_on_card():
    """The fp32 DS-CNN stream compiled by the port (``streaming=True``)
    with its artifact's params: the artifact's program, 60 steps with
    the stream's exact launches, each within the tolerance of the
    golden."""
    _need_card()
    from repro_torch import compile as port_compile
    from repro_torch.compile.artifact import decode, load as load_payload

    payload = load_payload(_float_artifact("ds-cnn-stream"))
    cn = port_compile("ds-cnn", "host-sim", streaming=True,
                      params=decode(payload["params"]))
    assert cn.program.to_json_dict() == payload["program"]
    golden = _float_golden("ds-cnn-stream")
    s = cn.stream()
    reset_launch_counts()
    ys = [s.step(torch.from_numpy(f).cuda()) for f in golden["x"]]
    torch.cuda.synchronize()
    assert {k: n for k, n in launch_counts().items() if n} \
        == FLOAT_STREAM_LAUNCHES["ds-cnn-stream"]
    scale = float(np.abs(golden["y"]).max())
    for i, y in enumerate(ys):
        np.testing.assert_allclose(y.cpu().numpy(), golden["y"][i],
                                   rtol=RTOL, atol=ATOL_REL * scale,
                                   err_msg=f"step {i}")


def _counted_outputs(net, x, stream: bool):
    """``net``'s outputs on ``x`` (run, or stream step by step) on the
    card, and the launches they took."""
    reset_launch_counts()
    if stream:
        s = net.stream()
        y = torch.stack([s.step(torch.from_numpy(f).cuda()) for f in x])
    else:
        y = net.run(x)
    torch.cuda.synchronize()
    return {k: n for k, n in launch_counts().items() if n}, y.cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ds-cnn", "mcunet-5fps-vww",
                                  "ds-cnn-stream"])
def test_statically_certified_compiles_run_on_card(name):
    """The three plans the port compiles on the card's host, certified
    with ``certify="static"``: a static proof with the committed
    artifact's program and certificate, then, on the card, the launches
    of the artifact's plan and outputs within the golden's tolerance
    (DS-CNN int8: one int8 step of the output scale)."""
    _need_card()
    from repro_torch import compile as port_compile
    from repro_torch.compile.artifact import (decode, load as load_payload,
                                              read_compile_inputs)

    stream = name == "ds-cnn-stream"
    if name == "ds-cnn":
        params, calib = read_compile_inputs(
            ASSETS / "ds-cnn.cortex-m4.int8.compile.npz")
        cn = port_compile("ds-cnn", "cortex-m4", params=params, calib=calib,
                          certify="static")
        loaded, golden = load(_artifact(name)), _golden(name)
    else:
        payload = load_payload(_float_artifact(name))
        cn = port_compile("ds-cnn" if stream else name, "host-sim",
                          streaming=stream, certify="static",
                          params=decode(payload["params"]))
        loaded, golden = load(_float_artifact(name)), _float_golden(name)
    note = next(p.note for p in cn.passes if p.name == "certify")
    assert note.startswith("static proof"), note
    assert cn.program == loaded.program
    assert cn.certificate == loaded.certificate
    want_counts, _ = _counted_outputs(loaded, golden["x"], stream)
    counts, y = _counted_outputs(cn, golden["x"], stream)
    assert counts == want_counts
    if name == "ds-cnn":
        step = cn.qnet.out_scale
        assert np.abs(y - golden["y"]).max() <= step * (1 + 1e-4)
    else:
        scale = float(np.abs(golden["y"]).max())
        np.testing.assert_allclose(y, golden["y"], rtol=RTOL,
                                   atol=ATOL_REL * scale)


# -- the mesh path: a one-rank NCCL mesh, and two gloo ranks ------------------

@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL group over a FileStore and its 1 x 1 ``("data",
    "model")`` mesh (``make_host_mesh``), ended after the module."""
    _need_card()
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1, 1)
    assert dist.get_backend() == "nccl"
    yield mesh
    dist.destroy_process_group()


def _mesh_rules(cfg, mesh, kind):
    from repro_torch.configs.base import DECODE_32K, TRAIN_4K
    from repro_torch.launch.specs import make_rules

    return make_rules(cfg, mesh, DECODE_32K if kind == "decode" else TRAIN_4K)


@pytest.mark.gpu
def test_reduced_gemma3_on_a_one_rank_nccl_mesh_is_the_unsharded_path(
        nccl_mesh):
    """Reduced gemma3-1b on the one-rank NCCL mesh, its params DTensors
    placed by ``params_shardings``: the served tokens are the unsharded
    engine's, through one ``ring_decode_attention`` launch per layer per
    decode step; 2 train steps on DTensor state give the unsharded
    steps' losses, grad_norms and new params (within rtol 1e-5, atol
    1e-6 x max; one rank sums in the same order)."""
    from repro_torch.parallel import place_tree
    from repro_torch.train import init_state, make_train_step, \
        sharded_batch, synthetic_batch
    from repro_torch.train.tree import leaves, unflatten_like

    cfg = get_config("gemma3-1b").reduced()
    model = build_model(cfg)
    params = params_from_reference(cfg, lm_params(cfg, 0), "cuda")
    rules = _mesh_rules(cfg, nccl_mesh, "decode")
    placed = place_tree(params, rules.params_shardings(params))
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, n)]
               for n in (40, 9, 21)]
    want = ServingEngine(model, params, cache_len=48).generate(prompts, 8)
    reset_launch_counts()
    got = ServingEngine(model, placed, rules=rules,
                        cache_len=48).generate(prompts, 8)
    torch.cuda.synchronize()
    assert got == want
    assert {k: n for k, n in launch_counts().items() if n} \
        == {"ring_decode_attention": cfg.n_layers * 8}

    tree = lm_params(cfg, 0)
    rules = _mesh_rules(cfg, nccl_mesh, "train")

    def fresh():
        return init_state(unflatten_like(tree, [
            torch.from_numpy(np.array(a, np.float32)).cuda()
            for a in leaves(tree)]))
    plain, sharded = fresh(), fresh()
    sharded = place_tree(sharded, sharded._replace(
        step=None, params=rules.params_shardings(sharded.params),
        mu=rules.params_shardings(sharded.mu),
        nu=rules.params_shardings(sharded.nu)))
    rows = {"tokens": rules.sharding("batch", None),
            "labels": rules.sharding("batch", None)}
    step, mesh_step = make_train_step(model), make_train_step(model, rules)
    for i in range(2):
        plain, m1 = step(plain, synthetic_batch(cfg, 4, 32, i,
                                                device="cuda"))
        sharded, m2 = mesh_step(sharded, sharded_batch(cfg, 4, 32, i, rows))
        for k in ("loss", "grad_norm"):
            assert abs(float(m2[k]) - float(m1[k])) <= 1e-5 * abs(float(m1[k]))
    for got, want in zip(leaves(sharded.params), leaves(plain.params)):
        got = got.full_tensor()
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))


@pytest.mark.gpu
def test_a_sharded_checkpoint_restores_onto_the_mesh_on_card(nccl_mesh,
                                                             tmp_path):
    """A DTensor train state saved on the one-rank NCCL mesh and restored
    with ``shardings=params_shardings`` is the live state bitwise, each
    leaf a DTensor in its placements; its files are those the unsharded
    state writes."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.parallel import place_tree
    from repro_torch.parallel.sharding import is_dtensor
    from repro_torch.train import init_state
    from repro_torch.train.train_step import eval_state_shapes
    from repro_torch.train.tree import leaves, unflatten_like

    cfg = get_config("gemma3-1b").reduced()
    tree = lm_params(cfg, 0)
    rules = _mesh_rules(cfg, nccl_mesh, "train")
    state = init_state(unflatten_like(tree, [
        torch.from_numpy(np.array(a, np.float32)).cuda()
        for a in leaves(tree)]))
    shardings = state._replace(
        step=None, params=rules.params_shardings(state.params),
        mu=rules.params_shardings(state.mu),
        nu=rules.params_shardings(state.nu))
    placed = place_tree(state, shardings)
    mgr = CheckpointManager(str(tmp_path / "mesh"))
    mgr.save(3, placed)
    back = mgr.restore(eval_state_shapes(build_model(cfg)), device="cuda",
                       shardings=shardings)
    for got, want in zip(leaves(back), leaves(placed)):
        assert is_dtensor(got) == is_dtensor(want)
        if is_dtensor(want):
            assert got.placements == want.placements
            got, want = got.to_local(), want.to_local()
        assert got.device.type == "cuda" and torch.equal(got, want)
    one = CheckpointManager(str(tmp_path / "one")).save(3, state)
    with np.load(pathlib.Path(one) / "shard_00000.npz") as a, \
            np.load(tmp_path / "mesh" / f"step_{3:010d}"
                    / "shard_00000.npz") as b:
        assert a.files == b.files
        assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)


def _gloo_collectives_rank(rank: int, world: int, store: str) -> None:
    """One rank of :func:`test_collectives_over_two_gloo_ranks`: the
    process-group collectives against the one-process forms."""
    import torch.distributed as dist

    from repro_torch.parallel import (bucketed_psum, bucketed_psum_stacked,
                                      compressed_psum,
                                      compressed_psum_stacked)

    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        xs = [torch.from_numpy(np.random.default_rng([5, r])
                               .standard_normal(300).astype(np.float32)
                               * (r + 1)) for r in range(world)]
        assert torch.equal(compressed_psum(xs[rank]),
                           compressed_psum_stacked(xs)[rank])
        trees = [{"a": x[:100].reshape(10, 10), "b": x[100:]} for x in xs]
        for compressed in (True, False):
            got = bucketed_psum(trees[rank], bucket_bytes=128,
                                compressed=compressed)
            want = bucketed_psum_stacked(trees, bucket_bytes=128,
                                         compressed=compressed)[rank]
            for k in want:
                if compressed:
                    assert torch.equal(got[k], want[k]), k
                else:
                    torch.testing.assert_close(
                        got[k], want[k], rtol=1e-6,
                        atol=1e-6 * float(want[k].abs().max()))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_collectives_over_two_gloo_ranks(tmp_path):
    """Two spawned gloo ranks over a FileStore: ``compressed_psum`` and
    ``bucketed_psum`` (compressed: bitwise; else within rtol 1e-6) equal
    the one-process forms; each rank is joined with a timeout."""
    _need_card()
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_collectives_rank,
                         args=(r, 2, str(tmp_path / "store")))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    assert not any(alive) and [p.exitcode for p in procs] == [0, 0]
