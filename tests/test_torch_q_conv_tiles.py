"""The tiling of the int8 pointwise and k x k conv kernels, on the CPU.

``ring_conv_pw_q`` and ``ring_conv_k2d_q`` (``csrc/ring_q.cu``) run one
CTA per tile of ``repro_torch.kernels.conv2d.conv_tiling`` (kinds
``ring_conv_pw_q``, ``ring_conv_k2d_q``: a block of output image rows x
a channel tile), stage what the tile's taps reach (the pw the source
pixel of each output, the k x k conv its halo rows) at int8 widths, read
all of an op's input before a grid-wide barrier and store only after it.
Held here, on every ``conv_pw`` / ``conv_k2d`` op of the committed int8
plans (DS-CNN, ResNet-8, MCUNet-5fps-VWW, the DS-CNN stream), of the
reference's int8 ``mobilenetv1-0.25`` cortex-m4 plan (compiled once per
module; not served yet) and on every int8 pw / k2d edge case, at an H100
SXM's 132 SMs, an H100 PCIe's 114 and at 16:

* the tiles cover each (output row, channel) exactly once, and their
  stores each lane of every output pixel's segments exactly once, in
  whole 32-bit words (the last channel tile takes the channel tail);
* a tile's staged input rows hold every row its outputs read;
* one CTA's shared memory is at most ``MAX_SMEM`` and the CTAs at most
  the SMs; every op of the committed plans runs more than one CTA.

Also: the wrappers hand that tiling to the launch, a geometry that no
tile fits is refused with its shape named, and a CPU model of the
kernel (each CTA computes its tile from only what it stages, the
products summed mod 2**32 and the plain version's epilogue) is bitwise
the plain version when every CTA reads before any stores, while the
same model without the barrier (each CTA reads the pool as the CTAs
after it left it, then stores, the last tile first) differs on the three
in-place edge cases with a short last row block.
"""
import ctypes
import pathlib

import numpy as np
import pytest
import torch

import repro
from repro_torch import load
from repro_torch.core.executors import op_kernel_call
from repro_torch.core.program import PoolProgram
from repro_torch.core.rowsched import conv_k2d_pad, conv_k2d_pad_w
from repro_torch.core.vpool import fetch_rows
from repro_torch.kernels import quantized
from repro_torch.kernels._build import SIGNATURES
from repro_torch.kernels._launch import MAX_SMEM
from repro_torch.kernels.cases import EDGE_CASES, case_inputs, program_cases
from repro_torch.kernels.conv2d import conv_tiling, pw_sources, \
    q_pixel_pitch
from repro_torch.quant.requant import requantize

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
PW, K2D = "ring_conv_pw_q", "ring_conv_k2d_q"
N_SM = (132, 114, 16)
#: The committed int8 plans with pointwise or k x k convs.
PLANS = ("ds-cnn", "resnet-8", "mcunet-5fps-vww", "ds-cnn-stream")
#: The reference's int8 plan compiled here (pw and k2d ops: 13 and 1).
MOBILENET = "mobilenetv1-0.25"
MOBILENET_OPS = 14


def _plan_cases(name):
    cn = load(ASSETS / f"{name}.cortex-m4.int8.json")
    return tuple(c for c in program_cases(
        cn.program, cn.qnet.qparams,
        kernel_block_rows=cn.target.kernel_block_rows, prefix=f"{name}_")
        if c.kernel in (PW, K2D))


PLAN_CASES = {n: _plan_cases(n) for n in PLANS}
EDGE = tuple(c for c in EDGE_CASES if c.kernel in (PW, K2D))
UNEVEN = tuple(c for c in EDGE if c.name.endswith("_inplace_uneven"))
CASES = sum(PLAN_CASES.values(), ()) + EDGE


@pytest.fixture(scope="module")
def mobilenet_ops():
    """``(kernel, kwargs)`` of every pw / k2d op of the reference's int8
    MobileNet plan (the geometry only: no weights are drawn)."""
    ref = repro.compile(MOBILENET, "cortex-m4", dtype="int8")
    program = PoolProgram.from_json_dict(ref.program.to_json_dict())
    return [op_kernel_call(program, op, (None,) * 4)[::2]
            for op in program.ops if op.kind in ("conv_pw", "conv_k2d")]


def _rows_read(kernel, kw, p):
    """The input image rows that output row ``p`` reads."""
    if kernel == PW:
        return [pw_sources(kw["h_in"], kw["h_out"], kw["stride"],
                           kw["resample"])[p]]
    top = p * kw["stride"] - conv_k2d_pad(kw["k"], kw["padding"])
    return [r for r in range(top, top + kw["k"]) if 0 <= r < kw["h_in"]]


def _hold_tiling(kernel, kw, n_sm):
    t = conv_tiling(kernel, kw, n_sm)
    h_out, w_out, c = kw["h_out"], kw["w_out"], kw["c_out"]
    assert 1 <= t.ctas <= n_sm and t.smem <= MAX_SMEM and t.stage_w
    assert t.held == t.rows * w_out * t.ctile          # a byte an output
    k = 1 if kernel == PW else kw["k"]
    staged = t.rows * w_out if kernel == PW else t.halo * kw["w_in"]
    assert t.smem >= t.held + q_pixel_pitch(kw["c_in"]) \
        * (staged + k * k * t.ctile) + 12 * t.ctile
    segs = -(-c // 128)
    outputs = np.zeros((h_out, c), int)
    stored = np.zeros((h_out, segs * 128), int)
    for i in range(t.ctas):
        p0, np_, c0, cn, lo, nh = t.tile(i)
        assert 1 <= np_ <= t.rows and cn >= 1 and c0 % 4 == 0
        assert kernel == PW or nh <= t.halo
        outputs[p0:p0 + np_, c0:c0 + cn] += 1
        end = segs * 128 if c0 + t.ctile >= c else c0 + t.ctile
        assert end % 4 == 0                          # whole 32-bit words
        stored[p0:p0 + np_, c0:end] += 1
        for p in range(p0, p0 + np_):
            assert all(lo <= r < lo + nh for r in _rows_read(kernel, kw, p))
    assert (outputs == 1).all() and (stored == 1).all()
    return t


def test_the_plans_have_the_ops_the_tiling_is_held_on(mobilenet_ops):
    assert [len(PLAN_CASES[n]) for n in PLANS] == [5, 9, 21, 4]
    assert [c.kernel for c in PLAN_CASES["resnet-8"]].count(K2D) == 7
    assert len(mobilenet_ops) == MOBILENET_OPS
    assert [k for k, _ in mobilenet_ops].count(K2D) == 1
    assert len(UNEVEN) == 3 and len(EDGE) == 9
    assert all(c.kwargs["in_ptr"] == c.kwargs["out_ptr"] for c in UNEVEN)


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_tiles_cover_every_output_once_and_fit(case, n_sm):
    _hold_tiling(case.kernel, case.kwargs, n_sm)


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("op", range(MOBILENET_OPS),
                         ids=[f"{MOBILENET}_op{i}" for i in
                              range(MOBILENET_OPS)])
def test_mobilenet_tiles_cover_every_output_once_and_fit(mobilenet_ops, op,
                                                         n_sm):
    _hold_tiling(*mobilenet_ops[op], n_sm)


@pytest.mark.parametrize("case", sum(PLAN_CASES.values(), ()),
                         ids=lambda c: c.name)
def test_plan_ops_run_many_ctas(case):
    t = conv_tiling(case.kernel, case.kwargs)
    assert t.ctas > 1 and t.stage_w
    if case.name.startswith(("ds-cnn_", "ds-cnn-stream_")):   # 25 x 5
        assert (t.ctas, t.rows, t.ctile) == (100, 1, 16)
    if case.name.startswith("resnet-8_"):
        assert (t.ctas, t.rows, t.ctile) == (128, 1, 4)
    if case.name.startswith("mcunet-5fps-vww_"):
        assert 40 <= t.ctas <= 120


def test_a_geometry_no_tile_fits_is_refused_with_its_shape(monkeypatch):
    wide = dict(h_in=1, w_in=8192, h_out=1, w_out=8192, c_in=512,
                c_out=512, stride=1, resample=False)
    with pytest.raises(ValueError, match=r"ring_conv_pw_q: no tile of the "
                       r"op \[1, 8192, 512\] -> \[1, 8192, 512\], k 1"):
        conv_tiling(PW, wide)
    tall = dict(h_in=4, w_in=4096, h_out=4, w_out=4096, c_in=64, c_out=64,
                k=3, stride=1, padding="same")
    with pytest.raises(ValueError, match=r"ring_conv_k2d_q: no tile of the "
                       r"op \[4, 4096, 64\] -> \[4, 4096, 64\], k 3"):
        conv_tiling(K2D, tall)
    # more channel tiles than SMs
    with pytest.raises(ValueError, match=K2D):
        conv_tiling(K2D, dict(tall, w_in=4, w_out=4, c_out=480), n_sm=2)
    # the wrapper refuses it before any launch
    monkeypatch.setattr(quantized, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(quantized, "_sm_count", lambda device: 132)
    monkeypatch.setattr(quantized, "_launch", None)
    pool = torch.zeros((4 * 4096, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match=r"\[4, 4096, 64\]"):
        quantized.ring_conv_k2d_q(pool, None, None, None, None, **tall)


@pytest.mark.parametrize("case", (EDGE[0], EDGE[3], UNEVEN[0], UNEVEN[2],
                                  PLAN_CASES["resnet-8"][0],
                                  PLAN_CASES["mcunet-5fps-vww"][4]),
                         ids=lambda c: c.name)
def test_wrapper_launches_with_its_tiling(case, monkeypatch):
    calls = []
    monkeypatch.setattr(quantized, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(quantized, "_sm_count", lambda device: 132)
    monkeypatch.setattr(quantized, "_launch",
                        lambda name, pool, smem, tensors, ints:
                        calls.append((name, smem, tensors, ints)))
    wrapper = quantized.KERNELS[case.kernel]
    monkeypatch.setattr(wrapper, "launches", 0)
    monkeypatch.setattr(wrapper, "weights_staged", None)
    pool, params = case_inputs(case, seed=0)
    params = tuple(map(torch.from_numpy, params))
    wrapper(torch.from_numpy(pool), *params, **case.kwargs)
    kw, n = case.kwargs, case.n_seg
    t = conv_tiling(case.kernel, kw)
    [(name, smem, tensors, ints)] = calls
    assert name == case.kernel and smem == t.smem
    assert all(a is b for a, b in zip(tensors, params, strict=True))
    assert len(ints) == SIGNATURES["ring_q"][name].count(ctypes.c_int)
    head = (n, kw["h_in"], kw["w_in"], kw["h_out"], kw["w_out"], kw["c_in"],
            kw["c_out"])
    if case.kernel == PW:
        assert ints[:9] == (*head, kw["stride"], int(kw["resample"]))
    else:
        k = kw["k"]
        assert ints[:11] == (*head, k, kw["stride"],
                             conv_k2d_pad(k, kw["padding"]),
                             conv_k2d_pad_w(k, kw["padding"]))
    assert ints[-5:-3] == (kw["in_ptr"] % n, kw["out_ptr"] % n)
    assert ints[-2:] == (t.rows, t.ctile)
    assert wrapper.launches == 1 and wrapper.weights_staged is True


# ---------------------------------------------------------------------------
# What the grid barrier is for: a model of the tiles' reads and stores.
# ---------------------------------------------------------------------------

def _cta_stores(case, t, i, pool, params):
    """CTA ``i``'s stores, ``(segments, lanes, values)``, computed as the
    kernel does from the pool ``pool``: from its staged input rows only
    (the pw's picked pixels of them), int64 products summed mod 2**32,
    then the plain version's bias, relu and requantization, over its rows
    x channel tile (the last channel tile with the channel tail)."""
    kw, n_seg = case.kwargs, pool.shape[0]
    w, b, mult, shift = params
    p0, np_, c0, cn, lo, nh = t.tile(i)
    h_in, w_in, w_out = kw["h_in"], kw["w_in"], kw["w_out"]
    c_in, c_out, stride = kw["c_in"], kw["c_out"], kw["stride"]
    row = w_in * -(-c_in // 128)
    staged = fetch_rows(pool, kw["in_ptr"] + lo * row, nh * w_in, c_in) \
        .reshape(nh, w_in, c_in).to(torch.int64)
    ws = w[..., c0:c0 + cn].to(torch.int64)
    if case.kernel == PW:
        rows = pw_sources(h_in, kw["h_out"], stride, kw["resample"])
        cols = pw_sources(w_in, w_out, stride, kw["resample"])
        x = staged[[r - lo for r in rows[p0:p0 + np_]]][:, cols]
        acc = (x.unsqueeze(-1) * ws).sum(-2)
    else:
        k = kw["k"]
        pad_v, pad_h = conv_k2d_pad(k, kw["padding"]), \
            conv_k2d_pad_w(k, kw["padding"])
        span = (np_ - 1) * stride + k
        right = max(0, (w_out - 1) * stride + k - pad_h - w_in)
        sub = torch.zeros((span, pad_h + w_in + right, c_in),
                          dtype=torch.int64)
        for r in range(span):
            src = p0 * stride - pad_v + r
            if 0 <= src < h_in:
                sub[r, pad_h:pad_h + w_in] = staged[src - lo]
        acc = 0
        for r in range(k):
            for s in range(k):
                tap = sub[r:r + (np_ - 1) * stride + 1:stride,
                          s:s + (w_out - 1) * stride + 1:stride]
                acc = acc + (tap.unsqueeze(-1) * ws[r, s]).sum(-2)
    acc = quantized._acc32(acc, b[c0:c0 + cn], kw["activation"])
    y = requantize(acc, mult[c0:c0 + cn], shift[c0:c0 + cn])
    segs = -(-c_out // 128)
    end = segs * 128 if c0 + t.ctile >= c_out else c0 + t.ctile
    values = torch.zeros((np_ * w_out, end - c0), dtype=torch.int8)
    values[:, :cn] = y.reshape(-1, cn)
    pix = torch.arange(p0 * w_out, (p0 + np_) * w_out)
    lanes = torch.arange(c0, end)
    seg = (kw["out_ptr"] + pix[:, None] * segs + lanes[None, :] // 128) \
        % n_seg
    return seg, lanes % 128, values


def _inputs(case):
    pool, params = case_inputs(case, seed=0)
    return torch.from_numpy(pool), [torch.from_numpy(a) for a in params]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_reading_first_is_bitwise_the_plain_version(case):
    pool, params = _inputs(case)
    want = pool.clone()
    quantized.PLAIN[case.kernel](want, *params, **case.kwargs)
    t = conv_tiling(case.kernel, case.kwargs)
    got = pool.clone()
    for seg, lanes, values in [_cta_stores(case, t, i, pool, params)
                               for i in reversed(range(t.ctas))]:
        got[seg, lanes] = values
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", UNEVEN, ids=lambda c: c.name)
def test_uneven_cases_tell_a_missing_barrier_from_reading_first(case):
    t = conv_tiling(case.kernel, case.kwargs)
    assert case.kwargs["h_out"] % t.rows and t.ctas > 100   # a short tile
    pool, params = _inputs(case)
    want = pool.clone()
    quantized.PLAIN[case.kernel](want, *params, **case.kwargs)
    # each CTA reads the pool as the CTAs after it left it, then stores:
    # the last tile, the short one, first
    no_barrier = pool.clone()
    for i in reversed(range(t.ctas)):
        seg, lanes, values = _cta_stores(case, t, i, no_barrier, params)
        no_barrier[seg, lanes] = values
    assert not torch.equal(no_barrier, want)
