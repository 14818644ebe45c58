"""The tiling of the fp32 depthwise and k x k conv kernels, on the CPU.

``ring_conv_dw`` and ``ring_conv_k2d`` (``csrc/ring_f32.cu``) run one
CTA per tile of ``repro_torch.kernels.conv2d.conv_tiling`` (a block of
output image rows x a channel tile), read all of an op's input before a
grid-wide barrier and store only after it.  Held here, on every
``conv_dw`` / ``conv_k2d`` op of the committed fp32 plans and on every
fp32 dw/k2d edge case, at an H100 SXM's 132 SMs, an H100 PCIe's 114 and
at 16:

* the tiles cover each (output row, pixel, channel) exactly once, and
  their stores each lane of every output pixel's segments exactly once
  (the last channel tile takes the channel tail);
* a tile's input rows cover every in-image tap of its outputs, within
  the ``halo`` rows its shared memory is sized for;
* one CTA's shared memory is at most ``MAX_SMEM`` and the CTAs at most
  the SMs; every op of the committed plans runs more than one CTA.

Also: the wrappers hand that tiling to the launch, a geometry that no
tile fits is refused with its shape named, and the in-place edge cases
tell a sequential walk of the rows from a kernel that reads everything
first (only the latter matches the plain version there).
"""
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import load
from repro_torch.core.rowsched import conv_k2d_pad
from repro_torch.kernels import conv2d
from repro_torch.kernels._launch import MAX_SMEM
from repro_torch.kernels.cases import (F32_EDGE_CASES, case_inputs,
                                       compare_f32, live_lanes,
                                       output_regions, program_cases)
from repro_torch.kernels.conv2d import conv_tiling

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
CONVS = ("ring_conv_dw", "ring_conv_k2d")
#: The committed fp32 plans with depthwise or k x k convs.
PLANS = ("ds-cnn", "resnet-8", "mcunet-5fps-vww", "ds-cnn-stream")


def _plan_cases(name):
    cn = load(ASSETS / f"{name}.host-sim.float32.json")
    return tuple(c for c in program_cases(
        cn.program, cn.params, kernel_block_rows=cn.target.kernel_block_rows,
        prefix=f"{name}_f32_") if c.kernel in CONVS)


PLAN_CASES = sum((_plan_cases(n) for n in PLANS), ())
EDGE = tuple(c for c in F32_EDGE_CASES if c.kernel in CONVS)
INPLACE = tuple(c for c in EDGE if "inplace" in c.name)


def _geometry(case):
    kw = case.kwargs
    dw = case.kernel == "ring_conv_dw"
    k = kw["rs"] if dw else kw["k"]
    c = kw["c"] if dw else kw["c_out"]
    return kw, k, c


@pytest.mark.parametrize("n_sm", (132, 114, 16))
@pytest.mark.parametrize("case", PLAN_CASES + EDGE, ids=lambda c: c.name)
def test_tiles_cover_every_output_once_and_fit(case, n_sm):
    kw, k, c = _geometry(case)
    t = conv_tiling(case.kernel, kw, n_sm)
    assert 1 <= t.ctas <= n_sm
    assert t.smem <= MAX_SMEM and t.held == 4 * t.rows * kw["w_out"] * t.ctile
    segs = -(-c // 128)
    outputs = np.zeros((kw["h_out"], c), int)
    stored = np.zeros((kw["h_out"], segs * 128), int)
    pad_v = conv_k2d_pad(k, kw["padding"])
    for i in range(t.ctas):
        p0, np_, c0, cn, lo, nh = t.tile(i)
        assert np_ >= 1 and cn >= 1 and nh <= t.halo
        outputs[p0:p0 + np_, c0:c0 + cn] += 1
        end = segs * 128 if c0 + t.ctile >= c else c0 + t.ctile
        stored[p0:p0 + np_, c0:end] += 1
        for p in range(p0, p0 + np_):
            for r in range(k):
                src = p * kw["stride"] - pad_v + r
                if 0 <= src < kw["h_in"]:
                    assert lo <= src < lo + nh, (i, p, src)
    # every pixel of a row belongs to its row's tiles
    assert (outputs == 1).all() and (stored == 1).all()


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: c.name)
def test_plan_ops_run_many_ctas(case):
    t = conv_tiling(case.kernel, case.kwargs)
    assert t.ctas > 1 and t.stage_w
    if case.name.startswith(("ds-cnn_", "ds-cnn-stream_")) \
            and case.kernel == "ring_conv_dw":
        assert (t.ctas, t.rows, t.ctile) == (25, 1, 64)
    if case.name.startswith("mcunet"):       # 3 x 3 rows, 480 or 384 ch
        assert t.ctas == 3 * -(-case.kwargs["c"] // 128)


def test_a_geometry_no_tile_fits_is_refused_with_its_shape():
    wide = dict(h_in=8, w_in=4096, h_out=8, w_out=4096, c_in=64, c_out=64,
                k=3, stride=1, padding="same")
    with pytest.raises(ValueError, match=r"\[8, 4096, 64\] -> \[8, 4096, "
                                         r"64\], k 3"):
        conv_tiling("ring_conv_k2d", wide)
    # more channel tiles than SMs
    with pytest.raises(ValueError, match="ring_conv_dw"):
        conv_tiling("ring_conv_dw", dict(h_in=3, w_in=3, h_out=3, w_out=3,
                                         c=480, rs=3, stride=1,
                                         padding="same"), n_sm=2)
    # weights too large to stage are read from global memory instead
    deep = dict(h_in=4, w_in=4, h_out=4, w_out=4, c_in=2048, c_out=64,
                k=3, stride=1, padding="same")
    t = conv_tiling("ring_conv_k2d", deep)
    assert not t.stage_w and t.smem <= MAX_SMEM


@pytest.mark.parametrize("case", (EDGE[0], INPLACE[0], PLAN_CASES[0]),
                         ids=lambda c: c.name)
def test_wrapper_launches_with_its_tiling(case, monkeypatch):
    calls = []
    monkeypatch.setattr(conv2d, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(conv2d, "_sm_count", lambda device: 132)
    monkeypatch.setattr(conv2d, "launch",
                        lambda name, pool, smem, tensors, ints:
                        calls.append((name, smem, ints)))
    wrapper = conv2d.KERNELS[case.kernel]
    monkeypatch.setattr(wrapper, "launches", 0)
    pool, params = case_inputs(case, seed=0)
    wrapper(torch.from_numpy(pool), *map(torch.from_numpy, params),
            **case.kwargs)
    t = conv_tiling(case.kernel, case.kwargs)
    tail = (t.rows, int(t.stage_w)) if case.kernel == "ring_conv_dw" \
        else (t.rows, t.ctile, int(t.stage_w))
    [(name, smem, ints)] = calls
    assert name == case.kernel and smem == t.smem
    assert ints[-len(tail):] == tail and wrapper.launches == 1
    assert wrapper.weights_staged is t.stage_w


def _serial_walk(case, pool, params):
    """The rows of ``case`` stored one at a time in order, each computed
    from the pool as the earlier rows left it (a one-block kernel's
    walk), through the plain version."""
    kw, _, c = _geometry(case)
    plain = conv2d.PLAIN[case.kernel]
    p = torch.from_numpy(pool.copy())
    w = [torch.from_numpy(a) for a in params]
    row = kw["w_out"] * -(-c // 128)
    for r in range(kw["h_out"]):
        q = p.clone()
        plain(q, *w, **kw)
        idx = (kw["out_ptr"] + r * row + np.arange(row)) % case.n_seg
        p[idx] = q[idx]
    return p.numpy()


@pytest.mark.parametrize("case", INPLACE, ids=lambda c: c.name)
def test_inplace_cases_tell_a_serial_walk_from_reading_first(case):
    kw = case.kwargs
    assert kw["in_ptr"] == kw["out_ptr"]
    pool, params = case_inputs(case, seed=0)
    want = torch.from_numpy(pool.copy())
    conv2d.PLAIN[case.kernel](want, *map(torch.from_numpy, params), **kw)
    live = live_lanes(case.n_seg, output_regions(case.kernel, kw))
    _, bad = compare_f32(_serial_walk(case, pool, params), want.numpy(),
                         live)
    assert bad is not None and "a live lane" in bad
