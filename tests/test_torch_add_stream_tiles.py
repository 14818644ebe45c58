"""The tiling of the fp32 residual add and streaming conv kernels, on the
CPU.

``ring_add`` and ``ring_conv_stream`` (``csrc/ring_f32.cu``) run one CTA
per tile, read all of an op's input before a grid-wide barrier and store
only after it.  The add's tiles are blocks of rows
(``repro_torch.kernels.conv2d.add_tiling``); the streaming conv's are the
k x k conv's over its window (``conv2d.conv_tiling``), each CTA also
copying back a share of the window's rows.  Held here, on every ``add``
and ``conv_stream`` op of the committed fp32 plans and on every fp32
add/stream edge case, at an H100 SXM's 132 SMs, an H100 PCIe's 114 and
at 16:

* every output row and every window row is stored exactly once, every
  lane of its segments;
* a stream tile's staged window rows cover every in-window tap of its
  outputs;
* one CTA's shared memory is at most ``MAX_SMEM`` and the CTAs at most
  the SMs; every op of the committed plans runs more than one CTA.

Also: each wrapper hands its tiling to the launch, and a model of the
tiles without the barrier (each CTA reads, then stores, the last tile
first) differs from the plain version on the edge cases that store onto
rows another CTA reads, where reading everything first does not; on the
stream whose output overlaps its window, storing the outputs before the
window differs too.
"""
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import load
from repro_torch.core.rowsched import conv_k2d_pad
from repro_torch.kernels import PLAIN, conv2d, stream
from repro_torch.kernels._launch import MAX_SMEM
from repro_torch.kernels.cases import (F32_EDGE_CASES,
                                       F32_FUSED_STREAM_EDGE_CASES,
                                       case_inputs, compare_f32, live_lanes,
                                       output_regions, program_cases)
from repro_torch.kernels.conv2d import add_tiling, conv_tiling

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
KERNELS = ("ring_add", "ring_conv_stream")
#: The committed fp32 plans with residual adds or a streaming conv.
PLANS = ("resnet-8", "mcunet-5fps-vww", "ds-cnn-stream", "kws-gru-chain")
N_SM = (132, 114, 16)


def _plan_cases(name):
    cn = load(ASSETS / f"{name}.host-sim.float32.json")
    return tuple(c for c in program_cases(
        cn.program, cn.params, kernel_block_rows=cn.target.kernel_block_rows,
        prefix=f"{name}_f32_") if c.kernel in KERNELS)


PLAN_CASES = sum((_plan_cases(n) for n in PLANS), ())
EDGE = tuple(c for c in F32_EDGE_CASES + F32_FUSED_STREAM_EDGE_CASES
             if c.kernel in KERNELS)
ADDS = tuple(c for c in PLAN_CASES + EDGE if c.kernel == "ring_add")
STREAMS = tuple(c for c in PLAN_CASES + EDGE
                if c.kernel == "ring_conv_stream")
#: The edge cases that store onto rows another CTA of the op reads.
BARRIER_CASES = tuple(c for c in EDGE if c.name in (
    "f32_add_shifted_uneven", "f32_add_out_on_residual",
    "f32_stream_dscnn_out_on_frame", "f32_stream_out_over_window"))


def _segs(c):
    return -(-c // 128)


def _add_tiling(case, n_sm=conv2d.H100_SMS):
    return add_tiling(case.kwargs["rows"], case.kwargs["d"], n_sm)


def _stream_tiling(case, n_sm=conv2d.H100_SMS):
    return conv_tiling("ring_conv_stream", case.kwargs, n_sm)


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("case", ADDS, ids=lambda c: c.name)
def test_add_tiles_store_every_row_once_and_fit(case, n_sm):
    kw = case.kwargs
    t = _add_tiling(case, n_sm)
    assert 1 <= t.ctas <= n_sm
    assert t.smem == t.held == 4 * t.tile_rows * kw["d"] <= MAX_SMEM
    chunk = _segs(kw["d"])
    rows = np.zeros(kw["rows"], int)
    segs = np.zeros(case.n_seg, int)
    for i in range(t.ctas):
        r0, n = t.tile(i)
        assert 1 <= n <= t.tile_rows
        rows[r0:r0 + n] += 1
        segs[(kw["out_ptr"] + r0 * chunk + np.arange(n * chunk))
             % case.n_seg] += 1
    assert (rows == 1).all()
    assert segs.sum() == kw["rows"] * chunk and segs.max() == 1


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("case", STREAMS, ids=lambda c: c.name)
def test_stream_tiles_store_every_output_and_window_row_once_and_fit(case,
                                                                     n_sm):
    kw = case.kwargs
    t = _stream_tiling(case, n_sm)
    assert 1 <= t.ctas <= n_sm and t.h_in == kw["h_win"]
    w_in, c_in, c = kw["w_in"], kw["c_in"], kw["c_out"]
    assert t.win_row_len == w_in * c_in and t.smem <= MAX_SMEM
    assert t.held == 4 * (t.rows * kw["w_out"] * t.ctile
                          + t.win_rows * w_in * c_in)
    # the window rows ride in the staged rows' share of shared memory
    assert t.smem >= 4 * ((t.halo + t.win_rows) * w_in * c_in
                          + t.rows * kw["w_out"] * t.ctile)
    segs = _segs(c)
    outputs = np.zeros((kw["h_out"], c), int)
    stored = np.zeros((kw["h_out"], segs * 128), int)
    window = np.zeros(kw["h_win"], int)
    pad_v = conv_k2d_pad(kw["k"], kw["padding"])
    for i in range(t.ctas):
        p0, np_, c0, cn, lo, nh = t.tile(i)
        assert np_ >= 1 and cn >= 1 and nh <= t.halo
        outputs[p0:p0 + np_, c0:c0 + cn] += 1
        end = segs * 128 if c0 + t.ctile >= c else c0 + t.ctile
        stored[p0:p0 + np_, c0:end] += 1
        for p in range(p0, p0 + np_):
            for r in range(kw["k"]):
                src = p * kw["stride"] - pad_v + r
                if 0 <= src < kw["h_win"]:
                    assert lo <= src < lo + nh, (i, p, src)
        r0, n = t.window(i)
        assert 0 <= n <= t.win_rows
        window[r0:r0 + n] += 1
    assert (outputs == 1).all() and (stored == 1).all()
    assert (window == 1).all()


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: c.name)
def test_plan_ops_run_many_ctas(case):
    if case.kernel == "ring_add":      # ResNet-8's 1,024, 256 and 64 rows
        t = _add_tiling(case)            # and VWW's 9
        assert t.ctas == {1024: 128, 256: 128, 64: 64, 9: 9}[
            case.kwargs["rows"]]
    else:                # DS-CNN's stem window, 49 x 10 x 1 -> 25 x 5 x 64
        t = _stream_tiling(case)
        assert (t.ctas, t.rows, t.ctile, t.win_rows) == (100, 1, 16, 1)
        assert t.stage_w
    assert t.ctas > 1


def test_an_add_no_tile_fits_is_refused_with_its_shape():
    with pytest.raises(ValueError, match="ring_add: 4000 rows of 8192 "
                                         "channels"):
        add_tiling(4000, 8192)
    assert add_tiling(4000, 8192, 4000).tile_rows == 1


def _inputs(case):
    pool, params = case_inputs(case, seed=0)
    return torch.from_numpy(pool), [torch.from_numpy(a) for a in params]


@pytest.mark.parametrize("case", (ADDS[0], BARRIER_CASES[0]),
                         ids=lambda c: c.name)
def test_add_wrapper_launches_with_its_tiling(case, monkeypatch):
    calls = []
    monkeypatch.setattr(conv2d, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(conv2d, "_sm_count", lambda device: 132)
    monkeypatch.setattr(conv2d, "launch",
                        lambda name, pool, smem, tensors, ints:
                        calls.append((name, smem, ints)))
    monkeypatch.setattr(conv2d.ring_add, "launches", 0)
    pool, _ = _inputs(case)
    conv2d.ring_add(pool, **case.kwargs)
    t = _add_tiling(case)
    [(name, smem, ints)] = calls
    assert name == "ring_add" and smem == t.smem
    assert ints[-1] == t.tile_rows and conv2d.ring_add.launches == 1


@pytest.mark.parametrize("case, over", [
    (STREAMS[0], False), (BARRIER_CASES[2], False),
    (BARRIER_CASES[3], True)], ids=lambda c: getattr(c, "name", str(c)))
def test_stream_wrapper_launches_with_its_tiling(case, over, monkeypatch):
    calls = []
    monkeypatch.setattr(stream, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(conv2d, "_sm_count", lambda device: 132)
    monkeypatch.setattr(stream, "_launch",
                        lambda name, pool, smem, tensors, ints:
                        calls.append((name, smem, ints)))
    wrapper = stream.ring_conv_stream
    monkeypatch.setattr(wrapper, "launches", 0)
    pool, params = _inputs(case)
    wrapper(pool, *params, **case.kwargs)
    t = _stream_tiling(case)
    [(name, smem, ints)] = calls
    assert name == "ring_conv_stream" and smem == t.smem
    assert ints[-4:] == (t.rows, t.ctile, int(t.stage_w), int(over))
    assert wrapper.launches == 1 and wrapper.weights_staged is t.stage_w


# ---------------------------------------------------------------------------
# What the grid barrier is for: models of the tiles' reads and stores.
# ---------------------------------------------------------------------------

def _plain(case, snap, params):
    q = snap.clone()
    PLAIN[case.kernel](q, *params, **case.kwargs)
    return q


def _cta_stores(case, t, i, snap, params):
    """CTA ``i``'s stores, each ``(kind, segments, lanes, values)``, with
    the values it computes from the pool ``snap`` (the plain version's):
    the add's rows, or the stream's window rows then its output tile."""
    kw, n_seg = case.kwargs, case.n_seg
    if case.kernel == "ring_add":
        chunk = _segs(kw["d"])
        r0, n = t.tile(i)
        seg = (kw["out_ptr"] + r0 * chunk + np.arange(n * chunk)) % n_seg
        seg, lane = np.repeat(seg, 128), np.tile(np.arange(128), len(seg))
        return [("out", seg, lane, _plain(case, snap, params)[seg, lane])]
    wc = kw["w_in"] * _segs(kw["c_in"])
    win = snap.clone()
    stream._shift_window(win, wc, h_win=kw["h_win"], w_in=kw["w_in"],
                         c_in=kw["c_in"], hop=kw["hop"], in_ptr=kw["in_ptr"],
                         state_ptr=kw["state_ptr"])
    r0, n = t.window(i)
    wseg = np.repeat(kw["state_ptr"] + r0 * wc + np.arange(n * wc), 128)
    wlane = np.tile(np.arange(128), n * wc)
    p0, np_, c0, _, _, _ = t.tile(i)
    segs = _segs(kw["c_out"])
    end = segs * 128 if c0 + t.ctile >= kw["c_out"] else c0 + t.ctile
    pix = np.arange(p0 * kw["w_out"], (p0 + np_) * kw["w_out"])
    lanes = np.arange(c0, end)
    flat = (kw["out_ptr"] + pix[:, None] * segs) * 128 + lanes[None, :]
    oseg, olane = (flat.ravel() // 128) % n_seg, flat.ravel() % 128
    out = _plain(case, snap, params)
    return [("window", wseg, wlane, win[wseg, wlane]),
            ("out", oseg, olane, out[oseg, olane])]


def _apply(pool, stores, kinds=("window", "out")):
    for kind in kinds:
        for k, seg, lane, values in stores:
            if k == kind:
                pool[seg, lane] = values


def _no_barrier(case, t, pool, params):
    """Each CTA reads the pool as the CTAs before it left it, then
    stores: the last tile first."""
    p = pool.clone()
    for i in reversed(range(t.ctas)):
        _apply(p, _cta_stores(case, t, i, p, params))
    return p


def _reading_first(case, t, pool, params, kinds=("window", "out")):
    """Every CTA reads the pool from before the op, then every store of
    each kind in ``kinds`` order, the last tile first."""
    stores = sum((_cta_stores(case, t, i, pool, params)
                  for i in reversed(range(t.ctas))), [])
    p = pool.clone()
    _apply(p, stores, kinds)
    return p


def _held(case, got, want):
    live = live_lanes(case.n_seg, output_regions(case.kernel, case.kwargs))
    return compare_f32(got.numpy(), want.numpy(), live)[1]


@pytest.mark.parametrize("case", BARRIER_CASES, ids=lambda c: c.name)
def test_barrier_cases_tell_a_missing_barrier_from_reading_first(case):
    pool, params = _inputs(case)
    t = _add_tiling(case) if case.kernel == "ring_add" \
        else _stream_tiling(case)
    assert t.ctas > 1
    want = _plain(case, pool, params)
    assert _held(case, _reading_first(case, t, pool, params), want) is None
    bad = _held(case, _no_barrier(case, t, pool, params), want)
    assert bad is not None


def test_an_output_over_the_window_needs_the_window_stored_first():
    """The overlap case needs the kernel's second barrier: with every
    read first, storing the outputs before the window still differs."""
    case = BARRIER_CASES[3]
    kw = case.kwargs
    n_seg = case.n_seg
    wc = kw["w_in"] * _segs(kw["c_in"])
    assert stream._runs_overlap(n_seg, kw["out_ptr"],
                                kw["h_out"] * kw["w_out"] * _segs(
                                    kw["c_out"]), kw["state_ptr"],
                                kw["h_win"] * wc)
    for other in STREAMS:
        if other is not case:
            o = other.kwargs
            assert not stream._runs_overlap(
                other.n_seg, o["out_ptr"] % other.n_seg,
                o["h_out"] * o["w_out"] * _segs(o["c_out"]), o["state_ptr"],
                o["h_win"] * o["w_in"] * _segs(o["c_in"])), other.name
    pool, params = _inputs(case)
    t = _stream_tiling(case)
    want = _plain(case, pool, params)
    got = _reading_first(case, t, pool, params, kinds=("out", "window"))
    assert _held(case, got, want) is not None
