"""The int8 streaming conv's and the int8 FC's tilings, on the CPU.

``ring_conv_stream_q`` (``csrc/ring_q.cu``) runs one CTA per tile of
``repro_torch.kernels.conv2d.conv_tiling`` (kind ``ring_conv_stream_q``:
the k x k conv's tiles over the window, each CTA also copying back a
share of the window's rows as whole segments), reads all of an op's
input before a grid-wide barrier and stores only after it; where the
output run overlaps the window region it stores the window, meets a
second barrier, then its outputs.  ``ring_gemm_q`` runs the tiles of
``quantized.gemm_q_tiling``: one CTA in an ordinary launch where the op
is small, else column tiles under one grid barrier in a cooperative
launch.  Held here, on every ``conv_stream`` / ``gemm`` op of the
committed int8 plans (DS-CNN, ResNet-8, MCUNet-5fps-VWW, ToyADMOS, the
DS-CNN stream, the GRU chain) and on every int8 stream / FC edge case,
at an H100 SXM's 132 SMs, an H100 PCIe's 114 and at 16:

* the tiles cover each output exactly once, and their stores each lane
  of every output row's segments exactly once, in whole 32-bit words
  (the last channel or column tile takes the channel tail); each window
  row is copied back once;
* a stream tile's staged rows hold every in-window row its outputs read;
* one CTA's shared memory is at most ``MAX_SMEM`` and the CTAs at most
  the SMs; both plan streams and ToyADMOS's two 640-wide layers run many
  CTAs, every other plan FC one.

Also: the wrappers hand their tiling and mode to the launch, a geometry
no tile fits is refused with its shape named, and CPU models of both
kernels are bitwise the plain version when every CTA reads before any
stores (the FC's k split over lanes summed mod 2**32, the stream's
window copied as raw segments from each row's source), while without
the barrier (each CTA reads the pool as the CTAs after it left it, then
stores, the last tile first) the FC differs on ``gemm_q_inplace_uneven``
and ``gemm_q_widen`` and the stream on ``stream_q_uneven``; the stream
whose output overlaps its window also differs when it stores its
outputs before the window.
"""
import ctypes
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import load
from repro_torch.core.rowsched import conv_k2d_pad, conv_k2d_pad_w
from repro_torch.core.vpool import fetch_rows, fetch_segments
from repro_torch.kernels import PLAIN, conv2d, quantized, stream
from repro_torch.kernels._build import SIGNATURES
from repro_torch.kernels._launch import MAX_SMEM
from repro_torch.kernels.cases import EDGE_CASES, case_inputs, program_cases
from repro_torch.kernels.conv2d import conv_tiling, q_pixel_pitch
from repro_torch.kernels.quantized import (GEMM_Q_ONE_CTA_BYTES,
                                           GEMM_Q_THREADS, gemm_q_tiling)
from repro_torch.quant.requant import requantize

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
STREAM, GEMM = "ring_conv_stream_q", "ring_gemm_q"
N_SM = (132, 114, 16)
#: The committed int8 plans with an FC or a streaming conv.
PLANS = ("ds-cnn", "resnet-8", "mcunet-5fps-vww", "ad-toyadmos",
         "ds-cnn-stream", "kws-gru-chain")
#: The edge cases that store onto what another CTA of the op reads.
UNEVEN = ("gemm_q_inplace_uneven", "gemm_q_widen", "stream_q_uneven")


def _plan_cases(name):
    cn = load(ASSETS / f"{name}.cortex-m4.int8.json")
    return tuple(c for c in program_cases(
        cn.program, cn.qnet.qparams,
        kernel_block_rows=cn.target.kernel_block_rows, prefix=f"{name}_")
        if c.kernel in (STREAM, GEMM))


PLAN_CASES = {n: _plan_cases(n) for n in PLANS}
_PLAN = sum(PLAN_CASES.values(), ())
EDGE = tuple(c for c in EDGE_CASES if c.kernel in (STREAM, GEMM))
STREAMS = tuple(c for c in _PLAN + EDGE if c.kernel == STREAM)
GEMMS = tuple(c for c in _PLAN + EDGE if c.kernel == GEMM)
_BY_NAME = {c.name: c for c in EDGE}


def _segs(c):
    return -(-c // 128)


def _gemm_tiling(case, n_sm=132):
    kw = case.kwargs
    return gemm_q_tiling(kw["m_rows"], kw["d_in"], kw["d_out"], n_sm)


def test_the_plans_and_edge_cases_have_the_ops_held_here():
    assert [sum(c.kernel == GEMM for c in PLAN_CASES[n]) for n in PLANS] \
        == [1, 1, 1, 10, 1, 0]
    assert [sum(c.kernel == STREAM for c in PLAN_CASES[n]) for n in PLANS] \
        == [0, 0, 0, 0, 1, 1]
    assert {c.name for c in EDGE} >= set(UNEVEN) | {
        "gemm_q_head_1000", "stream_q_out_over_window"}


# ---------------------------------------------------------------------------
# The streaming conv's tiling.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("case", STREAMS, ids=lambda c: c.name)
def test_stream_tiles_store_every_output_and_window_row_once_and_fit(case,
                                                                     n_sm):
    kw = case.kwargs
    t = conv_tiling(STREAM, kw, n_sm)
    assert 1 <= t.ctas <= n_sm and t.h_in == kw["h_win"] and t.stage_w
    w_in, c_in, c = kw["w_in"], kw["c_in"], kw["c_out"]
    row_bytes = w_in * _segs(c_in) * 128           # a window row's segments
    assert t.win_row_len == row_bytes and t.smem <= MAX_SMEM
    assert t.held == t.rows * kw["w_out"] * t.ctile + t.win_rows * row_bytes
    # the halo pixels, the window rows, the weight slice, the constants
    assert t.smem >= t.held + q_pixel_pitch(c_in) * (
        t.halo * w_in + kw["k"] ** 2 * t.ctile) + 12 * t.ctile
    segs = _segs(c)
    outputs = np.zeros((kw["h_out"], c), int)
    stored = np.zeros((kw["h_out"], segs * 128), int)
    window = np.zeros(kw["h_win"], int)
    pad_v = conv_k2d_pad(kw["k"], kw["padding"])
    for i in range(t.ctas):
        p0, np_, c0, cn, lo, nh = t.tile(i)
        assert 1 <= np_ <= t.rows and cn >= 1 and nh <= t.halo
        outputs[p0:p0 + np_, c0:c0 + cn] += 1
        end = segs * 128 if c0 + t.ctile >= c else c0 + t.ctile
        assert c0 % 4 == 0 and end % 4 == 0          # whole 32-bit words
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


@pytest.mark.parametrize("case", tuple(c for c in _PLAN if c.kernel == STREAM),
                         ids=lambda c: c.name)
def test_plan_streams_run_many_ctas(case):
    """DS-CNN's stem window, 49 x 10 x 1 -> 25 x 5 x 64, on both int8
    streams: 100 CTAs of 1 output row x 16 channels, one window row each
    (the fp32 twin's tiles)."""
    t = conv_tiling(STREAM, case.kwargs)
    assert (t.ctas, t.rows, t.ctile, t.win_rows) == (100, 1, 16, 1)
    assert t.tile(99)[:4] == (24, 1, 48, 16)
    assert t.window(48) == (48, 1) and t.window(49) == (49, 0)


def test_a_stream_no_tile_fits_is_refused_with_its_shape(monkeypatch):
    wide = dict(h_win=8, w_in=2048, h_out=8, w_out=2048, c_in=64, c_out=64,
                k=3, stride=1, padding="same", hop=1)
    with pytest.raises(ValueError, match=r"ring_conv_stream_q: no tile of "
                       r"the op \[8, 2048, 64\] -> \[8, 2048, 64\], k 3"):
        conv_tiling(STREAM, wide)
    # the wrapper refuses it before any launch
    monkeypatch.setattr(stream, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(conv2d, "_sm_count", lambda device: 132)
    monkeypatch.setattr(stream, "_launch", None)
    pool = torch.zeros((8 * 2048 * 2, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match=r"\[8, 2048, 64\]"):
        stream.ring_conv_stream_q(pool, None, None, None, None, **wide,
                                  in_ptr=0, out_ptr=0, state_ptr=2048)


# ---------------------------------------------------------------------------
# The FC's tiling and its mode.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("case", GEMMS, ids=lambda c: c.name)
def test_gemm_tiles_cover_every_output_once_and_fit(case, n_sm):
    kw = case.kwargs
    m, d_in, d_out = kw["m_rows"], kw["d_in"], kw["d_out"]
    t = _gemm_tiling(case, n_sm)
    assert t.smem <= MAX_SMEM and t.held == t.rows * t.ctile
    assert t.smem >= t.held + q_pixel_pitch(d_in) * (t.rows + t.ctile) \
        + 12 * t.ctile
    assert t.barrier == (t.ctas > 1)
    small = d_in * d_out <= GEMM_Q_ONE_CTA_BYTES
    one = quantized.GemmQTiling(m, d_in, d_out, m, d_out, False)
    if small and one.smem <= MAX_SMEM:
        assert t == one                      # the whole op, one CTA
    else:
        assert t.ctas <= n_sm and (t.ctile in
                                   quantized.GEMM_Q_COLUMN_TILES
                                   or t.ctile == d_out)
    segs = _segs(d_out)
    outputs = np.zeros((m, d_out), int)
    stored = np.zeros((m, segs * 128), int)
    for i in range(t.ctas):
        r0, nr, c0, cn = t.tile(i)
        assert 1 <= nr <= t.rows and 1 <= cn <= t.ctile
        outputs[r0:r0 + nr, c0:c0 + cn] += 1
        end = segs * 128 if c0 + t.ctile >= d_out else c0 + t.ctile
        assert c0 % 4 == 0 and end % 4 == 0          # whole 32-bit words
        stored[r0:r0 + nr, c0:end] += 1
    assert (outputs == 1).all() and (stored == 1).all()


@pytest.mark.parametrize("case", tuple(c for c in _PLAN if c.kernel == GEMM),
                         ids=lambda c: c.name)
def test_plan_fcs_take_the_modes_of_the_rule(case):
    """Every head and ToyADMOS's 128-wide layers run one CTA in an
    ordinary launch; its two 640-wide layers column tiles of 16 under a
    grid barrier."""
    kw = case.kwargs
    t = _gemm_tiling(case)
    wide = 640 in (kw["d_in"], kw["d_out"])
    assert t.barrier is wide
    if wide:
        assert (t.rows, t.ctile, t.ctas) == (1, 16, kw["d_out"] // 16)
    else:
        assert (t.rows, t.ctile, t.ctas) == (1, kw["d_out"], 1)


def test_gemm_modes_can_be_forced_and_an_unfit_op_is_refused(monkeypatch):
    head = gemm_q_tiling(1, 64, 12, 132, False)
    assert head.barrier and head.ctas == 1           # cooperative, 1 CTA
    big = gemm_q_tiling(1, 640, 128, 132, True)
    assert not big.barrier and big.ctas == 1
    assert big.smem >= 128 * 656                     # the weight slice
    with pytest.raises(ValueError, match=r"ring_gemm_q: no tile of the op "
                       r"\[2, 1000\] -> \[2, 240\] fits 232448 B of shared "
                       r"memory in one CTA"):
        gemm_q_tiling(2, 1000, 240, 132, True)
    with pytest.raises(ValueError, match=r"\[1, 100000\] -> \[1, 1000\]"):
        gemm_q_tiling(1, 100_000, 1000)
    # the wrapper refuses it before any launch
    monkeypatch.setattr(quantized, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(quantized, "_sm_count", lambda device: 132)
    monkeypatch.setattr(quantized, "_launch", None)
    pool = torch.zeros((3128, 128), dtype=torch.int8)   # block-aligned
    with pytest.raises(ValueError, match=r"\[1, 100000\] -> \[1, 1000\]"):
        quantized.ring_gemm_q(pool, None, None, None, None, m_rows=1,
                              d_in=100_000, d_out=1000, in_ptr=0,
                              out_ptr=0, block_rows=1)


# ---------------------------------------------------------------------------
# The wrappers hand their tiling and mode to the launch.
# ---------------------------------------------------------------------------

def _inputs(case):
    pool, params = case_inputs(case, seed=0)
    return torch.from_numpy(pool), [torch.from_numpy(a) for a in params]


def _record(monkeypatch, module, wrapper):
    calls = []
    monkeypatch.setattr(module, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(conv2d, "_sm_count", lambda device: 132)
    monkeypatch.setattr(quantized, "_sm_count", lambda device: 132)
    monkeypatch.setattr(module, "_launch",
                        lambda name, pool, smem, tensors, ints:
                        calls.append((name, smem, tensors, ints)))
    monkeypatch.setattr(wrapper, "launches", 0)
    monkeypatch.setattr(wrapper, "weights_staged", None)
    return calls


@pytest.mark.parametrize("case", (GEMMS[0], PLAN_CASES["ad-toyadmos"][0],
                                  PLAN_CASES["ad-toyadmos"][-1],
                                  _BY_NAME["gemm_q_inplace_uneven"],
                                  _BY_NAME["gemm_weights_global"]),
                         ids=lambda c: c.name)
def test_gemm_wrapper_launches_with_its_tiling_and_mode(case, monkeypatch):
    wrapper = quantized.ring_gemm_q
    calls = _record(monkeypatch, quantized, wrapper)
    monkeypatch.setattr(wrapper, "barrier", None)
    pool, params = _inputs(case)
    wrapper(pool, *params, **case.kwargs)
    kw, n = case.kwargs, case.n_seg
    t = _gemm_tiling(case)
    [(name, smem, tensors, ints)] = calls
    assert name == GEMM and smem == t.smem
    assert all(a is b for a, b in zip(tensors, params, strict=True))
    assert len(ints) == SIGNATURES["ring_q"][name].count(ctypes.c_int)
    assert ints == (n, kw["m_rows"], kw["d_in"], kw["d_out"],
                    kw["in_ptr"] % n, kw["out_ptr"] % n,
                    int(kw["activation"] == "relu"), t.rows, t.ctile,
                    int(t.barrier))
    assert wrapper.barrier is t.barrier and wrapper.launches == 1
    assert wrapper.weights_staged is True


@pytest.mark.parametrize("case", STREAMS, ids=lambda c: c.name)
def test_stream_wrapper_launches_with_its_tiling(case, monkeypatch):
    wrapper = stream.ring_conv_stream_q
    calls = _record(monkeypatch, stream, wrapper)
    pool, params = _inputs(case)
    wrapper(pool, *params, **case.kwargs)
    kw, n = case.kwargs, case.n_seg
    t = conv_tiling(STREAM, kw)
    over = case.name == "stream_q_out_over_window"
    [(name, smem, tensors, ints)] = calls
    assert name == STREAM and smem == t.smem
    assert len(ints) == SIGNATURES["ring_q"][name].count(ctypes.c_int)
    k = kw["k"]
    assert ints == (n, kw["h_win"], kw["w_in"], kw["h_out"], kw["w_out"],
                    kw["c_in"], kw["c_out"], k, kw["stride"], kw["hop"],
                    conv_k2d_pad(k, kw["padding"]),
                    conv_k2d_pad_w(k, kw["padding"]), kw["in_ptr"],
                    kw["out_ptr"] % n, kw["state_ptr"],
                    int(kw["activation"] == "relu"), t.rows, t.ctile,
                    int(over))
    assert wrapper.launches == 1 and wrapper.weights_staged is True


# ---------------------------------------------------------------------------
# What the barriers are for: models of the tiles' reads and stores.
# ---------------------------------------------------------------------------

def _plain(case, pool, params):
    want = pool.clone()
    PLAIN[case.kernel](want, *params, **case.kwargs)
    return want


def _lanes(ks, chunks):
    """The kernel's k split: lane j of ``ks`` takes chunks j, j + ks, ..."""
    return [list(range(j, chunks, ks)) for j in range(ks)]


def _gemm_cta_stores(case, t, i, pool, params):
    """CTA ``i``'s stores, ``[(kind, segments, lanes, values)]``, computed as
    the kernel does from the pool ``pool``: each row's first ceil(d_in /
    16) 16-byte chunks as staged (bytes past d_in included) against the
    weights zero from d_in on, each output split over the kernel's ``ks``
    lanes and their partials summed mod 2**32, then the plain version's
    bias, relu and requantization; over the CTA's rows x lanes c0 .. end
    (the last column tile with the channel tail)."""
    kw, n_seg = case.kwargs, pool.shape[0]
    w, b, mult, shift = params
    d_in, d_out = kw["d_in"], kw["d_out"]
    r0, nr, c0, cn = t.tile(i)
    chunks = -(-d_in // 16)
    ksegs, osegs = _segs(d_in), _segs(d_out)
    x = fetch_segments(pool, kw["in_ptr"] + r0 * ksegs, nr * ksegs) \
        .reshape(nr, ksegs * 128)[:, :16 * chunks].to(torch.int64)
    wz = torch.zeros((16 * chunks, cn), dtype=torch.int64)
    wz[:d_in] = w[:, c0:c0 + cn].to(torch.int64)
    ks = 1
    while ks < 32 and 2 * ks <= chunks and 2 * ks * nr * cn <= GEMM_Q_THREADS:
        ks *= 2
    acc = torch.zeros((nr, cn), dtype=torch.int64)
    for lane in _lanes(ks, chunks):
        part = 0
        for c in lane:
            part = part + x[:, 16 * c:16 * c + 16] @ wz[16 * c:16 * c + 16]
        acc = (acc + part) % (1 << 32)                # uint32 partials
    acc = torch.where(acc >= 1 << 31, acc - (1 << 32), acc)
    acc = quantized._acc32(acc, b[c0:c0 + cn], kw["activation"])
    y = requantize(acc, mult[c0:c0 + cn], shift[c0:c0 + cn])
    end = osegs * 128 if c0 + t.ctile >= d_out else c0 + t.ctile
    values = torch.zeros((nr, end - c0), dtype=torch.int8)
    values[:, :cn] = y
    lanes = torch.arange(c0, end)
    rows = torch.arange(r0, r0 + nr)
    seg = (kw["out_ptr"] + rows[:, None] * osegs + lanes[None, :] // 128) \
        % n_seg
    return [("out", seg, (lanes % 128).expand(nr, -1), values)]


def _stream_cta_stores(case, t, i, pool, params):
    """CTA ``i``'s stores from the pool ``pool``, ``[(kind, segments,
    lanes, values)]``: its window rows ``r0 ..`` as raw segments copied
    from each row's source (old state row ``r + hop``, or the frame), then
    its output tile (the plain version's values from the same pool)."""
    kw, n_seg = case.kwargs, pool.shape[0]
    wc = kw["w_in"] * _segs(kw["c_in"])
    keep = kw["h_win"] - kw["hop"]
    stores = []
    r0, n = t.window(i)
    segs, values = [], []
    for r in range(r0, r0 + n):
        src = kw["state_ptr"] + (r + kw["hop"]) * wc if r < keep \
            else kw["in_ptr"] + (r - keep) * wc
        values.append(pool[src:src + wc])
        segs.append(torch.arange(kw["state_ptr"] + r * wc,
                                 kw["state_ptr"] + (r + 1) * wc))
    if n:
        seg = torch.cat(segs)[:, None].expand(-1, 128)
        stores.append(("window", seg,
                       torch.arange(128).expand(len(seg), -1),
                       torch.cat(values)))
    p0, np_, c0, _, _, _ = t.tile(i)
    osegs = _segs(kw["c_out"])
    end = osegs * 128 if c0 + t.ctile >= kw["c_out"] else c0 + t.ctile
    pix = torch.arange(p0 * kw["w_out"], (p0 + np_) * kw["w_out"])
    lanes = torch.arange(c0, end)
    seg = (kw["out_ptr"] + pix[:, None] * osegs + lanes[None, :] // 128) \
        % n_seg
    out = _plain(case, pool, params)
    stores.append(("out", seg, (lanes % 128).expand(len(pix), -1),
                   out[seg, lanes % 128]))
    return stores


def _tiling(case):
    return _gemm_tiling(case) if case.kernel == GEMM \
        else conv_tiling(STREAM, case.kwargs)


def _cta_stores(case, t, i, pool, params):
    fn = _gemm_cta_stores if case.kernel == GEMM else _stream_cta_stores
    return fn(case, t, i, pool, params)


def _reading_first(case, t, pool, params, kinds=("window", "out")):
    """Every CTA reads the pool from before the op, then every store of
    each kind in ``kinds`` order, the last tile first."""
    stores = sum((_cta_stores(case, t, i, pool, params)
                  for i in reversed(range(t.ctas))), [])
    got = pool.clone()
    for kind in kinds:
        for k, seg, lanes, values in stores:
            if k == kind:
                got[seg, lanes] = values
    return got


def _no_barrier(case, t, pool, params):
    """Each CTA reads the pool as the CTAs after it left it, then
    stores: the last tile first."""
    got = pool.clone()
    for i in reversed(range(t.ctas)):
        for _, seg, lanes, values in _cta_stores(case, t, i, got, params):
            got[seg, lanes] = values
    return got


@pytest.mark.parametrize("case", GEMMS + STREAMS, ids=lambda c: c.name)
def test_reading_first_is_bitwise_the_plain_version(case):
    pool, params = _inputs(case)
    t = _tiling(case)
    got = _reading_first(case, t, pool, params)
    assert torch.equal(got, _plain(case, pool, params))


@pytest.mark.parametrize("name", UNEVEN)
def test_uneven_cases_tell_a_missing_barrier_from_reading_first(name):
    case = _BY_NAME[name]
    t = _tiling(case)
    assert t.ctas > 1 and (case.kernel == STREAM or t.barrier)
    pool, params = _inputs(case)
    want = _plain(case, pool, params)
    assert torch.equal(_reading_first(case, t, pool, params), want)
    assert not torch.equal(_no_barrier(case, t, pool, params), want)


def test_an_output_over_the_window_needs_the_window_stored_first():
    """Only ``stream_q_out_over_window`` overlaps its window (the wrapper
    passes ``out_over_window`` for it alone), and there, with every read
    first, storing the outputs before the window differs."""
    case = _BY_NAME["stream_q_out_over_window"]
    for c in STREAMS:
        kw = c.kwargs
        over = stream._runs_overlap(
            c.n_seg, kw["out_ptr"] % c.n_seg,
            kw["h_out"] * kw["w_out"] * _segs(kw["c_out"]), kw["state_ptr"],
            kw["h_win"] * kw["w_in"] * _segs(kw["c_in"]))
        assert over is (c is case), c.name
    pool, params = _inputs(case)
    t = _tiling(case)
    want = _plain(case, pool, params)
    got = _reading_first(case, t, pool, params, kinds=("out", "window"))
    assert not torch.equal(got, want)


def test_the_window_copy_is_raw_segments():
    """The window goes back with its channel tails as they were (DS-CNN's
    1-channel pixels keep their 127 tail bytes): a copy that zeroed them
    would differ from the plain version."""
    (case,) = [c for c in STREAMS if c.name.startswith("ds-cnn-stream_")]
    kw = case.kwargs
    pool, params = _inputs(case)
    wc = kw["w_in"] * _segs(kw["c_in"])
    window = slice(kw["state_ptr"], kw["state_ptr"] + kw["h_win"] * wc)
    frame = slice(kw["in_ptr"], kw["in_ptr"] + kw["hop"] * wc)
    pool[window, kw["c_in"]:] = 7                # nonzero channel tails
    pool[frame, kw["c_in"]:] = 7
    want = _plain(case, pool, params)
    assert (want[window, kw["c_in"]:] == 7).all()
    got = _reading_first(case, conv_tiling(STREAM, kw), pool, params)
    assert torch.equal(got, want)
    assert torch.equal(fetch_rows(got, kw["out_ptr"], 1, kw["c_out"]),
                       fetch_rows(want, kw["out_ptr"], 1, kw["c_out"]))
