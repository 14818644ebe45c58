"""The int8 depthwise conv's tiling and the int8 residual add's two
modes, on the CPU.

``ring_conv_dw_q`` (``csrc/ring_q.cu``) runs one CTA per tile of
``repro_torch.kernels.conv2d.conv_tiling`` (kind ``ring_conv_dw_q``: a
block of output image rows x a channel tile of one segment), stages its
channel tile of the halo rows its taps reach, reads all of an op's
input before a grid-wide barrier and stores only after it.  Held here,
on every ``conv_dw`` op of the committed int8 plans (DS-CNN,
MCUNet-5fps-VWW, the DS-CNN stream), of the reference's int8
``mobilenetv1-0.25`` cortex-m4 plan (compiled once per module; not served
yet) and on every int8 dw edge case, at an H100 SXM's 132 SMs, an H100
PCIe's 114 and at 16:

* the tiles cover each (output row, channel) exactly once, and their
  stores each lane of every output pixel's segments exactly once, in
  whole 32-bit words (the last channel tile takes the channel tail);
* a tile's staged rows hold every row its outputs read, and its channel
  tile lies in one segment of each pixel;
* one CTA's shared memory is at most ``MAX_SMEM`` and the CTAs at most
  the SMs; every op of the committed plans runs more than one CTA.

``ring_add_q`` maps its rows with no barrier where
``quantized.add_needs_barrier`` is False, and reads first over the row
blocks of ``conv2d.add_tiling`` (kind ``ring_add_q``, a byte an
element) elsewhere.  The predicate is held against a brute-force check
of which segments each row's store hits, on every add of the committed
int8 plans (False on all ten), every add edge case (True exactly on the
shifted ones) and every geometry of two small rings.

Also: each wrapper hands its tiling and mode to the launch, and CPU
models of the kernels are bitwise the plain version: the dw with every
CTA reading before any stores, the add's row map in both row orders
wherever the predicate allows it, and the add's read-first blocks.
Without the barrier (each CTA reads the pool as the CTAs after it left
it, then stores, the last tile first) the dw differs on
``dw_inplace_uneven`` and the add on every case that needs the barrier.
"""
import ctypes
import itertools
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
from repro_torch.kernels.cases import (CARD_EDGE_CASES, EDGE_CASES,
                                       case_inputs, program_cases)
from repro_torch.kernels.conv2d import add_tiling, conv_tiling
from repro_torch.kernels.quantized import (ADD_THREADS, add_map_rows,
                                           add_needs_barrier)
from repro_torch.quant.requant import requantize

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
DW, ADD = "ring_conv_dw_q", "ring_add_q"
N_SM = (132, 114, 16)
#: The committed int8 plans with depthwise convs or residual adds.
PLANS = ("ds-cnn", "resnet-8", "mcunet-5fps-vww", "ds-cnn-stream")
#: The reference's int8 plan compiled here, and its depthwise convs.
MOBILENET = "mobilenetv1-0.25"
MOBILENET_OPS = 13
#: The add edge cases that store a row onto an operand row of another
#: index: the ones on which ``ring_add_q`` takes its barrier.
SHIFTED = ("add_shifted", "add_tiles_shifted", "add_shifted_uneven",
           "add_out_on_residual", "add_shifted_card")


def _plan_cases(name):
    cn = load(ASSETS / f"{name}.cortex-m4.int8.json")
    return tuple(c for c in program_cases(
        cn.program, cn.qnet.qparams,
        kernel_block_rows=cn.target.kernel_block_rows, prefix=f"{name}_")
        if c.kernel in (DW, ADD))


PLAN_CASES = {n: _plan_cases(n) for n in PLANS}
_PLAN = sum(PLAN_CASES.values(), ())
_EDGE = EDGE_CASES + CARD_EDGE_CASES
PLAN_DW = tuple(c for c in _PLAN if c.kernel == DW)
PLAN_ADD = tuple(c for c in _PLAN if c.kernel == ADD)
EDGE_DW = tuple(c for c in _EDGE if c.kernel == DW)
EDGE_ADD = tuple(c for c in _EDGE if c.kernel == ADD)
DWS = PLAN_DW + EDGE_DW
ADDS = PLAN_ADD + EDGE_ADD
#: The adds small enough to model row by row here (all but the
#: card-sized one, which the card holds).
MODELLED_ADDS = tuple(c for c in ADDS if c not in CARD_EDGE_CASES)


def _segs(c):
    return -(-c // 128)


def _r16(n):
    return -(-n // 16) * 16


def _ptrs(case):
    kw, n = case.kwargs, case.n_seg
    return kw["in_ptr"] % n, kw["aux_ptr"] % n, kw["out_ptr"] % n


def _needs_barrier(case):
    kw = case.kwargs
    return add_needs_barrier(case.n_seg, kw["rows"], kw["d"], *_ptrs(case))


@pytest.fixture(scope="module")
def mobilenet_ops():
    """The kwargs of every dw op of the reference's int8 MobileNet plan
    (the geometry only: no weights are drawn)."""
    ref = repro.compile(MOBILENET, "cortex-m4", dtype="int8")
    program = PoolProgram.from_json_dict(ref.program.to_json_dict())
    return [op_kernel_call(program, op, (None,) * 4)[2]
            for op in program.ops if op.kind == "conv_dw"]


def test_the_plans_have_the_ops_held_here(mobilenet_ops):
    assert [sum(c.kernel == DW for c in PLAN_CASES[n]) for n in PLANS] \
        == [4, 0, 8, 4]
    assert [sum(c.kernel == ADD for c in PLAN_CASES[n]) for n in PLANS] \
        == [0, 3, 7, 0]
    assert len(mobilenet_ops) == MOBILENET_OPS
    assert [c.name for c in EDGE_DW] == ["dw_valid_s2", "dw_same_top",
                                         "dw_wrap_shifted",
                                         "dw_inplace_uneven"]
    assert {c.name for c in EDGE_ADD} >= set(SHIFTED)
    assert len(EDGE_ADD) == 7


# ---------------------------------------------------------------------------
# The depthwise conv's tiling.
# ---------------------------------------------------------------------------

def _rows_read(kw, p):
    """The input image rows that output row ``p`` reads."""
    top = p * kw["stride"] - conv_k2d_pad(kw["rs"], kw["padding"])
    return [r for r in range(top, top + kw["rs"]) if 0 <= r < kw["h_in"]]


def _hold_dw_tiling(kw, n_sm):
    t = conv_tiling(DW, kw, n_sm)
    h_out, w_out, c = kw["h_out"], kw["w_out"], kw["c"]
    assert 1 <= t.ctas <= n_sm and t.smem <= MAX_SMEM and t.stage_w
    assert t.ctile == min(c, 128)
    assert t.held == t.rows * w_out * t.ctile          # a byte an output
    # the halo's channel tile of each pixel, the weight slice, the
    # constants and the held outputs
    assert t.smem >= t.held + _r16(t.ctile) * t.halo * kw["w_in"] \
        + kw["rs"] ** 2 * t.ctile + 12 * t.ctile
    segs = _segs(c)
    outputs = np.zeros((h_out, c), int)
    stored = np.zeros((h_out, segs * 128), int)
    for i in range(t.ctas):
        p0, np_, c0, cn, lo, nh = t.tile(i)
        assert 1 <= np_ <= t.rows and 1 <= cn <= t.ctile and nh <= t.halo
        assert c0 % 128 == 0 and (c0 + cn - 1) // 128 == c0 // 128
        outputs[p0:p0 + np_, c0:c0 + cn] += 1
        end = segs * 128 if c0 + t.ctile >= c else c0 + t.ctile
        assert end % 4 == 0                          # whole 32-bit words
        stored[p0:p0 + np_, c0:end] += 1
        for p in range(p0, p0 + np_):
            assert all(lo <= r < lo + nh for r in _rows_read(kw, p))
    assert (outputs == 1).all() and (stored == 1).all()
    return t


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("case", DWS, ids=lambda c: c.name)
def test_dw_tiles_cover_every_output_once_and_fit(case, n_sm):
    _hold_dw_tiling(case.kwargs, n_sm)


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("op", range(MOBILENET_OPS),
                         ids=[f"{MOBILENET}_dw{i}" for i in
                              range(MOBILENET_OPS)])
def test_mobilenet_dw_tiles_cover_every_output_once_and_fit(mobilenet_ops,
                                                            op, n_sm):
    _hold_dw_tiling(mobilenet_ops[op], n_sm)


@pytest.mark.parametrize("case", PLAN_DW, ids=lambda c: c.name)
def test_plan_dw_ops_run_many_ctas(case):
    t = conv_tiling(DW, case.kwargs)
    assert t.ctas > 1 and t.rows == 1
    if case.name.startswith(("ds-cnn_", "ds-cnn-stream_")):   # 25 x 5 x 64
        assert (t.ctas, t.ctile) == (25, 64)
    else:                                                    # VWW
        assert 9 <= t.ctas <= 20


def test_a_dw_geometry_no_tile_fits_is_refused_with_its_shape(monkeypatch):
    wide = dict(h_in=4, w_in=8192, h_out=4, w_out=8192, c=128, rs=3,
                stride=1, padding="same")
    with pytest.raises(ValueError, match=r"ring_conv_dw_q: no tile of the "
                       r"op \[4, 8192, 128\] -> \[4, 8192, 128\], k 3"):
        conv_tiling(DW, wide)
    with pytest.raises(ValueError, match=DW):   # more channel tiles than SMs
        conv_tiling(DW, dict(wide, w_in=4, w_out=4, c=480), n_sm=2)
    # the wrapper refuses it before any launch
    monkeypatch.setattr(quantized, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(quantized, "_sm_count", lambda device: 132)
    monkeypatch.setattr(quantized, "_launch", None)
    pool = torch.zeros((4 * 8192, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match=r"\[4, 8192, 128\]"):
        quantized.ring_conv_dw_q(pool, None, None, None, None, **wide)


def _record_launches(monkeypatch, wrapper):
    calls = []
    monkeypatch.setattr(quantized, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(quantized, "_sm_count", lambda device: 132)
    monkeypatch.setattr(quantized, "_launch",
                        lambda name, pool, smem, tensors, ints:
                        calls.append((name, smem, tensors, ints)))
    monkeypatch.setattr(wrapper, "launches", 0)
    return calls


def _inputs(case):
    pool, params = case_inputs(case, seed=0)
    return torch.from_numpy(pool), [torch.from_numpy(a) for a in params]


@pytest.mark.parametrize("case", (PLAN_DW[0], PLAN_DW[4], PLAN_DW[6],
                                  EDGE_DW[0], EDGE_DW[3]),
                         ids=lambda c: c.name)
def test_dw_wrapper_launches_with_its_tiling(case, monkeypatch):
    wrapper = quantized.ring_conv_dw_q
    calls = _record_launches(monkeypatch, wrapper)
    monkeypatch.setattr(wrapper, "weights_staged", None)
    pool, params = _inputs(case)
    wrapper(pool, *params, **case.kwargs)
    kw, n = case.kwargs, case.n_seg
    t = conv_tiling(DW, kw)
    [(name, smem, tensors, ints)] = calls
    assert name == DW and smem == t.smem
    assert all(a is b for a, b in zip(tensors, params, strict=True))
    assert len(ints) == SIGNATURES["ring_q"][name].count(ctypes.c_int)
    rs = kw["rs"]
    assert ints == (n, kw["h_in"], kw["w_in"], kw["h_out"], kw["w_out"],
                    kw["c"], rs, kw["stride"],
                    conv_k2d_pad(rs, kw["padding"]),
                    conv_k2d_pad_w(rs, kw["padding"]), kw["in_ptr"] % n,
                    kw["out_ptr"] % n, int(kw["activation"] == "relu"),
                    t.rows, t.ctile)
    assert wrapper.launches == 1 and wrapper.weights_staged is True


def _dw_cta_stores(case, t, i, pool, params):
    """CTA ``i``'s stores, ``(segments, lanes, values)``, computed as the
    kernel does from the pool ``pool``: from its channel tile of its
    staged rows only, int64 products summed mod 2**32, then the plain
    version's bias, relu and requantization, over its rows x channel tile
    (the last channel tile with the channel tail)."""
    kw, n_seg = case.kwargs, pool.shape[0]
    w, b, mult, shift = params
    p0, np_, c0, cn, lo, nh = t.tile(i)
    h_in, w_in, w_out, c = kw["h_in"], kw["w_in"], kw["w_out"], kw["c"]
    rs, stride = kw["rs"], kw["stride"]
    staged = fetch_rows(pool, kw["in_ptr"] + lo * w_in * _segs(c),
                        nh * w_in, c)[:, c0:c0 + cn] \
        .reshape(nh, w_in, cn).to(torch.int64)
    pad_v, pad_h = conv_k2d_pad(rs, kw["padding"]), \
        conv_k2d_pad_w(rs, kw["padding"])
    span = (np_ - 1) * stride + rs
    right = max(0, (w_out - 1) * stride + rs - pad_h - w_in)
    sub = torch.zeros((span, pad_h + w_in + right, cn), dtype=torch.int64)
    for r in range(span):
        src = p0 * stride - pad_v + r
        if 0 <= src < h_in:
            sub[r, pad_h:pad_h + w_in] = staged[src - lo]
    acc = 0
    for r in range(rs):
        for s in range(rs):
            tap = sub[r:r + (np_ - 1) * stride + 1:stride,
                      s:s + (w_out - 1) * stride + 1:stride]
            acc = acc + tap * w[r, s, c0:c0 + cn].to(torch.int64)
    acc = quantized._acc32(acc, b[c0:c0 + cn], kw["activation"])
    y = requantize(acc, mult[c0:c0 + cn], shift[c0:c0 + cn])
    segs = _segs(c)
    end = segs * 128 if c0 + t.ctile >= c else c0 + t.ctile
    values = torch.zeros((np_ * w_out, end - c0), dtype=torch.int8)
    values[:, :cn] = y.reshape(-1, cn)
    pix = torch.arange(p0 * w_out, (p0 + np_) * w_out)
    lanes = torch.arange(c0, end)
    seg = (kw["out_ptr"] + pix[:, None] * segs + lanes[None, :] // 128) \
        % n_seg
    return seg, lanes % 128, values


def _plain(case, pool, params):
    want = pool.clone()
    quantized.PLAIN[case.kernel](want, *params, **case.kwargs)
    return want


@pytest.mark.parametrize("case", DWS, ids=lambda c: c.name)
def test_dw_reading_first_is_bitwise_the_plain_version(case):
    pool, params = _inputs(case)
    t = conv_tiling(DW, case.kwargs)
    got = pool.clone()
    for seg, lanes, values in [_dw_cta_stores(case, t, i, pool, params)
                               for i in reversed(range(t.ctas))]:
        got[seg, lanes] = values
    assert torch.equal(got, _plain(case, pool, params))


def test_dw_inplace_uneven_tells_a_missing_barrier_from_reading_first():
    (case,) = [c for c in EDGE_DW if c.name == "dw_inplace_uneven"]
    kw = case.kwargs
    t = conv_tiling(DW, kw)
    assert kw["in_ptr"] == kw["out_ptr"] and kw["h_out"] % t.rows
    assert t.channel_tiles > 1 and t.ctas > 50      # a short last row block
    pool, params = _inputs(case)
    # each CTA reads the pool as the CTAs after it left it, then stores:
    # the last tiles, the short ones, first
    no_barrier = pool.clone()
    for i in reversed(range(t.ctas)):
        seg, lanes, values = _dw_cta_stores(case, t, i, no_barrier, params)
        no_barrier[seg, lanes] = values
    assert not torch.equal(no_barrier, _plain(case, pool, params))


# ---------------------------------------------------------------------------
# The residual add: which mode, and the models of both.
# ---------------------------------------------------------------------------

def _brute_needs_barrier(n_seg, rows, d, in_ptr, aux_ptr, out_ptr):
    """Whether some row's store hits a segment that an operand row of
    another index reads, by listing every row's segments."""
    chunk = _segs(d)
    row = np.repeat(np.arange(rows), chunk)
    j = np.tile(np.arange(chunk), rows)
    out = (out_ptr + row * chunk + j) % n_seg
    for ptr in (in_ptr, aux_ptr):
        readers = [set() for _ in range(n_seg)]
        for seg, r in zip((ptr + row * chunk + j) % n_seg, row):
            readers[seg].add(r)
        if any(readers[seg] - {r} for seg, r in zip(out, row)):
            return True
    return False


@pytest.mark.parametrize("case", ADDS, ids=lambda c: c.name)
def test_add_needs_barrier_is_the_brute_force_check(case):
    kw = case.kwargs
    need = _needs_barrier(case)
    assert need == _brute_needs_barrier(case.n_seg, kw["rows"], kw["d"],
                                        *_ptrs(case))
    # every plan's add and the in-place edge cases are barrier-free
    assert need == (case.name in SHIFTED)


@pytest.mark.parametrize("n_seg, d", [(6, 16), (8, 16), (8, 200),
                                      (12, 300)])
def test_add_needs_barrier_on_every_geometry_of_a_small_ring(n_seg, d):
    chunk = _segs(d)
    ptrs = range(0, n_seg, chunk)
    for rows in range(1, n_seg // chunk + 2):
        for in_ptr, aux_ptr, out_ptr in itertools.product(ptrs, repeat=3):
            assert add_needs_barrier(n_seg, rows, d, in_ptr, aux_ptr,
                                     out_ptr) == _brute_needs_barrier(
                n_seg, rows, d, in_ptr, aux_ptr, out_ptr), \
                (rows, in_ptr, aux_ptr, out_ptr)


@pytest.mark.parametrize("d", (1, 16, 128, 129, 200, 1024, 1025, 4096))
def test_the_row_map_gives_each_thread_one_word(d):
    rows = add_map_rows(d)
    words = _segs(d) * 32                        # 32-bit words a row
    assert rows >= 1
    assert rows * words <= ADD_THREADS or rows == 1
    assert rows * words > ADD_THREADS - words    # no room for one more row


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("case", tuple(c for c in ADDS if c.name in SHIFTED),
                         ids=lambda c: c.name)
def test_read_first_add_tiles_store_every_row_once_and_fit(case, n_sm):
    kw = case.kwargs
    t = add_tiling(kw["rows"], kw["d"], n_sm, ADD)
    assert 1 <= t.ctas <= n_sm and t.elem == 1
    assert t.smem == t.held == t.tile_rows * kw["d"] <= MAX_SMEM
    # the fp32 add's tiling of the same rows holds 4 bytes an element
    assert add_tiling(kw["rows"], kw["d"], n_sm).tile_rows == t.tile_rows
    rows = np.zeros(kw["rows"], int)
    for i in range(t.ctas):
        r0, n = t.tile(i)
        assert 1 <= n <= t.tile_rows
        rows[r0:r0 + n] += 1
    assert (rows == 1).all()


@pytest.mark.parametrize("case", (PLAN_ADD[0], PLAN_ADD[-1], EDGE_ADD[0],
                                  EDGE_ADD[1], EDGE_ADD[-2]),
                         ids=lambda c: c.name)
def test_add_wrapper_launches_with_its_mode(case, monkeypatch):
    wrapper = quantized.ring_add_q
    calls = _record_launches(monkeypatch, wrapper)
    monkeypatch.setattr(wrapper, "barrier", None)
    pool, _ = _inputs(case)
    wrapper(pool, **case.kwargs)
    kw, n = case.kwargs, case.n_seg
    need = _needs_barrier(case)
    [(name, smem, tensors, ints)] = calls
    assert name == ADD and tensors == ()
    assert len(ints) == SIGNATURES["ring_q"][name].count(ctypes.c_int)
    assert ints[:6] == (n, kw["rows"], kw["d"], *_ptrs(case))
    if need:
        t = add_tiling(kw["rows"], kw["d"], 132, ADD)
        assert ints[-2:] == (1, t.tile_rows) and smem == t.smem
    else:
        assert ints[-2:] == (0, add_map_rows(kw["d"])) and smem == 0
    assert wrapper.barrier is need and wrapper.launches == 1


def _rows_stored(case, pool, r0, n):
    """The pool after rows ``r0 .. r0 + n - 1`` of the add are computed
    from ``pool`` (the plain version's arithmetic) and stored into a copy
    of it."""
    kw = case.kwargs
    off = r0 * _segs(kw["d"])
    q = pool.clone()
    quantized.ring_add_q_plain(
        q, **dict(kw, rows=n, in_ptr=kw["in_ptr"] + off,
                  aux_ptr=kw["aux_ptr"] + off, out_ptr=kw["out_ptr"] + off))
    return q


def _row_map(case, pool, order):
    """The row map with no barrier: each row read from the pool as the
    rows before it in ``order`` left it, then stored."""
    p = pool.clone()
    for r in order:
        p = _rows_stored(case, p, r, 1)
    return p


@pytest.mark.parametrize("case", MODELLED_ADDS, ids=lambda c: c.name)
def test_the_row_map_is_bitwise_the_plain_version_where_it_is_taken(case):
    pool, _ = _inputs(case)
    want = _plain(case, pool, ())
    rows = case.kwargs["rows"]
    forward = _row_map(case, pool, range(rows))
    backward = _row_map(case, pool, reversed(range(rows)))
    if not _needs_barrier(case):
        assert torch.equal(forward, want) and torch.equal(backward, want)
    else:   # row t onto an operand row t - 1: the later rows first differ
        assert not torch.equal(backward, want)


@pytest.mark.parametrize("case", tuple(c for c in MODELLED_ADDS
                                       if c.name in SHIFTED),
                         ids=lambda c: c.name)
def test_read_first_adds_tell_a_missing_barrier_from_reading_first(case):
    kw = case.kwargs
    t = add_tiling(kw["rows"], kw["d"], 132, ADD)
    pool, _ = _inputs(case)
    want = _plain(case, pool, ())
    # every CTA reads the pool from before the op, then all store
    stores = [(i, _rows_stored(case, pool, *t.tile(i)))
              for i in reversed(range(t.ctas))]
    got = pool.clone()
    chunk = _segs(kw["d"])
    for i, q in stores:
        r0, n = t.tile(i)
        seg = (kw["out_ptr"] + r0 * chunk + np.arange(n * chunk)) \
            % case.n_seg
        got[seg] = q[seg]
    assert torch.equal(got, want)
    # each CTA reads the pool as the CTAs after it left it, then stores
    no_barrier = pool.clone()
    for i in reversed(range(t.ctas)):
        no_barrier = _rows_stored(case, no_barrier, *t.tile(i))
    assert not torch.equal(no_barrier, want)
