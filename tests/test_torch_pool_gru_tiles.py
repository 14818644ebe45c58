"""The fp32 average pool's partition and the fp32 GRU cell's tiling, on
the CPU.

``ring_avgpool`` (``csrc/ring_f32.cu``) is one CTA in an ordinary launch
(``conv2d.pool_tiling``): its threads stage the live float4s of the
pixels (in chunks where they do not fit shared memory), then thread
``(j, ch)`` sums channel ``ch`` of pixels ``j, j + parts, ...``; after
every read a thread a channel adds the parts, divides by ``h w`` and
stores the row, which lands on pixel 0 of its input in every plan.
``ring_gru_cell`` runs the tiles of ``stream.gru_tiling``: one CTA in an
ordinary launch where the cell's fp32 W and U are small, else channel
tiles under one grid barrier in a cooperative launch, each CTA staging
x, h and the z, r and n columns of W and U of its hidden channels.  Held
here, on every pool and GRU cell of the committed fp32 plans (DS-CNN,
ResNet-8, MCUNet-5fps-VWW, the DS-CNN stream, the GRU chain) and on every
fp32 pool / GRU edge case, at an H100 SXM's 132 SMs, an H100 PCIe's 114
and at 16:

* the pool stages each (pixel, float4) of its input's live channels
  exactly once and sums each (pixel, channel) once, and a model of its
  parts is within the fp32 tolerance of the plain version, channel tails
  and every other lane exact;
* the GRU tiles own each hidden channel once, and their stores each lane
  of the output row's segments once (the last tile takes the channel
  tail); one CTA's shared memory is at most ``MAX_SMEM`` and the CTAs at
  most the SMs.

Also: the wrappers hand their geometry, tiling and mode to the launch, a
pool or a cell no tiling fits is refused with its shape named, and a CPU
model of the GRU kernel (the ``lanes``-way k split, the update from the
old h) is within the tolerance of the plain version in both modes when
every CTA reads before any stores, while in the tile mode without the
barrier (each CTA reads the pool as the CTAs after it left it, then
stores, the last tile first) it differs on the GRU chain's own in-place
cell.  No reference plan is compiled here.
"""
import ctypes
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import load
from repro_torch.core.vpool import fetch_segments
from repro_torch.kernels import PLAIN, conv2d, stream
from repro_torch.kernels._build import SIGNATURES
from repro_torch.kernels._launch import MAX_SMEM
from repro_torch.kernels.cases import (F32_EDGE_CASES,
                                       F32_FUSED_STREAM_EDGE_CASES,
                                       case_inputs, compare_f32, live_lanes,
                                       output_regions, program_cases)
from repro_torch.kernels.conv2d import pool_tiling
from repro_torch.kernels.stream import (GRU_ONE_CTA_BYTES, GRU_THREADS,
                                        GruTiling, gru_tiling)
from repro_torch.quant.requant import gru_update

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
POOL, GRU = "ring_avgpool", "ring_gru_cell"
N_SM = (132, 114, 16)
#: The committed fp32 plans with a pool or a GRU cell.
PLANS = ("ds-cnn", "resnet-8", "mcunet-5fps-vww", "ds-cnn-stream",
         "kws-gru-chain")


def _plan_cases(name):
    cn = load(ASSETS / f"{name}.host-sim.float32.json")
    return tuple(c for c in program_cases(
        cn.program, cn.params, kernel_block_rows=cn.target.kernel_block_rows,
        prefix=f"{name}_f32_") if c.kernel in (POOL, GRU))


PLAN_CASES = {n: _plan_cases(n) for n in PLANS}
_PLAN = sum(PLAN_CASES.values(), ())
EDGE = tuple(c for c in F32_EDGE_CASES + F32_FUSED_STREAM_EDGE_CASES
             if c.kernel in (POOL, GRU))
POOLS = tuple(c for c in _PLAN + EDGE if c.kernel == POOL)
GRUS = tuple(c for c in _PLAN + EDGE if c.kernel == GRU)
(PLAN_GRU,) = (c for c in _PLAN if c.kernel == GRU)
_BY_NAME = {c.name: c for c in EDGE}


def _segs(c):
    return -(-c // 128)


def _inputs(case):
    pool, params = case_inputs(case, seed=0)
    return torch.from_numpy(pool), [torch.from_numpy(a) for a in params]


def _plain(case, pool, params):
    want = pool.clone()
    PLAIN[case.kernel](want, *params, **case.kwargs)
    return want


def _within(case, got, want) -> bool:
    """``got`` within the fp32 tolerance of ``want`` on the lanes the call
    writes, exact everywhere else."""
    live = live_lanes(case.n_seg, output_regions(case.kernel, case.kwargs))
    return compare_f32(got.numpy(), want.numpy(), live)[1] is None


def test_the_plans_and_edge_cases_have_the_ops_held_here():
    assert [sum(c.kernel == POOL for c in PLAN_CASES[n]) for n in PLANS] \
        == [1, 1, 1, 1, 1]
    assert [sum(c.kernel == GRU for c in PLAN_CASES[n]) for n in PLANS] \
        == [0, 0, 0, 0, 1]
    assert {c.name for c in EDGE} >= {
        "f32_avgpool_wrap", "f32_avgpool_chunks", "f32_avgpool_inplace_256",
        "f32_gru_wide_input", "f32_gru_d_h_72", "f32_gru_inplace",
        "f32_gru_d_h_70", "f32_gru_wide"}
    # a pool in two chunks: 49 pixels of 1,280 channels over 512 threads
    kw = _BY_NAME["f32_avgpool_chunks"].kwargs
    t = pool_tiling(kw["h"], kw["w"], kw["c"])
    assert (t.threads, t.parts, t.chunk_pix, t.npix) == (512, 1, 43, 49)
    assert 4 * kw["h"] * kw["w"] * kw["c"] > MAX_SMEM
    # every plan pool is in place; the GRU chain's cell too (h' onto x)
    for c in _PLAN:
        assert c.kwargs["out_ptr"] == c.kwargs["in_ptr"], c.name
    kw = PLAN_GRU.kwargs
    assert (kw["d_in"], kw["d_h"], kw["state_ptr"]) == (64, 64, 620)
    assert _BY_NAME["f32_gru_d_h_70"].kwargs["d_h"] % 4
    kw = _BY_NAME["f32_gru_wide"].kwargs
    assert 4 * (kw["d_in"] + kw["d_h"]) * 3 * kw["d_h"] > GRU_ONE_CTA_BYTES


# ---------------------------------------------------------------------------
# The pool: its partition and a model of its parts.
# ---------------------------------------------------------------------------

def _staged(t, n):
    """``(pixel, float4)`` of every 16-byte copy of a chunk of ``n``
    pixels, as the kernel's threads issue them."""
    vecs = -(-t.c // 4)
    if vecs > t.threads:
        return [divmod(i, vecs) for i in range(n * vecs)]
    step = t.threads // vecs
    return [(p, tid % vecs) for tid in range(step * vecs)
            for p in range(tid // vecs, n, step)]


@pytest.mark.parametrize("case", POOLS, ids=lambda c: c.name)
def test_pool_reads_each_pixel_once_and_sums_each_channel_once(case):
    kw = case.kwargs
    c, npix = kw["c"], kw["h"] * kw["w"]
    t = pool_tiling(kw["h"], kw["w"], c)
    vecs = -(-c // 4)
    assert t.smem <= MAX_SMEM and t.cw >= c and t.cw & (t.cw - 1) == 0
    assert t.parts == 1 or t.parts * t.cw <= t.threads
    assert t.chunk_pix == npix or t.chunk_pix % t.parts == 0
    # a float4 of a pixel stays inside its segments
    assert 4 * vecs <= _segs(c) * 128
    staged = np.zeros((npix, vecs), int)
    summed = np.zeros((npix, c), int)
    for p0 in range(0, npix, t.chunk_pix):
        n = min(t.chunk_pix, npix - p0)
        for p, v in _staged(t, n):
            staged[p0 + p, v] += 1
        # thread (j, ch): pixels j, j + parts, ... of the chunk
        for j in range(t.parts):
            summed[p0 + j:p0 + n:t.parts, :] += 1
    assert (staged == 1).all() and (summed == 1).all()


def test_pool_tilings_at_plan_widths():
    """DS-CNN's 125 pixels and ResNet-8's 64 (64 channels) in 4 parts of
    a channel's sum, 256 threads; VWW's 9 pixels in one; every plan pool
    in one chunk; a 1,000-channel pool 512 threads."""
    got = {(h, w, c): pool_tiling(h, w, c)
           for h, w, c in ((25, 5, 64), (8, 8, 64), (3, 3, 96), (7, 7, 1000))}
    assert [(t.threads, t.cw, t.parts, t.chunk_pix) for t in got.values()] \
        == [(256, 64, 4, 125), (256, 64, 4, 64), (256, 128, 1, 9),
            (512, 1024, 1, 49)]
    # live float4s only: DS-CNN's 125 pixels of 64 channels, 32,000 B
    assert got[25, 5, 64].smem == 4 * 4 * 64 + 125 * 256
    big = pool_tiling(56, 56, 128)          # chunks, a multiple of parts
    assert big.chunk_pix < 56 * 56 and big.chunk_pix % big.parts == 0
    with pytest.raises(ValueError, match=r"ring_avgpool: no pixel of the "
                       r"pool \[7, 7, 100000\] fits 232448 B"):
        pool_tiling(7, 7, 100_000)


def _pool_model(case, pool, skip=None):
    """The kernel's arithmetic on ``pool``: per part j the fp32 sums of
    pixels j, j + parts, ... of every live channel (but pixel ``skip``),
    the parts summed in order, divided by h w, the row stored at out_ptr
    with a zero tail."""
    kw, n_seg = case.kwargs, pool.shape[0]
    c, npix, segs = kw["c"], kw["h"] * kw["w"], _segs(kw["c"])
    t = pool_tiling(kw["h"], kw["w"], c)
    img = fetch_segments(pool, kw["in_ptr"], npix * segs) \
        .reshape(npix, segs * 128)[:, :c]
    total = torch.zeros(c, dtype=torch.float32)
    for j in range(t.parts):
        part = torch.zeros(c, dtype=torch.float32)
        for p in range(j, npix, t.parts):
            if p != skip:
                part = part + img[p]
        total = total + part
    row = torch.zeros(segs * 128, dtype=torch.float32)
    row[:c] = total / npix
    got = pool.clone()
    seg = (kw["out_ptr"] + torch.arange(segs)) % n_seg
    got[seg] = row.reshape(segs, 128)
    return got


@pytest.mark.parametrize("case", POOLS, ids=lambda c: c.name)
def test_pool_model_is_within_the_tolerance_of_the_plain_version(case):
    pool, _ = _inputs(case)
    want = _plain(case, pool, ())
    got = _pool_model(case, pool)
    assert _within(case, got, want)
    # one that misses a pixel (the last chunk's last) is not
    npix = case.kwargs["h"] * case.kwargs["w"]
    assert not _within(case, _pool_model(case, pool, skip=npix - 1), want)


# ---------------------------------------------------------------------------
# The GRU cell's tiling and its mode.
# ---------------------------------------------------------------------------

def _gru_tilings(case, n_sm):
    kw = case.kwargs
    yield gru_tiling(kw["d_in"], kw["d_h"], n_sm)
    yield gru_tiling(kw["d_in"], kw["d_h"], n_sm, False)


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("case", GRUS, ids=lambda c: c.name)
def test_gru_tiles_own_every_channel_once_and_fit(case, n_sm):
    kw = case.kwargs
    d_in, d_h = kw["d_in"], kw["d_h"]
    for t in _gru_tilings(case, n_sm):
        assert t.smem <= MAX_SMEM and 1 <= t.ctas <= n_sm
        row = -(-3 * t.ctile // 4) * 4
        # x, h, the tile's 3 ctile columns of W and of U as rows of `row`
        # floats, the biases, 4 partial sums a thread and 2 gates a column
        assert t.smem >= 4 * (d_in + d_h + (d_in + d_h + 1) * row
                              + 4 * GRU_THREADS + 6 * t.ctile)
        assert t.smem <= 4 * (d_in + d_h + 6 + (d_in + d_h + 1) * row
                              + 4 * max(GRU_THREADS, row // 2)
                              + 6 * t.ctile)
        assert t.ctas == 1 or t.ctile % 4 == 0
        assert t.lanes & (t.lanes - 1) == 0
        assert t.lanes * 2 * (row // 4) <= GRU_THREADS or t.lanes == 1
        assert t.lanes ** 2 <= max(d_in, d_h)
        owned = np.zeros(d_h, int)
        stored = np.zeros(_segs(d_h) * 128, int)
        for i in range(t.ctas):
            i0, tn = t.tile(i)
            assert 1 <= tn <= t.ctile
            owned[i0:i0 + tn] += 1
            end = _segs(d_h) * 128 if i0 + t.ctile >= d_h else i0 + t.ctile
            stored[i0:end] += 1
        assert (owned == 1).all() and (stored == 1).all()


@pytest.mark.parametrize("case", GRUS, ids=lambda c: c.name)
def test_gru_cells_take_the_mode_of_the_rule(case):
    """One CTA in an ordinary launch up to ``GRU_ONE_CTA_BYTES`` of fp32
    weights where ``d_h`` is a multiple of 4, else the narrowest channel
    tile under a grid barrier."""
    kw = case.kwargs
    d_in, d_h = kw["d_in"], kw["d_h"]
    t = gru_tiling(d_in, d_h)
    small = 4 * (d_in + d_h) * 3 * d_h <= GRU_ONE_CTA_BYTES and d_h % 4 == 0
    assert t.barrier is (not small) is (t.ctas > 1)
    if small:
        assert t == GruTiling(d_in, d_h, d_h, False)
    else:
        assert t.ctile == 4


def test_gru_modes_can_be_forced_and_an_unfit_cell_is_refused(monkeypatch):
    grid = gru_tiling(64, 64, 132, False)
    assert grid.barrier and (grid.ctas, grid.ctile) == (16, 4)
    assert gru_tiling(2, 2, 132, False).barrier        # one CTA, barrier
    one = gru_tiling(64, 64, 132, True)
    assert not one.barrier and one.ctas == 1
    assert one.smem >= 4 * 2 * 64 * 192                 # W and U staged
    assert (one.lanes, grid.lanes) == (2, 8)
    with pytest.raises(ValueError, match=r"ring_gru_cell: no tile of the "
                       r"cell d_in 128, d_h 128 \(W \[128, 384\], U \[128, "
                       r"384\]\) fits 232448 B of shared memory in one "
                       r"CTA"):
        gru_tiling(128, 128, 132, True)
    with pytest.raises(ValueError, match=r"ring_gru_cell: no tile of the "
                       r"cell d_in 20000, d_h 64 .* over at most 132 CTAs"):
        gru_tiling(20_000, 64)
    # the wrapper refuses it before any launch
    monkeypatch.setattr(stream, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(conv2d, "_sm_count", lambda device: 132)
    monkeypatch.setattr(stream, "_launch", None)
    pool = torch.zeros((2 * 157, 128), dtype=torch.float32)   # row-aligned
    with pytest.raises(ValueError, match=r"d_in 20000, d_h 64"):
        stream.ring_gru_cell(pool, *[None] * 3, d_in=20_000, d_h=64,
                             in_ptr=0, out_ptr=0, state_ptr=200)


# ---------------------------------------------------------------------------
# The wrappers hand their geometry, tiling and mode to the launch.
# ---------------------------------------------------------------------------

def _record(monkeypatch, module, check, launch, wrapper):
    calls = []
    monkeypatch.setattr(module, check, lambda *a, **k: None)
    monkeypatch.setattr(conv2d, "_sm_count", lambda device: 132)
    monkeypatch.setattr(module, launch,
                        lambda name, pool, smem, tensors, ints:
                        calls.append((name, smem, tensors, ints)))
    monkeypatch.setattr(wrapper, "launches", 0)
    return calls


@pytest.mark.parametrize("case", POOLS, ids=lambda c: c.name)
def test_pool_wrapper_launches_with_its_geometry(case, monkeypatch):
    wrapper = conv2d.ring_avgpool
    calls = _record(monkeypatch, conv2d, "check_cuda", "launch", wrapper)
    pool, _ = _inputs(case)
    before = pool.clone()
    wrapper(pool, **case.kwargs)
    kw, n = case.kwargs, case.n_seg
    [(name, smem, tensors, ints)] = calls
    t = pool_tiling(kw["h"], kw["w"], kw["c"])
    assert name == POOL and smem == t.smem and tensors == ()
    assert len(ints) == SIGNATURES["ring_f32"][name].count(ctypes.c_int)
    assert ints == (n, kw["h"], kw["w"], kw["c"], kw["in_ptr"] % n,
                    kw["out_ptr"] % n, t.threads, t.parts, t.chunk_pix)
    assert wrapper.launches == 1 and wrapper.weights_staged is None
    assert torch.equal(pool, before)           # no plain fallback


@pytest.mark.parametrize("case", GRUS, ids=lambda c: c.name)
def test_gru_wrapper_launches_with_its_tiling_and_mode(case, monkeypatch):
    wrapper = stream.ring_gru_cell
    calls = _record(monkeypatch, stream, "_check_cuda", "_launch", wrapper)
    monkeypatch.setattr(wrapper, "barrier", None)
    monkeypatch.setattr(wrapper, "weights_staged", None)
    pool, params = _inputs(case)
    before = pool.clone()
    wrapper(pool, *params, **case.kwargs)
    kw, n = case.kwargs, case.n_seg
    t = gru_tiling(kw["d_in"], kw["d_h"])
    [(name, smem, tensors, ints)] = calls
    assert name == GRU and smem == t.smem
    assert all(a is b for a, b in zip(tensors, params, strict=True))
    assert len(ints) == SIGNATURES["ring_f32"][name].count(ctypes.c_int)
    assert ints == (n, kw["d_in"], kw["d_h"], kw["in_ptr"],
                    kw["out_ptr"] % n, kw["state_ptr"], t.ctile,
                    int(t.barrier))
    assert wrapper.barrier is t.barrier and wrapper.launches == 1
    assert wrapper.weights_staged is True
    assert torch.equal(pool, before)           # no plain fallback


# ---------------------------------------------------------------------------
# What the GRU's barrier is for: a model of the tiles' reads and stores.
# ---------------------------------------------------------------------------

def _lane_dot(v, m, lanes):
    """``v [depth] @ m [depth, n]`` as the kernel sums it: lane l of
    ``lanes`` takes rows l, l + lanes, ... in one fp32 chain a column;
    the lanes' partials are summed in lane order."""
    acc = None
    for lane in range(lanes):
        part = torch.zeros(m.shape[1], dtype=torch.float32)
        for k in range(lane, v.shape[0], lanes):
            part = part + v[k] * m[k]
        acc = part if acc is None else acc + part
    return acc


def _gru_cta_stores(case, t, i, pool, params):
    """CTA ``i``'s stores, ``[(segments, lanes, values)]``, computed as the
    kernel does from the pool ``pool``: x and h as staged, the tile's 6 tn
    gate columns summed over ``t.lanes`` lanes (+ the bias for gx), then
    the update of its channels from the OLD h, stored to the state and
    the output rows over lanes i0 .. end (the last tile with the channel
    tail)."""
    kw, n_seg = case.kwargs, pool.shape[0]
    w, u, b = params
    d_in, d_h = kw["d_in"], kw["d_h"]
    i0, tn = t.tile(i)
    x = fetch_segments(pool, kw["in_ptr"], _segs(d_in)).reshape(-1)[:d_in]
    h = fetch_segments(pool, kw["state_ptr"], _segs(d_h)).reshape(-1)[:d_h]
    cols = torch.cat([torch.arange(s * d_h + i0, s * d_h + i0 + tn)
                      for s in range(3)])
    gx = torch.zeros(3 * d_h, dtype=torch.float32)
    gh = torch.zeros(3 * d_h, dtype=torch.float32)
    gx[cols] = _lane_dot(x, w[:, cols], t.lanes) + b[cols]
    gh[cols] = _lane_dot(h, u[:, cols], t.lanes)
    hp = gru_update(gx[None], gh[None], h[None], d_h)[0]
    end = _segs(d_h) * 128 if i0 + t.ctile >= d_h else i0 + t.ctile
    values = torch.zeros(end - i0, dtype=torch.float32)
    values[:tn] = hp[i0:i0 + tn]
    lanes = torch.arange(i0, end)
    return [(((ptr + lanes // 128) % n_seg), lanes % 128, values)
            for ptr in (kw["state_ptr"], kw["out_ptr"])]


def _reading_first(case, t, pool, params):
    """Every CTA reads the pool from before the op, then every store, the
    last tile first."""
    stores = sum((_gru_cta_stores(case, t, i, pool, params)
                  for i in reversed(range(t.ctas))), [])
    got = pool.clone()
    for seg, lanes, values in stores:
        got[seg, lanes] = values
    return got


def _no_barrier(case, t, pool, params):
    """Each CTA reads the pool as the CTAs after it left it, then
    stores: the last tile first."""
    got = pool.clone()
    for i in reversed(range(t.ctas)):
        for seg, lanes, values in _gru_cta_stores(case, t, i, got, params):
            got[seg, lanes] = values
    return got


@pytest.mark.parametrize("one", (True, False), ids=("one_cta", "tiles"))
@pytest.mark.parametrize("case", GRUS, ids=lambda c: c.name)
def test_gru_reading_first_is_within_the_tolerance_of_the_plain_version(
        case, one):
    kw = case.kwargs
    if one and GruTiling(kw["d_in"], kw["d_h"], kw["d_h"],
                         False).smem > MAX_SMEM:
        # no CTA holds the whole cell: the rule takes the tiles
        one = False
    t = gru_tiling(kw["d_in"], kw["d_h"], 132, one)
    pool, params = _inputs(case)
    assert _within(case, _reading_first(case, t, pool, params),
                   _plain(case, pool, params))


@pytest.mark.parametrize("case", (PLAN_GRU, _BY_NAME["f32_gru_inplace"]),
                         ids=lambda c: c.name)
def test_gru_tiles_tell_a_missing_barrier_from_reading_first(case):
    """On the GRU chain's cell (h' onto x and onto h) the 16 channel
    tiles need their barrier: a tile that stores before the others have
    read changes the x and h they read."""
    kw = case.kwargs
    t = gru_tiling(kw["d_in"], kw["d_h"], 132, False)
    assert t.barrier and t.ctas == 16
    pool, params = _inputs(case)
    want = _plain(case, pool, params)
    assert _within(case, _reading_first(case, t, pool, params), want)
    assert not _within(case, _no_barrier(case, t, pool, params), want)


def test_gru_update_reads_the_old_h():
    """The update blends the OLD h: one that read h back from the ring
    after the state's store (h' already there) would differ."""
    kw, d_h = PLAN_GRU.kwargs, PLAN_GRU.kwargs["d_h"]
    pool, params = _inputs(PLAN_GRU)
    w, u, b = params
    x = pool[kw["in_ptr"], :kw["d_in"]]
    h = pool[kw["state_ptr"], :d_h]
    gx, gh = x @ w + b, h @ u
    hp = _plain(PLAN_GRU, pool, params)[kw["state_ptr"], :d_h]
    torch.testing.assert_close(gru_update(gx[None], gh[None], h[None],
                                          d_h)[0], hp)
    stale = gru_update(gx[None], gh[None], hp[None], d_h)[0]
    assert (stale - hp).abs().max() > 1e-3
