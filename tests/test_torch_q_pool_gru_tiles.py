"""The int8 average pool's partition and the int8 GRU cell's tiling, on
the CPU.

``ring_avgpool_q`` (``csrc/ring_q.cu``) is one CTA in an ordinary launch
(``quantized.pool_q_tiling``): its threads stage the pixels as 16-byte
vectors (in chunks where they do not fit shared memory), then thread
``(j, ch)`` sums channel ``ch`` of pixels ``j, j + parts, ...``; after
every read a thread a channel adds the parts, requantizes and stores the
row, which lands on pixel 0 of its input in every plan.
``ring_gru_cell_q`` runs the tiles of ``stream.gru_q_tiling``: one CTA in
an ordinary launch where the cell is small, else channel tiles under one
grid barrier in a cooperative launch, each CTA staging x, h and the z, r
and n columns of W and U of its hidden channels.  Held here, on every
pool and GRU cell of the committed int8 plans (DS-CNN, ResNet-8,
MCUNet-5fps-VWW, the DS-CNN stream, the GRU chain) and on every pool /
GRU edge case, at an H100 SXM's 132 SMs, an H100 PCIe's 114 and at 16:

* the pool stages each (pixel, vector) of its input exactly once and sums
  each (pixel, channel) once, and a model of its parts is bitwise the
  plain version;
* the GRU tiles own each hidden channel once, and their stores each lane
  of the output row's segments once, in whole 32-bit words (the last
  tile takes the channel tail); one CTA's shared memory is at most
  ``MAX_SMEM`` and the CTAs at most the SMs.

Also: the wrappers hand their geometry, tiling and mode to the launch, a
cell no tile fits is refused with its shape named, and a CPU model of the
GRU kernel (the ``ks``-lane k split summed mod 2**32, the update from the
old h) is bitwise the plain version in both modes when every CTA reads
before any stores, while in the tile mode without the barrier (each CTA
reads the pool as the CTAs after it left it, then stores, the last tile
first) it differs on the GRU chain's own in-place cell.
"""
import ctypes
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import load
from repro_torch.core.vpool import fetch_segments
from repro_torch.kernels import PLAIN, conv2d, quantized, stream
from repro_torch.kernels._build import SIGNATURES
from repro_torch.kernels._launch import MAX_SMEM
from repro_torch.kernels.cases import (CARD_EDGE_CASES, EDGE_CASES,
                                       case_inputs, program_cases)
from repro_torch.kernels.quantized import pool_q_tiling
from repro_torch.kernels.stream import (GRU_Q_ONE_CTA_BYTES, GRU_Q_THREADS,
                                        GruQTiling, gru_q_tiling)
from repro_torch.quant.requant import (gru_update_q12, requantize,
                                       requantize_i32, wrap_i32)

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
POOL, GRU = "ring_avgpool_q", "ring_gru_cell_q"
N_SM = (132, 114, 16)
#: The committed int8 plans with a pool or a GRU cell.
PLANS = ("ds-cnn", "resnet-8", "mcunet-5fps-vww", "ds-cnn-stream",
         "kws-gru-chain")


def _plan_cases(name):
    cn = load(ASSETS / f"{name}.cortex-m4.int8.json")
    return tuple(c for c in program_cases(
        cn.program, cn.qnet.qparams,
        kernel_block_rows=cn.target.kernel_block_rows, prefix=f"{name}_")
        if c.kernel in (POOL, GRU))


PLAN_CASES = {n: _plan_cases(n) for n in PLANS}
_PLAN = sum(PLAN_CASES.values(), ())
EDGE = tuple(c for c in EDGE_CASES + CARD_EDGE_CASES
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


def test_the_plans_and_edge_cases_have_the_ops_held_here():
    assert [sum(c.kernel == POOL for c in PLAN_CASES[n]) for n in PLANS] \
        == [1, 1, 1, 1, 1]
    assert [sum(c.kernel == GRU for c in PLAN_CASES[n]) for n in PLANS] \
        == [0, 0, 0, 0, 1]
    assert {c.name for c in EDGE} >= {
        "avgpool_wrap", "avgpool_q_inplace_wrap", "avgpool_q_wide",
        "gru_wide_input", "gru_bias_wraps", "gru_q_inplace", "gru_q_d_h_70",
        "avgpool_q_chunks_card", "avgpool_q_wide_card"}
    # the card's pools in chunks: 256 threads a vector each, and 568
    # vectors a pixel over 512 threads
    chunks = _BY_NAME["avgpool_q_chunks_card"].kwargs
    t = pool_q_tiling(chunks["h"], chunks["w"], chunks["c"])
    assert (t.threads, t.parts, t.chunk_pix, t.npix) == (256, 2, 1808, 2025)
    wide = _BY_NAME["avgpool_q_wide_card"].kwargs
    t = pool_q_tiling(wide["h"], wide["w"], wide["c"])
    assert (t.threads, t.parts, t.chunk_pix, t.npix) == (512, 1, 18, 49)
    assert _segs(wide["c"]) * 8 > t.threads
    # every plan pool is in place; the GRU chain's cell too (h' onto x)
    for c in _PLAN:
        assert c.kwargs["out_ptr"] == c.kwargs["in_ptr"], c.name
    kw = PLAN_GRU.kwargs
    assert (kw["d_in"], kw["d_h"], kw["state_ptr"]) == (64, 64, 620)


# ---------------------------------------------------------------------------
# The pool: its partition and a model of its group sums.
# ---------------------------------------------------------------------------

def _staged(t, n):
    """``(pixel, vector)`` of every 16-byte copy of a chunk of ``n``
    pixels, as the kernel's threads issue them."""
    vecs = _segs(t.c) * 8
    if vecs > t.threads:
        return [divmod(i, vecs) for i in range(n * vecs)]
    step = t.threads // vecs
    return [(p, tid % vecs) for tid in range(step * vecs)
            for p in range(tid // vecs, n, step)]


@pytest.mark.parametrize("case", POOLS, ids=lambda c: c.name)
def test_pool_reads_each_pixel_once_and_sums_each_byte_once(case):
    kw = case.kwargs
    c, npix = kw["c"], kw["h"] * kw["w"]
    t = pool_q_tiling(kw["h"], kw["w"], c)
    vecs = _segs(c) * 8
    assert t.smem <= MAX_SMEM and t.cw >= c and t.cw & (t.cw - 1) == 0
    assert t.parts == 1 or t.parts * t.cw <= t.threads
    assert t.chunk_pix == npix or t.chunk_pix % t.parts == 0
    staged = np.zeros((npix, vecs), int)
    summed = np.zeros((npix, c), int)
    for p0 in range(0, npix, t.chunk_pix):
        n = min(t.chunk_pix, npix - p0)
        for p, v in _staged(t, n):
            staged[p0 + p, v] += 1
        # thread (j, ch): pixels j, j + parts, ... of the chunk
        for j in range(t.parts):
            summed[p0 + j:p0 + n:t.parts, :] += 1
            assert all((p0 + p) % t.parts == j for p in range(j, n, t.parts))
    assert (staged == 1).all() and (summed == 1).all()


def test_pool_tilings_at_plan_widths():
    """DS-CNN's 125 pixels and ResNet-8's 64 (64 channels) in 4 parts of
    a channel's sum, 256 threads; VWW's 9 pixels in one; every plan pool
    in one chunk; the 1000-channel pool 512 threads."""
    got = {(h, w, c): pool_q_tiling(h, w, c)
           for h, w, c in ((25, 5, 64), (8, 8, 64), (3, 3, 96), (7, 7, 1000))}
    assert [(t.threads, t.cw, t.parts, t.chunk_pix) for t in got.values()] \
        == [(256, 64, 4, 125), (256, 64, 4, 64), (256, 128, 1, 9),
            (512, 1024, 1, 49)]
    big = pool_q_tiling(56, 56, 128)        # chunks, a multiple of parts
    assert big.chunk_pix < 56 * 56 and big.chunk_pix % big.parts == 0
    with pytest.raises(ValueError, match=r"ring_avgpool_q: no pixel of the "
                       r"pool \[7, 7, 2000000\] fits 232448 B"):
        pool_q_tiling(7, 7, 2_000_000)


def _pool_model(case, pool, signed=True):
    """The kernel's arithmetic on ``pool``: per part j the int32
    (wrapping) sums of pixels j, j + parts, ... of every live channel
    (sign-extended bytes, or read as unsigned where ``signed`` is False),
    the parts summed mod 2**32, requantized, the row stored at out_ptr
    with a zero tail."""
    kw, n_seg = case.kwargs, pool.shape[0]
    c, npix, segs = kw["c"], kw["h"] * kw["w"], _segs(kw["c"])
    t = pool_q_tiling(kw["h"], kw["w"], c)
    img = fetch_segments(pool, kw["in_ptr"], npix * segs) \
        .reshape(npix, segs * 128)[:, :c].to(torch.int64)
    if not signed:
        img = img % 256
    part = torch.stack([img[j::t.parts].sum(dim=0) % (1 << 32)
                        for j in range(t.parts)])
    total = part.sum(dim=0) % (1 << 32)
    total = torch.where(total >= 1 << 31, total - (1 << 32), total)
    row = torch.zeros(segs * 128, dtype=torch.int8)
    row[:c] = requantize(total, int(kw["mult"]), int(kw["shift"]))
    got = pool.clone()
    seg = (kw["out_ptr"] + torch.arange(segs)) % n_seg
    got[seg] = row.reshape(segs, 128)
    return got


@pytest.mark.parametrize("case", POOLS, ids=lambda c: c.name)
def test_pool_model_is_bitwise_the_plain_version(case):
    pool, _ = _inputs(case)
    want = _plain(case, pool, ())
    assert torch.equal(_pool_model(case, pool), want)
    # bytes read as unsigned would give other sums: the inputs hold
    # negative bytes
    assert not torch.equal(_pool_model(case, pool, signed=False), want)


# ---------------------------------------------------------------------------
# The GRU cell's tiling and its mode.
# ---------------------------------------------------------------------------

def _gru_tilings(case, n_sm):
    kw = case.kwargs
    yield gru_q_tiling(kw["d_in"], kw["d_h"], n_sm)
    yield gru_q_tiling(kw["d_in"], kw["d_h"], n_sm, False)


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("case", GRUS, ids=lambda c: c.name)
def test_gru_tiles_own_every_channel_once_and_fit(case, n_sm):
    kw = case.kwargs
    d_in, d_h = kw["d_in"], kw["d_h"]
    for t in _gru_tilings(case, n_sm):
        assert t.smem <= MAX_SMEM and 1 <= t.ctas <= n_sm
        row = -(-3 * t.ctile // 4) * 4
        # x, h, the tile's 3 ctile columns of W and of U as rows of `row`
        # bytes, 7 int32 a column and 4 partial sums a thread
        assert t.smem >= d_in + d_h + (d_in + d_h) * row + 84 * t.ctile \
            + 16 * GRU_Q_THREADS
        assert t.smem <= (d_in + d_h + 60) * (row + 16) + 84 * t.ctile \
            + 16 * GRU_Q_THREADS
        assert t.ctas == 1 or t.ctile % 4 == 0
        owned = np.zeros(d_h, int)
        stored = np.zeros(_segs(d_h) * 128, int)
        for i in range(t.ctas):
            i0, tn = t.tile(i)
            assert 1 <= tn <= t.ctile
            owned[i0:i0 + tn] += 1
            end = _segs(d_h) * 128 if i0 + t.ctile >= d_h else i0 + t.ctile
            assert i0 % 4 == 0 and end % 4 == 0      # whole 32-bit words
            stored[i0:end] += 1
        assert (owned == 1).all() and (stored == 1).all()


@pytest.mark.parametrize("case", GRUS, ids=lambda c: c.name)
def test_gru_cells_take_the_mode_of_the_rule(case):
    """One CTA in an ordinary launch up to ``GRU_Q_ONE_CTA_BYTES`` of
    weights where ``d_h`` is a multiple of 4, else the narrowest channel
    tile under a grid barrier."""
    kw = case.kwargs
    d_in, d_h = kw["d_in"], kw["d_h"]
    t = gru_q_tiling(d_in, d_h)
    small = (d_in + d_h) * 3 * d_h <= GRU_Q_ONE_CTA_BYTES and d_h % 4 == 0
    assert t.barrier is (not small) is (t.ctas > 1)
    if small:
        assert t == GruQTiling(d_in, d_h, d_h, False)
    else:
        assert t.ctile == 4


def test_gru_modes_can_be_forced_and_an_unfit_cell_is_refused(monkeypatch):
    grid = gru_q_tiling(64, 64, 132, False)
    assert grid.barrier and (grid.ctas, grid.ctile) == (16, 4)
    assert gru_q_tiling(2, 2, 132, False).barrier        # one CTA, barrier
    one = gru_q_tiling(64, 64, 132, True)
    assert not one.barrier and one.ctas == 1
    assert one.smem >= 2 * 64 * 192                      # W and U staged
    with pytest.raises(ValueError, match=r"ring_gru_cell_q: no tile of the "
                       r"cell d_in 512, d_h 512 \(W \[512, 1536\], U \[512, "
                       r"1536\]\) fits 232448 B of shared memory in one "
                       r"CTA"):
        gru_q_tiling(512, 512, 132, True)
    with pytest.raises(ValueError, match=r"d_in 20000, d_h 64"):
        gru_q_tiling(20_000, 64)
    # the wrapper refuses it before any launch
    monkeypatch.setattr(stream, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(conv2d, "_sm_count", lambda device: 132)
    monkeypatch.setattr(stream, "_launch", None)
    pool = torch.zeros((2 * 157, 128), dtype=torch.int8)   # row-aligned
    with pytest.raises(ValueError, match=r"d_in 20000, d_h 64"):
        stream.ring_gru_cell_q(pool, *[None] * 7, d_in=20_000, d_h=64,
                               in_ptr=0, out_ptr=0, state_ptr=200)


# ---------------------------------------------------------------------------
# The wrappers hand their geometry, tiling and mode to the launch.
# ---------------------------------------------------------------------------

def _record(monkeypatch, module, wrapper):
    calls = []
    monkeypatch.setattr(module, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(conv2d, "_sm_count", lambda device: 132)
    monkeypatch.setattr(module, "_launch",
                        lambda name, pool, smem, tensors, ints:
                        calls.append((name, smem, tensors, ints)))
    monkeypatch.setattr(wrapper, "launches", 0)
    return calls


@pytest.mark.parametrize("case", POOLS, ids=lambda c: c.name)
def test_pool_wrapper_launches_with_its_geometry(case, monkeypatch):
    wrapper = quantized.ring_avgpool_q
    calls = _record(monkeypatch, quantized, wrapper)
    pool, _ = _inputs(case)
    before = pool.clone()
    wrapper(pool, **case.kwargs)
    kw, n = case.kwargs, case.n_seg
    [(name, smem, tensors, ints)] = calls
    t = pool_q_tiling(kw["h"], kw["w"], kw["c"])
    assert name == POOL and smem == t.smem and tensors == ()
    assert len(ints) == SIGNATURES["ring_q"][name].count(ctypes.c_int)
    assert ints == (n, kw["h"], kw["w"], kw["c"], kw["in_ptr"] % n,
                    kw["out_ptr"] % n, kw["mult"], kw["shift"], t.chunk_pix)
    assert wrapper.launches == 1 and wrapper.weights_staged is None
    assert torch.equal(pool, before)           # no plain fallback


@pytest.mark.parametrize("case", GRUS, ids=lambda c: c.name)
def test_gru_wrapper_launches_with_its_tiling_and_mode(case, monkeypatch):
    wrapper = stream.ring_gru_cell_q
    calls = _record(monkeypatch, stream, wrapper)
    monkeypatch.setattr(wrapper, "barrier", None)
    monkeypatch.setattr(wrapper, "weights_staged", None)
    pool, params = _inputs(case)
    wrapper(pool, *params, **case.kwargs)
    kw, n = case.kwargs, case.n_seg
    t = gru_q_tiling(kw["d_in"], kw["d_h"])
    [(name, smem, tensors, ints)] = calls
    assert name == GRU and smem == t.smem
    assert all(a is b for a, b in zip(tensors, params, strict=True))
    assert len(ints) == SIGNATURES["ring_q"][name].count(ctypes.c_int)
    assert ints == (n, kw["d_in"], kw["d_h"], kw["in_ptr"],
                    kw["out_ptr"] % n, kw["state_ptr"], t.ctile,
                    int(t.barrier))
    assert wrapper.barrier is t.barrier and wrapper.launches == 1
    assert wrapper.weights_staged is True


# ---------------------------------------------------------------------------
# What the GRU's barrier is for: a model of the tiles' reads and stores.
# ---------------------------------------------------------------------------

def _lane_dot(x, w, chunks, ks):
    """``x [16 chunks] @ w [16 chunks, n]`` as the kernel sums it: lane j
    of ``ks`` takes chunks j, j + ks, ...; the lanes' uint32 partials are
    summed mod 2**32; returned as int32 values (int64)."""
    acc = torch.zeros(w.shape[1], dtype=torch.int64)
    for j in range(ks):
        part = 0
        for c in range(j, chunks, ks):
            part = part + x[16 * c:16 * c + 16] @ w[16 * c:16 * c + 16]
        acc = (acc + part) % (1 << 32)
    return torch.where(acc >= 1 << 31, acc - (1 << 32), acc)


def _gru_cta_stores(case, t, i, pool, params):
    """CTA ``i``'s stores, ``[(segments, lanes, values)]``, computed as the
    kernel does from the pool ``pool``: x's and h's first ceil(d / 16)
    16-byte chunks as staged (bytes past d included) against the weights
    zero from d on, the tile's 6 tn outputs split over the kernel's ``ks``
    lanes, requantized (gx plus the bias, wrapping), then the update of
    its channels from the OLD h, stored to the state and the output rows
    over lanes i0 .. end (the last tile with the channel tail)."""
    kw, n_seg = case.kwargs, pool.shape[0]
    w, u, b, mx, sx, mu, su = params
    d_in, d_h = kw["d_in"], kw["d_h"]
    i0, tn = t.tile(i)
    cx, ch = -(-d_in // 16), -(-d_h // 16)
    x = fetch_segments(pool, kw["in_ptr"], _segs(d_in)).reshape(-1)[
        :16 * cx].to(torch.int64)
    h = fetch_segments(pool, kw["state_ptr"], _segs(d_h)).reshape(-1)[
        :16 * ch].to(torch.int64)
    cols = torch.cat([torch.arange(s * d_h + i0, s * d_h + i0 + tn)
                      for s in range(3)])
    wz = torch.zeros((16 * cx, 3 * tn), dtype=torch.int64)
    wz[:d_in] = w[:, cols].to(torch.int64)
    uz = torch.zeros((16 * ch, 3 * tn), dtype=torch.int64)
    uz[:d_h] = u[:, cols].to(torch.int64)
    n_out, ks = 6 * tn, 1
    while ks < 32 and 2 * ks <= max(cx, ch) and 2 * ks * n_out <= \
            GRU_Q_THREADS:
        ks *= 2
    gx = torch.zeros(3 * d_h, dtype=torch.int64)
    gh = torch.zeros(3 * d_h, dtype=torch.int64)
    gx[cols] = wrap_i32(requantize_i32(_lane_dot(x, wz, cx, ks), mx[cols],
                                       sx[cols]) + b[cols])   # uint32 sum
    gh[cols] = requantize_i32(_lane_dot(h, uz, ch, ks), mu[cols], su[cols])
    hp = gru_update_q12(gx[None], gh[None], h[None, :d_h], d_h)[0]
    end = _segs(d_h) * 128 if i0 + t.ctile >= d_h else i0 + t.ctile
    values = torch.zeros(end - i0, dtype=torch.int8)
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
def test_gru_reading_first_is_bitwise_the_plain_version(case, one):
    kw = case.kwargs
    t = gru_q_tiling(kw["d_in"], kw["d_h"], 132, one)
    pool, params = _inputs(case)
    assert torch.equal(_reading_first(case, t, pool, params),
                       _plain(case, pool, params))


@pytest.mark.parametrize("case", (PLAN_GRU, _BY_NAME["gru_q_inplace"]),
                         ids=lambda c: c.name)
def test_gru_tiles_tell_a_missing_barrier_from_reading_first(case):
    """On the GRU chain's cell (h' onto x and onto h) the 16 channel
    tiles need their barrier: a tile that stores before the others have
    read changes the x and h they read."""
    kw = case.kwargs
    t = gru_q_tiling(kw["d_in"], kw["d_h"], 132, False)
    assert t.barrier and t.ctas == 16
    pool, params = _inputs(case)
    want = _plain(case, pool, params)
    assert torch.equal(_reading_first(case, t, pool, params), want)
    assert not torch.equal(_no_barrier(case, t, pool, params), want)


def test_gru_update_reads_the_old_h():
    """The update blends the OLD h: one that read h back from the ring
    after the state's store (h' already there) would differ."""
    kw, d_h = PLAN_GRU.kwargs, PLAN_GRU.kwargs["d_h"]
    pool, params = _inputs(PLAN_GRU)
    w, u, b, mx, sx, mu, su = params
    x = pool[kw["in_ptr"], :kw["d_in"]].to(torch.int64)
    h = pool[kw["state_ptr"], :d_h].to(torch.int64)
    gx = wrap_i32(requantize_i32(wrap_i32(x @ w.to(torch.int64)), mx, sx)
                  + b)
    gh = requantize_i32(wrap_i32(h @ u.to(torch.int64)), mu, su)
    hp = _plain(PLAN_GRU, pool, params)[kw["state_ptr"], :d_h]
    assert torch.equal(gru_update_q12(gx[None], gh[None], h[None], d_h)[0],
                       hp)
    assert not torch.equal(
        gru_update_q12(gx[None], gh[None], hp[None], d_h)[0], hp)
