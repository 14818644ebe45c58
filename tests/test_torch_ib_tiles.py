"""The tiling of the fp32 fused inverted bottleneck kernel, on the CPU.

``ring_inverted_bottleneck`` (``csrc/ring_f32.cu``) runs one CTA per tile
of ``repro_torch.kernels.inverted_bottleneck.ib_tiling`` (a block of
output rows x a block of columns), computes each tile in sub-tiles from
the A pixels their taps reach, reads all of an op's input before a
grid-wide barrier and stores only after it.  Held here, on every
``ib_fused`` op of the committed fp32 MCUNet-5fps-VWW plan, of the fp32
``mcunet-320kb-imagenet`` plan (compiled by the reference once per
module; not served yet) and on every fp32 bottleneck edge case, at an
H100 SXM's 132 SMs, an H100 PCIe's 114 and at 16:

* the tiles store every output pixel's segment exactly once, every lane,
  and their sub-tiles cover each tile's pixels exactly once;
* a sub-tile's staged pixels cover every in-image tap of its outputs,
  within the halo its shared memory is sized for;
* one CTA's shared memory is at most ``MAX_SMEM`` and the CTAs at most
  the SMs; every plan op runs more than one CTA.

Also: the wrapper hands that tiling to the launch, a geometry that no
tile fits is refused with its shape named, and a model of the tiles
without the barrier (each CTA reads, then stores, the last tile first)
differs from the plain version on ``f32_ib_inplace_uneven`` where
reading everything first does not.
"""
import pathlib

import numpy as np
import pytest
import torch

import repro
from repro_torch import load
from repro_torch.core.executors import op_kernel_call
from repro_torch.core.program import PoolProgram
from repro_torch.kernels import inverted_bottleneck as ib
from repro_torch.kernels._launch import MAX_SMEM
from repro_torch.kernels.cases import (F32_FUSED_STREAM_EDGE_CASES,
                                       case_inputs, compare_f32, live_lanes,
                                       output_regions, program_cases)
from repro_torch.kernels.inverted_bottleneck import ib_tiling

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
KERNEL = "ring_inverted_bottleneck"
N_SM = (132, 114, 16)


def _vww():
    cn = load(ASSETS / "mcunet-5fps-vww.host-sim.float32.json")
    return tuple(c for c in program_cases(
        cn.program, cn.params, kernel_block_rows=cn.target.kernel_block_rows,
        prefix="vww_f32_") if c.kernel == KERNEL)


def _imagenet():
    """The kwargs of every ``ib_fused`` op of the reference's fp32
    ImageNet plan (the geometry only: no weights are drawn)."""
    ref = repro.compile("mcunet-320kb-imagenet", "host-sim")
    program = PoolProgram.from_json_dict(ref.program.to_json_dict())
    return tuple(
        (f"imagenet_f32_op{i:02d}",
         op_kernel_call(program, op, (None, None, None))[2])
        for i, op in enumerate(program.ops) if op.kind == "ib_fused")


VWW = _vww()
EDGE = tuple(c for c in F32_FUSED_STREAM_EDGE_CASES if c.kernel == KERNEL)
IMAGENET = _imagenet()
PLANS = tuple((c.name, c.kwargs) for c in VWW) + IMAGENET
GEOMETRIES = PLANS + tuple((c.name, c.kwargs) for c in EDGE)
UNEVEN = next(c for c in EDGE if c.name == "f32_ib_inplace_uneven")


def test_the_plans_have_the_ops_the_tiling_is_held_on():
    assert len(VWW) == 6 and len(IMAGENET) == 10
    assert {kw["RS"] for _, kw in IMAGENET} == {3, 5, 7}
    assert all(kw["in_ptr"] == kw["out_ptr"] for name, kw in GEOMETRIES
               if not name.startswith("f32_"))


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("name, kw", GEOMETRIES,
                         ids=[name for name, _ in GEOMETRIES])
def test_tiles_store_every_pixel_once_and_fit(name, kw, n_sm):
    t = ib_tiling(kw, n_sm)
    H, W, RS = kw["H"], kw["W"], kw["RS"]
    pad = (RS - 1) // 2
    assert 1 <= t.ctas <= n_sm and t.smem <= MAX_SMEM
    assert t.held == 4 * t.rows * t.cols * kw["C_out"]
    halo = min(H, t.sub_rows + RS - 1) * min(W, t.sub_cols + RS - 1)
    assert t.smem >= t.held + 4 * (halo * (kw["C_in"] + kw["C_mid"])
                                   + t.sub_rows * t.sub_cols * kw["C_mid"])
    tiles = np.zeros((H, W), int)
    subs = np.zeros((H, W), int)
    for i in range(t.ctas):
        p0, np_, q0, nq = t.tile(i)
        assert 1 <= np_ <= t.rows and 1 <= nq <= t.cols
        tiles[p0:p0 + np_, q0:q0 + nq] += 1
        for s0, sn, u0, un, lo, nh, lc, nc in t.subtiles(i):
            assert p0 <= s0 and s0 + sn <= p0 + np_
            assert q0 <= u0 and u0 + un <= q0 + nq
            assert sn <= t.sub_rows and un <= t.sub_cols and nh * nc <= halo
            subs[s0:s0 + sn, u0:u0 + un] += 1
            for p in range(s0, s0 + sn):
                for q in range(u0, u0 + un):
                    for r in range(p - pad, p + pad + 1):
                        for c in range(q - pad, q + pad + 1):
                            if 0 <= r < H and 0 <= c < W:
                                assert lo <= r < lo + nh and lc <= c < lc \
                                    + nc, (i, p, q, r, c)
    assert (tiles == 1).all() and (subs == 1).all()
    # one segment a pixel, stored whole: every segment of the output run
    # once
    n_seg = 2 * H * W
    stored = np.zeros(n_seg, int)
    for i in range(t.ctas):
        p0, np_, q0, nq = t.tile(i)
        for p in range(p0, p0 + np_):
            stored[(kw["out_ptr"] + p * W + q0 + np.arange(nq)) % n_seg] += 1
    assert stored.sum() == H * W and stored.max() == 1


@pytest.mark.parametrize("name, kw", PLANS,
                         ids=[name for name, _ in PLANS])
def test_plan_ops_run_many_ctas(name, kw):
    t = ib_tiling(kw)
    assert t.ctas > 1
    if name.startswith("vww"):     # 20, 10 and 5 rows; all fit whole
        assert (t.sub_rows, t.sub_cols) == (t.rows, t.cols) and t.stage_w
        assert t.ctas == {(20, 48): 70, (10, 144): 50, (10, 120): 25,
                          (5, 240): 15, (5, 192): 25}[kw["H"], kw["C_mid"]]


def test_subtiles_where_the_halo_does_not_fit_and_weights_through_l2():
    """The uneven edge case needs three sub-tiles a CTA (C_mid 1024), and
    its 233 KB of weights do not fit beside them."""
    t = ib_tiling(UNEVEN.kwargs)
    assert (t.ctas, t.rows, t.cols, t.sub_rows, t.sub_cols) == \
        (108, 6, 3, 2, 3)
    assert not t.stage_w and len(t.subtiles(0)) == 3
    last = t.tile(t.ctas - 1)
    assert last[1] == 1 and len(t.subtiles(t.ctas - 1)) == 1
    whole = ib._ib_smem(49, 36, 16, 1024, 16, 5, 6, 3, 6, 3, False)
    assert whole > MAX_SMEM


def test_a_geometry_no_tile_fits_is_refused_with_its_shape():
    wide = dict(H=8, W=8, C_in=64, C_mid=1024, C_out=64, RS=9)
    with pytest.raises(ValueError, match=r"\[8, 8, 64\] -> 1024 -> 64, "
                                         r"RS 9"):
        ib_tiling(wide)
    # more pixels a CTA than its held outputs can take
    with pytest.raises(ValueError, match="ring_inverted_bottleneck"):
        ib_tiling(dict(H=2048, W=2048, C_in=128, C_mid=128, C_out=128,
                       RS=3), n_sm=2)


@pytest.mark.parametrize("case", (VWW[0], UNEVEN, EDGE[1]),
                         ids=lambda c: c.name)
def test_wrapper_launches_with_its_tiling(case, monkeypatch):
    calls = []
    monkeypatch.setattr(ib, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(ib, "_sm_count", lambda device: 132)
    monkeypatch.setattr(ib, "launch",
                        lambda name, pool, smem, tensors, ints:
                        calls.append((name, smem, ints)))
    wrapper = ib.ring_inverted_bottleneck
    monkeypatch.setattr(wrapper, "launches", 0)
    pool, params = case_inputs(case, seed=0)
    wrapper(torch.from_numpy(pool), *map(torch.from_numpy, params),
            **case.kwargs)
    t = ib_tiling(case.kwargs)
    [(name, smem, ints)] = calls
    assert name == KERNEL and smem == t.smem
    assert ints[-5:] == (t.rows, t.cols, t.sub_rows, t.sub_cols,
                         int(t.stage_w))
    assert ints[7:9] == (case.kwargs["in_ptr"] % case.n_seg,
                         case.kwargs["out_ptr"] % case.n_seg)
    assert wrapper.launches == 1 and wrapper.weights_staged is t.stage_w


# ---------------------------------------------------------------------------
# What the grid barrier is for: a model of the tiles' reads and stores.
# ---------------------------------------------------------------------------

def _cta_stores(case, t, i, snap, params):
    """CTA ``i``'s stores, ``(segments, values [n, 128])``, computed from
    the pool ``snap``: the bottleneck of the A pixels its taps reach (a
    crop of the image, 'same'-padded only at the image's own edges), its
    tile's pixels kept, zero channel tails."""
    kw = case.kwargs
    H, W, pad = kw["H"], kw["W"], (kw["RS"] - 1) // 2
    p0, np_, q0, nq = t.tile(i)
    lo, hi = max(0, p0 - pad), min(H, p0 + np_ + pad)
    lc, rc = max(0, q0 - pad), min(W, q0 + nq + pad)
    rows = np.arange(lo, hi)[:, None] * W + np.arange(lc, rc)[None, :]
    a = snap[(kw["in_ptr"] + rows) % case.n_seg, :kw["C_in"]]
    e = ib.inverted_bottleneck_ref(a, *params, residual=kw["residual"])
    e = e[p0 - lo:p0 - lo + np_, q0 - lc:q0 - lc + nq]
    out = torch.zeros((np_ * nq, 128))
    out[:, :kw["C_out"]] = e.reshape(-1, kw["C_out"])
    pix = np.arange(p0, p0 + np_)[:, None] * W + np.arange(q0, q0 + nq)
    return (kw["out_ptr"] + pix.ravel()) % case.n_seg, out


def _held(case, got, want):
    live = live_lanes(case.n_seg, output_regions(case.kernel, case.kwargs))
    return compare_f32(got.numpy(), want.numpy(), live)[1]


def test_uneven_case_tells_a_missing_barrier_from_reading_first():
    case = UNEVEN
    assert case.kwargs["in_ptr"] == case.kwargs["out_ptr"]
    pool, params = case_inputs(case, seed=0)
    pool = torch.from_numpy(pool)
    params = [torch.from_numpy(a) for a in params]
    t = ib_tiling(case.kwargs)
    want = pool.clone()
    ib.ring_inverted_bottleneck_plain(want, *params, **case.kwargs)
    # every CTA reads the pool from before the op, then every store
    first = pool.clone()
    for seg, values in [_cta_stores(case, t, i, pool, params)
                        for i in reversed(range(t.ctas))]:
        first[seg] = values
    assert _held(case, first, want) is None
    # each CTA reads the pool as the CTAs before it left it, then stores:
    # the last tile, one row, first
    no_barrier = pool.clone()
    for i in reversed(range(t.ctas)):
        seg, values = _cta_stores(case, t, i, no_barrier, params)
        no_barrier[seg] = values
    assert _held(case, no_barrier, want) is not None
