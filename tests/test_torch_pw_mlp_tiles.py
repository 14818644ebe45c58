"""The tiling of the fp32 pointwise conv and fused MLP kernels, on the CPU.

``ring_conv_pw`` (``csrc/ring_f32.cu``) runs one CTA per tile of
``repro_torch.kernels.conv2d.conv_tiling`` (a block of output image rows
x a channel tile), stages the source pixel of each of its outputs, reads
all of an op's input before a grid-wide barrier and stores only after
it.  Held here, on every ``conv_pw`` op of the committed fp32 plans, of
the reference's fp32 ``mobilenetv1-0.25`` and ``mcunet-320kb-imagenet``
plans (compiled once per module; not served yet) and on every fp32 pw
edge case, at an H100 SXM's 132 SMs, an H100 PCIe's 114 and at 16:

* the tiles cover each (output row, channel) exactly once, and their
  stores each lane of every output pixel's segments exactly once (the
  last channel tile takes the channel tail);
* a tile's source rows are its outputs' picks, inside the image;
* one CTA's shared memory is at most ``MAX_SMEM`` and the CTAs at most
  the SMs; every op of the committed plans runs more than one CTA.

Also: the wrapper hands that tiling to the launch, a geometry that no
tile fits is refused with its shape named, and a model of the tiles
without the barrier (each CTA reads, then stores, the last tile first)
differs from the plain version on the two in-place uneven edge cases
where reading everything first does not.

``ring_fused_mlp`` runs one CTA per (block of rows, sub-tile of an ff
tile) of ``repro_torch.kernels.fused_mlp.mlp_tiling``, each writing its
partial into scratch, and a second kernel sums the partials in order
and adds the residual.  Held here: the tiling covers every (row, d_ff
column) once, each sub-tile inside one ff tile, and fits shared memory
at every d_model from 64 to 8,192; a torch model of that arithmetic
holds against the plain version and, on the small cases, against the
reference's Pallas kernel in interpret mode; the wrapper hands its
tiling and its scratch to the launch.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.kernels.fused_mlp import ring_fused_mlp as ref_fused_mlp
from repro_torch import load
from repro_torch.core.executors import op_kernel_call
from repro_torch.core.program import PoolProgram, resolve_activation
from repro_torch.core.vpool import fetch_rows, stage_rows
from repro_torch.kernels import conv2d, fused_mlp
from repro_torch.kernels._launch import MAX_SMEM
from repro_torch.kernels.cases import (F32_EDGE_CASES, F32_MLP_EDGE_CASES,
                                       case_inputs, compare_f32, live_lanes,
                                       output_regions, program_cases)
from repro_torch.kernels.conv2d import conv_tiling, pw_sources
from repro_torch.kernels.fused_mlp import mlp_smem, mlp_tiling

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
PW = "ring_conv_pw"
N_SM = (132, 114, 16)
#: The committed fp32 plans with pointwise convs.
PLANS = ("ds-cnn", "resnet-8", "mcunet-5fps-vww", "ds-cnn-stream")


def _plan_cases(name):
    cn = load(ASSETS / f"{name}.host-sim.float32.json")
    return tuple(c for c in program_cases(
        cn.program, cn.params, kernel_block_rows=cn.target.kernel_block_rows,
        prefix=f"{name}_f32_") if c.kernel == PW)


def _reference_plan(net):
    """The kwargs of every ``conv_pw`` op of the reference's fp32 plan of
    ``net`` (the geometry only: no weights are drawn)."""
    ref = repro.compile(net, "host-sim")
    program = PoolProgram.from_json_dict(ref.program.to_json_dict())
    return tuple(
        (f"{net}_f32_op{i:02d}", op_kernel_call(program, op, (None, None))[2])
        for i, op in enumerate(program.ops) if op.kind == "conv_pw")


PLAN_CASES = {n: _plan_cases(n) for n in PLANS}
UNSERVED = {n: _reference_plan(n)
            for n in ("mobilenetv1-0.25", "mcunet-320kb-imagenet")}
EDGE = tuple(c for c in F32_EDGE_CASES if c.kernel == PW)
UNEVEN = tuple(c for c in EDGE if c.name.endswith("_inplace_uneven"))
PLANS_KW = tuple((c.name, c.kwargs) for n in PLANS for c in PLAN_CASES[n]) \
    + sum(UNSERVED.values(), ())
GEOMETRIES = PLANS_KW + tuple((c.name, c.kwargs) for c in EDGE)


def test_the_plans_have_the_ops_the_tiling_is_held_on():
    assert [len(PLAN_CASES[n]) for n in PLANS] == [4, 2, 9, 4]
    assert [len(v) for v in UNSERVED.values()] == [13, 16]
    for n in ("ds-cnn", "resnet-8", "ds-cnn-stream"):
        assert all(c.kwargs["in_ptr"] == c.kwargs["out_ptr"]
                   for c in PLAN_CASES[n])
    assert {c.kwargs["stride"] for c in PLAN_CASES["resnet-8"]} == {2}
    assert any(kw["resample"] for _, kw in UNSERVED["mcunet-320kb-imagenet"])
    assert len(UNEVEN) == 2 and len(EDGE) == 7


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("name, kw", GEOMETRIES,
                         ids=[name for name, _ in GEOMETRIES])
def test_tiles_cover_every_output_once_and_fit(name, kw, n_sm):
    t = conv_tiling(PW, kw, n_sm)
    h_out, w_out, c = kw["h_out"], kw["w_out"], kw["c_out"]
    assert 1 <= t.ctas <= n_sm and t.smem <= MAX_SMEM
    assert t.held == 4 * t.rows * w_out * t.ctile
    staged = t.rows * w_out * (kw["c_in"] | 1)
    assert t.smem >= t.held + 4 * (staged + t.ctile
                                   + (kw["c_in"] * t.ctile if t.stage_w
                                      else 0))
    segs = -(-c // 128)
    outputs = np.zeros((h_out, c), int)
    stored = np.zeros((h_out, segs * 128), int)
    rows = pw_sources(kw["h_in"], h_out, kw["stride"], kw["resample"])
    cols = pw_sources(kw["w_in"], w_out, kw["stride"], kw["resample"])
    assert max(rows) < kw["h_in"] and max(cols) < kw["w_in"]
    for i in range(t.ctas):
        p0, np_, c0, cn, lo, nh = t.tile(i)
        assert 1 <= np_ <= t.rows and cn >= 1
        outputs[p0:p0 + np_, c0:c0 + cn] += 1
        end = segs * 128 if c0 + t.ctile >= c else c0 + t.ctile
        stored[p0:p0 + np_, c0:end] += 1
        assert all(lo <= rows[p] < lo + nh for p in range(p0, p0 + np_))
    assert (outputs == 1).all() and (stored == 1).all()


@pytest.mark.parametrize("name, kw", PLANS_KW,
                         ids=[name for name, _ in PLANS_KW])
def test_plan_ops_run_many_ctas(name, kw):
    t = conv_tiling(PW, kw)
    assert t.ctas > 1 and t.stage_w
    if name.startswith(("ds-cnn_", "ds-cnn-stream_")):   # 25 x 5, 64 -> 64
        assert (t.ctas, t.rows, t.ctile) == (100, 1, 16)


def test_a_geometry_no_tile_fits_is_refused_with_its_shape():
    wide = dict(h_in=1, w_in=8192, h_out=1, w_out=8192, c_in=512, c_out=512,
                stride=1, resample=False)
    with pytest.raises(ValueError, match=r"\[1, 8192, 512\] -> \[1, 8192, "
                                         r"512\], k 1"):
        conv_tiling(PW, wide)
    # more channel tiles than SMs
    with pytest.raises(ValueError, match=PW):
        conv_tiling(PW, dict(h_in=3, w_in=3, h_out=3, w_out=3, c_in=8,
                             c_out=480, stride=1, resample=False), n_sm=2)
    # MobileNet's 256 x 256 weights (262,144 B) do not fit whole: the tile
    # splits c_out and stages its slice
    t = conv_tiling(PW, next(c for c in EDGE
                             if c.name == "f32_pw_wide_weights").kwargs)
    assert 4 * 256 * 256 > MAX_SMEM and t.ctile < 256 and t.stage_w


@pytest.mark.parametrize("case", (EDGE[1], UNEVEN[0],
                                  PLAN_CASES["resnet-8"][0]),
                         ids=lambda c: c.name)
def test_wrapper_launches_with_its_tiling(case, monkeypatch):
    calls = []
    monkeypatch.setattr(conv2d, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(conv2d, "_sm_count", lambda device: 132)
    monkeypatch.setattr(conv2d, "launch",
                        lambda name, pool, smem, tensors, ints:
                        calls.append((name, smem, ints)))
    wrapper = conv2d.ring_conv_pw
    monkeypatch.setattr(wrapper, "launches", 0)
    pool, params = case_inputs(case, seed=0)
    wrapper(torch.from_numpy(pool), *map(torch.from_numpy, params),
            **case.kwargs)
    t = conv_tiling(PW, case.kwargs)
    kw = case.kwargs
    [(name, smem, ints)] = calls
    assert name == PW and smem == t.smem and len(ints) == 15
    assert ints[:9] == (case.n_seg, kw["h_in"], kw["w_in"], kw["h_out"],
                        kw["w_out"], kw["c_in"], kw["c_out"], kw["stride"],
                        int(kw["resample"]))
    assert ints[-3:] == (t.rows, t.ctile, int(t.stage_w))
    assert wrapper.launches == 1 and wrapper.weights_staged is t.stage_w


# ---------------------------------------------------------------------------
# What the grid barrier is for: a model of the tiles' reads and stores.
# ---------------------------------------------------------------------------

def _cta_stores(case, t, i, snap, params):
    """CTA ``i``'s stores, ``(segments, lanes, values)``, computed from the
    pool ``snap``: its rows x channel tile of the plain version's output
    (the last channel tile with the channel tail)."""
    kw = case.kwargs
    out = snap.clone()
    conv2d.ring_conv_pw_plain(out, *params, **kw)
    p0, np_, c0, _, _, _ = t.tile(i)
    segs = -(-kw["c_out"] // 128)
    end = segs * 128 if c0 + t.ctile >= kw["c_out"] else c0 + t.ctile
    pix = np.arange(p0 * kw["w_out"], (p0 + np_) * kw["w_out"])
    lanes = np.arange(c0, end)
    seg = (kw["out_ptr"] + pix[:, None] * segs + lanes[None, :] // 128) \
        % case.n_seg
    return seg, lanes % 128, out[seg, lanes % 128]


def _held(case, got, want):
    live = live_lanes(case.n_seg, output_regions(case.kernel, case.kwargs))
    return compare_f32(got.numpy(), want.numpy(), live)[1]


@pytest.mark.parametrize("case", UNEVEN, ids=lambda c: c.name)
def test_uneven_cases_tell_a_missing_barrier_from_reading_first(case):
    kw = case.kwargs
    assert kw["in_ptr"] == kw["out_ptr"]
    t = conv_tiling(PW, kw)
    assert kw["h_out"] % t.rows and t.ctas > 100     # a short last tile
    pool, params = case_inputs(case, seed=0)
    pool = torch.from_numpy(pool)
    params = [torch.from_numpy(a) for a in params]
    want = pool.clone()
    conv2d.ring_conv_pw_plain(want, *params, **kw)
    # every CTA reads the pool from before the op, then every store
    first = pool.clone()
    for seg, lanes, values in [_cta_stores(case, t, i, pool, params)
                               for i in reversed(range(t.ctas))]:
        first[seg, lanes] = values
    assert _held(case, first, want) is None
    # each CTA reads the pool as the CTAs after it left it, then stores:
    # the last tile, the short one, first
    no_barrier = pool.clone()
    for i in reversed(range(t.ctas)):
        seg, lanes, values = _cta_stores(case, t, i, no_barrier, params)
        no_barrier[seg, lanes] = values
    assert _held(case, no_barrier, want) is not None


# ---------------------------------------------------------------------------
# The fused MLP: its tiling and its arithmetic.
# ---------------------------------------------------------------------------

MLP_CASES = tuple(c for c in F32_MLP_EDGE_CASES
                  if c.kernel == "ring_fused_mlp")
#: Too wide for the reference's kernel in interpret mode here.
WIDE = ("f32_mlp_gemma3_1b_geglu", "f32_mlp_d4096")


def _tiling_of(case):
    kw = case.kwargs
    return mlp_tiling(kw["m_rows"], kw["d_model"], case.d_ff, kw["ff_tile"],
                      kw["gated"])


def _model(case, pool, params, t):
    """The pool the two kernels leave, in torch on the CPU: per CTA its
    rows' partial ``act(...) @ W_down[sub-tile]`` from the pool before the
    op, then per row the partials summed in sub-tile order from zero, plus
    x, stored as whole segments."""
    kw = case.kwargs
    wg, wu, wd = params
    act = resolve_activation("gelu" if kw["activation"] == "gelu"
                             else "silu")
    x = fetch_rows(pool, kw["ptr"], kw["m_rows"], kw["d_model"])
    parts = torch.zeros((t.n_sub, kw["m_rows"], kw["d_model"]))
    for i in range(t.ctas):
        r0, n, f0, w = t.tile(i)
        xs, sl = x[r0:r0 + n], slice(f0, f0 + w)
        up = xs @ wu[:, sl]
        h = act(xs @ wg[:, sl]) * up if kw["gated"] else act(up)
        parts[i % t.n_sub, r0:r0 + n] = h @ wd[sl]
    y = torch.zeros_like(x)
    for s in range(t.n_sub):
        y = y + parts[s]
    out = pool.clone()
    stage_rows(out, y + x if kw["residual"] else y, kw["ptr"])
    return out


@pytest.mark.parametrize("case", MLP_CASES, ids=lambda c: c.name)
def test_mlp_model_matches_the_plain_version_and_the_reference(case):
    pool, params = case_inputs(case, seed=0)
    t = _tiling_of(case)
    live = live_lanes(case.n_seg, output_regions(case.kernel, case.kwargs))
    got = _model(case, torch.from_numpy(pool), [torch.from_numpy(a)
                                                for a in params], t)
    plain = torch.from_numpy(pool.copy())
    fused_mlp.ring_fused_mlp_plain(plain, *map(torch.from_numpy, params),
                                   **case.kwargs)
    err, bad = compare_f32(got.numpy(), plain.numpy(), live)
    assert bad is None, bad
    if case.name in WIDE:
        return
    want = np.asarray(ref_fused_mlp(jnp.asarray(pool),
                                    *(jnp.asarray(a) for a in params),
                                    **case.kwargs, interpret=True))
    err, bad = compare_f32(got.numpy(), want, live)
    assert bad is None, bad


GRID = [(m, d, f, ff) for m, f, ff in ((1500, 1536, 512), (16, 6912, 432),
                                       (100, 512, 256), (8, 256, 128))
        for d in (64, 384, 1152, 2048, 4096, 8192)]


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("m, d, f, ff", GRID,
                         ids=[f"m{m}_d{d}_f{f}_t{ff}" for m, d, f, ff in GRID])
def test_mlp_tiling_covers_every_row_and_column_once_and_fits(m, d, f, ff,
                                                              n_sm):
    t = mlp_tiling(m, d, f, ff, True, n_sm)
    assert t.smem <= MAX_SMEM and t.smem == mlp_smem(t.tm, t.sub)
    assert t.scratch_shape == (t.n_sub, m, -(-d // 128) * 128)
    assert t.n_sub >= f // ff and t.sub % 4 == 0
    cover = np.zeros((m, f), int)
    for i in range(t.ctas):
        r0, n, f0, w = t.tile(i)
        assert 1 <= n <= t.rows and 1 <= w <= t.sub
        assert f0 // ff == (f0 + w - 1) // ff      # inside one ff tile
        cover[r0:r0 + n, f0:f0 + w] += 1
    assert (cover == 1).all()


def test_mlp_tiling_fills_the_card_on_the_paths():
    tower = mlp_tiling(1500, 384, 1536, 512)           # whisper-tiny's layer
    assert (tower.rows, tower.sub, tower.splits, tower.ctas) == \
        (80, 256, 2, 114)
    assert tower.scratch_bytes == 6 * 1500 * 384 * 4 and tower.vec
    gemma = mlp_tiling(16, 1152, 6912, 432, True)      # 2 blocks before
    assert gemma.ctas >= 16 and gemma.rows == 16
    uneven = next(c for c in MLP_CASES if c.name == "f32_mlp_uneven_rows")
    assert uneven.kwargs["m_rows"] % _tiling_of(uneven).rows
    assert 1500 % tower.rows     # a short last row block on the path too


@pytest.mark.parametrize("case", MLP_CASES[:1] + MLP_CASES[-2:],
                         ids=lambda c: c.name)
def test_mlp_wrapper_launches_with_its_tiling(case, monkeypatch):
    calls = []
    monkeypatch.setattr(fused_mlp, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(fused_mlp, "_sm_count", lambda device: 132)
    monkeypatch.setattr(fused_mlp, "launch",
                        lambda name, pool, smem, tensors, ints:
                        calls.append((name, smem, tensors, ints)))
    wrapper = fused_mlp.ring_fused_mlp
    monkeypatch.setattr(wrapper, "launches", 0)
    pool, params = case_inputs(case, seed=0)
    wrapper(torch.from_numpy(pool), *map(torch.from_numpy, params),
            **case.kwargs)
    t = _tiling_of(case)
    [(name, smem, tensors, ints)] = calls
    assert name == "ring_fused_mlp" and smem == t.smem
    assert tuple(tensors[3].shape) == t.scratch_shape
    assert tensors[3].dtype == torch.float32
    assert ints[-5:] == (case.kwargs["ff_tile"], t.tm, t.sub, t.splits,
                         int(t.vec))
    assert wrapper.launches == 1 and wrapper.tiles == t
