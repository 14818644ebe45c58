"""The tiling of the fp32 FC and the runs of the elementwise map, on the CPU.

``ring_gemm`` (``csrc/ring_f32.cu``) runs one CTA per tile of
``repro_torch.kernels.segment_matmul.gemm_tiling`` (a block of rows x a
tile of output columns), stages its rows and its weight slice, reads all
of an op's input before a grid-wide barrier and stores only after it.
Held here, on every ``gemm`` op of the committed fp32 plans (ToyADMOS's
ten among them), of the reference's fp32 ``mobilenetv1-0.25`` and
``mcunet-320kb-imagenet`` plans (compiled once per module; not served
yet) and on every fp32 gemm edge case, at an H100 SXM's 132 SMs, an H100
PCIe's 114 and at 16:

* the tiles cover each (row, output column) exactly once, and their
  stores each lane of every output row's segments exactly once (the
  last column tile takes the channel tail);
* one CTA's shared memory is at most ``MAX_SMEM`` and the CTAs at most
  the SMs; ToyADMOS's 640-wide layers run many CTAs, the FC heads one or
  two.

Also: the wrapper hands that tiling to the launch, a geometry that no
tile fits is refused with its shape named, a torch model of the
kernel's sum (k slices of ``GEMM_KSLICE``, the partials in order) holds
the fp32 tolerance against the plain version and the reference's Pallas
kernel in interpret mode, and a model of the tiles
shows what the grid barrier is for: reading everything first gives the
plain version's pool, as the one-block walk in row order does, while
CTAs that each read and then store (the short last one first) differ on
the two in-place edge cases.

``ring_elementwise`` maps its region as the two linear runs of
``elementwise.ring_runs`` over the grid of ``elementwise.ew_blocks``:
held here on regions that wrap the ring, one that ends exactly at its
end, and through a torch model of the kernel's index map against the
plain version, bit for bit.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.kernels.segment_matmul import ring_gemm as ref_ring_gemm
from repro_torch import load
from repro_torch.core.executors import op_kernel_call
from repro_torch.core.program import PoolProgram, resolve_activation
from repro_torch.core.vpool import fetch_rows, fetch_segments, stage_rows
from repro_torch.kernels import elementwise, segment_matmul
from repro_torch.kernels._launch import MAX_SMEM
from repro_torch.kernels.cases import (F32_EDGE_CASES, F32_MLP_EDGE_CASES,
                                       case_inputs, compare_f32, live_lanes,
                                       output_regions, program_cases)
from repro_torch.kernels.elementwise import (EW_BLOCKS_PER_SM, EW_THREADS,
                                             ew_blocks, ring_runs)
from repro_torch.kernels.segment_matmul import (GEMM_COLUMN_TILES,
                                                GEMM_KSLICE, gemm_smem,
                                                gemm_tiling)

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
GEMM = "ring_gemm"
N_SM = (132, 114, 16)
#: The committed fp32 plans with an FC.
PLANS = ("ds-cnn", "resnet-8", "mcunet-5fps-vww", "ad-toyadmos")


def _plan_cases(name):
    cn = load(ASSETS / f"{name}.host-sim.float32.json")
    return tuple(c for c in program_cases(
        cn.program, cn.params, kernel_block_rows=cn.target.kernel_block_rows,
        prefix=f"{name}_f32_") if c.kernel == GEMM)


def _reference_plan(net):
    """The kwargs of every ``gemm`` op of the reference's fp32 plan of
    ``net`` (the geometry only: no weights are drawn)."""
    ref = repro.compile(net, "host-sim")
    program = PoolProgram.from_json_dict(ref.program.to_json_dict())
    return tuple(
        (f"{net}_f32_op{i:02d}", op_kernel_call(program, op, (None, None))[2])
        for i, op in enumerate(program.ops) if op.kind == "gemm")


PLAN_CASES = {n: _plan_cases(n) for n in PLANS}
UNSERVED = {n: _reference_plan(n)
            for n in ("mobilenetv1-0.25", "mcunet-320kb-imagenet")}
EDGE = tuple(c for c in F32_EDGE_CASES if c.kernel == GEMM)
IN_PLACE = tuple(c for c in EDGE
                 if c.name in ("f32_gemm_inplace_uneven", "f32_gemm_widen"))
PLANS_KW = tuple((c.name, c.kwargs) for n in PLANS for c in PLAN_CASES[n]) \
    + sum(UNSERVED.values(), ())
GEOMETRIES = PLANS_KW + tuple((c.name, c.kwargs) for c in EDGE)
EW = tuple(c for c in F32_MLP_EDGE_CASES if c.kernel == "ring_elementwise")


def _tiling(kw, n_sm=132):
    return gemm_tiling(kw["m_rows"], kw["d_in"], kw["d_out"], n_sm)


def test_the_plans_have_the_ops_the_tiling_is_held_on():
    assert [len(PLAN_CASES[n]) for n in PLANS] == [1, 1, 1, 10]
    assert [len(v) for v in UNSERVED.values()] == [1, 1]
    toy = [c.kwargs for c in PLAN_CASES["ad-toyadmos"]]
    assert [(kw["d_in"], kw["d_out"]) for kw in toy] == \
        [(640, 128)] + [(128, 128)] * 3 + [(128, 8), (8, 128)] \
        + [(128, 128)] * 3 + [(128, 640)]
    assert all(kw["m_rows"] == 1 for kw in toy)
    # every layer but the last in place at segment 5; the last from 5 to 0
    assert all(kw["in_ptr"] == kw["out_ptr"] == 5 for kw in toy[:-1])
    assert (toy[-1]["in_ptr"], toy[-1]["out_ptr"]) == (5, 0)
    assert len(EDGE) == 6 and len(IN_PLACE) == 2


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("name, kw", GEOMETRIES,
                         ids=[name for name, _ in GEOMETRIES])
def test_tiles_cover_every_output_once_and_fit(name, kw, n_sm):
    t = _tiling(kw, n_sm)
    m, d_in, d_out = kw["m_rows"], kw["d_in"], kw["d_out"]
    assert 1 <= t.ctas <= n_sm and t.smem <= MAX_SMEM
    assert t.ctile in GEMM_COLUMN_TILES or t.ctile == d_out < 8
    assert t.held == 4 * t.rows * t.ctile
    assert t.smem == gemm_smem(t.rows, t.ctile, d_in) >= t.held + 4 * (
        t.rows * d_in + d_in * t.ctile + t.ctile)
    segs = -(-d_out // 128)
    outputs = np.zeros((m, d_out), int)
    stored = np.zeros((m, segs * 128), int)
    for i in range(t.ctas):
        r0, nr, c0, cn = t.tile(i)
        assert 1 <= nr <= t.rows and 1 <= cn <= t.ctile
        outputs[r0:r0 + nr, c0:c0 + cn] += 1
        end = segs * 128 if c0 + t.ctile >= d_out else c0 + t.ctile
        stored[r0:r0 + nr, c0:end] += 1
    assert (outputs == 1).all() and (stored == 1).all()


@pytest.mark.parametrize("name, kw", PLANS_KW,
                         ids=[name for name, _ in PLANS_KW])
def test_wide_layers_spread_and_heads_stay_small(name, kw):
    """A layer's weight read spreads over one CTA per 8 output columns
    (one 32-byte sector of each weight row); an FC head stays at one or
    two CTAs."""
    t = _tiling(kw)
    assert t.rows == kw["m_rows"] == 1 and t.ctile == min(8, kw["d_out"])
    assert t.ctas == -(-kw["d_out"] // 8)
    if kw["d_out"] >= 128:                  # ToyADMOS's 128-wide layers
        assert t.ctas >= 16
    if kw["d_in"] == 640:                   # 327,680 B of weights
        assert 4 * kw["d_in"] * kw["d_out"] > MAX_SMEM
        assert t.ctas == 16 and t.smem == gemm_smem(1, 8, 640)
    if kw["d_out"] == 640:
        assert t.ctas == 80
    if name.startswith(("ds-cnn_", "resnet-8_", "mcunet-5fps-vww_",
                        "mobilenet")):      # 2 to 12 classes
        assert t.ctas <= 2


def test_edge_cases_run_many_ctas_and_stage_every_slice():
    for c in EDGE:
        t = _tiling(c.kwargs)
        assert t.ctas > 1 and t.smem <= MAX_SMEM
    # 960,000 B of weights: 30 column tiles of 32,000 B, each staged
    big = next(c for c in EDGE if c.name == "f32_gemm_weights_global")
    t = _tiling(big.kwargs)
    assert 4 * 1000 * 240 > MAX_SMEM
    assert (t.rows, t.ctile, t.ctas) == (1, 8, 60)
    uneven = _tiling(IN_PLACE[0].kwargs)
    assert (uneven.rows, uneven.ctile, uneven.ctas) == (1, 8, 34)
    assert uneven.tile(33) == (1, 1, 128, 4)          # the short last CTA
    widen = _tiling(IN_PLACE[1].kwargs)
    assert (widen.rows, widen.ctile, widen.ctas) == (2, 8, 80)


def test_a_geometry_no_tile_fits_is_refused_with_its_shape():
    # 8,192 inputs: a one-row CTA of 8 columns needs 295,040 B
    with pytest.raises(ValueError, match=r"\[1, 8192\] -> \[1, 64\]"):
        gemm_tiling(1, 8192, 64)
    # more column tiles of 1,024 than SMs
    with pytest.raises(ValueError, match=r"ring_gemm: no tile"):
        gemm_tiling(1, 8, 1024 * 20, n_sm=16)
    # too many rows for one CTA's shared memory at any column tile
    with pytest.raises(ValueError, match=r"\[4096, 4096\]"):
        gemm_tiling(4096, 4096, 8, n_sm=16)
    # a wider column tile when the narrowest leaves too many rows a CTA
    t = gemm_tiling(1000, 64, 1024)
    assert t.ctile == 16 and t.rows == 500 and t.smem <= MAX_SMEM


@pytest.mark.parametrize("case", (EDGE[0],) + IN_PLACE
                         + PLAN_CASES["ad-toyadmos"][:1],
                         ids=lambda c: c.name)
def test_wrapper_launches_with_its_tiling(case, monkeypatch):
    calls = []
    monkeypatch.setattr(segment_matmul, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(segment_matmul, "_sm_count", lambda device: 132)
    monkeypatch.setattr(segment_matmul, "launch",
                        lambda name, pool, smem, tensors, ints:
                        calls.append((name, smem, ints)))
    wrapper = segment_matmul.ring_gemm
    monkeypatch.setattr(wrapper, "launches", 0)
    pool, params = case_inputs(case, seed=0)
    before = pool.copy()
    p = torch.from_numpy(pool)
    wrapper(p, *map(torch.from_numpy, params), **case.kwargs)
    kw, t = case.kwargs, _tiling(case.kwargs)
    [(name, smem, ints)] = calls
    assert name == GEMM and smem == t.smem and len(ints) == 9
    assert ints == (case.n_seg, kw["m_rows"], kw["d_in"], kw["d_out"],
                    kw["in_ptr"] % case.n_seg, kw["out_ptr"] % case.n_seg,
                    segment_matmul.act_code(kw["activation"]), t.rows,
                    t.ctile)
    assert wrapper.launches == 1 and wrapper.weights_staged is True
    np.testing.assert_array_equal(p.numpy(), before)   # no plain fallback


# ---------------------------------------------------------------------------
# The kernel's sum: k slices of GEMM_KSLICE, their partials in order.
# ---------------------------------------------------------------------------

SUMMED = PLAN_CASES["ad-toyadmos"] + PLAN_CASES["ds-cnn"] + EDGE


@pytest.mark.parametrize("case", SUMMED, ids=lambda c: c.name)
def test_k_slices_summed_in_order_hold_the_tolerance(case):
    """A torch model of the kernel's arithmetic (each slice's product in
    fp32, the partials added in slice order, then the bias and the
    activation) within the fp32 tolerance of the plain version and of the
    reference's Pallas kernel in interpret mode."""
    kw = case.kwargs
    pool, params = case_inputs(case, seed=0)
    w, b = map(torch.from_numpy, params)
    x = fetch_rows(torch.from_numpy(pool), kw["in_ptr"], kw["m_rows"],
                   kw["d_in"])
    acc = None
    for k0 in range(0, kw["d_in"], GEMM_KSLICE):
        part = x[:, k0:k0 + GEMM_KSLICE] @ w[k0:k0 + GEMM_KSLICE]
        acc = part if acc is None else acc + part
    model = torch.from_numpy(pool.copy())
    stage_rows(model, resolve_activation(kw["activation"])(acc + b),
               kw["out_ptr"])
    want = torch.from_numpy(pool.copy())
    segment_matmul.ring_gemm_plain(want, w, b, **kw)
    assert _held(case, model, want) is None
    ref = np.array(ref_ring_gemm(jnp.asarray(pool),
                                   *(jnp.asarray(a) for a in params), **kw,
                                   interpret=True))
    assert _held(case, model, torch.from_numpy(ref)) is None
    assert -(-kw["d_in"] // GEMM_KSLICE) == (20 if kw["d_in"] == 640
                                             else -(-kw["d_in"] // 32))


# ---------------------------------------------------------------------------
# What the grid barrier is for: a model of the tiles' reads and stores.
# ---------------------------------------------------------------------------

def _cta_stores(case, t, i, snap, params):
    """CTA ``i``'s stores, ``(segments, lanes, values)``, computed from the
    pool ``snap``: its rows x column tile of the plain version's output
    (the last column tile with the channel tail)."""
    kw = case.kwargs
    out = snap.clone()
    segment_matmul.ring_gemm_plain(out, *params, **kw)
    r0, nr, c0, _ = t.tile(i)
    segs = -(-kw["d_out"] // 128)
    end = segs * 128 if c0 + t.ctile >= kw["d_out"] else c0 + t.ctile
    rows = np.arange(r0, r0 + nr)
    lanes = np.arange(c0, end)
    seg = (kw["out_ptr"] + rows[:, None] * segs + lanes[None, :] // 128) \
        % case.n_seg
    return seg, lanes % 128, out[seg, lanes % 128]


def _walk(case, pool, params):
    """The one-block walk: row by row in plan order, each read from the
    pool the rows before it left, then stored."""
    kw = case.kwargs
    ksegs, nsegs = -(-kw["d_in"] // 128), -(-kw["d_out"] // 128)
    for r in range(kw["m_rows"]):
        segment_matmul.ring_gemm_plain(
            pool, *params, **dict(kw, m_rows=1, block_rows=1,
                                  in_ptr=kw["in_ptr"] + r * ksegs,
                                  out_ptr=kw["out_ptr"] + r * nsegs))
    return pool


def _held(case, got, want):
    live = live_lanes(case.n_seg, output_regions(case.kernel, case.kwargs))
    return compare_f32(got.numpy(), want.numpy(), live)[1]


@pytest.mark.parametrize("case", IN_PLACE, ids=lambda c: c.name)
def test_in_place_cases_tell_a_missing_barrier_from_reading_first(case):
    kw = case.kwargs
    t = _tiling(kw)
    assert t.ctas > 1
    pool, params = case_inputs(case, seed=0)
    pool = torch.from_numpy(pool)
    params = [torch.from_numpy(a) for a in params]
    want = pool.clone()
    segment_matmul.ring_gemm_plain(want, *params, **kw)
    # every CTA reads the pool from before the op, then every store
    first = pool.clone()
    for seg, lanes, values in [_cta_stores(case, t, i, pool, params)
                               for i in reversed(range(t.ctas))]:
        first[seg, lanes] = values
    assert _held(case, first, want) is None
    assert torch.equal(first, want)
    # the one-block walk in row order gives the same pool
    assert _held(case, _walk(case, pool.clone(), params), want) is None
    # each CTA reads the pool as the CTAs after it left it, then stores:
    # the last tile, the short one, first
    no_barrier = pool.clone()
    for i in reversed(range(t.ctas)):
        seg, lanes, values = _cta_stores(case, t, i, no_barrier, params)
        no_barrier[seg, lanes] = values
    assert _held(case, no_barrier, want) is not None


# ---------------------------------------------------------------------------
# The elementwise map: two linear runs, and its grid.
# ---------------------------------------------------------------------------

def _modulo(n_seg, ptr, n):
    return [(ptr + i) % n_seg for i in range(n)]


@pytest.mark.parametrize("n_seg, ptr, n", [
    (40, 30, 24),        # wraps: 10 segments to the end, 14 from 0
    (40, 20, 20),        # ends exactly at the ring's end
    (40, 0, 40),         # the whole ring from 0
    (40, 39, 40),        # the whole ring from its last segment
    (40, 5, 1),
    (4500, 0, 4500),     # whisper-tiny's tower
    (4500, 4499, 2)])
def test_ring_runs_split_a_region_at_the_ring_end(n_seg, ptr, n):
    (start, a), (zero, b) = ring_runs(n_seg, ptr, n)
    assert (start, zero) == (ptr, 0) and a >= 1 and b >= 0 and a + b == n
    assert start + a <= n_seg
    assert list(range(start, start + a)) + list(range(b)) \
        == _modulo(n_seg, ptr, n)
    if ptr + n <= n_seg:
        assert b == 0


def test_ew_blocks_size_the_grid_to_the_sms():
    chunk = EW_THREADS // 32                      # segments a block maps
    assert ew_blocks(4500) == 563 == -(-4500 // chunk)   # whisper's gelu
    assert 563 <= EW_BLOCKS_PER_SM * 132          # all resident at once
    assert ew_blocks(1) == 1 and ew_blocks(8) == 1 and ew_blocks(9) == 2
    assert ew_blocks(10 ** 6) == EW_BLOCKS_PER_SM * 132
    assert ew_blocks(10 ** 6, n_sm=16) == EW_BLOCKS_PER_SM * 16


def _kernel_model(pool, kw):
    """The kernel's index map in torch: float4 ``i`` of the region is
    ``start * 32 + i`` in the first run, ``i - first * 32`` after it."""
    n = kw["m_rows"] * -(-kw["d"] // 128)
    (start, first), _ = ring_runs(pool.shape[0], kw["ptr"] % pool.shape[0],
                                  n)
    vec = pool.view(-1, 4)
    i = torch.arange(n * 32)
    at = torch.where(i < first * 32, start * 32 + i, i - first * 32)
    vec[at] = resolve_activation(kw["fn"])(vec[at])
    return pool


@pytest.mark.parametrize("case", EW, ids=lambda c: c.name)
def test_the_kernels_index_map_is_the_plain_version_bit_for_bit(case):
    pool, _ = case_inputs(case, seed=0)
    want = torch.from_numpy(pool.copy())
    elementwise.ring_elementwise_plain(want, **case.kwargs)
    got = _kernel_model(torch.from_numpy(pool.copy()), case.kwargs)
    assert torch.equal(got, want)
    # the region the plain version maps is the run(s) the kernel maps
    n = case.kwargs["m_rows"] * 2
    assert torch.equal(fetch_segments(got, case.kwargs["ptr"], n),
                       fetch_segments(want, case.kwargs["ptr"], n))


@pytest.mark.parametrize("case", EW, ids=lambda c: c.name)
def test_elementwise_wrapper_launches_its_runs(case, monkeypatch):
    calls = []
    monkeypatch.setattr(elementwise, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(elementwise, "_sm_count", lambda device: 132)
    monkeypatch.setattr(elementwise, "launch",
                        lambda name, pool, smem, tensors, ints:
                        calls.append((name, smem, tensors, ints)))
    wrapper = elementwise.ring_elementwise
    monkeypatch.setattr(wrapper, "launches", 0)
    pool, _ = case_inputs(case, seed=0)
    kw = case.kwargs
    wrapper(torch.from_numpy(pool), **kw)
    n = kw["m_rows"] * -(-kw["d"] // 128)
    [(name, smem, tensors, ints)] = calls
    (start, first), (_, rest) = ring_runs(case.n_seg, kw["ptr"], n)
    assert name == "ring_elementwise" and smem == 0 and tensors == ()
    assert ints == (n, start, first, segment_matmul.act_code(kw["fn"]),
                    ew_blocks(n, 132))
    if case.name.endswith("_wrap"):
        assert rest > 0
    else:                                   # ends at the ring's end
        assert start + first == case.n_seg and rest == 0
    assert wrapper.launches == 1
