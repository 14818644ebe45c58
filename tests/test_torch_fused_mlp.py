"""The port's delta-0 fp32 kinds, the fused MLP and the elementwise map,
against the reference on the CPU.

* The plain ``ring_fused_mlp`` and ``ring_elementwise`` against the
  reference's Pallas kernels in interpret mode, from the same seeded pool
  and weights, on every case of ``F32_MLP_EDGE_CASES`` but the
  gemma3-1b-width one (95.6 MB of weights) and the d_model-4096 one, too
  large for interpret mode here.
* The whisper-tiny MLP tower at full width and depth (4 layers, d_model
  384, d_ff 1536, 1,500 rows, then an elementwise gelu), from its
  params-less artifact and ``mlp_tower_params`` (seed 0): the port's
  ``run(x, device="cpu")`` and ``reference_forward`` against the
  reference's ``run(x, backend="jnp")`` and ``reference_forward`` on the
  same weights, and against the committed golden rows.
* A 2-layer tower at 16 rows through the port's plain versions against
  the reference's Pallas path in interpret mode: outputs and final pools.
* ``report()``, the parameter normalization, the executor's dispatch, the
  wrappers' geometry errors against the reference's ``ValueError``\\ s,
  their tile sizing, and the params-less artifact's construction.

Tolerance, everywhere: ``|got - want| <= 3e-5 * max|want| + 3e-4 *
|want|`` (``RTOL``/``ATOL_REL``, the reference's conformance-matrix rule)
on live channels; channel tails and lanes no op writes are held exactly.
"""
import hashlib
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.configs import get_config
from repro.core.executors import run_program as ref_run_program
from repro.graph.ir import Tensor, build_mlp_tower
from repro.graph.run import reference_forward as ref_reference_forward
from repro.kernels.elementwise import ring_elementwise as ref_elementwise
from repro.kernels.fused_mlp import ring_fused_mlp as ref_fused_mlp
from repro.kernels.ref import fused_mlp_ref as ref_fused_mlp_ref
from repro_torch import load
from repro_torch.compile.artifact import to_device
from repro_torch.compile.driver import CompileError, CompiledNet
from repro_torch.core.executors import (F32_KINDS, _normalize_params,
                                        op_kernel_call, run_program)
from repro_torch.core.program import EXECUTABLE_KINDS, PoolProgram
from repro_torch.graph.run import reference_forward
from repro_torch.kernels import KERNELS, PLAIN, launch_counts
from repro_torch.kernels._launch import MAX_SMEM
from repro_torch.kernels.cases import (ATOL_REL, F32_MLP_EDGE_CASES, RTOL,
                                       case_inputs, compare_f32, live_lanes,
                                       mlp_tower_params, output_regions,
                                       program_cases, program_live_lanes,
                                       seeded_float_net)
from repro_torch.kernels.fused_mlp import (fused_mlp_ref, mlp_smem,
                                           mlp_tiling)

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
TOWER = ASSETS / "whisper-tiny-mlp.host-sim.float32"
REFERENCE = {"ring_fused_mlp": ref_fused_mlp,
             "ring_elementwise": ref_elementwise}
SMALL_CASES = tuple(c for c in F32_MLP_EDGE_CASES
                    if c.name not in ("f32_mlp_gemma3_1b_geglu",
                                      "f32_mlp_d4096"))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL_REL * scale)


def _plain_pool(case, pool, params):
    p = torch.from_numpy(pool.copy())
    PLAIN[case.kernel](p, *(torch.from_numpy(a) for a in params),
                       **case.kwargs)
    return p.numpy()


# ---------------------------------------------------------------------------
# Kernels: plain versions against the Pallas kernels.
# ---------------------------------------------------------------------------

def test_edge_cases_cover_both_kernels_every_fn_and_the_geometries():
    assert {c.kernel for c in F32_MLP_EDGE_CASES} == set(REFERENCE)
    assert set(REFERENCE) <= set(KERNELS) == set(PLAIN)
    fns = {c.kwargs["fn"] for c in F32_MLP_EDGE_CASES
           if c.kernel == "ring_elementwise"}
    assert fns == {"gelu", "silu", "relu", "square", "identity"}
    mlp = {c.name: c.kwargs for c in F32_MLP_EDGE_CASES
           if c.kernel == "ring_fused_mlp"}
    assert any(kw["gated"] and kw["activation"] == "silu"
               for kw in mlp.values())
    assert any(not kw["gated"] and not kw["residual"] for kw in mlp.values())
    assert any(kw["d_model"] % 128 for kw in mlp.values())
    # a run of rows that wraps the ring, over more than one block of rows
    wraps = mlp["f32_mlp_ring_wraps"]
    n_seg = dict((c.name, c.n_seg) for c in F32_MLP_EDGE_CASES)
    assert wraps["ptr"] + 2 * wraps["m_rows"] > n_seg["f32_mlp_ring_wraps"]
    assert wraps["m_rows"] > mlp_tiling(wraps["m_rows"], 160, 256, 256,
                                        True).rows
    for c in F32_MLP_EDGE_CASES:
        if c.kernel == "ring_elementwise":
            kw = c.kwargs
            end = kw["ptr"] + 2 * kw["m_rows"]
            if c.name.endswith("_wrap"):
                assert end > c.n_seg                      # wraps
            else:                                 # ends at the ring's end
                assert c.name.endswith("_ends_at_ring_end")
                assert end == c.n_seg


@pytest.mark.parametrize("case", SMALL_CASES, ids=lambda c: c.name)
def test_plain_version_matches_pallas_kernel(case):
    pool, params = case_inputs(case, seed=0)
    want = np.asarray(REFERENCE[case.kernel](
        jnp.asarray(pool), *(jnp.asarray(a) for a in params),
        **case.kwargs, interpret=True))
    got = _plain_pool(case, pool, params)
    if case.kwargs.get("fn") != "identity":
        assert not np.array_equal(want, pool), "the kernel stored nothing"
    live = live_lanes(case.n_seg, output_regions(case.kernel, case.kwargs))
    err, bad = compare_f32(got, want, live)
    assert bad is None, bad
    assert not got[~live & (got != pool)].any()   # every tail stored as 0


def test_fused_mlp_ref_matches_the_reference_oracle():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 40), np.float32)
    wg, wu = (rng.standard_normal((40, 96), np.float32) / 6 for _ in "gu")
    wd = rng.standard_normal((96, 40), np.float32) / 10
    for gated, residual, act in ((True, True, "gelu"), (True, False, "silu"),
                                 (False, True, "gelu"),
                                 (False, False, "silu")):
        want = ref_fused_mlp_ref(jnp.asarray(x), jnp.asarray(wg),
                                 jnp.asarray(wu), jnp.asarray(wd),
                                 gated=gated, residual=residual,
                                 activation=act)
        got = fused_mlp_ref(torch.from_numpy(x), torch.from_numpy(wg),
                            torch.from_numpy(wu), torch.from_numpy(wd),
                            gated=gated, residual=residual, activation=act)
        _close(got.numpy(), want)


@pytest.mark.parametrize("case", SMALL_CASES[::2], ids=lambda c: c.name)
def test_wrapper_refuses_cpu_tensors(case):
    pool, params = case_inputs(case, seed=0)
    p = torch.from_numpy(pool.copy())
    before = launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        KERNELS[case.kernel](p, *(torch.from_numpy(a) for a in params),
                             **case.kwargs)
    np.testing.assert_array_equal(p.numpy(), pool)   # no plain fallback
    assert launch_counts() == before


def _mlp_args(n_seg=16, m=8, d=256, f=512, ptr=0, block_rows=8,
              ff_tile=256):
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((n_seg, 128), np.float32)
    w = [rng.standard_normal(s, np.float32) for s in ((d, f), (d, f),
                                                     (f, d))]
    return pool, w, dict(m_rows=m, d_model=d, ptr=ptr,
                         block_rows=block_rows, ff_tile=ff_tile)


def _raises_both(pool, w, kw, match):
    """The reference's Pallas kernel and both of the port's functions
    raise ``ValueError`` on this geometry."""
    with pytest.raises(ValueError):
        ref_fused_mlp(jnp.asarray(pool), *map(jnp.asarray, w), **kw,
                      interpret=True)
    for fn in (KERNELS["ring_fused_mlp"], PLAIN["ring_fused_mlp"]):
        with pytest.raises(ValueError, match=match):
            fn(torch.from_numpy(pool.copy()), *map(torch.from_numpy, w),
               **kw)


def test_geometry_errors_match_the_reference():
    # ff_tile must divide d_ff: the op's accumulation order
    pool, w, kw = _mlp_args(ff_tile=200)
    _raises_both(pool, w, kw, "ff_tile")
    # 8 rows of 2 segments do not fit a ring of 14: the reference refuses
    # the pool's alignment, the port the rows that wrap onto themselves
    pool, w, kw = _mlp_args(n_seg=14, block_rows=2)
    _raises_both(pool, w, kw, "wrap onto themselves")
    # an unknown elementwise fn, and a region longer than the ring
    pool = np.zeros((13, 128), np.float32)
    for kw, match in ((dict(m_rows=4, d=200, ptr=0, fn="tanh"), "unknown"),
                      (dict(m_rows=8, d=200, ptr=0, fn="gelu"), "fit")):
        with pytest.raises(ValueError):
            ref_elementwise(jnp.asarray(pool), **kw, interpret=True)
        for fn in (KERNELS["ring_elementwise"], PLAIN["ring_elementwise"]):
            with pytest.raises(ValueError, match=match):
                fn(torch.from_numpy(pool.copy()), **kw)


def test_the_port_does_not_demand_the_references_block_alignment():
    """The reference refuses a pointer off its block_rows alignment; the
    port's kernels are not blocked by block_rows, and its plain version
    gives the reference's result at an aligned pointer, moved."""
    pool, w, kw = _mlp_args(n_seg=32, m=8, ptr=2, block_rows=4)
    with pytest.raises(ValueError, match="aligned"):
        ref_fused_mlp(jnp.asarray(pool), *map(jnp.asarray, w), **kw,
                      interpret=True)
    got = torch.from_numpy(pool.copy())
    PLAIN["ring_fused_mlp"](got, *map(torch.from_numpy, w), **kw)
    aligned = np.roll(pool, -2, axis=0)
    want = ref_fused_mlp(jnp.asarray(aligned), *map(jnp.asarray, w),
                         **dict(kw, ptr=0), interpret=True)
    live = live_lanes(32, [(0, 8, 256)])
    err, bad = compare_f32(np.roll(got.numpy(), -2, axis=0),
                           np.asarray(want), live)
    assert bad is None, bad


def test_tiles_fit_shared_memory_at_every_width():
    # whisper-tiny's layer: 19 blocks of 80 rows x 6 sub-tiles of 256 d_ff
    # columns, 114 CTAs on 132 SMs, 13.8 MB of partials
    t = mlp_tiling(1500, 384, 1536, 512)
    assert (t.tm, t.sub, t.splits, t.ctas) == (5, 256, 2, 114)
    assert mlp_smem(5, 256) == t.smem == 139_008
    # gemma3-1b's width: 16 rows, 7 sub-tiles of each of its 16 ff tiles
    t = mlp_tiling(16, 1152, 6912, 432, True)
    assert (t.rows, t.ctas) == (16, 112) and t.smem <= MAX_SMEM
    assert mlp_tiling(8, 256, 512, 256, True).rows == 16
    assert mlp_tiling(3, 64, 256, 128).rows == 16
    for d in (64, 384, 1152, 2048, 4096, 8192):
        t = mlp_tiling(1024, d, 4 * d, min(512, 4 * d), True)
        assert t.smem <= MAX_SMEM and t.ctas >= 100
        assert t.smem == mlp_smem(t.tm, t.sub)      # no term in d_model


# ---------------------------------------------------------------------------
# The executor and the params-less artifact.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tower():
    """``(port CompiledNet, reference CompiledNet, golden, x)`` for the
    whisper-tiny MLP tower, both on ``mlp_tower_params(seed=0)``."""
    cn = seeded_float_net(f"{TOWER}.json", 0)
    ref = repro.load(f"{TOWER}.json")
    assert ref.params is None
    ref.params = mlp_tower_params(ref.program, 0)
    with np.load(f"{TOWER}.golden.npz") as g:
        golden = {k: g[k] for k in g.files}
    x = np.random.default_rng(0).standard_normal(
        (2, cn.program.m_rows, cn.program.in_dim), np.float32)
    return cn, ref, golden, x


def test_f32_kinds_cover_every_executable_kind():
    assert set(F32_KINDS) == set(EXECUTABLE_KINDS)


def test_normalize_params_with_none_and_explicit_gates(tower):
    cn = tower[0]
    program = cn.program
    wu, wd = np.ones((384, 1536), np.float32), np.ones((1536, 384),
                                                        np.float32)
    wg = np.full((384, 1536), 2.0, np.float32)
    out = _normalize_params(program, [(None, wu, wd), (wg, wu, wd),
                                      (None, wu, wd), (wg, wu, wd), None])
    assert out[0][0] is wu and out[0][1] is wu and out[0][2] is wd
    assert out[1][0] is wg and out[3][0] is wg
    assert out[4] is None
    with pytest.raises(ValueError, match="takes no params"):
        _normalize_params(program, [(None, wu, wd)] * 4 + [(wu,)])
    with pytest.raises(ValueError, match="4 param entries"):
        _normalize_params(program, [(None, wu, wd)] * 4)


def test_executor_dispatch_matches_the_reference_arguments(tower):
    cn = tower[0]
    program = cn.program
    params = _normalize_params(program, cn.params)
    calls = [op_kernel_call(program, op, p)
             for op, p in zip(program.ops, params)]
    assert [c[0] for c in calls] == ["ring_fused_mlp"] * 4 \
        + ["ring_elementwise"]
    for name, args, kw in calls[:4]:
        assert kw == dict(m_rows=1500, d_model=384, ptr=0, block_rows=1,
                          ff_tile=512, gated=False, residual=True,
                          activation="gelu")
        assert args[0] is args[1]        # the ungated op's gate is W_up
    assert calls[4][1] == () and calls[4][2] == dict(
        m_rows=1500, d=384, ptr=0, fn="gelu", block_rows=1)
    cases = program_cases(program, cn.params, prefix="t_")
    assert [c.kernel for c in cases] == [c[0] for c in calls]


def test_params_less_artifact_builds_only_with_supplied_params(tmp_path):
    payload = json.loads(pathlib.Path(f"{TOWER}.json").read_text())
    assert payload["params"] is None and payload["quant"] is None
    with pytest.raises(CompileError, match="without its fp32 params"):
        load(f"{TOWER}.json")
    program = PoolProgram.from_json_dict(payload["program"])
    params = mlp_tower_params(program, 0)
    cn = CompiledNet.from_payload(payload, where="tower", params=params)
    assert cn.params is params and not cn.quantized
    with pytest.raises(ValueError, match="param entries"):
        CompiledNet.from_payload(payload, params=params[:4])
    ds = json.loads((ASSETS / "ds-cnn.host-sim.float32.json").read_text())
    with pytest.raises(ValueError, match="holds its own params"):
        CompiledNet.from_payload(ds, params=[None] * 11)
    # the certificate check is the one load makes
    bad = json.loads(json.dumps(payload))
    bad["program"]["ops"][0]["ff_tile"] = 256
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(bad))
    with pytest.raises(CompileError, match="VMCU403"):
        seeded_float_net(path, 0)


def test_mlp_tower_params_are_seeded_and_shaped(tower):
    cn = tower[0]
    a = mlp_tower_params(cn.program, 0)
    b = mlp_tower_params(cn.program, 0)
    c = mlp_tower_params(cn.program, 1)
    assert len(a) == 5 and a[4] is None
    for (g1, u1, d1), (g2, u2, d2), (_, u3, _) in zip(a[:4], b[:4], c[:4]):
        assert g1 is None and g2 is None
        assert u1.shape == (384, 1536) and d1.shape == (1536, 384)
        assert u1.dtype == d1.dtype == np.float32
        assert np.array_equal(u1, u2) and np.array_equal(d1, d2)
        assert not np.array_equal(u1, u3)
        assert 0.9 < u1.std() * np.sqrt(384) < 1.1
        assert 0.9 < d1.std() * 1536 < 1.1
    assert not np.array_equal(a[0][1], a[1][1])   # one stream, in op order


def test_report_equals_the_references(tower):
    cn, ref = tower[:2]
    assert cn.report() == ref.report()
    assert cn.flash_bytes_used == ref.flash_bytes_used == 18_874_368


# ---------------------------------------------------------------------------
# The whisper-tiny tower end to end.
# ---------------------------------------------------------------------------

def test_tower_run_matches_the_reference_jnp_run(tower):
    cn, ref, golden, x = tower
    assert hashlib.sha256(x.tobytes()).hexdigest() == str(golden["x_sha256"])
    y = cn.run(x, device="cpu")
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, 1500, 384)
    want = np.asarray(ref.run(x, backend="jnp"))
    _close(y.numpy(), want)
    _close(y.numpy()[:, golden["rows"]], golden["y"])
    assert np.isfinite(y.numpy()).all()


def test_tower_reference_forward_matches_the_jax_one(tower):
    cn, ref, golden, x = tower
    want = np.asarray(ref_reference_forward(ref.program, jnp.asarray(x[1]),
                                            ref.params))
    got = reference_forward(cn.program, torch.from_numpy(x[1]),
                            to_device(cn.params, "cpu"))
    _close(got.numpy(), want)
    _close(got.numpy(), cn.run(x[1], device="cpu").numpy())
    _close(got.numpy()[golden["rows"]], golden["y"][1])


def _small_tower(n_layers=2, m_rows=16):
    cfg = get_config("whisper-tiny")
    g = build_mlp_tower(cfg, m_rows=m_rows, n_layers=n_layers, elem_bytes=4)
    g.add("gelu", "elementwise", [f"L{n_layers - 1}.mlp"],
          Tensor(rows=m_rows, d=cfg.d_model, elem_bytes=4),
          activation="gelu")
    g.validate()
    params = mlp_tower_params(repro.compile(g, "host-sim").program, 5)
    return repro.compile(g, "host-sim", params=params), params


def test_small_tower_matches_the_reference_pallas_path():
    """Two whisper-width layers at 16 rows: the port's plain versions
    against the reference's Pallas kernels in interpret mode, outputs
    and final pools."""
    ref, params = _small_tower()
    program = PoolProgram.from_json_dict(ref.program.to_json_dict())
    x = np.random.default_rng(1).standard_normal((16, 384), np.float32)
    y_ref, pool_ref = ref_run_program(ref.program, jnp.asarray(x), params,
                                      backend="pallas")
    y, pool = run_program(program, torch.from_numpy(x),
                          to_device(params, "cpu"))
    _close(y.numpy(), np.asarray(y_ref))
    live = program_live_lanes(program, params)
    err, bad = compare_f32(pool.array.numpy(), np.asarray(pool_ref.array),
                           live)
    assert bad is None, bad
    assert not pool.array.numpy()[~live].any()
