"""The port's plain oracles (``repro_torch.kernels.ref``), its FC-chain
adapters (``repro_torch.core.ring_buffer``), its one-call kernel entries
(``repro_torch.kernels.ops``) and its serving command
(``repro_torch.launch.serve``) against the reference's, on the CPU.

Every oracle gets the same seeded numpy inputs as the reference's: the
fp32 ones are held within the conformance matrix's rtol 3e-4, atol
3e-5 * max (``tests/test_conformance_matrix.py:316``), the int8 ones
bitwise.  The chain's plan equals the reference's field by field, and
its ring run the reference's ring run and the naive chain (fp32);
``segment_gemm`` and ``fused_mlp`` plan, stage, execute and fetch as the
reference's.  ``launch.serve.main`` prints the reference's two kinds of
line for every block kind on the CPU, and refuses the card where there
is none.
"""
import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ring_buffer as ref_rb
from repro.kernels import ops as ref_ops
from repro.kernels import ref as R
from repro_torch.core import ring_buffer as rb
from repro_torch.kernels import ops
from repro_torch.kernels import ref as P
from repro_torch.launch import serve

torch.set_num_threads(2)

F_RTOL, F_ATOL_REL = 3e-4, 3e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _f(shape, seed, scale=1.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _i8(shape, seed):
    return _rng(seed).integers(-128, 128, shape, dtype=np.int8)


def _requant(c, seed):
    rng = _rng(seed)
    return (rng.integers(1 << 30, (1 << 31) - 1, (c,), dtype=np.int32),
            rng.integers(-12, -7, (c,), dtype=np.int32))


def _call(fn_ref, fn_port, args, kwargs=None):
    """The reference's oracle (jitted: op by op it compiles every small
    op) and the port's on the same inputs."""
    kwargs = kwargs or {}
    want = jax.jit(functools.partial(fn_ref, **kwargs))(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    got = fn_port(*(torch.from_numpy(a.copy()) if isinstance(a, np.ndarray)
                    else a for a in args), **kwargs)
    return got, want


def _close_f32(got, want):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close_f32(g, w)
        return
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=F_RTOL,
                               atol=F_ATOL_REL * float(np.abs(want).max()))


def _equal(got, want):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _equal(g, w)
        return
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


F32_CASES = {
    "gemm_ref": lambda: ((_f((9, 40), 0), _f((40, 24), 1), _f((24,), 2)),
                         {}),
    "fused_mlp_ref_gated_gelu": lambda: (
        (_f((7, 32), 0), _f((32, 64), 1, .2), _f((32, 64), 2, .2),
         _f((64, 32), 3, .2)), {}),
    "fused_mlp_ref_silu_no_residual": lambda: (
        (_f((7, 32), 0), _f((32, 64), 1, .2), _f((32, 64), 2, .2),
         _f((64, 32), 3, .2)),
        {"gated": False, "residual": False, "activation": "silu"}),
    "conv_pw_ref": lambda: ((_f((7, 5, 12), 0), _f((12, 20), 1),
                             _f((20,), 2)),
                            {"stride": 2, "activation": "relu"}),
    "conv_dw_ref": lambda: ((_f((9, 8, 16), 0), _f((3, 3, 16), 1),
                             _f((16,), 2)), {"stride": 2}),
    "conv_k2d_ref_same": lambda: ((_f((10, 7, 3), 0), _f((3, 3, 3, 8), 1),
                                   _f((8,), 2)),
                                  {"stride": 2, "activation": "relu"}),
    "conv_k2d_ref_valid": lambda: ((_f((10, 7, 3), 0), _f((4, 4, 3, 8), 1),
                                    _f((8,), 2)), {"padding": "valid"}),
    "conv_stream_ref": lambda: ((_f((9, 6, 4), 0), _f((2, 6, 4), 1),
                                 _f((3, 3, 4, 8), 2), _f((8,), 3)),
                                {"activation": "relu"}),
    "gru_cell_ref": lambda: ((_f((1, 12), 0), _f((1, 8), 1),
                              _f((12, 24), 2, .3), _f((8, 24), 3, .3),
                              _f((24,), 4)), {}),
    "add_ref": lambda: ((_f((6, 20), 0), _f((6, 20), 1)),
                        {"activation": "relu"}),
    "avgpool_ref": lambda: ((_f((5, 7, 12), 0),), {}),
    "elementwise_ref_gelu": lambda: ((_f((6, 20), 0),), {"fn": "gelu"}),
    "elementwise_ref_square": lambda: ((_f((6, 20), 0),), {"fn": "square"}),
    "ib_fused_ref": lambda: ((_f((6, 5, 8), 0), _f((8, 24), 1, .3),
                              _f((3, 3, 24), 2, .3), _f((24, 8), 3, .3)),
                             {}),
    "ring_decode_ref": lambda: ((_f((8, 16), 0), _f((32, 2, 16), 1),
                                 _f((32, 2, 16), 2), 20),
                                {"window": 32, "softcap": 30.0}),
    "ring_decode_ref_wrapped": lambda: ((_f((4, 16), 0), _f((32, 4, 16), 1),
                                         _f((32, 4, 16), 2), 70),
                                        {"window": 32}),
}


def _fn_name(case):
    for name in ("fused_mlp_ref", "conv_k2d_ref", "elementwise_ref",
                 "ring_decode_ref"):
        if case.startswith(name):
            return name
    return case


@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_fp32_oracles_match_the_reference(case):
    args, kw = F32_CASES[case]()
    name = _fn_name(case)
    got, want = _call(getattr(R, name), getattr(P, name), args, kw)
    _close_f32(got, want)


Q_CASES = {
    "gemm_q_ref": lambda: (_i8((3, 40), 0), _i8((40, 24), 1),
                           _rng(2).integers(-4000, 4000, 24, dtype=np.int32),
                           *_requant(24, 3)),
    "conv_pw_q_ref": lambda: (_i8((7, 5, 12), 0), _i8((12, 20), 1),
                              _rng(2).integers(-4000, 4000, 20,
                                               dtype=np.int32),
                              *_requant(20, 3)),
    "conv_dw_q_ref": lambda: (_i8((9, 8, 16), 0), _i8((3, 3, 16), 1),
                              _rng(2).integers(-4000, 4000, 16,
                                               dtype=np.int32),
                              *_requant(16, 3)),
    "conv_k2d_q_ref": lambda: (_i8((10, 7, 3), 0), _i8((3, 3, 3, 8), 1),
                               _rng(2).integers(-4000, 4000, 8,
                                                dtype=np.int32),
                               *_requant(8, 3)),
    "avgpool_q_ref": lambda: (_i8((5, 7, 12), 0), *_requant(12, 1)),
}
Q_KWARGS = {"conv_pw_q_ref": {"stride": 2, "activation": "relu"},
            "conv_dw_q_ref": {"stride": 2},
            "conv_k2d_q_ref": {"stride": 2, "activation": "relu"},
            "gemm_q_ref": {"activation": "relu"}}


@pytest.mark.parametrize("name", sorted(Q_CASES))
def test_int8_oracles_match_the_reference_bitwise(name):
    got, want = _call(getattr(R, name), getattr(P, name), Q_CASES[name](),
                      Q_KWARGS.get(name))
    _equal(got, want)


def test_int8_k2d_valid_add_stream_and_gru_oracles_bitwise():
    b8 = _rng(2).integers(-4000, 4000, 8, dtype=np.int32)
    got, want = _call(R.conv_k2d_q_ref, P.conv_k2d_q_ref,
                      (_i8((10, 7, 3), 0), _i8((4, 4, 3, 8), 1), b8,
                       *_requant(8, 3)), {"padding": "valid"})
    _equal(got, want)
    m_in, s_in = _requant(20, 4)
    m_aux, s_aux = _requant(20, 5)
    got, want = _call(R.add_q_ref, P.add_q_ref,
                      (_i8((6, 20), 0), _i8((6, 20), 1), m_in, s_in + 8,
                       m_aux, s_aux + 8), {"activation": "relu"})
    _equal(got, want)
    got, want = _call(R.conv_stream_q_ref, P.conv_stream_q_ref,
                      (_i8((9, 6, 4), 0), _i8((2, 6, 4), 1),
                       _i8((3, 3, 4, 8), 2), b8, *_requant(8, 3)))
    _equal(got, want)
    d_h = 8
    mx, sx = _requant(3 * d_h, 6)
    mu, su = _requant(3 * d_h, 7)
    got, want = _call(R.gru_cell_q_ref, P.gru_cell_q_ref,
                      (_i8((1, 12), 0), _i8((1, d_h), 1),
                       _i8((12, 3 * d_h), 2), _i8((d_h, 3 * d_h), 3),
                       _rng(4).integers(-3000, 3000, 3 * d_h,
                                        dtype=np.int32),
                       mx, sx + 4, mu, su + 4))
    _equal(got, want)


def test_every_reference_oracle_has_a_port():
    public = {n for n in dir(R) if n.endswith("_ref") and callable(
        getattr(R, n))}
    assert public <= set(dir(P)), public - set(dir(P))
    assert len(public) >= 20


@pytest.mark.parametrize("dims,m,seg", [([96, 384, 96, 64], 8, 32),
                                        ([64, 256, 64], 16, 32),
                                        ([256, 256, 256], 64, 128),
                                        ([200, 130, 70], 5, 128)])
def test_ring_chain_matches_the_reference(dims, m, seg):
    want_plan = ref_rb.plan_chain(m, dims, seg_width=seg)
    plan = rb.plan_chain(m, dims, seg_width=seg)
    assert dataclasses.asdict(plan) == dataclasses.asdict(want_plan)
    assert (plan.pool_bytes, plan.naive_bytes) \
        == (want_plan.pool_bytes, want_plan.naive_bytes)
    params = ref_rb.init_chain_params(jax.random.PRNGKey(0), dims)
    tparams = [(torch.from_numpy(np.array(w)), torch.from_numpy(np.array(b)))
               for w, b in params]
    x = _f((m, dims[0]), 1)
    for block_rows in (1, m):
        want = np.asarray(ref_rb.run_chain_via_ring(jnp.asarray(x), params,
                                                    want_plan, block_rows))
        got = rb.run_chain_via_ring(torch.from_numpy(x), tparams, plan,
                                    block_rows).numpy()
        np.testing.assert_allclose(got, want, rtol=F_RTOL,
                                   atol=F_ATOL_REL * np.abs(want).max())
    naive = rb.naive_chain_apply(torch.from_numpy(x), tparams).numpy()
    np.testing.assert_allclose(got, naive, rtol=F_RTOL,
                               atol=F_ATOL_REL * np.abs(naive).max())
    with pytest.raises(ValueError, match="block_rows"):
        rb.run_chain_via_ring(torch.from_numpy(x), tparams, plan,
                              block_rows=m + 1)


def test_init_chain_params_scales():
    dims = [64, 256, 32]
    ps = rb.init_chain_params(torch.Generator().manual_seed(0), dims)
    assert [tuple(w.shape) for w, _ in ps] == [(64, 256), (256, 32)]
    assert all(not b.any() for _, b in ps)
    assert abs(float(ps[0][0].std()) * 8 - 1) < 0.05


def test_write_and_read_rows_wrap_the_ring():
    pool = torch.zeros((10, 32))
    x = torch.arange(3 * 40, dtype=torch.float32).reshape(3, 40)
    rb.write_rows(pool, x, 7, 10)
    assert torch.equal(rb.read_rows(pool, 7, 3, 40, 10), x)
    want = ref_rb.write_rows(jnp.zeros((10, 32)), jnp.asarray(x.numpy()), 7,
                             10)
    np.testing.assert_array_equal(pool.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,d_in,d_out,bias", [(8, 96, 200, True),
                                               (16, 128, 64, False),
                                               (24, 300, 130, True)])
def test_segment_gemm_matches_the_reference(m, d_in, d_out, bias):
    x, w = _f((m, d_in), 0), _f((d_in, d_out), 1, 0.1)
    b = _f((d_out,), 2) if bias else None
    want, want_info = ref_ops.segment_gemm(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b))
    got, info = ops.segment_gemm(torch.from_numpy(x), torch.from_numpy(w),
                                 None if b is None else torch.from_numpy(b))
    assert info == want_info
    _close_f32(got, np.asarray(want))


@pytest.mark.parametrize("gated,residual,act", [(True, True, "gelu"),
                                                (False, False, "silu")])
def test_fused_mlp_matches_the_reference(gated, residual, act):
    x = _f((16, 96), 0)
    wg, wu, wd = _f((96, 256), 1, .1), _f((96, 256), 2, .1), \
        _f((256, 96), 3, .1)
    kw = dict(gated=gated, residual=residual, activation=act, ff_tile=128)
    want = ref_ops.fused_mlp(*map(jnp.asarray, (x, wg, wu, wd)), **kw)
    got = ops.fused_mlp(*map(torch.from_numpy, (x, wg, wu, wd)), **kw)
    _close_f32(got, np.asarray(want))
    _close_f32(got, P.fused_mlp_ref(*map(torch.from_numpy, (x, wg, wu, wd)),
                                    gated=gated, residual=residual,
                                    activation=act).numpy())


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-780m",
                                  "granite-moe-1b-a400m", "whisper-tiny",
                                  "llama-3.2-vision-90b", "gemma3-1b"])
def test_launch_serve_runs_every_kind_on_the_cpu(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "6", "--max-new", "3"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("generated 6 tokens in ")
    assert lines[0].endswith(" tok/s batch=2)")
    assert [ln.split(":")[0] for ln in lines[1:]] == ["  req0", "  req1"]
    assert all(ln.endswith("]...") for ln in lines[1:])


def test_launch_serve_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        serve.main(["--arch", "gemma3-1b", "--reduced"])
