"""The port's Mamba-2 SSD block (``repro_torch.models.mamba2``) against
the reference's (``repro.models.mamba2``), on the CPU, at the reduced
mamba2-780m width (d 64, d_inner 128, 8 heads of 16, state 16, chunk 8).

The same numpy inputs and the reference's own ``init_ssm`` params (its
zero ``A_log``, ``dt_bias`` and norm scale replaced by draws, so that
each one shows) go into both.  The chunked SSD, fp32 throughout, is
held to fp32 rounding (rtol 1e-5, atol 1e-5 * max) over several chunks;
the block's outputs, its fp32 state and its conv state to rtol 2e-2,
atol 2e-2 * max: the activations are bf16, and XLA and torch round some
bf16 products apart.  ``silu`` and the gated norm, where the port follows
XLA's roundings step by step, are held bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import mamba2 as ref
from repro.parallel.sharding import no_sharding
from repro_torch.configs import get_config
from repro_torch.models import mamba2

torch.set_num_threads(2)

RTOL = ATOL_REL = 2e-2
CFG = get_config("mamba2-780m").reduced()
REF_CFG = ref_get_config("mamba2-780m").reduced()


def _ref_forward(p, x, cfg=None, cache=None):
    """The reference's ``ssm_forward`` with its cache, jitted (as a user runs
    it; op by op it takes seconds)."""
    cfg = cfg or REF_CFG
    return _jit(cfg, "ssm_forward")(p, x, cache)


def _ref_step(p, x, cache, cfg=None):
    cfg = cfg or REF_CFG
    return _jit(cfg, "ssm_step")(p, x, cache)


_JITS = {}


def _jit(cfg, name):
    if (cfg, name) not in _JITS:
        fn = getattr(ref, name)
        if name == "ssm_forward":
            _JITS[cfg, name] = jax.jit(lambda p, x, c: fn(
                p, x, cfg, no_sharding(), cache=c, return_cache=True))
        else:
            _JITS[cfg, name] = jax.jit(lambda p, x, c: fn(
                p, x, cfg, no_sharding(), c))
    return _JITS[cfg, name]


def _close(got, want, rtol=RTOL, atol_rel=ATOL_REL, what=""):
    got = np.asarray(torch.as_tensor(got).float(), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape, what)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()),
                               err_msg=what)


def _params(cfg):
    p = jax.tree.map(np.asarray, ref.init_ssm(jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(4)
    for k in ("ssm_a_log", "ssm_dt_bias", "ssm_norm"):
        p[k] = (rng.standard_normal(p[k].shape) * 0.3).astype(np.float32)
    p["ln"]["scale"] = (rng.standard_normal(p["ln"]["scale"].shape)
                        * 0.1).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def params():
    return _params(REF_CFG)


def _both(p):
    return (jax.tree.map(jnp.asarray, p),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)


def test_init_ssm_has_the_reference_layout_and_values():
    want = jax.eval_shape(lambda k: ref.init_ssm(k, REF_CFG),
                          jax.random.PRNGKey(0))
    have = mamba2.init_ssm(torch.Generator().manual_seed(0), CFG)
    assert sorted(have) == sorted(want)
    for k, w in want.items():
        if k == "ln":
            continue
        assert tuple(have[k].shape) == w.shape, k
        assert have[k].dtype == torch.float32, k
    assert not have["ssm_a_log"].any() and not have["ssm_dt_bias"].any()
    assert not have["ssm_norm"].any() and (have["ssm_d"] == 1).all()
    assert abs(float(have["ssm_w_z"].std()) * 8 - 1) < 0.1
    assert abs(float(have["ssm_conv"].std()) - 0.1) < 0.02
    assert abs(float(have["ssm_out"].std()) * np.sqrt(128) - 1) < 0.1


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_matches_reference_over_several_chunks(G):
    """Four chunks of 8, one group or two, every term (intra-chunk, chunk
    states, the scan across chunks) in fp32."""
    rng = np.random.default_rng(G)
    B, S, H, P, N, chunk = 2, 32, 4, 16, 8, 8
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
    A = rng.standard_normal((H,)).astype(np.float32) * 0.5
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    want = ref._ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk)
    got = mamba2._ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                              chunk)
    _close(got, want, 1e-5, 1e-5)
    # one chunk of 32 is the same recurrence
    _close(got, mamba2._ssd_chunked(*map(torch.from_numpy,
                                         (x, dt, A, Bm, Cm)), 32).numpy(),
           1e-4, 1e-5)


def test_causal_conv_matches_reference(params):
    x = _x((2, 9, 160), 1)
    st = _x((2, 3, 160), 2)
    w = params["ssm_conv"]
    for state in (None, st):
        o_r, s_r = ref._causal_conv(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
            None if state is None else jnp.asarray(state, jnp.bfloat16))
        o_p, s_p = mamba2._causal_conv(
            torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(w.copy()), None if state is None else torch.from_numpy(state).to(
                torch.bfloat16))
        _close(o_p, o_r)
        _close(s_p, s_r, 0, 0)


@pytest.mark.parametrize("S", [5, 8, 21, 40])
def test_ssm_forward_and_cache_match_reference(params, S):
    """S below the chunk (one chunk of S), a whole chunk, and 21 and 40
    tokens (3 and 5 chunks of 8, the last padded with zero dt) — the
    output, the hand-off state and the conv state."""
    jp, tp = _both(params)
    xj, xt = _bf16(_x((3, S, 64), S))
    out_r, c_r = _ref_forward(jp, xj)
    out_p, c_p = mamba2.ssm_forward(tp, xt, CFG, return_cache=True)
    assert out_p.dtype == torch.bfloat16
    assert c_p.state.dtype == torch.float32
    assert c_p.conv.dtype == torch.bfloat16
    _close(out_p, out_r, what="out")
    _close(c_p.state, c_r.state, what="state")
    _close(c_p.conv, c_r.conv, what="conv")


def test_ssm_steps_match_reference(params):
    """Six decode steps from a prefill's cache, against the reference's
    steps and against one forward over the whole sequence."""
    jp, tp = _both(params)
    xj, xt = _bf16(_x((3, 19, 64), 7))
    _, c_r = _ref_forward(jp, xj[:, :13])
    _, c_p = mamba2.ssm_forward(tp, xt[:, :13], CFG, return_cache=True)
    whole, _ = mamba2.ssm_forward(tp, xt, CFG)
    for t in range(13, 19):
        o_r, c_r = _ref_step(jp, xj[:, t:t + 1], c_r)
        o_p, c_p = mamba2.ssm_step(tp, xt[:, t:t + 1], CFG, c_p)
        assert o_p.shape == (3, 1, 64)
        _close(o_p, o_r, what=f"step {t}")
        _close(c_p.state, c_r.state, what=f"state {t}")
        _close(c_p.conv, c_r.conv, what=f"conv {t}")
        _close(o_p, whole[:, t:t + 1].float().numpy(), what=f"whole {t}")


def test_two_groups_match_reference():
    """ssm_groups 2: B and C shared by half the heads each."""
    rcfg = dataclasses.replace(REF_CFG, ssm_groups=2)
    cfg = dataclasses.replace(CFG, ssm_groups=2)
    jp, tp = _both(_params(rcfg))
    xj, xt = _bf16(_x((2, 12, 64), 11))
    out_r, c_r = _ref_forward(jp, xj, rcfg)
    out_p, c_p = mamba2.ssm_forward(tp, xt, cfg, return_cache=True)
    _close(out_p, out_r)
    _close(c_p.state, c_r.state)
    o_r, _ = _ref_step(jp, xj[:, :1], c_r, rcfg)
    o_p, _ = mamba2.ssm_step(tp, xt[:, :1], cfg, c_p)
    _close(o_p, o_r)


def test_init_ssm_cache_matches_reference():
    want = ref.init_ssm_cache(REF_CFG, 3)
    have = mamba2.init_ssm_cache(CFG, 3, device="cpu")
    assert tuple(have.state.shape) == want.state.shape
    assert tuple(have.conv.shape) == want.conv.shape
    assert have.state.dtype == torch.float32
    assert have.conv.dtype == torch.bfloat16


def test_silu_and_the_gated_norm_round_as_the_reference():
    """bf16 ``silu`` and the block's gated norm, bit for bit the
    reference's as XLA runs them: the sigmoid expanded to ``1 / (1 +
    exp(-x))`` and rounded at every step, and the gate's product kept in
    fp32 into the norm (XLA fuses it into the norm's fp32 cast).  The
    one-rounding forms differ in about a quarter of the outputs, which a
    48-layer mamba2-780m carries past the logits' tolerance."""
    from repro.models.common import rmsnorm as ref_rmsnorm
    from repro_torch.models.common import _silu

    rng = np.random.default_rng(12)
    y, z = (rng.standard_normal((64, 128)).astype(np.float32) * 3
            for _ in range(2))
    scale = (rng.standard_normal(128) * 0.3).astype(np.float32)
    (yj, yt), (zj, zt) = _bf16(y), _bf16(z)
    want = jax.jit(jax.nn.silu)(zj)
    np.testing.assert_array_equal(_silu(zt).float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    want = jax.jit(lambda y, z, s: ref_rmsnorm(y * jax.nn.silu(z), s))(
        yj, zj, jnp.asarray(scale))
    got = mamba2._gated_norm(yt, zt, torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_one_tokens_dt_keeps_the_references_fp32_sums(params):
    """A decode step's ``dt``: XLA fuses the reference's cast of ``h @
    w_dt`` to fp32 into the dot and drops the bf16 rounding between, so
    the port's is within fp32 rounding of it (a sequence's is rounded, as
    ``test_ssm_forward_and_cache_match_reference`` holds)."""
    jp, tp = _both(params)
    h = _x((3, 64), 13)
    want = jax.jit(lambda h, w, b: jax.nn.softplus(
        (h @ w.astype(h.dtype)).astype(jnp.float32) + b))(
        jnp.asarray(h, jnp.bfloat16), jp["ssm_w_dt"], jp["ssm_dt_bias"])
    _, _, dt = mamba2._project(tp, torch.from_numpy(h).to(torch.bfloat16),
                               CFG)
    np.testing.assert_allclose(dt.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
