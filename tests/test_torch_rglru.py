"""The port's RG-LRU block (``repro_torch.models.rglru``) against the
reference's (``repro.models.rglru``), on the CPU, at the reduced
recurrentgemma-2b width (d 64, lru_width 64, conv 4).

The same numpy inputs and the reference's own ``init_rec`` params go
into both.  fp32-only functions (the gates and the scan) are held to
fp32 rounding (rtol 1e-5, atol 1e-6 * max); the block's outputs and its
states to rtol 2e-2, atol 2e-2 * max: the activations are bf16, and
XLA and torch round some bf16 products apart (the fp32 LRU state is fed
by them, so it is held at the same tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import rglru as ref
from repro.parallel.sharding import no_sharding
from repro_torch.configs import get_config
from repro_torch.models import rglru

torch.set_num_threads(2)

RTOL = ATOL_REL = 2e-2
CFG = get_config("recurrentgemma-2b").reduced()
REF_CFG = ref_get_config("recurrentgemma-2b").reduced()


def _ref_forward(p, x, cfg=None, cache=None):
    """The reference's ``rec_forward`` with its cache, jitted (as a user runs
    it; op by op it takes seconds)."""
    cfg = cfg or REF_CFG
    return _jit(cfg, "rec_forward")(p, x, cache)


def _ref_step(p, x, cache, cfg=None):
    cfg = cfg or REF_CFG
    return _jit(cfg, "rec_step")(p, x, cache)


_JITS = {}


def _jit(cfg, name):
    if (cfg, name) not in _JITS:
        fn = getattr(ref, name)
        if name == "rec_forward":
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


@pytest.fixture(scope="module")
def params():
    """The reference's ``init_rec`` params as numpy, with its norm scale
    drawn (the reference's zeros would hide a misplaced norm)."""
    p = jax.tree.map(np.asarray,
                     ref.init_rec(jax.random.PRNGKey(3), REF_CFG))
    p["ln"]["scale"] = np.random.default_rng(4).standard_normal(
        p["ln"]["scale"].shape).astype(np.float32) * 0.1
    return p


def _both(p):
    return (jax.tree.map(jnp.asarray, p),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def test_init_rec_has_the_reference_layout_and_distributions():
    want = jax.eval_shape(lambda k: ref.init_rec(k, REF_CFG),
                          jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    have = rglru.init_rec(gen, CFG)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, want)) \
        == jax.tree.structure(jax.tree.map(lambda a: 0, have,
                                           is_leaf=torch.is_tensor))
    for (path, w), h in zip(jax.tree.leaves_with_path(want),
                            jax.tree.leaves(have, is_leaf=torch.is_tensor)):
        assert tuple(h.shape) == w.shape and h.dtype == torch.float32, path
    lam = have["lru_lambda"]
    assert 0.9 <= float(lam.min()) and float(lam.max()) < 0.999
    assert float(lam.std()) > 0.02          # spread over the interval
    assert abs(float(have["lru_w_x"].std()) * 8 - 1) < 0.1   # 1/sqrt(64)
    assert abs(float(have["lru_conv"].std()) - 0.1) < 0.02
    assert abs(float(have["lru_out"].std()) * 8 - 1) < 0.1
    assert not have["ln"]["scale"].any()
    again = rglru.init_rec(torch.Generator().manual_seed(0), CFG)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(have, is_leaf=torch.is_tensor),
        jax.tree.leaves(again, is_leaf=torch.is_tensor)))


def test_gates_match_reference(params):
    jp, tp = _both(params)
    x = _x((3, 11, 64), 0) * 3
    a_r, bx_r = ref._gates(jp, jnp.asarray(x))
    a_p, bx_p = rglru._gates(tp, torch.from_numpy(x))
    _close(a_p, a_r, 1e-5, 1e-6)
    _close(bx_p, bx_r, 1e-5, 1e-6)


@pytest.mark.parametrize("S", [1, 2, 7, 37, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_assoc_scan_matches_reference(S, with_h0):
    """The log-depth scan against the reference's associative scan (and,
    for the same inputs, a sequential loop)."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 5)).astype(np.float32)
    bx = rng.standard_normal((2, S, 5)).astype(np.float32)
    h0 = rng.standard_normal((2, 5)).astype(np.float32) if with_h0 else None
    want = ref._assoc_scan(jnp.asarray(a), jnp.asarray(bx),
                           None if h0 is None else jnp.asarray(h0))
    got = rglru._assoc_scan(torch.from_numpy(a), torch.from_numpy(bx),
                            None if h0 is None else torch.from_numpy(h0))
    _close(got, want, 1e-5, 1e-6)
    h = np.zeros((2, 5), np.float32) if h0 is None else h0
    loop = []
    for t in range(S):
        h = a[:, t] * h + bx[:, t]
        loop.append(h)
    _close(got, np.stack(loop, 1), 1e-5, 1e-6)


@pytest.mark.parametrize("S", [2, 3, 40])   # the reference scans S >= 2
def test_rec_forward_and_cache_match_reference(params, S):
    jp, tp = _both(params)
    x = _x((3, S, 64), S)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    out_r, c_r = _ref_forward(jp, xj)
    out_p, c_p = rglru.rec_forward(tp, xt, CFG, return_cache=True)
    assert out_p.dtype == torch.bfloat16
    assert c_p.h.dtype == torch.float32 and c_p.conv.dtype == torch.bfloat16
    _close(out_p, out_r, what="out")
    _close(c_p.h, c_r.h, what="h")
    _close(c_p.conv, c_r.conv, what="conv")
    none_p = rglru.rec_forward(tp, xt, CFG)
    assert none_p[1] is None and torch.equal(none_p[0], out_p)


def test_rec_forward_continues_from_a_cache(params):
    """A prefill given a cache (h0 and the conv state) continues the
    sequence: as the reference, and equal to one pass over both parts."""
    jp, tp = _both(params)
    x = _x((2, 30, 64), 5)
    xj, xt = jnp.asarray(x, jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)
    _, c_r = _ref_forward(jp, xj[:, :20])
    _, c_p = rglru.rec_forward(tp, xt[:, :20], CFG, return_cache=True)
    out_r, d_r = _ref_forward(jp, xj[:, 20:], cache=c_r)
    out_p, d_p = rglru.rec_forward(tp, xt[:, 20:], CFG, cache=c_p,
                                   return_cache=True)
    _close(out_p, out_r)
    _close(d_p.h, d_r.h)
    whole, _ = rglru.rec_forward(tp, xt, CFG)
    _close(out_p, whole[:, 20:].float().numpy())


def test_rec_steps_match_reference(params):
    """Six decode steps from a prefill's cache, each output and state
    against the reference's, and the steps against one prefill over the
    whole sequence."""
    jp, tp = _both(params)
    x = _x((3, 16, 64), 9)
    xj, xt = jnp.asarray(x, jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)
    _, c_r = _ref_forward(jp, xj[:, :10])
    _, c_p = rglru.rec_forward(tp, xt[:, :10], CFG, return_cache=True)
    whole, _ = rglru.rec_forward(tp, xt, CFG)
    for t in range(10, 16):
        o_r, c_r = _ref_step(jp, xj[:, t:t + 1], c_r)
        o_p, c_p = rglru.rec_step(tp, xt[:, t:t + 1], CFG, c_p)
        assert o_p.shape == (3, 1, 64) and c_p.h.dtype == torch.float32
        _close(o_p, o_r, what=f"step {t}")
        _close(c_p.h, c_r.h, what=f"h {t}")
        _close(c_p.conv, c_r.conv, what=f"conv {t}")
        _close(o_p, whole[:, t:t + 1].float().numpy(), what=f"whole {t}")


def test_init_rec_cache_matches_reference():
    want = ref.init_rec_cache(REF_CFG, 3)
    have = rglru.init_rec_cache(CFG, 3, device="cpu")
    assert tuple(have.h.shape) == want.h.shape
    assert tuple(have.conv.shape) == want.conv.shape
    assert have.h.dtype == torch.float32 and have.conv.dtype == torch.bfloat16
    assert not have.h.any() and not have.conv.any()
