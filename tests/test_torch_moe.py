"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``), on the CPU, at the reduced granite-moe-1b-a400m
(4 experts, top 2, expert d_ff 32) and deepseek-moe-16b (the same and
one shared expert) widths.

The reduced configs set ``capacity_factor = n_experts``, so they never
drop; these tests also run ``capacity_factor = 1.0`` (via
``dataclasses.replace``) on 80 tokens, where an expert's 41st choice and
later are dropped, in both dispatch modes (``cumsum``, ``scan``).  The
same numpy inputs and the reference's own ``init_moe`` params go into
both.  Held: the top-k choice and its order (exactly, ties included),
each choice's rank and whether it is kept (exactly, both modes), the
output within rtol 2e-2, atol 2e-2 * max (bf16 activations), and the aux
loss within rtol 1e-3.  The router's logits are bf16 products, so where
XLA and torch round one apart, a choice whose logit ties its runner-up
within two bf16 steps may differ; such a choice (and the choices its
expert ranks after it) must be a near tie, and is left out of the output
comparison.

:func:`reference_routes` and :func:`routing_of` read the reference's
routing out of a whole model's run for the other LM tests.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref
from repro.models.common import apply_norm as ref_apply_norm
from repro.parallel.sharding import no_sharding
from repro_torch.configs import get_config
from repro_torch.models import moe

torch.set_num_threads(2)

RTOL = ATOL_REL = 2e-2
ARCHS = ("granite-moe-1b-a400m", "deepseek-moe-16b")


def _cfgs(arch, cf=None, mode="cumsum"):
    cfg, rcfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    kw = {"moe_dispatch": mode}
    if cf is not None:
        kw["capacity_factor"] = cf
    return dataclasses.replace(cfg, **kw), dataclasses.replace(rcfg, **kw)


def _params(rcfg, seed=3):
    p = jax.tree.map(np.asarray, ref.init_moe(jax.random.PRNGKey(seed),
                                              rcfg))
    p["ln"]["scale"] = (np.random.default_rng(seed).standard_normal(
        p["ln"]["scale"].shape) * 0.1).astype(np.float32)
    return p


def _both(p):
    return (jax.tree.map(jnp.asarray, p),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _ref_routing(jp, xj, rcfg):
    """The reference's routing of ``xj``, step for step as its
    ``moe_forward`` computes it (``moe.py:53-79``): logits, expert ids,
    each choice's rank and whether it is kept."""
    B, S, d = xj.shape
    T, E, k = B * S, rcfg.n_experts, rcfg.top_k
    ht = ref_apply_norm(jp["ln"], xj, rcfg).reshape(T, d)
    logits = (ht @ jp["router"].astype(xj.dtype)).astype(jnp.float32)
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    onehot = jax.nn.one_hot(eidx.reshape(-1), E, dtype=jnp.int32)
    rank = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    cap = max(1, int(rcfg.capacity_factor * T * k / E), min(T, 16))
    return (np.asarray(logits), np.asarray(eidx), np.asarray(rank),
            np.asarray(rank < cap))


@contextlib.contextmanager
def reference_routes(cfg):
    """While open, every MoE FFN of the reference that JAX traces
    records, on each run, its router's expert ids ``[T, k]`` (the
    ``lax.top_k`` of ``moe.py:63``) through an ordered
    ``jax.debug.callback``; yields the list of numpy arrays, one a call
    in the order the layers ran.  Read it after
    ``jax.effects_barrier()``."""
    calls = []
    real = jax.lax.top_k

    def top_k(operand, k, **kw):
        vals, ids = real(operand, k, **kw)
        if k == cfg.top_k and operand.shape[-1] == cfg.n_experts:
            jax.debug.callback(lambda a: calls.append(np.asarray(a)), ids,
                               ordered=True)
        return vals, ids

    jax.lax.top_k = top_k
    try:
        yield calls
    finally:
        jax.lax.top_k = real


def routing_of(ids, batch: int, cfg) -> moe.Routing:
    """The reference's choices ``ids [T, k]`` of one call over ``batch``
    rows as the port's ``moe.Routing``: which choices the capacity keeps
    follows from the ids by the rank rule (``moe.dispatch``, held against
    the reference's by ``test_dispatch_ranks_and_keeps_as_the_reference``)."""
    T, k = ids.shape
    e = torch.from_numpy(np.asarray(ids, np.int64))
    _, keep = moe.dispatch(e.reshape(-1), cfg.n_experts,
                           moe.capacity(cfg, T), cfg.moe_dispatch)
    return moe.Routing(e.reshape(batch, T // batch, k),
                       keep.reshape(batch, T // batch, k))


def _near_tie(logits, k):
    """Whether the k-th and (k+1)-th logits of a token lie within two
    bf16 steps of the largest."""
    top = np.sort(logits)[::-1]
    step = 2.0 ** (np.floor(np.log2(np.abs(top[0]))) - 7)
    return k < len(top) and top[k - 1] - top[k] <= 2 * step


def test_init_moe_has_the_reference_layout():
    for arch in ARCHS:
        cfg, rcfg = _cfgs(arch)
        want = jax.eval_shape(lambda k: ref.init_moe(k, rcfg),
                              jax.random.PRNGKey(0))
        have = moe.init_moe(torch.Generator().manual_seed(0), cfg)
        assert sorted(have) == sorted(want)
        for k, w in want.items():
            if k != "ln":
                assert tuple(have[k].shape) == w.shape, (arch, k)
                assert have[k].dtype == torch.float32
        assert abs(float(have["moe_gate"].std()) * 8 - 1) < 0.1
        assert abs(float(have["moe_down"].std()) * np.sqrt(32) - 1) < 0.1


def test_top_k_orders_ties_as_lax_top_k():
    """Probabilities with many exact ties: the same ids in the same
    order as ``jax.lax.top_k``."""
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 4, (200, 16)).astype(np.float32) / 4
    for k in (1, 2, 6, 16):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        have_v, have_i = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(have_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(have_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("cap", [1, 7, 40, 400])
def test_dispatch_ranks_and_keeps_as_the_reference(cap):
    """Skewed expert ids (token-major, k choices a token): each choice's
    rank among its expert's choices and ``rank < cap``, equal in both
    modes to the reference's cumsum and associative-scan forms."""
    rng = np.random.default_rng(cap)
    E = 8
    flat = rng.choice(E, 333, p=np.linspace(1, 8, E) / 36).astype(np.int64)
    onehot = jax.nn.one_hot(jnp.asarray(flat), E, dtype=jnp.int32)
    for mode, csum in (
            ("cumsum", jnp.cumsum(onehot, axis=0)),
            ("scan", jax.lax.associative_scan(jnp.add, onehot, axis=0))):
        want = np.asarray((csum * onehot).sum(-1) - 1)
        rank, keep = moe.dispatch(torch.from_numpy(flat), E, cap, mode)
        np.testing.assert_array_equal(rank.numpy(), want)
        np.testing.assert_array_equal(keep.numpy(), want < cap)


def test_capacity_is_the_reference_rule():
    cfg, rcfg = _cfgs("granite-moe-1b-a400m", cf=1.0)
    for T in (1, 3, 16, 17, 80, 2400):
        want = max(1, int(rcfg.capacity_factor * T * rcfg.top_k
                          / rcfg.n_experts), min(T, 16))
        assert moe.capacity(cfg, T) == want
    full = get_config("granite-moe-1b-a400m")
    assert moe.capacity(full, 4 * 600) == 750     # the card's prefill
    assert moe.capacity(full, 4) == 4             # a decode step


@pytest.mark.parametrize("mode", ["cumsum", "scan"])
@pytest.mark.parametrize("cf", [None, 1.0], ids=["no_drop", "cf1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(arch, cf, mode):
    cfg, rcfg = _cfgs(arch, cf, mode)
    p = _params(rcfg)
    jp, tp = _both(p)
    x = _x((2, 40, 64), 1)
    xj, xt = jnp.asarray(x, jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)
    out_r, aux_r = ref.moe_forward(jp, xj, rcfg, no_sharding())
    out_p, aux_p, routing = moe.moe_forward(tp, xt, cfg)
    assert out_p.dtype == torch.bfloat16 and out_p.shape == (2, 40, 64)
    np.testing.assert_allclose(float(aux_p), float(aux_r), rtol=1e-3)

    # the port's routing against the reference's, choice by choice
    logits, eidx_r, rank_r, keep_r = _ref_routing(jp, xj, rcfg)
    T, k = 80, cfg.top_k
    eidx_p = routing.experts.reshape(T, k)
    rank_p, keep_p = moe.dispatch(eidx_p.reshape(-1), cfg.n_experts,
                                  moe.capacity(cfg, T), mode)
    assert torch.equal(keep_p, routing.keep.reshape(-1))
    flipped = (eidx_p.numpy() != eidx_r).any(-1)
    for t in np.nonzero(flipped)[0]:
        assert _near_tie(logits[t], k), (t, logits[t])
    same = ~flipped & (rank_p.numpy() == rank_r).reshape(T, k).all(-1) \
        & (keep_p.numpy() == keep_r).reshape(T, k).all(-1)
    assert same.sum() >= T - 4, same.sum()
    if cf is not None:   # the drop rule runs: some choices are dropped
        assert (~keep_r).sum() > 0 and (~keep_p.numpy()).sum() > 0
    else:
        assert keep_r.all() and keep_p.numpy().all()
    want = np.asarray(out_r.astype(jnp.float32)).reshape(T, 64)
    got = out_p.float().numpy().reshape(T, 64)
    np.testing.assert_allclose(got[same], want[same], rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_both_dispatch_modes_give_the_same_output(arch):
    x = torch.from_numpy(_x((2, 40, 64), 2)).to(torch.bfloat16)
    outs = []
    for mode in ("cumsum", "scan"):
        cfg, rcfg = _cfgs(arch, 1.0, mode)
        _, tp = _both(_params(rcfg))
        outs.append(moe.moe_forward(tp, x, cfg))
    assert torch.equal(outs[0][0], outs[1][0])
    assert float(outs[0][1]) == float(outs[1][1])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][2], outs[1][2]))


def test_a_decode_sized_batch_drops_nothing():
    """At T <= 16 the capacity is at least T, so each token's output is
    the one it gets alone (the cache-free decode rule)."""
    cfg, rcfg = _cfgs("deepseek-moe-16b", 1.0)
    _, tp = _both(_params(rcfg))
    x = torch.from_numpy(_x((4, 1, 64), 3)).to(torch.bfloat16)
    out, _, routing = moe.moe_forward(tp, x, cfg)
    assert routing.keep.all()
    for b in range(4):
        alone, _, _ = moe.moe_forward(tp, x[b:b + 1], cfg)
        np.testing.assert_allclose(alone.float().numpy(),
                                   out[b:b + 1].float().numpy(),
                                   rtol=1e-2, atol=1e-2 * float(
                                       out.float().abs().max()))


@pytest.mark.parametrize("T", [4, 80])
def test_router_logits_keep_the_references_fp32_sums(T):
    """The router's logits are the reference's as XLA compiles its jitted
    step: ``(ht @ router).astype(float32)`` with the bf16 rounding between
    dropped (the cast fused into the dot), so fp32 sums within fp32
    rounding; rounded to bf16 first they differ by about 1e-3."""
    cfg, rcfg = _cfgs("granite-moe-1b-a400m")
    jp, tp = _both(_params(rcfg))
    ht = _x((T, 64), 5)
    want = jax.jit(lambda h, r: (h @ r.astype(h.dtype)).astype(jnp.float32))(
        jnp.asarray(ht, jnp.bfloat16), jp["router"])
    tp["router"] = tp["router"].to(torch.bfloat16)
    got = moe.route(tp, torch.from_numpy(ht).to(torch.bfloat16), cfg)[0]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
