"""The port's optimizer and train steps (``repro_torch.train``) against
the reference's, on the CPU, at the reduced gemma3-1b:

* ``lr_at`` at step 0, the end of the warmup, mid-decay and the last
  step: rtol 1e-6;
* ``adamw_update`` on the same fp32 params, gradients (their norm above
  the clip), mu and nu at step 5: params, mu, nu and ``grad_norm``
  within rtol 1e-6 and atol 1e-7 * max, leaf by leaf in the reference's
  flatten order;
* ``make_train_step`` plain, ``two_copy`` and ``cast_params_bf16``
  against the reference's jitted step from the same state and batch
  (``test_torch_train.both_steps``, at its 4 x 16 tokens):
  loss within rtol 1e-2, grad_norm within 2e-2, lr within 1e-6; new
  params within 2.5 lr of the reference's (AdamW's first step moves a
  param by lr times about the sign of its gradient, and a gradient near
  0 may take either sign in bf16), and each leaf's update within 1% of
  the reference's in norm and at a cosine of 0.9 or more with it (a
  lost update has no norm, a reversed one a cosine of -1); a two-copy
  state's cast tree the bf16 rounding of its new params, bit for bit,
  and within a bf16 step of the reference's;
* the same three steps with fp32 activations (both packages' ``_embed``
  and ``_encode`` patched, ``test_torch_train.float32_activations``),
  where the gradients are the reference's: the update within 0.1 lr
  element by element, mu and nu within 1e-4 and 2e-4 (4e-3 and 8e-3
  where the forward takes a bf16 copy), loss within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as ref_opt
from repro_torch.configs import get_config
from repro_torch.kernels.cases import lm_params
from repro_torch.train import AdamWConfig, adamw_update
from repro_torch.train.optimizer import TrainState, lr_at
from repro_torch.train.tree import leaves, unflatten_like
from test_torch_train import both_steps, hold_update

torch.set_num_threads(2)

NAME = "gemma3-1b"
OPT = dict(peak_lr=3e-4, warmup_steps=10, total_steps=50)


def _close(got, want, rtol, atol_rel, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("step", [0, 9, 10, 30, 49])
def test_lr_at_matches_the_reference(step):
    want = float(ref_opt.lr_at(ref_opt.AdamWConfig(**OPT), jnp.asarray(step)))
    got = lr_at(AdamWConfig(**OPT), torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def _random_tree(seed: int, scale: float):
    """lm_params' layout, every leaf N(0, scale^2) fp32."""
    rng = np.random.default_rng(seed)
    tree = lm_params(get_config(NAME).reduced(), 0)
    return unflatten_like(tree, [
        (rng.standard_normal(a.shape) * scale).astype(np.float32)
        for a in leaves(tree)])


def test_adamw_update_matches_the_reference():
    params, grads = _random_tree(1, 0.05), _random_tree(2, 0.01)
    mu, nu = _random_tree(3, 0.01), _random_tree(4, 0.01)
    nu = unflatten_like(nu, [np.abs(a) * 1e-2 for a in leaves(nu)])
    opt = dict(OPT, clip_norm=1.0)

    def jx(tree):
        return jax.tree.map(jnp.asarray, tree)

    def th(tree):
        return unflatten_like(tree, [torch.tensor(a) for a in leaves(tree)])
    ref_state = ref_opt.TrainState(jnp.asarray(5, jnp.int32), jx(params),
                                   jx(mu), jx(nu))
    want, want_m = ref_opt.adamw_update(ref_state, jx(grads),
                                        ref_opt.AdamWConfig(**opt))
    state = TrainState(torch.tensor(5, dtype=torch.int32), th(params),
                       th(mu), th(nu))
    got, got_m = adamw_update(state, th(grads), AdamWConfig(**opt))
    assert float(got_m["grad_norm"]) > 1.0   # the clip acts
    _close(got_m["grad_norm"], want_m["grad_norm"], 1e-6, 0)
    _close(got_m["lr"], want_m["lr"], 1e-6, 0)
    assert int(got.step) == 6 and got.step.dtype == torch.int32
    for tree in ("params", "mu", "nu"):
        g, w = leaves(getattr(got, tree)), jax.tree.leaves(getattr(want,
                                                                   tree))
        assert len(g) == len(w)
        for a, b in zip(g, w):
            _close(a.numpy(), b, 1e-6, 1e-7, tree)


MODES = ["plain", "two_copy", "cast_params_bf16"]


def _kw(mode):
    return {} if mode == "plain" else {mode: True}


def _hold_cast(got, want, lr):
    """A two-copy state's cast tree: the bf16 rounding of its new params
    bit for bit, and within a bf16 step (plus ``lr``) of the
    reference's."""
    for c, p, w in zip(leaves(got.cast), leaves(got.params),
                       jax.tree.leaves(want.cast)):
        assert c.dtype == torch.bfloat16
        assert torch.equal(c, p.to(torch.bfloat16))
        w = np.asarray(w.astype(jnp.float32))
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert (np.abs(c.float().numpy() - w) <= step + lr).all()


@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_the_references(mode):
    tree, (want, want_m), (got, got_m) = both_steps(NAME, OPT, **_kw(mode))
    _close(got_m["loss"], want_m["loss"], 1e-2, 0, "loss")
    _close(got_m["grad_norm"], want_m["grad_norm"], 2e-2, 0, "grad_norm")
    _close(got_m["lr"], want_m["lr"], 1e-6, 0, "lr")
    lr = float(want_m["lr"])
    for a, b, p in zip(leaves(got.params), jax.tree.leaves(want.params),
                       leaves(tree)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2.5 * lr)
        # the update's direction and size, leaf by leaf, in fp64
        d = a.numpy().astype(np.float64).ravel() - p.ravel()
        w = np.asarray(b, np.float64).ravel() - p.ravel()
        assert d @ w >= 0.9 * np.linalg.norm(d) * np.linalg.norm(w)
        np.testing.assert_allclose(np.linalg.norm(d), np.linalg.norm(w),
                                   rtol=1e-2)
    assert (got.cast is None) == (mode != "two_copy")
    if mode == "two_copy":
        _hold_cast(got, want, 2.5 * lr)


@pytest.mark.parametrize("mode", MODES)
def test_train_step_updates_as_the_references_with_fp32_activations(mode):
    """With fp32 activations the gradients are the reference's, so the
    step's update is held element by element (``hold_update``: within 0.1
    lr) and its moments tightly: mu within 1e-4 for fp32 params; where
    the forward takes a bf16 copy the gradients are bf16 and round a
    last bit apart where the fp32 sums straddle a rounding point, so mu
    within 4e-3 (one bf16 step is 2^-8)."""
    tree, (want, want_m), (got, got_m) = both_steps(NAME, OPT, True,
                                                    **_kw(mode))
    _close(got_m["loss"], want_m["loss"], 1e-5, 0, "loss")
    _close(got_m["grad_norm"], want_m["grad_norm"], 1e-4, 0, "grad_norm")
    _close(got_m["lr"], want_m["lr"], 1e-6, 0, "lr")
    lr = float(want_m["lr"])
    hold_update(tree, want, got, lr, 1e-4 if mode == "plain" else 4e-3)
    if mode == "two_copy":
        _hold_cast(got, want, 0.1 * lr)
