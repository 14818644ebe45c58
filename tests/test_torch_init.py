"""``Model.init`` and the initialisers of the port (``models/common.py``,
``rglru``, ``mamba2``, ``moe``, ``transformer``) against the reference's
``Model.init``, on the CPU, for the reduced variant of every registered
config: the same tree (keys, nesting, the ``lead`` / ``groups`` /
``rem`` / ``encoder`` layout), shapes and dtypes as the reference's
``jax.eval_shape``; and each tensor drawn from the reference's
distribution, held against the reference's own draw: zeros and ones
exactly, every drawn tensor's mean and standard deviation within five
standard errors of the difference from the reference's, ``lru_lambda``
inside [0.9, 0.999).
The JAX PRNG cannot be reproduced, so the values differ.  Then the tree
serves: ``params_from_reference`` of it runs ``forward``.  The
distribution of ``cases.lm_params`` (the recipe both sides are fed) is
held the same way, but its norm scales, which it draws on purpose.
"""
import jax
import numpy as np
import pytest
import torch

import repro.models.transformer  # noqa: F401  (attaches memory_len)
from repro.configs import ARCH_REGISTRY as REF_REGISTRY
from repro.configs import get_config as ref_get_config
from repro.models.registry import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.kernels.cases import lm_params
from repro_torch.models import build_model, params_from_reference

torch.set_num_threads(2)

NAMES = sorted(REF_REGISTRY)


def _leaves(tree):
    return jax.tree.leaves_with_path(tree, is_leaf=torch.is_tensor)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module", params=NAMES)
def trees(request):
    name = request.param
    cfg = get_config(name).reduced()
    rmodel = ref_build_model(ref_get_config(name).reduced())
    want = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(0)))
    have = build_model(cfg).init(torch.Generator().manual_seed(0))
    return cfg, want, have


def test_init_has_the_reference_keys_shapes_and_dtypes(trees):
    cfg, want, have = trees
    hs, ws = _leaves(have), _leaves(want)
    assert [jax.tree_util.keystr(p) for p, _ in hs] \
        == [jax.tree_util.keystr(p) for p, _ in ws]
    for (path, h), (_, w) in zip(hs, ws):
        assert tuple(h.shape) == w.shape, jax.tree_util.keystr(path)
        assert h.dtype == torch.float32 and w.dtype == np.float32
    assert isinstance(have["groups"], tuple) \
        and isinstance(have["rem"], tuple)


def _same_distribution(h, w, where):
    if w.size == 0:
        return
    if not w.std():   # a constant: zeros or ones
        np.testing.assert_array_equal(h, w, err_msg=where)
        return
    if where.endswith("['lru_lambda']"):
        assert 0.9 <= h.min() and h.max() < 0.999, where
        assert abs(h.mean() - w.mean()) < 0.01, where
        return
    n = w.size
    # five standard errors of the difference of two samples' means and
    # stds (normal draws)
    assert abs(h.mean() - w.mean()) <= 5 * w.std() * np.sqrt(2 / n), where
    assert abs(h.std() / w.std() - 1) <= 5 / np.sqrt(n) + 1e-3, where


def test_init_draws_the_reference_distributions(trees):
    _, want, have = trees
    for (path, h), (_, w) in zip(_leaves(have), _leaves(want)):
        _same_distribution(_np(h), _np(w), jax.tree_util.keystr(path))
    again = build_model(trees[0]).init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(have, is_leaf=torch.is_tensor),
        jax.tree.leaves(again, is_leaf=torch.is_tensor)))


def test_the_recipe_has_the_layout_and_scales_of_init(trees):
    """``cases.lm_params`` for every kind: the reference's tree, and each
    weight at its init's scale (norm scales drawn on purpose)."""
    cfg, want, _ = trees
    recipe = lm_params(cfg, 0)
    rs, ws = _leaves(recipe), _leaves(want)
    assert [jax.tree_util.keystr(p) for p, _ in rs] \
        == [jax.tree_util.keystr(p) for p, _ in ws]
    for (path, r), (_, w) in zip(rs, ws):
        where = jax.tree_util.keystr(path)
        assert r.shape == w.shape and r.dtype == np.float32, where
        if "ln']['" in where:   # a norm's scale or bias
            assert r.std() > 0, where
        else:
            _same_distribution(r, w, where)


def test_an_initialised_model_serves(trees):
    cfg, _, have = trees
    params = params_from_reference(cfg, have, "cpu")
    model = build_model(cfg)
    memory = None
    if cfg.memory_len():
        memory = torch.randn((2, cfg.memory_len(), cfg.d_model),
                             generator=torch.Generator().manual_seed(1))
    logits, _ = model.forward(params, torch.tensor([[1, 2, 3], [4, 5, 6]]),
                              memory=memory)
    assert logits.shape == (2, 3, cfg.vocab)
    assert torch.isfinite(logits).all()


def test_meta_init_gives_full_width_shapes_without_memory():
    """On the meta device ``init`` draws nothing: the full-width trees
    of every config, as big as 90 B parameters, cost no memory; their
    embedding and layer count are the config's."""
    for name in NAMES:
        cfg = get_config(name)
        tree = build_model(cfg).init(torch.Generator(), device="meta")
        assert tree["embed"].shape == (cfg.vocab, cfg.d_model)
        assert tree["embed"].device.type == "meta"
        lead = len(tree.get("lead", ()))
        g = jax.tree.leaves(tree["groups"][0], is_leaf=torch.is_tensor)[0]
        n = lead + g.shape[0] * len(cfg.pattern) + len(tree["rem"])
        assert n == cfg.n_layers, name
