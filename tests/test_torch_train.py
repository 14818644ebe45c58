"""The port's training path (``repro_torch.train``, ``Model.loss``)
against the reference's, on the CPU, for one reduced config of every
block and FFN kind: gemma3-1b (local/global attention), recurrentgemma-2b
(the LRU scan), granite-moe-1b-a400m (MoE), deepseek-moe-16b (a leading
dense layer, a shared expert), mamba2-780m (chunked SSD), whisper-tiny
(an encoder, cross blocks, LayerNorm) and llama-3.2-vision-90b (cross
blocks over image tokens, an untied unembedding).

Both take the same params (``cases.lm_params(cfg, 0)``, numpy) and the
same batch (``synthetic_batch``, held bitwise here).  The reference runs
``jax.jit(jax.value_and_grad(Model.loss))`` once a config (a
module-scoped fixture).  Held:

* ``Model.loss`` (``loss``, ``ce``, ``aux``) within rtol 1e-2;
* every gradient leaf with fp32 activations (the reference's and the
  port's ``_embed`` / ``_encode`` cast to fp32 instead of bf16, the only
  two places either sets the activations' dtype) within the serve
  tolerance, rtol 2e-2 and atol 2e-2 * max|leaf|: the same function,
  differentiated the same way;
* every gradient leaf on the bf16 path as near the exact gradient (the
  fp32 one above) as the reference's bf16 gradient is, within a factor
  of 2 in L2 norm.  The serve tolerance does not hold element by element
  between bf16 gradients that round at other places: the reference
  against itself compiled with ``--xla_allow_excess_precision=false``
  moves up to 1.84x it, and its bf16 gradients lie up to 3.5x it from
  its fp32 ones (reduced gemma3-1b); in L2 norm the
  port's and the reference's lie 0.4-5.4% from the exact gradient, the
  port at most 1.44x the reference.  An MoE config's routing is read
  out of both runs (``test_torch_moe.reference_routes``), and its batch
  (:data:`BATCH_SEEDS`) is one at which every token routes alike in
  bf16 and in fp32 (asserted);
* every remat policy's gradients equal ``"none"``'s bitwise;
* 4 microbatches against 1: new params and moments within rtol/atol
  2e-4 (the reference's ``tests/test_train.py:32-41``), for the configs
  without MoE; an MoE aux loss is a mean over the microbatch's tokens,
  another function of the batch, so an MoE config's 4 microbatches are
  held against the reference's own 4, with fp32 activations: the
  update within 0.1 lr element by element, mu within 1e-4 and nu
  within 2e-4;
* ``make_train_step``'s metrics: loss within 1e-2, grad_norm within
  2e-2 of the reference's global norm of its gradients, lr within 1e-6.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as ref_transformer
from repro.configs import get_config as ref_get_config
from repro.models.registry import build_model as ref_build_model
from repro.train.data import synthetic_batch as ref_synthetic_batch
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.optimizer import global_norm as ref_global_norm
from repro.train.optimizer import init_state as ref_init_state
from repro.train.optimizer import lr_at as ref_lr_at
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.kernels.cases import lm_params, route_codes, routed_apart
from repro_torch.models import build_model
from repro_torch.models import transformer
from repro_torch.train import (AdamWConfig, init_state, make_train_step,
                               synthetic_batch)
from repro_torch.train.tree import leaves, leaves_with_paths, unflatten_like
from test_torch_moe import reference_routes, routing_of

torch.set_num_threads(2)

ARCHS = ("gemma3-1b", "recurrentgemma-2b", "granite-moe-1b-a400m",
         "deepseek-moe-16b", "mamba2-780m", "whisper-tiny",
         "llama-3.2-vision-90b")
B, S = 4, 16
LOSS_RTOL = 1e-2
RTOL = ATOL_REL = 2e-2


#: The batch seed of each config (``synthetic_batch(..., seed)``): 0, but
#: 1 for the MoE configs, whose bf16 runs route one token of seed 0's 64
#: apart (a near tie of the router, ``cases.routed_apart``), which moves
#: every gradient; at seed 1 every token routes alike (asserted).
BATCH_SEEDS = {"granite-moe-1b-a400m": 1, "deepseek-moe-16b": 1}


def batch_seed(name: str) -> int:
    return BATCH_SEEDS.get(name, 0)


def ref_key(path) -> str:
    return "|".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def numpy_batch(batch) -> dict:
    """A batch's arrays as numpy, bf16 as its raw 16-bit payload."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            v = v.view(torch.int16) if v.dtype == torch.bfloat16 else v
            out[k] = v.numpy()
        else:
            v = np.asarray(v)
            out[k] = v.view(np.int16) if v.dtype == jnp.bfloat16 else v
    return out


class _Float32Activations:
    """``jax.numpy`` with ``bfloat16`` standing for ``float32``: put in
    the reference's ``transformer`` module, its ``_embed`` and
    ``_encode`` cast the activations to fp32."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def float32_activations():
    """Both models' activations in fp32 while open."""
    saved = ref_transformer.jnp, transformer.ACT_DTYPE
    ref_transformer.jnp = _Float32Activations()
    transformer.ACT_DTYPE = torch.float32
    try:
        yield
    finally:
        ref_transformer.jnp, transformer.ACT_DTYPE = saved


def reference_run(name: str, f32: bool = False) -> dict:
    """The reference's jitted ``value_and_grad(Model.loss)`` on
    ``lm_params(cfg, 0)`` and its batch (``synthetic_batch`` at step 0
    and :func:`batch_seed`): loss, ce, aux, the gradients by key, and an
    MoE config's routing codes."""
    rcfg = ref_get_config(name).reduced()
    model = ref_build_model(rcfg)
    batch = ref_synthetic_batch(rcfg, B, S, 0, batch_seed(name))
    ctx = float32_activations() if f32 else contextlib.nullcontext()
    with ctx, reference_routes(rcfg) as calls:
        if f32 and "memory" in batch:
            batch["memory"] = batch["memory"].astype(jnp.float32)
        tree = jax.tree.map(jnp.asarray, lm_params(rcfg, 0))
        fn = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss(p, b, remat_policy="none"),
            has_aux=True))
        (loss, metrics), grads = fn(tree, batch)
        jax.effects_barrier()
        routes = [routing_of(c, B, rcfg) for c in calls]
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return {"loss": float(loss), "ce": float(metrics["ce"]),
            "aux": float(metrics["aux"]),
            "grads": {ref_key(p): np.asarray(g) for p, g in flat},
            "grad_norm": float(ref_global_norm(grads)),
            "batch": numpy_batch(batch),
            "routes": route_codes(routes) if routes else None}


def port_run(name: str, f32: bool = False, remat: str = "none") -> dict:
    """The port's ``Model.loss`` and its gradients by autograd, on the
    same params and batch, as :func:`reference_run` returns them."""
    cfg = get_config(name).reduced()
    model = build_model(cfg)
    batch = synthetic_batch(cfg, B, S, 0, batch_seed(name))
    tree = lm_params(cfg, 0)
    ctx = float32_activations() if f32 else contextlib.nullcontext()
    with ctx:
        if f32 and "memory" in batch:
            batch["memory"] = batch["memory"].float()
        live = [torch.tensor(a, requires_grad=True) for a in leaves(tree)]
        params = unflatten_like(tree, live)
        loss, metrics = model.loss(params, batch, remat_policy=remat)
        grads = torch.autograd.grad(loss, live)
        routes = []
        if cfg.n_experts:
            with torch.no_grad():
                model.forward(transformer.train_params(cfg, params),
                              batch["tokens"], routes=routes)
    return {"loss": float(loss.detach()), "ce": float(metrics["ce"].detach()),
            "aux": float(metrics["aux"].detach()),
            "grads": {"|".join(p): g for (p, _), g in
                      zip(leaves_with_paths(tree), grads)},
            "batch": numpy_batch(batch),
            "routes": route_codes(routes) if routes else None}


_RUNS: dict = {}


def run(side: str, name: str, f32: bool = False) -> dict:
    """Each run once a session."""
    key = (side, name, f32)
    if key not in _RUNS:
        _RUNS[key] = (reference_run if side == "ref" else port_run)(
            name, f32)
    return _RUNS[key]


@pytest.mark.parametrize("name", ARCHS)
def test_synthetic_batch_is_the_references_bitwise(name):
    """Tokens, labels and (VLM, audio) bf16 memory, bit for bit, at two
    steps and two seeds."""
    cfg, rcfg = get_config(name).reduced(), ref_get_config(name).reduced()
    for step, seed in ((0, 0), (17, 3)):
        want = numpy_batch(ref_synthetic_batch(rcfg, B, S, step, seed))
        got = numpy_batch(synthetic_batch(cfg, B, S, step, seed))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ("memory" in want) == bool(cfg.memory_len())


@pytest.mark.parametrize("name", ARCHS)
def test_loss_matches_the_reference(name):
    ref, port = run("ref", name), run("port", name)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(port[k], ref[k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    assert (ref["aux"] > 0) == bool(get_config(name).n_experts)


@pytest.mark.parametrize("name", ARCHS)
def test_fp32_gradients_match_the_reference_leaf_by_leaf(name):
    """With fp32 activations every gradient leaf is the reference's
    within the serve tolerance, element by element."""
    ref, port = run("ref", name, True), run("port", name, True)
    if ref["routes"] is not None:
        assert not routed_apart(port["routes"], ref["routes"]).any()
    assert sorted(port["grads"]) == sorted(ref["grads"])
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)
    for k, want in ref["grads"].items():
        got = port["grads"][k].numpy()
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=ATOL_REL * np.abs(want).max(),
                                   err_msg=k)


DENSE = tuple(n for n in ARCHS if not get_config(n).n_experts)
MOE = tuple(n for n in ARCHS if get_config(n).n_experts)


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_gradients_are_as_near_the_exact_ones_as_the_references(name):
    """Each bf16 gradient leaf lies within twice the reference's bf16
    distance of the exact (fp32) gradient, in L2 norm; an MoE config's
    bf16 runs route every token alike."""
    ref, port = run("ref", name), run("port", name)
    if ref["routes"] is not None:
        assert not routed_apart(port["routes"], ref["routes"]).any()
    exact = run("ref", name, True)["grads"]
    assert sorted(port["grads"]) == sorted(exact)
    for k, want in exact.items():
        got = port["grads"][k].numpy()
        assert got.shape == want.shape, k
        ref_err = np.linalg.norm(ref["grads"][k] - want)
        assert np.linalg.norm(got - want) <= 2 * ref_err, k


@pytest.mark.parametrize("name", ARCHS)
def test_remat_policies_give_the_same_gradients_bitwise(name):
    base = run("port", name)["grads"]
    for policy in ("nothing", "dots", "unknown-name"):
        grads = port_run(name, remat=policy)["grads"]
        for k, g in base.items():
            assert torch.equal(grads[k], g), (policy, k)


def both_steps(name: str, opt: dict, f32: bool = False, **kw):
    """One step of the reference's jitted ``make_train_step`` and of the
    port's, each with ``opt`` and ``kw``, from ``lm_params(cfg, 0)`` and
    the config's batch: ``(tree, (ref state, metrics), (port state,
    metrics))``."""
    cfg, rcfg = get_config(name).reduced(), ref_get_config(name).reduced()
    tree = lm_params(cfg, 0)
    two_copy = kw.get("two_copy", False)
    ctx = float32_activations() if f32 else contextlib.nullcontext()
    with ctx:
        rbatch = ref_synthetic_batch(rcfg, B, S, 0, batch_seed(name))
        batch = synthetic_batch(cfg, B, S, 0, batch_seed(name))
        if f32 and "memory" in batch:
            rbatch["memory"] = rbatch["memory"].astype(jnp.float32)
            batch["memory"] = batch["memory"].float()
        ref_step = jax.jit(ref_make_train_step(
            ref_build_model(rcfg), opt=RefAdamWConfig(**opt), **kw))
        want = ref_step(ref_init_state(jax.tree.map(jnp.asarray, tree),
                                       two_copy=two_copy), rbatch)
        state = init_state(unflatten_like(
            tree, [torch.tensor(a) for a in leaves(tree)]), two_copy=two_copy)
        got = make_train_step(build_model(cfg), opt=AdamWConfig(**opt),
                              **kw)(state, batch)
    return tree, want, got


def hold_update(tree, want, got, lr: float, tol: float) -> None:
    """``got``'s params moved from ``tree``'s as ``want``'s did, within
    0.1 ``lr`` element by element (AdamW moves each by about ``lr``, so
    a lost update misses by ``lr`` and a reversed one by ``2 lr``); its
    mu within rtol ``tol`` and atol ``tol`` * max|leaf| of ``want``'s,
    its nu (squares) within ``2 tol``."""
    for a, b, p in zip(leaves(got.params), jax.tree.leaves(want.params),
                       leaves(tree)):
        np.testing.assert_allclose(a.numpy() - p, np.asarray(b) - p,
                                   rtol=0, atol=0.1 * lr)
    for name, t in (("mu", tol), ("nu", 2 * tol)):
        for a, b in zip(leaves(getattr(got, name)),
                        jax.tree.leaves(getattr(want, name))):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=t,
                                       atol=t * np.abs(b).max(),
                                       err_msg=name)


def _state(name):
    cfg = get_config(name).reduced()
    tree = lm_params(cfg, 0)
    return init_state(unflatten_like(
        tree, [torch.tensor(a) for a in leaves(tree)]))


@pytest.mark.parametrize("name", DENSE)
def test_microbatches_match_the_full_batch(name):
    """4 microbatches of 1 row against the batch of 4: new params, mu
    and nu within rtol/atol 2e-4."""
    cfg = get_config(name).reduced()
    model = build_model(cfg)
    batch = synthetic_batch(cfg, B, S, 0, batch_seed(name))
    full, m_full = make_train_step(model)(_state(name), batch)
    mb, m_mb = make_train_step(model, microbatches=4)(_state(name), batch)
    for tree in ("params", "mu", "nu"):
        for a, b in zip(leaves(getattr(full, tree)),
                        leaves(getattr(mb, tree))):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4,
                                       atol=2e-4, err_msg=tree)
    np.testing.assert_allclose(float(m_mb["loss"]), float(m_full["loss"]),
                               rtol=2e-4)


@pytest.mark.parametrize("name", MOE)
def test_moe_microbatches_match_the_references(name):
    """An MoE config's 4 microbatches against the reference's own 4 (its
    aux loss is a mean over a microbatch's tokens, so the full batch is
    another function), with fp32 activations: the update within 0.1 lr
    of the reference's, mu within rtol/atol 1e-4 and nu within 2e-4,
    loss within 1e-5."""
    opt = dict(peak_lr=3e-4, warmup_steps=10, total_steps=50)
    tree, (want, want_m), (got, got_m) = both_steps(name, opt, True,
                                                    microbatches=4)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=1e-5)
    hold_update(tree, want, got, float(want_m["lr"]), 1e-4)


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_metrics_match_the_reference(name):
    cfg = get_config(name).reduced()
    ref = run("ref", name)
    opt = AdamWConfig()
    state, metrics = make_train_step(build_model(cfg), opt=opt)(
        _state(name), synthetic_batch(cfg, B, S, 0, batch_seed(name)))
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               ref["grad_norm"], rtol=RTOL)
    np.testing.assert_allclose(float(metrics["lr"]),
                               float(ref_lr_at(RefAdamWConfig(), 0)),
                               rtol=1e-6)
    assert int(state.step) == 1 and state.step.dtype == torch.int32
