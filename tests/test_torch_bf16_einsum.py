"""``bf16_einsum``, the reference's bf16 score pipeline and bf16
unembedding operands, in the port against the reference on the CPU.

Where the flag acts, the port computes as the reference does:

* ``models.common.attention``: bf16 scores summed in fp32, softcap and
  mask in bf16, the max and the sum in fp32, ``exp`` and ``p / l`` in
  bf16, ``p @ v`` summed in fp32 (causal, windowed, softcapped, chunked
  and cross cases);
* ``Model._unembed``: the weights rounded to the activations' bf16, the
  products summed in fp32.

On seeded bf16 inputs the port's result lies within one bf16 step of
the reference's (jitted) and, in L2, at most a quarter as far from it
as the reference's own result without the flag (measured 0.06-0.12 of
it on the attention cases, 0 on the unembedding), so a port that
ignores the flag fails here.

Through whole reduced models (gemma3-1b, mamba2-780m, whisper-tiny with
the flag set) the forward logits and ``Model.loss`` are held at the LM
tolerance (rtol 2e-2, atol 2e-2 * max).  Measured, as a share of
max|logits|: 0.0212 / 0.0091 / 0.0045 (the reference's own result
without the flag: 0.0224 / 0.0016 / 0.0050), losses within 2.9e-4 /
3.9e-5 / 1.4e-6.  There the bf16 roundings that XLA and torch make apart
in every layer (1-2% of max|logits| through the reduced models)
are as large as the flag's effect, so the models are not where the flag
is told apart: every attention call and the unembedding of each model
are checked to receive it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer  # noqa: F401  (attaches memory_len)
from repro.configs import get_config as ref_get_config
from repro.models import common as ref_common
from repro.models.registry import build_model as ref_build_model
from repro.parallel.sharding import no_sharding
from repro.train.data import synthetic_batch as ref_synthetic_batch
from repro_torch.configs import get_config
from repro_torch.kernels.cases import LM_ATOL_REL, LM_RTOL, lm_memory, \
    lm_params
from repro_torch.models import build_model, common, params_from_reference
from repro_torch.models import transformer
from repro_torch.train import synthetic_batch
from repro_torch.train.tree import leaves, unflatten_like

torch.set_num_threads(2)

B, SQ, H, D, KV = 2, 24, 4, 32, 2
#: (case, attention keywords, key length): scores of std 9, so that
#: their rounding to bf16 moves the softmax.
CASES = (
    ("causal", dict(causal=True, window=None, softcap=None), SQ),
    ("window", dict(causal=True, window=8, softcap=None), SQ),
    ("softcap", dict(causal=True, window=None, softcap=20.0), SQ),
    ("chunked", dict(causal=True, window=None, softcap=None, chunk=8,
                     q_offset=3), SQ + 3),
    ("cross", dict(causal=False, window=None, softcap=None), 19),
)
#: The port's L2 distance from the reference's flagged result, at most
#: this share of the reference's own unflagged distance from it.
NEARER = 0.25
ARCHS = ("gemma3-1b", "mamba2-780m", "whisper-tiny")
PROMPTS, PROMPT_LEN = 3, 40
LOSS_BATCH, LOSS_SEQ = 2, 16


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, held as fp32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _inputs(skv: int):
    rng = np.random.default_rng(0)
    q = _bf16(3 * rng.standard_normal((B, SQ, H, D)))
    k = _bf16(3 * rng.standard_normal((B, skv, KV, D)))
    v = _bf16(rng.standard_normal((B, skv, KV, D)))
    return q, k, v


def _reference_attention(q, k, v, flag: bool, kw) -> np.ndarray:
    fn = jax.jit(lambda a, b, c: ref_common.attention(
        a, b, c, bf16_einsum=flag, **kw))
    out = fn(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    return np.asarray(out.astype(jnp.float32))


def _hold(got, want, unflagged, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=LM_RTOL,
                               atol=LM_ATOL_REL * scale, err_msg=what)
    near = np.linalg.norm(got - want)
    far = np.linalg.norm(unflagged - want)
    assert far > 0 and near <= NEARER * far, (what, near, far)


@pytest.mark.parametrize("name, kw, skv", CASES, ids=[c[0] for c in CASES])
def test_attention_bf16_einsum_is_the_references(name, kw, skv):
    q, k, v = _inputs(skv)
    got = common.attention(*(torch.from_numpy(a).to(torch.bfloat16)
                             for a in (q, k, v)), bf16_einsum=True, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (B, SQ, H, D)
    want = _reference_attention(q, k, v, True, kw)
    # within one bf16 step of the output's scale
    assert np.abs(got.float().numpy() - want).max() \
        <= 2.0 ** -7 * np.abs(want).max(), name
    _hold(got.float().numpy(), want, _reference_attention(q, k, v, False,
                                                          kw), name)


@pytest.mark.parametrize("untied", (False, True), ids=("tied", "untied"))
def test_unembed_bf16_einsum_is_the_references(untied):
    """fp32 weights rounded to the bf16 activations' dtype, products
    summed in fp32, then the softcap: the port's logits equal the
    reference's to fp32 rounding, and the flag's rounding is there."""
    rng = np.random.default_rng(1)
    d, vocab = 64, 300
    x = _bf16(rng.standard_normal((2, 5, d)))
    w = rng.standard_normal((vocab, d)).astype(np.float32)
    params = {"embed": w}
    if untied:
        params["unembed"] = rng.standard_normal((vocab, d)).astype(
            np.float32)
    out = {}
    for flag in (True, False):
        rcfg = dataclasses.replace(ref_get_config("gemma3-1b").reduced(),
                                   bf16_einsum=flag)
        cfg = dataclasses.replace(get_config("gemma3-1b").reduced(),
                                  bf16_einsum=flag)
        assert rcfg.logit_softcap == cfg.logit_softcap
        model = ref_build_model(rcfg)
        out["ref", flag] = np.asarray(jax.jit(
            lambda p, a: model._unembed(p, a, no_sharding()))(
            {k: jnp.asarray(a) for k, a in params.items()},
            jnp.asarray(x, jnp.bfloat16)))
        out["port", flag] = build_model(cfg)._unembed(
            {k: torch.from_numpy(a) for k, a in params.items()},
            torch.from_numpy(x).to(torch.bfloat16)).numpy()
    want = out["ref", True]
    assert out["port", True].dtype == np.float32
    np.testing.assert_allclose(out["port", True], want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    _hold(out["port", True], want, out["ref", False], "unembed")


def _prompts(vocab: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    return rng.integers(1, vocab, (PROMPTS, PROMPT_LEN)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def flagged(request):
    """One reduced arch with ``bf16_einsum`` set: the reference's jitted
    forward logits and loss, and the port's model and params."""
    arch = request.param
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(),
                               bf16_einsum=True)
    cfg = dataclasses.replace(get_config(arch).reduced(), bf16_einsum=True)
    tree = lm_params(cfg, 0)
    mem = lm_memory(cfg, 0, PROMPTS)
    jtree = jax.tree.map(jnp.asarray, tree)
    rmodel = ref_build_model(rcfg)
    toks = jnp.asarray(_prompts(cfg.vocab))
    jmem = None if mem is None else jnp.asarray(mem)
    logits, _ = jax.jit(lambda p, t, m: rmodel.forward(p, t, memory=m))(
        jtree, toks, jmem)
    last = jax.jit(lambda p, t, m: rmodel.prefill(
        p, t, memory=m, cache_len=PROMPT_LEN)[0])(jtree, toks, jmem)
    loss, _ = jax.jit(rmodel.loss)(
        jtree, ref_synthetic_batch(rcfg, LOSS_BATCH, LOSS_SEQ, 0))
    return {"cfg": cfg, "tree": tree, "logits": np.asarray(logits),
            "prefill": np.asarray(last),
            "loss": float(loss), "model": build_model(cfg),
            "params": params_from_reference(cfg, tree, "cpu"),
            "memory": None if mem is None else torch.from_numpy(mem)}


def test_a_flagged_model_holds_the_references_logits(flagged):
    """``forward``'s logits at every position and ``prefill``'s at the
    last."""
    toks = torch.from_numpy(_prompts(flagged["cfg"].vocab))
    model, params = flagged["model"], flagged["params"]
    with torch.no_grad():
        logits, _ = model.forward(params, toks, memory=flagged["memory"])
        last, _, cur = model.prefill(params, toks, cache_len=PROMPT_LEN,
                                     memory=flagged["memory"])
    assert cur == PROMPT_LEN
    for got, want in ((logits, flagged["logits"]),
                      (last, flagged["prefill"])):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=LM_RTOL,
                                   atol=LM_ATOL_REL
                                   * float(np.abs(want).max()))


def test_a_flagged_model_holds_the_references_loss(flagged):
    cfg, tree = flagged["cfg"], flagged["tree"]
    params = unflatten_like(tree, [torch.tensor(a) for a in leaves(tree)])
    with torch.no_grad():
        loss, _ = flagged["model"].loss(
            params, synthetic_batch(cfg, LOSS_BATCH, LOSS_SEQ, 0))
    np.testing.assert_allclose(float(loss), flagged["loss"], rtol=1e-3)


def test_a_flagged_model_hands_the_flag_to_attention_and_unembed(
        flagged, monkeypatch):
    """Every attention call (self, cross memory, encoder) and the
    unembedding of a forward pass run with the flag."""
    flags, unembeds = [], []
    attention = transformer.attention

    def spy(*args, bf16_einsum=False, **kw):
        flags.append(bf16_einsum)
        return attention(*args, bf16_einsum=bf16_einsum, **kw)
    monkeypatch.setattr(transformer, "attention", spy)
    model = flagged["model"]
    unembed = transformer.Model._unembed

    def spy_unembed(self, params, x):
        unembeds.append(self.cfg.bf16_einsum)
        return unembed(self, params, x)
    monkeypatch.setattr(transformer.Model, "_unembed", spy_unembed)
    with torch.no_grad():
        model.forward(flagged["params"], torch.from_numpy(_prompts(
            flagged["cfg"].vocab)), memory=flagged["memory"])
    cfg = flagged["cfg"]
    assert unembeds == [True]
    assert all(flags)
    if cfg.name.startswith("mamba2"):
        assert flags == []
    else:
        assert len(flags) >= cfg.n_layers
