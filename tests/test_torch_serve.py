"""The port's LM stack (``repro_torch.configs``, ``models``, ``serve``)
against the reference's, on the CPU, at reduced width.

gemma3-1b's and gemma2-2b's ``reduced()`` configs (6 and 2 layers, d 64,
vocab 256, window 32; gemma2-2b with its attention and logit softcaps)
run with two sets of params: the reference's own ``Model.init(PRNGKey)``
carried across by ``params_from_reference``, and the numpy recipe
``repro_torch.kernels.cases.lm_params`` fed to both.  Held, each within
rtol 2e-2 and atol 2e-2 * max|logits| (bf16 activations: XLA and torch
round some bf16 steps apart, so logits agree to bf16 tolerance, not
bitwise):

* ``forward`` logits on 3 left-padded prompts;
* ``prefill`` logits of the last position and every layer's cache (the
  local rings rolled so slot t % 32 holds token t: the 40-token prompt
  wraps them);
* 8 ``decode_step``s teacher-forced on the reference's generated tokens;
* ``ServingEngine.generate`` (3 prompts of 40, 9 and 21 tokens,
  left-padded with token 0, 8 new tokens): tokens equal wherever the
  reference's top-2 margin exceeds twice the tolerance; after a token
  that a near tie flipped, the rest of that row is not compared;
* a global cache shorter than prompt + max_new, where both drop the
  tokens past its end.

Also: ``get_config`` and ``reduced()`` give the reference's fields for
every registered name, the recipe's tree has ``Model.init``'s layout,
``generate`` records the reference's spans, and what the port does not
run yet (training: ``Model.loss``) raises for the configs of every new
block kind, which build.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer  # noqa: F401  (attaches memory_len)
from repro.configs import ARCH_REGISTRY as REF_REGISTRY
from repro.configs import get_config as ref_get_config
from repro.models.registry import build_model as ref_build_model
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch.configs import ARCH_REGISTRY, get_config
from repro_torch.kernels.cases import lm_params
from repro_torch.models import build_model, params_from_reference
from repro_torch.models.transformer import layer_kinds, layers_from_tree
from repro_torch.obs.spans import active, collect
from repro_torch.serve import ServingEngine
from repro_torch.train import synthetic_batch
from repro_torch.train.tree import leaves, unflatten_like

torch.set_num_threads(2)

ARCHS = ("gemma3-1b", "gemma2-2b")
SOURCES = ("init", "recipe")
PROMPT_LENS = (40, 9, 21)
CACHE_LEN, MAX_NEW = 48, 8
RTOL = ATOL_REL = 2e-2


def _close(got, want, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(want).max()),
                               err_msg=what)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in PROMPT_LENS]


def _padded(prompts):
    L = max(len(p) for p in prompts)
    return np.asarray([[0] * (L - len(p)) + p for p in prompts], np.int32)


def _assert_tokens_agree(got, want, step_logits):
    """Greedy tokens ``got`` equal the reference's ``want`` at every step
    whose reference top-2 margin exceeds twice the tolerance; the rest of
    a row after a flipped near tie is not compared."""
    for b, (g_row, w_row) in enumerate(zip(got, want)):
        for t, (g, w) in enumerate(zip(g_row, w_row)):
            if g == w:
                continue
            logits = step_logits[t][b]
            top2 = np.sort(logits)[-2:]
            tol = ATOL_REL * float(np.abs(step_logits[t]).max()) \
                + RTOL * abs(float(top2[1]))
            assert top2[1] - top2[0] <= 2 * tol, (b, t, g_row, w_row)
            break


class _Reference:
    """The reference model of one reduced config with its jitted serve
    functions (compiled once per shape and reused for both params)."""

    def __init__(self, arch: str, cache_len: int = CACHE_LEN):
        self.arch = arch
        self.cfg = ref_get_config(arch).reduced()
        self.model = ref_build_model(self.cfg)
        self.engine = RefEngine(self.model, None, cache_len=cache_len)
        self.forward = jax.jit(lambda p, t: self.model.forward(p, t)[0])
        self.runs = {}

    def tree(self, source: str):
        if source == "init":
            return jax.tree.map(np.asarray,
                                self.model.init(jax.random.PRNGKey(0)))
        return lm_params(get_config(self.arch).reduced(), 0)

    def run(self, source: str, prompts):
        """forward and prefill logits, caches, the generated tokens, and
        the logits of every step teacher-forced on them."""
        key = (source, tuple(map(tuple, prompts)))
        if key in self.runs:
            return self.runs[key]
        tree = self.tree(source)
        jtree = jax.tree.map(jnp.asarray, tree)
        toks = jnp.asarray(_padded(prompts))
        self.engine.params = jtree
        gen = self.engine.generate(prompts, max_new=MAX_NEW)
        logits, caches, cur = self.engine.prefill(jtree, toks)
        out = {"tree": tree, "gen": gen, "cur": int(cur),
               "forward": np.asarray(self.forward(jtree, toks)),
               "caches": layers_from_tree(self.cfg, jax.tree.map(
                   lambda a: np.asarray(a.astype(jnp.float32)), caches)),
               "steps": [np.asarray(logits)]}
        for t in range(MAX_NEW):
            tok = jnp.asarray([row[t] for row in gen], jnp.int32)
            logits, caches, cur = self.engine.decode(jtree, caches, tok, cur)
            out["steps"].append(np.asarray(logits))
        self.runs[key] = out
        return out


@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(arch, cache_len=CACHE_LEN):
        if (arch, cache_len) not in cache:
            cache[arch, cache_len] = _Reference(arch, cache_len)
        return cache[arch, cache_len]
    return get


def _port(arch, tree):
    cfg = get_config(arch).reduced()
    return cfg, build_model(cfg), params_from_reference(cfg, tree, "cpu")


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, source, reference):
    ref = reference(arch)
    prompts = _prompts(ref.cfg.vocab)
    r = ref.run(source, prompts)
    _, model, params = _port(arch, r["tree"])
    logits, aux = model.forward(params, torch.from_numpy(_padded(prompts)))
    assert logits.dtype == torch.float32 and aux == 0.0
    assert logits.shape == r["forward"].shape == (3, 40, 256)
    _close(logits.numpy(), r["forward"])


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_reference(arch, source, reference):
    ref = reference(arch)
    prompts = _prompts(ref.cfg.vocab)
    r = ref.run(source, prompts)
    cfg, model, params = _port(arch, r["tree"])
    logits, caches, cur = model.prefill(
        params, torch.from_numpy(_padded(prompts)), cache_len=CACHE_LEN)
    assert cur == r["cur"] == 40
    _close(logits.numpy(), r["steps"][0], "prefill logits")
    kinds = layer_kinds(cfg)
    assert len(caches) == len(r["caches"]) == cfg.n_layers == len(kinds)
    # the caches are one output, as the logits are: atol 2e-2 times the
    # largest |K| or |V| of any layer
    scale = max(float(np.abs(c).max()) for kv in r["caches"] for c in kv)
    for i, (kind, have, want) in enumerate(zip(kinds, caches, r["caches"])):
        slots = cfg.window if kind == "local" else CACHE_LEN
        assert have.k.shape == want.k.shape == (3, slots, cfg.n_kv_heads,
                                                cfg.head_dim)
        assert have.k.dtype == have.v.dtype == torch.bfloat16
        for name, h, w in (("k", have.k, want.k), ("v", have.v, want.v)):
            np.testing.assert_allclose(h.float().numpy(), w, rtol=RTOL,
                                       atol=ATOL_REL * scale,
                                       err_msg=f"layer {i} {name}")


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference_teacher_forced(arch, source,
                                                     reference):
    ref = reference(arch)
    prompts = _prompts(ref.cfg.vocab)
    r = ref.run(source, prompts)
    _, model, params = _port(arch, r["tree"])
    _, caches, cur = model.prefill(params, torch.from_numpy(_padded(prompts)),
                                   cache_len=CACHE_LEN)
    for t in range(MAX_NEW):
        tok = torch.tensor([row[t] for row in r["gen"]])
        logits, caches, cur = model.decode_step(params, caches, tok, cur)
        assert cur == 41 + t
        _close(logits.numpy(), r["steps"][t + 1], f"decode step {t}")


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch, source, reference):
    ref = reference(arch)
    prompts = _prompts(ref.cfg.vocab)
    r = ref.run(source, prompts)
    _, model, params = _port(arch, r["tree"])
    got = ServingEngine(model, params, cache_len=CACHE_LEN).generate(
        prompts, max_new=MAX_NEW)
    assert [len(o) for o in got] == [MAX_NEW] * 3
    _assert_tokens_agree(got, r["gen"], r["steps"])


def test_a_full_global_cache_drops_tokens_as_the_reference(reference):
    """cache_len 40 with a 40-token prompt and 8 new tokens: the global
    layer's cache is full after prefill and both drop every later token's
    K/V (the reference's one-hot write hits no slot; the port's slot
    write is skipped)."""
    ref = reference("gemma3-1b", cache_len=40)
    prompts = _prompts(ref.cfg.vocab)
    r = ref.run("recipe", prompts)
    cfg, model, params = _port("gemma3-1b", r["tree"])
    _, caches, cur = model.prefill(params, torch.from_numpy(_padded(prompts)),
                                   cache_len=40)
    glob = [c for c, kind in zip(caches, layer_kinds(cfg))
            if kind == "global"][0]
    before = glob.k.clone()
    for t in range(MAX_NEW):
        tok = torch.tensor([row[t] for row in r["gen"]])
        logits, caches, cur = model.decode_step(params, caches, tok, cur)
        _close(logits.numpy(), r["steps"][t + 1], f"decode step {t}")
    assert torch.equal(glob.k, before)
    got = ServingEngine(model, params, cache_len=40).generate(prompts,
                                                              MAX_NEW)
    _assert_tokens_agree(got, r["gen"], r["steps"])


@pytest.mark.parametrize("name", sorted(REF_REGISTRY))
def test_configs_match_reference(name):
    """The same names, and for each the same fields, derived sizes and
    ``reduced()`` variant as the reference's."""
    assert sorted(ARCH_REGISTRY) == sorted(REF_REGISTRY)
    for have, want in ((get_config(name), ref_get_config(name)),
                       (get_config(name).reduced(),
                        ref_get_config(name).reduced())):
        assert dataclasses.asdict(have) == dataclasses.asdict(want)
        assert getattr(have, "vocab_unpadded", None) \
            == getattr(want, "vocab_unpadded", None)
        assert (have.q_dim, have.kv_dim, have.n_groups(),
                have.param_count(), have.memory_len()) \
            == (want.q_dim, want.kv_dim, want.n_groups(),
                want.param_count(), want.memory_len())


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_have_the_reference_init_layout(arch):
    """The recipe's tree has ``Model.init``'s structure, shapes and
    dtypes; norm scales are drawn (not zeros); one seed gives one tree."""
    cfg = get_config(arch).reduced()
    tree = lm_params(cfg, 0)
    want = jax.eval_shape(ref_build_model(ref_get_config(arch).reduced())
                          .init, jax.random.PRNGKey(0))
    have = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        tree)
    assert jax.tree.structure(have) == jax.tree.structure(want)
    assert jax.tree.leaves(have) == jax.tree.leaves(want)
    assert np.abs(tree["final_ln"]["scale"]).min() > 0
    again = lm_params(cfg, 0)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(tree), jax.tree.leaves(again)))
    assert not np.array_equal(lm_params(cfg, 1)["embed"], tree["embed"])


def test_params_from_reference_layout():
    cfg = get_config("gemma3-1b").reduced()
    params = params_from_reference(cfg, lm_params(cfg, 0), "cpu")
    assert layer_kinds(cfg) == ["local"] * 5 + ["global"]
    assert layer_kinds(get_config("gemma3-1b")) == (
        (["local"] * 5 + ["global"]) * 4 + ["local"] * 2)
    assert len(params["layers"]) == 6
    assert params["embed"].dtype == torch.float32
    layer = params["layers"][5]
    assert layer["attn"]["w_q"].dtype == torch.bfloat16
    assert layer["ffn"]["w_down"].dtype == torch.bfloat16
    assert layer["ffn"]["post_ln"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("name", ["mamba2-780m", "recurrentgemma-2b",
                                  "whisper-tiny", "granite-moe-1b-a400m"])
def test_every_kind_has_a_finite_loss(name):
    """Every block kind trains now: ``Model.loss`` of the reduced config
    on a reference-layout tree gives a finite loss, ce and aux (aux > 0
    for MoE, 0 otherwise)."""
    cfg = get_config(name).reduced()
    model = build_model(cfg)
    tree = lm_params(cfg, 0)
    params = unflatten_like(tree, [torch.tensor(a) for a in leaves(tree)])
    loss, metrics = model.loss(params, synthetic_batch(cfg, 2, 8, 0))
    for v in (loss, metrics["ce"], metrics["aux"]):
        assert v.shape == () and torch.isfinite(v)
    assert (float(metrics["aux"]) > 0) == bool(cfg.n_experts)


def test_generate_records_the_reference_spans():
    """With a collector installed, ``generate`` records the reference's
    two spans and attributes (``serve/engine.py:60-79``); without one,
    ``span`` records nothing."""
    cfg = get_config("gemma3-1b").reduced()
    params = params_from_reference(cfg, lm_params(cfg, 0), "cpu")
    engine = ServingEngine(build_model(cfg), params, cache_len=16)
    assert not active()
    with collect() as col:
        assert active()
        out = engine.generate([[1, 2, 3], [4, 5]], max_new=2)
    assert not active() and [len(o) for o in out] == [2, 2]
    assert [(s.name, s.attrs) for s in col.spans] == [
        ("serve.prefill", {"batch": 2, "prompt_len": 3}),
        ("serve.decode", {"batch": 2, "steps": 2})]
    assert all(s.seconds > 0 for s in col.spans)
