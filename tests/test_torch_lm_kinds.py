"""Every block and FFN kind of the port's LM stack against the
reference's, on the CPU, at reduced width: the reduced
``recurrentgemma-2b`` (rec, rec, local: the LRU and a 32-slot ring that
the 40-token prompt wraps), ``mamba2-780m`` (ssm blocks, no FFN),
``granite-moe-1b-a400m`` (MoE FFNs), ``deepseek-moe-16b`` (a leading
dense layer, MoE with a shared expert), ``whisper-tiny`` (an encoder over
24 frames, cross blocks, LayerNorm, gelu) and ``llama-3.2-vision-90b``
(an untied unembedding, cross blocks over 8 image tokens); and the two
dense configs ``tests/test_torch_serve.py`` leaves out, ``gemma2-27b``
and ``granite-8b``, so that all ten registered configs are held.

Params are ``repro_torch.kernels.cases.lm_params(cfg, 0)`` and memory
``cases.lm_memory(cfg, 0, 3)`` fed to both.  Held, each within rtol 2e-2
and atol 2e-2 * max (bf16 activations; the fp32 LRU and SSM states are
fed by bf16 products that XLA and torch round apart, so they are held at
the same tolerance):

* ``forward`` logits (and the MoE aux loss) on 3 left-padded prompts of
  40, 9 and 21 tokens;
* ``prefill``'s last logits and every layer's cache, field by field;
* 8 ``decode_step``s teacher-forced on the reference's generated tokens;
* ``ServingEngine.generate`` (8 new tokens): tokens equal wherever the
  reference's top-2 margin exceeds twice the tolerance; after a token
  that a near tie flipped, the rest of that row is not compared.

The reference runs its jitted ``forward`` and serve functions, as a
user calls them.  An MoE router's logits are bf16 products, so where
XLA and torch round one apart, a token whose k-th and (k+1)-th logits
nearly tie may take another expert.  Each pass compares the two
routings: the port's ``moe.Routing`` of every MoE layer (``routes=``)
against the reference's, read out of its run
(``test_torch_moe.reference_routes``); only where they really sent a
token apart is the rest of that row (its later positions, its cache,
its later steps) not compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer  # noqa: F401  (attaches memory_len)
from repro.configs import get_config as ref_get_config
from repro.models.registry import build_model as ref_build_model
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.kernels.cases import (lm_memory, lm_params, route_codes,
                                       routed_apart)
from repro_torch.models import build_model, params_from_reference
from repro_torch.models.transformer import layer_kinds, layers_from_tree
from repro_torch.serve import ServingEngine
from test_torch_moe import reference_routes, routing_of

torch.set_num_threads(2)

ARCHS = ("recurrentgemma-2b", "mamba2-780m", "granite-moe-1b-a400m",
         "deepseek-moe-16b", "whisper-tiny", "llama-3.2-vision-90b",
         "gemma2-27b", "granite-8b")
PROMPT_LENS = (40, 9, 21)
CACHE_LEN, MAX_NEW = 48, 8
RTOL = ATOL_REL = 2e-2


def _close(got, want, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape, what)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(want).max()),
                               err_msg=what)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in PROMPT_LENS]


def _padded(prompts):
    L = max(len(p) for p in prompts)
    return np.asarray([[0] * (L - len(p)) + p for p in prompts], np.int32)


def _ref_codes(calls, batch: int, cfg):
    """The reference's routing codes of one pass (``cases.route_codes``
    of its recorded expert ids, ``[layers, B, S, k]``; the records
    cleared), None for a config without MoE."""
    jax.effects_barrier()
    codes = route_codes([routing_of(c, batch, cfg) for c in calls]) \
        if calls else None
    calls.clear()
    return codes


def _apart(routes, want, B: int, S: int):
    """``(here, onward)``, each ``[B, S]``, where the port's routings of
    one pass (``routes``, its ``moe.Routing`` a layer, in order; cleared)
    sent a token apart from the reference's codes ``want``: at any MoE
    layer, and at any but the last, which is the model's last layer (its
    output reaches no cache and no later position)."""
    here = np.zeros((B, S), bool)
    onward = here.copy()
    if routes:
        have = route_codes(routes)
        assert have.shape == want.shape, (have.shape, want.shape)
        here = routed_apart(have, want)
        onward = routed_apart(have[:-1], want[:-1])
        routes.clear()
    return here, onward


def _skipped(here, onward):
    """``[B, S]`` positions not compared: a near tie's own position, and
    every later one of its row where it reaches them."""
    return here | (np.cumsum(onward, axis=1) > 0)


def _close_rows(got, want, skip, what=""):
    """:func:`_close` over the entries whose leading index ``skip``
    leaves in (the scale is the whole step's)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    keep = ~np.asarray(skip)
    np.testing.assert_allclose(got[keep], want[keep], rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(want).max()),
                               err_msg=what)


def _assert_tokens_agree(got, want, step_logits, from_step=None):
    """Greedy tokens ``got`` equal the reference's ``want`` at every step
    whose reference top-2 margin exceeds twice the tolerance; the rest of
    a row after a flipped near tie (or from ``from_step[b]`` on) is not
    compared."""
    for b, (g_row, w_row) in enumerate(zip(got, want)):
        for t, (g, w) in enumerate(zip(g_row, w_row)):
            if from_step is not None and t >= from_step[b]:
                break
            if g == w:
                continue
            logits = step_logits[t][b]
            top2 = np.sort(logits)[-2:]
            tol = ATOL_REL * float(np.abs(step_logits[t]).max()) \
                + RTOL * abs(float(top2[1]))
            assert top2[1] - top2[0] <= 2 * tol, (b, t, g_row, w_row)
            break


def _fields(cache):
    """A layer cache's arrays by name (NamedTuples nest one level)."""
    out = {}
    for name, v in zip(cache._fields, cache):
        if hasattr(v, "_fields"):
            out.update({f"{name}.{n}": a for n, a in zip(v._fields, v)})
        else:
            out[name] = v
    return out


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """The reference's and the port's model of one reduced config, the
    recipe's params, and the reference's forward, prefill, generate and
    teacher-forced decode steps."""
    arch = request.param
    rcfg = ref_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    tree = lm_params(cfg, 0)
    mem = lm_memory(cfg, 0, len(PROMPT_LENS))
    jtree = jax.tree.map(jnp.asarray, tree)
    jmem = None if mem is None else jnp.asarray(mem)
    rmodel = ref_build_model(rcfg)
    engine = RefEngine(rmodel, jtree, cache_len=CACHE_LEN)
    prompts = _prompts(cfg.vocab)
    toks = jnp.asarray(_padded(prompts))
    with reference_routes(rcfg) as calls:
        gen = engine.generate(prompts, max_new=MAX_NEW, memory=jmem)
        jax.effects_barrier()
        calls.clear()
        logits, caches, cur = engine.prefill(jtree, toks, jmem)
        routes = {"prefill": _ref_codes(calls, 3, rcfg), "steps": []}
        fwd, aux = jax.jit(lambda p, t, m: rmodel.forward(p, t, memory=m))(
            jtree, toks, jmem)
        routes["forward"] = _ref_codes(calls, 3, rcfg)
        out = {"arch": arch, "cfg": cfg, "tree": tree, "prompts": prompts,
               "gen": gen, "cur": int(cur), "forward": np.asarray(fwd),
               "aux": float(aux),
               "caches": layers_from_tree(rcfg, jax.tree.map(
                   lambda a: np.asarray(a.astype(jnp.float32)), caches)),
               "dtypes": [{n: str(a.dtype) for n, a in _fields(c).items()}
                          for c in layers_from_tree(rcfg, caches)],
               "steps": [np.asarray(logits)], "routes": routes,
               "memory": None if mem is None else torch.from_numpy(mem)}
        for t in range(MAX_NEW):
            tok = jnp.asarray([row[t] for row in gen], jnp.int32)
            logits, caches, cur = engine.decode(jtree, caches, tok, cur)
            out["steps"].append(np.asarray(logits))
            routes["steps"].append(_ref_codes(calls, 3, rcfg))
    out["model"] = build_model(cfg)
    out["params"] = params_from_reference(cfg, tree, "cpu")
    return out


def test_forward_matches_reference(run):
    routes = []
    logits, aux = run["model"].forward(
        run["params"], torch.from_numpy(_padded(run["prompts"])),
        memory=run["memory"], routes=routes)
    assert logits.dtype == torch.float32
    assert logits.shape == run["forward"].shape == (3, 40, 256)
    _close_rows(logits.numpy(), run["forward"],
                _skipped(*_apart(routes, run["routes"]["forward"], 3, 40)))
    np.testing.assert_allclose(float(aux), run["aux"], rtol=1e-2,
                               atol=1e-6)
    if run["cfg"].n_experts:
        assert run["aux"] > 0


def test_prefill_logits_and_caches_match_reference(run):
    cfg = run["cfg"]
    routes = []
    logits, caches, cur = run["model"].prefill(
        run["params"], torch.from_numpy(_padded(run["prompts"])),
        cache_len=CACHE_LEN, memory=run["memory"], routes=routes)
    assert cur == run["cur"] == 40
    here, onward = _apart(routes, run["routes"]["prefill"], 3, 40)
    _close_rows(logits.numpy(), run["steps"][0],
                _skipped(here, onward)[:, -1], "prefill logits")
    rows = onward.any(axis=1)
    kinds = layer_kinds(cfg)
    assert len(caches) == len(run["caches"]) == cfg.n_layers == len(kinds)
    for i, (kind, have, want) in enumerate(zip(kinds, caches,
                                               run["caches"])):
        assert type(have).__name__ == type(want).__name__, (i, kind)
        hf, wf = _fields(have), _fields(want)
        assert sorted(hf) == sorted(wf)
        for name, w in wf.items():
            h = hf[name]
            assert str(h.dtype).split(".")[1] == run["dtypes"][i][name], \
                (i, name, h.dtype)
            _close_rows(h.float().numpy(), w, rows,
                        f"layer {i} ({kind}) {name}")


def test_decode_steps_match_reference_teacher_forced(run):
    _decode_steps(run, run["model"], run["params"])


def _decode_steps(run, model, params):
    """The port's prefill and decode steps teacher-forced on the
    reference's tokens, each step's logits held where no routing went
    apart; returns, per row, the first of generate's steps (0 the
    prefill, ``t + 1`` decode step ``t``) whose routing went apart from
    the reference's, ``MAX_NEW`` where none did."""
    routes = []
    _, caches, cur = model.prefill(
        params, torch.from_numpy(_padded(run["prompts"])),
        cache_len=CACHE_LEN, memory=run["memory"], routes=routes)
    here, onward = _apart(routes, run["routes"]["prefill"], 3, 40)
    rows = onward.any(axis=1)
    from_step = np.where(here.any(axis=1), 0, MAX_NEW)
    for t in range(MAX_NEW):
        tok = torch.tensor([row[t] for row in run["gen"]])
        logits, caches, cur = model.decode_step(params, caches, tok, cur,
                                                routes=routes)
        assert cur == 41 + t
        here, onward = _apart(routes, run["routes"]["steps"][t], 3, 1)
        assert not (rows | here[:, 0]).all()
        _close_rows(logits.numpy(), run["steps"][t + 1], rows | here[:, 0],
                    f"decode step {t}")
        from_step = np.where(here[:, 0], np.minimum(from_step, t + 1),
                             from_step)
        rows |= onward[:, 0]
    return from_step


def test_generate_matches_reference(run):
    """``generate``'s tokens are the reference's; a row is compared up to
    the step whose routing went apart from the reference's in the
    teacher-forced run (the same inputs as generate's until a token
    differs)."""
    engine = ServingEngine(run["model"], run["params"], cache_len=CACHE_LEN)
    got = engine.generate(run["prompts"], max_new=MAX_NEW,
                          memory=run["memory"])
    assert [len(o) for o in got] == [MAX_NEW] * 3
    from_step = _decode_steps(run, run["model"], run["params"])
    _assert_tokens_agree(got, run["gen"], run["steps"], from_step)


def test_the_kinds_are_those_of_the_reference(run):
    """The layer order, the untied unembedding, the lead layer's dense
    FFN width and the encoder's depth carried across."""
    cfg, params, tree = run["cfg"], run["params"], run["tree"]
    assert len(params["layers"]) == cfg.n_layers
    assert ("unembed" in params) == (not cfg.tie_embeddings)
    if cfg.first_dense_layers:
        lead = params["layers"][0]["ffn"]
        assert "router" not in lead and lead["w_up"].shape[1] == \
            cfg.d_ff * (cfg.top_k + cfg.n_shared_experts)
        assert "router" in params["layers"][1]["ffn"]
    if cfg.encoder_layers:
        assert len(params["encoder"]["blocks"]) == cfg.encoder_layers
    if cfg.n_experts:   # the tie rule's premise: the last layer is MoE
        assert "router" in params["layers"][-1]["ffn"]
    if not cfg.d_ff:
        assert all("ffn" not in p for p in params["layers"])
    assert sorted(tree) == sorted(
        k for k in ("embed", "final_ln", "groups", "rem", "lead", "unembed",
                    "encoder")
        if k in tree)
