"""The port over a ``model`` axis above 1 (``tp``: heads, ``d_ff``,
experts and vocabulary on the model ranks) and MoE routing over a split
batch, on the CPU, through the one-process stand-in
(``parallel.standin.StandInMesh``: one thread a rank, no process group,
socket or subprocess; every wait bounded).

Reduced granite-moe-1b-a400m, mamba2-780m, deepseek-moe-16b, granite-8b,
gemma2-27b and llama-3.2-vision-90b (the configs whose ``shard_mode`` is
``tp``), weights ``cases.lm_params(cfg, 0)``, each rank's tree
``AxisRules.rank_tree`` of them, at ``(data, model)`` = (1, 2), (1, 4),
(2, 2) and (2, 4):

* with fp32 activations (``transformer.ACT_DTYPE``; only the order of
  the fp32 sums differs from one device) within rtol 1e-5, atol 1e-6 x
  max of the port's unsharded run: the forward logits (the ranks'
  vocabulary rows gathered) and aux; the loss and grad_norm of a
  ``standin_train_step`` against ``make_train_step``'s; AdamW on the
  ranks' trees against AdamW on the whole tree from the same gradients
  (one step of AdamW moves a gradient element near its ``eps`` by ``lr *
  eps / (|g| + eps)^2`` per unit of gradient difference: an element of
  2.6e-8 against 2.9e-8, within the gradient tolerance, puts
  deepseek-moe's ``w_k`` 6x past the parameter tolerance, so the step is
  held on equal gradients); and the prefill plus 4 decode steps' logits.
  Every gradient leaf, reassembled from the ranks' shards (each summed
  over the ranks that hold it alike), lies within that tolerance of the
  unsharded run's, or, where fp32 rounding alone goes past it, no farther
  from the run with fp64 activations than twice the unsharded fp32
  run's own distance from it (llama-3.2-vision's 5 layers: the unsharded
  fp32 gradient lies 1.52x the tolerance from the fp64 one; sharded,
  1.22x from the unsharded);
* with bf16 activations, the forward logits within rtol 2e-2, atol
  2e-2 x max of the reference's unsharded forward in JAX (a row of an
  MoE config from where its routing went apart from the reference's is
  not compared, as ``test_torch_lm_kinds``);
* exactly: the embedding output (bf16 and fp32), the label
  log-probability (``transformer.label_logprob``: the reference's masked
  sum, sharded or not, equal to ``gather`` and to the masked sum written
  out), the greedy tokens (``transformer.greedy`` on each rank's rows
  against ``argmax`` of the gathered logits, and ``generate`` against
  the unsharded engine), and ``moe.Routing`` under a batch split over 2
  and 4 ranks, against the whole batch's routing and the reference's
  expert ids, at the reduced configs' capacity and at a capacity that
  drops choices;
* the decode kernel's split on a rank's KV heads (``decode_splits``
  takes the local count from the cache: about one CTA an SM);
* sequence parallelism, which these rules used to refuse, is taken:
  the ``fsdp_sp`` configs over a ``model`` axis above 1 build a train
  step, and ``kv_seq`` on a mesh dim (a decode cache whose KV heads do
  not divide, ``long_context`` over a data axis) and ``sp_residual``
  pass ``check`` and build an engine (``test_torch_sequence_parallel``
  holds their numbers); a ``rec`` block under ``tp`` still raises
  ``NotImplementedError`` naming ``MODEL_AXIS_ITEM``; a failing rank
  raises on every rank.
"""
import contextlib
import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models.registry import build_model as ref_build_model
from repro.parallel.sharding import no_sharding as ref_no_sharding
from repro_torch.configs import get_config
from repro_torch.configs.base import (DECODE_32K, LONG_500K, PREFILL_32K,
                                      TRAIN_4K)
from repro_torch.kernels.cases import TRAIN_GOLDEN_OPT, lm_memory, lm_params
from repro_torch.kernels.conv2d import H100_SMS
from repro_torch.kernels.ring_decode import decode_splits
from repro_torch.launch.specs import make_rules
from repro_torch.models import build_model, moe, transformer
from repro_torch.models.common import local_heads
from repro_torch.models.transformer import (greedy, label_logprob,
                                            layer_kinds, log_softmax,
                                            params_from_reference,
                                            vocab_logits)
from repro_torch.parallel.sharding import MODEL_AXIS_ITEM, no_sharding
from repro_torch.parallel.standin import StandInMesh
from repro_torch.serve import ServingEngine
from repro_torch.train import (AdamWConfig, adamw_update, init_state,
                               make_train_step, synthetic_batch)
from repro_torch.train.train_step import (rank_loss_and_grads,
                                          standin_loss_and_grads,
                                          standin_states,
                                          standin_train_step)
from repro_torch.train.tree import (leaves, leaves_with_paths, tree_map,
                                    unflatten_like)
from test_torch_moe import _params as ref_moe_params
from test_torch_moe import _x, reference_routes, routing_of

torch.set_num_threads(1)

ARCHS = ("granite-moe-1b-a400m", "mamba2-780m", "deepseek-moe-16b",
         "granite-8b", "gemma2-27b", "llama-3.2-vision-90b")
SHAPES = ((1, 2), (1, 4), (2, 2), (2, 4))
RTOL, ATOL_REL = 1e-5, 1e-6
BF16_RTOL = BF16_ATOL_REL = 2e-2
B, S = 4, 12
CACHE_LEN, STEPS = 24, 4


@contextlib.contextmanager
def activations(dtype):
    saved = transformer.ACT_DTYPE
    transformer.ACT_DTYPE = dtype
    try:
        yield
    finally:
        transformer.ACT_DTYPE = saved


def _close(got, want) -> float:
    """max |got - want| / (atol + rtol |want|) at the fp32 tolerance."""
    got, want = got.double(), want.double()
    atol = ATOL_REL * float(want.abs().max())
    return float(((got - want).abs() / (atol + RTOL * want.abs())).max())


def _mesh_rules(cfg, shape, cell=TRAIN_4K):
    mesh = StandInMesh(shape)
    return mesh, make_rules(cfg, mesh, cell)


def _serve_rules(cfg, shape):
    """Decode rules where they are executable (the KV heads divide);
    else the prefill cell's, which keep the cache's sequence whole."""
    mesh, rules = _mesh_rules(cfg, shape, DECODE_32K)
    return (mesh, rules) if rules.kv_shardable else \
        _mesh_rules(cfg, shape, PREFILL_32K)


def _rows(rules, x):
    return rules.sharding(*(("batch",) + (None,) * (x.dim() - 1))).local(x)


def _whole(rules, per_rank: dict, path, leaf_ndim, i):
    """Leaf ``i`` whole from the ranks' pieces at batch coordinate 0."""
    d = rules.model_dim(path, leaf_ndim)
    if d is None:
        return per_rank[(0, 0)][i]
    return torch.cat([per_rank[(0, m)][i]
                      for m in range(rules.model_ranks())], dim=d)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """A reduced config's model, weights (the reference tree as fp32
    torch tensors, and the serve params in fp32 and bf16), tokens and
    memory."""
    cfg = get_config(request.param).reduced()
    tree = lm_params(cfg, 0)
    ttree = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                     tree)
    rng = np.random.default_rng(5)
    mem = lm_memory(cfg, 0, B)
    return {"cfg": cfg, "tree": tree, "ttree": ttree,
            "model": build_model(cfg),
            "params32": tree_map(lambda t: t.float(),
                                 params_from_reference(cfg, tree, "cpu")),
            "params16": params_from_reference(cfg, tree, "cpu"),
            "tokens": torch.from_numpy(rng.integers(1, cfg.vocab, (B, S))),
            "memory": None if mem is None else torch.from_numpy(mem)}


def _batch(cfg, dtype):
    batch = synthetic_batch(cfg, 8, 16, 0)
    if "memory" in batch:
        batch["memory"] = batch["memory"].to(dtype)
    return batch


def _unsharded_grads(arch, dtype):
    """The unsharded step's gradients with ``dtype`` activations and
    weights (once an arch and dtype)."""
    key = ("grads", dtype)
    if key not in arch:
        with activations(dtype):
            params = tree_map(lambda t: t.to(dtype), arch["ttree"])
            arch[key] = rank_loss_and_grads(
                arch["model"], params, _batch(arch["cfg"], dtype),
                no_sharding(), remat_policy="none")[1]
    return arch[key]


# -- fp32 against the port's unsharded run ------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"data{s[0]}model"
                         f"{s[1]}")
def test_forward_grads_and_step_match_unsharded(arch, shape):
    cfg, model = arch["cfg"], arch["model"]
    mesh, rules = _mesh_rules(cfg, shape)
    opt = AdamWConfig(**TRAIN_GOLDEN_OPT)
    with activations(torch.float32):
        mem = None if arch["memory"] is None else arch["memory"].float()
        want, aux = model.forward(arch["params32"], arch["tokens"], mem)

        def forward(coord):
            m = None if mem is None else _rows(rules, mem)
            logits, a = model.forward(rules.rank_tree(arch["params32"]),
                                      _rows(rules, arch["tokens"]), m,
                                      rules=rules)
            return vocab_logits(logits, rules), a
        out = mesh.run(forward)
        got = torch.cat([out[(d, 0)][0] for d in range(shape[0])])
        assert _close(got, want) <= 1
        for _, a in out.values():
            assert abs(float(a) - float(aux)) <= RTOL * abs(float(aux)) + 1e-7

        batch = _batch(cfg, torch.float32)
        one = init_state(tree_map(torch.clone, arch["ttree"]))
        one, m1 = make_train_step(model, opt=opt, remat_policy="none")(
            one, batch)
        states = standin_states(rules, arch["ttree"])
        _, grads = standin_loss_and_grads(
            model, rules, {c: s.params for c, s in states.items()}, batch)
        new, m = standin_train_step(model, rules, opt=opt)(states, batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(m1[k])) <= RTOL * abs(float(m1[k])), k
    like = arch["ttree"]
    whole_g = []
    for i, (path, w) in enumerate(leaves_with_paths(
            _unsharded_grads(arch, torch.float32))):
        g = _whole(rules, grads, path, w.ndim, i)
        if _close(g, w) > 1:
            w64 = leaves(_unsharded_grads(arch, torch.float64))[i]
            assert _close(g, w64) <= 2 * _close(w, w64), \
                ("grad", path, _close(g, w), _close(g, w64), _close(w, w64))
        whole_g.append(g)
    # AdamW on the ranks' shards == AdamW on the whole tree, same grads
    ref_state, _ = adamw_update(init_state(tree_map(torch.clone, like)),
                                unflatten_like(like, whole_g), opt,
                                gnorm=m["grad_norm"])
    for part in ("params", "mu", "nu"):
        pieces = {c: leaves(getattr(s, part)) for c, s in new.items()}
        for i, (path, w) in enumerate(leaves_with_paths(
                getattr(ref_state, part))):
            assert _close(_whole(rules, pieces, path, w.ndim, i), w) <= 1, \
                (part, path)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"data{s[0]}model"
                         f"{s[1]}")
def test_prefill_decode_and_tokens_match_unsharded(arch, shape):
    cfg, model = arch["cfg"], arch["model"]
    mesh, rules = _serve_rules(cfg, shape)
    toks = arch["tokens"]
    with activations(torch.float32):
        params = arch["params32"]
        mem = None if arch["memory"] is None else arch["memory"].float()
        want = []
        logits, caches, cur = model.prefill(params, toks, CACHE_LEN,
                                            memory=mem)
        want.append(logits)
        for t in range(STEPS):
            logits, caches, cur = model.decode_step(params, caches,
                                                    toks[:, t], cur)
            want.append(logits)
        prompts = [[int(t) for t in row[:n]] for row, n in
                   zip(toks.tolist(), (S, 5, 9, S))]
        want_gen = ServingEngine(model, params, cache_len=CACHE_LEN) \
            .generate(prompts, STEPS, memory=mem)

        def serve(coord):
            p = rules.rank_tree(params)
            rows = _rows(rules, toks)
            m = None if mem is None else _rows(rules, mem)
            steps, exact = [], True
            logits, caches, cur = model.prefill(p, rows, CACHE_LEN,
                                                memory=m, rules=rules)
            for t in range(STEPS + 1):
                whole = vocab_logits(logits, rules)
                steps.append(whole)
                exact &= torch.equal(greedy(logits, rules),
                                     torch.argmax(whole, dim=-1))
                if t < STEPS:
                    logits, caches, cur = model.decode_step(
                        p, caches, rows[:, t], cur, rules=rules)
            gen = ServingEngine(model, p, rules=rules,
                                cache_len=CACHE_LEN).generate(
                prompts, STEPS, memory=mem)
            return steps, exact, gen
        out = mesh.run(serve)
    for t in range(STEPS + 1):
        got = torch.cat([out[(d, 0)][0][t] for d in range(shape[0])])
        assert _close(got, want[t]) <= 1, ("step", t)
    assert all(exact for _, exact, _ in out.values())
    assert all(gen == want_gen for _, _, gen in out.values())


# -- bf16 against the reference's unsharded forward ---------------------------

@pytest.fixture(scope="module")
def reference_forward(arch):
    """The reference's bf16 forward of the tokens in JAX and its routing
    codes (None without MoE)."""
    from test_torch_lm_kinds import _ref_codes

    rcfg = ref_get_config(arch["cfg"].name.removesuffix("-smoke")).reduced()
    jtree = jax.tree.map(jnp.asarray, arch["tree"])
    mem = None if arch["memory"] is None else jnp.asarray(arch["memory"])
    rmodel = ref_build_model(rcfg)
    with reference_routes(rcfg) as calls:
        logits, _ = jax.jit(lambda p, t, m: rmodel.forward(p, t, memory=m))(
            jtree, jnp.asarray(arch["tokens"].numpy(), jnp.int32), mem)
        codes = _ref_codes(calls, B, rcfg)
    return np.asarray(logits), codes


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"data{s[0]}model"
                         f"{s[1]}")
def test_bf16_logits_match_the_reference(arch, reference_forward, shape):
    from test_torch_lm_kinds import _apart, _close_rows, _skipped

    cfg, model = arch["cfg"], arch["model"]
    want, codes = reference_forward
    mesh, rules = _mesh_rules(cfg, shape)

    def forward(coord):
        routes = []
        m = None if arch["memory"] is None else _rows(rules, arch["memory"])
        logits, _ = model.forward(rules.rank_tree(arch["params16"]),
                                  _rows(rules, arch["tokens"]), m,
                                  routes=routes, rules=rules)
        return vocab_logits(logits, rules), routes
    out = mesh.run(forward)
    got = torch.cat([out[(d, 0)][0] for d in range(shape[0])])
    routes = [moe.Routing(torch.cat([out[(d, 0)][1][i].experts
                                     for d in range(shape[0])]),
                          torch.cat([out[(d, 0)][1][i].keep
                                     for d in range(shape[0])]))
              for i in range(len(out[(0, 0)][1]))]
    skip = _skipped(*_apart(routes, codes, B, S)) if codes is not None \
        else np.zeros((B, S), bool)
    _close_rows(got.numpy(), want, skip)


# -- exact results ------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"data{s[0]}model"
                         f"{s[1]}")
def test_embedding_and_label_logprob_are_exact(arch, shape):
    cfg, model = arch["cfg"], arch["model"]
    mesh, rules = _mesh_rules(cfg, shape)
    toks = arch["tokens"]
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, S, cfg.vocab)).astype(np.float32) * 4)
    labels = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S)))
    logp = torch.log_softmax(logits, dim=-1)
    gathered = logp.gather(-1, labels[..., None])[..., 0]
    iota = torch.arange(cfg.vocab)
    masked = torch.where(iota == labels[..., None], logp, 0.0).sum(-1)
    assert torch.equal(label_logprob(logp, labels), gathered)
    assert torch.equal(masked, gathered)
    want = {}
    for dtype in (torch.bfloat16, torch.float32):
        with activations(dtype):
            want[dtype] = model._embed(arch["params32"], toks)
    V = cfg.vocab // rules.shards("vocab")

    for dtype in want:   # the activations' dtype is the module's
        with activations(dtype):
            out = mesh.run(lambda c: model._embed(
                rules.rank_tree(arch["params32"]), _rows(rules, toks), rules))
        got = torch.cat([out[(d, 0)] for d in range(shape[0])])
        assert torch.equal(got, want[dtype]), dtype

    def ranks(coord):
        m = rules.shard_index("vocab")
        lp = log_softmax(_rows(rules, logits[..., m * V:(m + 1) * V]),
                         rules)
        return vocab_logits(lp, rules), \
            label_logprob(lp, _rows(rules, labels), rules)
    out = mesh.run(ranks)
    # the sharded log-softmax sums its exponentials in another order
    # (held at the fp32 tolerance); the label's term is exactly the
    # masked sum, and the gather, of the ranks' log-softmax
    lp = torch.cat([out[(d, 0)][0] for d in range(shape[0])])
    ll = torch.cat([out[(d, 0)][1] for d in range(shape[0])])
    assert _close(lp, logp) <= 1
    assert torch.equal(ll, torch.where(iota == labels[..., None], lp,
                                       0.0).sum(-1))
    assert torch.equal(ll, lp.gather(-1, labels[..., None])[..., 0])
    for c, (_, got) in out.items():
        assert torch.equal(got, out[(c[0], 0)][1])


@pytest.mark.parametrize("cf", [None, 1.0], ids=["reduced", "dropping"])
@pytest.mark.parametrize("data", [2, 4])
@pytest.mark.parametrize("moe_arch", ["granite-moe-1b-a400m",
                                      "deepseek-moe-16b"])
def test_moe_routing_is_the_whole_batchs(moe_arch, data, cf):
    cfg = get_config(moe_arch).reduced()
    rcfg = ref_get_config(moe_arch).reduced()
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
        rcfg = dataclasses.replace(rcfg, capacity_factor=cf)
    p = ref_moe_params(rcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    x = _x((8, 6, cfg.d_model), 11)
    whole, aux, want = moe.moe_forward(tp, torch.from_numpy(x), cfg)
    with reference_routes(rcfg) as calls:
        jax.jit(lambda q, y: ref_moe.moe_forward(q, y, rcfg,
                                                 ref_no_sharding()))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        jax.effects_barrier()
    ref = routing_of(calls[0], 8, cfg)
    if cf is not None:
        assert not bool(want.keep.all())        # the capacity drops some
    for shape in ((data, 1), (data // 2, 2)):
        mesh, rules = _mesh_rules(cfg, shape)

        def forward(coord):
            q = rules.rank_tree(tp)
            return moe.moe_forward(q, _rows(rules, torch.from_numpy(x)), cfg,
                                   rules)
        out = mesh.run(forward)
        for m in range(shape[1]):
            rows = [out[(d, m)] for d in range(shape[0])]
            routing = moe.Routing(torch.cat([r[2].experts for r in rows]),
                                  torch.cat([r[2].keep for r in rows]))
            for r in (want, ref):
                assert torch.equal(routing.experts, r.experts)
                assert torch.equal(routing.keep, r.keep)
            got = torch.cat([r[0] for r in rows])
            assert _close(got, whole) <= 1
            for r in rows:
                assert abs(float(r[1]) - float(aux)) <= 1e-5 * float(aux)


# -- refusals and the stand-in's failures -------------------------------------

@pytest.mark.parametrize("name", ["gemma3-1b", "whisper-tiny",
                                  "recurrentgemma-2b", "gemma2-2b"])
def test_sequence_parallel_rules_raise(name):
    """The ``fsdp_sp`` rules over a ``model`` axis above 1 split the
    sequence and build a train step (they raised before sequence
    parallelism was ported); a ``rec`` block under ``tp`` still
    raises."""
    cfg = get_config(name).reduced()
    for shape in ((1, 2), (2, 2)):
        _, rules = _mesh_rules(cfg, shape)
        assert rules.mode == "fsdp_sp" and rules.shards("seq") == 2
        rules.check(cfg)
        assert callable(make_train_step(build_model(cfg), rules))
    if "rec" in cfg.pattern:
        tp = dataclasses.replace(cfg, shard_mode="tp")
        with pytest.raises(NotImplementedError, match=MODEL_AXIS_ITEM):
            _mesh_rules(tp, (1, 2))[1].check(tp)


def test_kv_seq_on_a_mesh_dim_raises():
    """``kv_seq`` on a mesh dim and ``sp_residual`` pass ``check`` and
    build an engine (they raised before sequence parallelism was
    ported): a rank's cache is its slice of every KV head."""
    cfg = get_config("granite-moe-1b-a400m").reduced()   # 2 KV heads
    mesh, rules = _mesh_rules(cfg, (1, 4), DECODE_32K)
    assert rules.spec("kv_seq") == ("model",)
    rules.check(cfg)
    caches = mesh.run(lambda c: build_model(cfg).init_caches(
        2, 24, device="cpu", rules=rules))
    for m in range(4):
        kv = caches[(0, m)][0]
        assert (kv.start, tuple(kv.k.shape)) == (6 * m, (2, 6, 2, 16))
    _, rules = _mesh_rules(cfg, (2, 2), LONG_500K)
    assert rules.spec("kv_seq") == ("data",)
    ServingEngine(build_model(cfg), {}, rules=rules)
    _, rules = _mesh_rules(cfg, (1, 2), DECODE_32K)   # 1 KV head a rank
    rules.check(cfg)
    sp = dataclasses.replace(rules, decode=False, sp_residual=True)
    assert sp.spec("res_seq") == ("model",) and sp.scatters_residual()
    sp.check(cfg)


def test_a_failing_rank_raises_on_every_rank():
    mesh = StandInMesh((1, 4), timeout=30.0)
    rules = make_rules(get_config("granite-8b").reduced(), mesh, TRAIN_4K)
    reached = []

    def body(coord):
        if coord == (0, 2):
            raise ValueError("rank 2 fails")
        x = rules.psum(torch.ones(3), "heads")
        reached.append(coord)
        return x
    with pytest.raises(ValueError, match="rank 2 fails"):
        mesh.run(body)
    assert reached == []
    assert not [t for t in threading.enumerate()
                if t.name.startswith("rank(")]
    out = mesh.run(lambda c: rules.psum(torch.full((2,), float(c[1])),
                                        "heads"))
    assert all(torch.equal(v, torch.full((2,), 6.0)) for v in out.values())


def test_the_exchange_holds_under_thread_switching():
    """8 ranks in two model groups of 4, the interpreter switching
    threads every microsecond: 100 rounds of a sum and a gather of values
    unique to the rank and the round give every rank the group's sum and
    its rows in rank order (a slot read in another round, or written over
    before every rank read it, breaks this)."""
    mesh = StandInMesh((2, 4), timeout=60.0)
    rules = make_rules(get_config("granite-8b").reduced(), mesh, TRAIN_4K)

    def body(coord):
        m, bad = rules.shard_index("heads"), 0
        for k in range(100):
            v = torch.tensor([1000.0 * k + m + 10 * coord[0]])
            total = rules.psum(v, "heads")
            rows = rules.pgather(v, "heads")[:, 0]
            base = 1000.0 * k + 10 * coord[0]
            bad += int(float(total) != 4 * base + 6)
            bad += int(not torch.equal(rows, base + torch.arange(4.0)))
        return bad
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = mesh.run(body)
    finally:
        sys.setswitchinterval(saved)
    assert out == {c: 0 for c in mesh.coords()}


def test_layer_kinds_are_served_per_rank():
    """Every layer kind of the six configs: its per-rank caches hold the
    rank's KV heads (or the KV heads its query heads read) and SSD
    heads."""
    for name in ARCHS:
        cfg = get_config(name).reduced()
        for shape in ((1, 2), (1, 4)):
            mesh, rules = _serve_rules(cfg, shape)
            model = build_model(cfg)
            out = mesh.run(lambda c: model.init_caches(
                1, 8, device="cpu", rules=rules))
            for c, caches in out.items():
                for kind, cache in zip(layer_kinds(cfg), caches):
                    if kind == "ssm":
                        assert cache.state.shape[1] == cfg.ssm_heads \
                            // shape[1]
                    else:
                        kv = cache.k if kind != "cross" else cache.self_kv.k
                        want = cfg.n_kv_heads // shape[1] \
                            if rules.kv_shardable else 1
                        assert kv.shape[2] == want, (name, kind, shape)


def test_decode_splits_take_the_ranks_kv_heads():
    """A rank's cache holds its KV heads, and the decode kernel's split
    rule reads their count from the cache: granite-moe-1b-a400m at full
    width over 2 and 4 model ranks (4 and 2 KV heads a rank) at batch 1
    fills about one CTA an SM, where the whole model's split (8 KV heads)
    on a rank's heads would leave half the card or more idle."""
    cfg = get_config("granite-moe-1b-a400m")
    for R in (2, 4):
        mesh, rules = _mesh_rules(cfg, (1, R), DECODE_32K)
        heads = mesh.run(lambda c: local_heads(cfg, rules))
        assert {h[:2] for h in heads.values()} == {(16 // R, 8 // R)}
        assert sorted(h[2] for h in heads.values()) == \
            [m * 8 // R for m in range(R)]
        assert H100_SMS * 3 // 4 <= decode_splits(1, 8 // R, 1024).ctas \
            <= H100_SMS
        assert 8 // R * decode_splits(1, 8, 1024).splits < H100_SMS // 2
