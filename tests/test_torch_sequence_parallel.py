"""Sequence parallelism on the CPU, through the one-process stand-in
(``parallel.standin.StandInMesh``: one thread a rank, no process group,
socket or subprocess; every wait bounded).

Reduced configs, weights ``cases.lm_params(cfg, 0)``, each rank's tree
``AxisRules.rank_tree`` of them; "fp32" below means fp32 activations
(``transformer.ACT_DTYPE``), where only the order of the fp32 sums can
differ from one device: within rtol 1e-5, atol 1e-5 x max of the port's
unsharded run.

* ``fsdp_sp`` (``seq`` and ``res_seq`` on ``model``: each rank a run of
  the positions) over ``(data, model)`` = (1, 2), (1, 4) and (2, 2) for
  gemma2-2b, gemma3-1b, recurrentgemma-2b and whisper-tiny, 14 tokens
  (uneven over 4 ranks: runs of 4, 4, 4 and 2): the forward logits
  against the unsharded run (fp32), and in bf16 within the LM tolerance
  (rtol 2e-2, atol 2e-2 x max) of the reference's ``Model.forward`` on
  the same params; one ``standin_train_step``'s loss and grad_norm
  against ``make_train_step``'s, and every gradient leaf against the
  unsharded one (fp32); the prefill under the prefill cell's rules
  (sequence-sharded) and 4 decode steps after it against the unsharded
  ones (fp32).
* ``kv_seq`` on a mesh dim under the decode cells (gemma3-1b at (1, 2)
  and (1, 4), granite-moe-1b-a400m under ``tp`` at (1, 4) with 2 KV
  heads, whisper-tiny at (1, 4) with 6) and ``long_context`` over
  (2, 1) and (2, 2) (gemma3-1b, batch 1): a rank's cache is its run of
  every full-length cache (ring windows and cross memories whole), the
  prefill and decode logits against the unsharded path's (fp32) and the
  engine's greedy tokens equal to the unsharded engine's.
* ``sp_residual`` (Megatron-SP under ``tp``) against ``tp`` itself on
  four ``tp`` configs: the same logits and gradients (the ranks' sums
  are added in the same order, so exactly).
* an empty slice (``cur_len`` below a rank's slice start): no NaN, the
  partial ``out = 0``, ``lse = -inf``, and the ranks' combine equal to
  attention over the whole cache; ``return_lse`` of the kernel's plain
  version against an exact log-sum-exp on the slice cases the card
  runs.
* the scan carry and conv halo of ``rglru`` against ``_assoc_scan`` and
  ``_conv`` over the whole sequence.
* ``check_executable`` on every ``(arch, cell)`` pair of ``cells_for``
  on stand-in meshes of ``(16, 16)`` and ``(2, 16, 16)``: none raises.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.registry import build_model as ref_build_model
from repro_torch.configs import ARCH_REGISTRY, get_config
from repro_torch.configs.base import (DECODE_32K, LONG_500K, PREFILL_32K,
                                      TRAIN_4K, cells_for)
from repro_torch.kernels.cases import (SLICE_DECODE_CASES, TRAIN_GOLDEN_OPT,
                                       compare_lse, decode_inputs, lm_memory,
                                       lm_params)
from repro_torch.kernels.ring_decode import (ring_decode_attention_plain,
                                             ring_decode_ref)
from repro_torch.launch.specs import make_rules
from repro_torch.models import build_model, rglru, transformer
from repro_torch.models.common import (KVCache, KVSlice, combine_partials,
                                       decode_attention)
from repro_torch.models.transformer import (layer_kinds,
                                            params_from_reference,
                                            train_params, vocab_logits)
from repro_torch.parallel.sharding import AxisRules, check_executable
from repro_torch.parallel.standin import StandInMesh
from repro_torch.serve import ServingEngine
from repro_torch.train import (AdamWConfig, init_state, make_train_step,
                               synthetic_batch)
from repro_torch.train.train_step import (rank_loss_and_grads,
                                          standin_loss_and_grads,
                                          standin_states,
                                          standin_train_step)
from repro_torch.train.tree import leaves_with_paths, tree_map
from test_torch_sharding import FakeMesh

torch.set_num_threads(1)

SP_ARCHS = ("gemma2-2b", "gemma3-1b", "recurrentgemma-2b", "whisper-tiny")
TP_ARCHS = ("granite-8b", "granite-moe-1b-a400m", "mamba2-780m",
            "llama-3.2-vision-90b")
SHAPES = ((1, 2), (1, 4), (2, 2))
RTOL = ATOL_REL = 1e-5
LM_RTOL = LM_ATOL_REL = 2e-2
B, S = 4, 14                 # 14 positions: runs of 4, 4, 4, 2 over 4
PROMPT, CACHE_LEN, STEPS = 8, 24, 4


def _ids(shape):
    return f"data{shape[0]}model{shape[1]}"


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


def _rows(rules, x):
    return rules.sharding(*(("batch",) + (None,) * (x.dim() - 1))).local(x)


def _whole_rows(rules, out: dict, pick=lambda v: v):
    """The batch rows of the ranks at model coordinate 0, joined."""
    n = rules.mesh.shape[0]
    if rules.batch_shards() == 1:
        return pick(out[(0,) * rules.mesh.ndim])
    return torch.cat([pick(out[(d, 0)]) for d in range(n)])


_LOADED: dict = {}


def _load(name: str) -> dict:
    """A reduced config's model, weights (the reference tree, as fp32
    torch tensors, and the serve params in fp32 and bf16), tokens and
    memory (once a config)."""
    if name not in _LOADED:
        cfg = get_config(name).reduced()
        tree = lm_params(cfg, 0)
        rng = np.random.default_rng(5)
        mem = lm_memory(cfg, 0, B)
        _LOADED[name] = {
            "cfg": cfg, "tree": tree,
            "ttree": tree_map(lambda a: torch.from_numpy(
                np.array(a, np.float32)), tree),
            "model": build_model(cfg),
            "params32": tree_map(lambda t: t.float(),
                                 params_from_reference(cfg, tree, "cpu")),
            "params16": params_from_reference(cfg, tree, "cpu"),
            "tokens": torch.from_numpy(rng.integers(1, cfg.vocab, (B, S))),
            "memory": None if mem is None else torch.from_numpy(mem)}
    return _LOADED[name]


@pytest.fixture(scope="module", params=SP_ARCHS)
def arch(request):
    """An ``fsdp_sp`` config, loaded (:func:`_load`)."""
    return _load(request.param)


@pytest.fixture(scope="module", params=TP_ARCHS)
def tp_arch(request):
    """A ``tp`` config, loaded (:func:`_load`)."""
    return _load(request.param)


def _counting(monkeypatch):
    """A list each sequence gather appends its logical axis to."""
    seen = []
    real = AxisRules.seq_gather

    def spy(self, x, logical, n, dim=1):
        seen.append(logical)
        return real(self, x, logical, n, dim)
    monkeypatch.setattr(AxisRules, "seq_gather", spy)
    return seen


# -- fsdp_sp: forward, training, prefill -------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_fsdp_sp_forward_matches_unsharded(arch, shape, monkeypatch):
    cfg, model = arch["cfg"], arch["model"]
    mesh = StandInMesh(shape)
    rules = make_rules(cfg, mesh, TRAIN_4K)
    assert rules.shards("seq") == shape[1]
    with activations(torch.float32):
        mem = None if arch["memory"] is None else arch["memory"].float()
        want, _ = model.forward(arch["params32"], arch["tokens"], mem)
        seen = _counting(monkeypatch)

        def forward(coord):
            m = None if mem is None else _rows(rules, mem)
            logits, _ = model.forward(rules.rank_tree(arch["params32"]),
                                      _rows(rules, arch["tokens"]), m,
                                      rules=rules)
            return vocab_logits(logits, rules)
        out = mesh.run(forward)
    assert "seq" in seen and "res_seq" in seen
    for c, got in out.items():
        assert torch.equal(got, out[(c[0], 0)])   # alike over the model
    assert _close(_whole_rows(rules, out), want) <= 1


@pytest.fixture(scope="module")
def reference_forward(arch):
    """The reference's bf16 forward of the tokens in JAX."""
    rcfg = ref_get_config(arch["cfg"].name.removesuffix("-smoke")).reduced()
    mem = None if arch["memory"] is None else jnp.asarray(arch["memory"])
    rmodel = ref_build_model(rcfg)
    logits, _ = jax.jit(lambda p, t, m: rmodel.forward(p, t, memory=m))(
        jax.tree.map(jnp.asarray, arch["tree"]),
        jnp.asarray(arch["tokens"].numpy(), jnp.int32), mem)
    return np.asarray(logits)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_fsdp_sp_bf16_logits_match_the_reference(arch, reference_forward,
                                                 shape):
    cfg, model = arch["cfg"], arch["model"]
    mesh = StandInMesh(shape)
    rules = make_rules(cfg, mesh, TRAIN_4K)

    def forward(coord):
        m = None if arch["memory"] is None else _rows(rules, arch["memory"])
        logits, _ = model.forward(rules.rank_tree(arch["params16"]),
                                  _rows(rules, arch["tokens"]), m,
                                  rules=rules)
        return vocab_logits(logits, rules)
    got = _whole_rows(rules, mesh.run(forward)).float().numpy()
    want = reference_forward
    np.testing.assert_allclose(got, want, rtol=LM_RTOL,
                               atol=LM_ATOL_REL * float(np.abs(want).max()))


def _batch(cfg):
    batch = synthetic_batch(cfg, 8, S, 0)
    if "memory" in batch:
        batch["memory"] = batch["memory"].float()
    return batch


def _whole_grad(rules, grads: dict, path, ndim: int, i: int):
    """Leaf ``i``'s gradient whole, from the ranks at batch coordinate
    0 (each summed over the ranks that hold the leaf alike)."""
    d = rules.model_dim(path, ndim)
    if d is None:
        return grads[(0, 0)][i]
    return torch.cat([grads[(0, m)][i]
                      for m in range(rules.model_ranks())], dim=d)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_fsdp_sp_train_step_matches_unsharded(arch, shape):
    cfg, model = arch["cfg"], arch["model"]
    rules = make_rules(cfg, StandInMesh(shape), TRAIN_4K)
    opt = AdamWConfig(**TRAIN_GOLDEN_OPT)
    with activations(torch.float32):
        batch = _batch(cfg)
        _, want = rank_loss_and_grads(model, arch["ttree"], batch,
                                      make_rules(cfg, None, TRAIN_4K),
                                      remat_policy="none")
        one = init_state(tree_map(torch.clone, arch["ttree"]))
        _, m1 = make_train_step(model, opt=opt, remat_policy="none")(
            one, batch)
        states = standin_states(rules, arch["ttree"])
        _, grads = standin_loss_and_grads(
            model, rules, {c: s.params for c, s in states.items()}, batch)
        _, m = standin_train_step(model, rules, opt=opt)(states, batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(m1[k])) <= RTOL * abs(float(m1[k])), k
    for i, (path, w) in enumerate(leaves_with_paths(want)):
        g = _whole_grad(rules, grads, path, w.ndim, i)
        assert _close(g, w) <= 1, path


def _serve_unsharded(arch, prompt, cache_len=CACHE_LEN, batch=B):
    """The unsharded fp32 prefill of ``prompt`` tokens and ``STEPS``
    decode steps' logits, and the engine's tokens."""
    model, params = arch["model"], arch["params32"]
    toks = arch["tokens"][:batch]
    mem = None if arch["memory"] is None else arch["memory"][:batch].float()
    out = []
    logits, caches, cur = model.prefill(params, toks[:, :prompt], cache_len,
                                        memory=mem)
    out.append(logits)
    for t in range(STEPS):
        logits, caches, cur = model.decode_step(params, caches,
                                                toks[:, prompt + t], cur)
        out.append(logits)
    prompts = [[int(t) for t in row[:n]] for row, n in
               zip(toks.tolist(), (prompt, 3, prompt - 1, 5))]
    gen = ServingEngine(model, params, cache_len=cache_len).generate(
        prompts, STEPS, memory=mem)
    return out, prompts, gen, mem


def _serve_sharded(arch, rules, prompt, mesh, prompts, mem,
                   cache_len=CACHE_LEN, batch=B):
    """Each rank's prefill, decode logits (whole vocabulary), caches and
    engine tokens under ``rules``."""
    model = arch["model"]
    toks = arch["tokens"][:batch]

    def serve(coord):
        p = rules.rank_tree(arch["params32"])
        rows = _rows(rules, toks)
        m = None if mem is None else _rows(rules, mem)
        steps = []
        logits, caches, cur = model.prefill(p, rows[:, :prompt], cache_len,
                                            memory=m, rules=rules)
        steps.append(vocab_logits(logits, rules))
        first = caches
        for t in range(STEPS):
            logits, caches, cur = model.decode_step(
                p, caches, rows[:, prompt + t], cur, rules=rules)
            steps.append(vocab_logits(logits, rules))
        gen = ServingEngine(model, p, rules=rules,
                            cache_len=cache_len).generate(prompts, STEPS,
                                                          memory=mem)
        return steps, first, gen
    return mesh.run(serve)


def _hold_served(arch, rules, out, want, want_gen):
    for t in range(STEPS + 1):
        got = _whole_rows(rules, out, lambda v: v[0][t])
        assert not torch.isnan(got).any()
        assert _close(got, want[t]) <= 1, ("step", t)
    assert all(gen == want_gen for _, _, gen in out.values())


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_fsdp_sp_prefill_then_decode_match_unsharded(arch, shape):
    """The prefill cell's rules split the prompt's sequence: the caches
    it builds (from K/V gathered whole, the recurrences' whole-sequence
    state) serve the decode steps after it."""
    cfg = arch["cfg"]
    mesh = StandInMesh(shape)
    rules = make_rules(cfg, mesh, PREFILL_32K)
    assert rules.shards("seq") == shape[1]
    with activations(torch.float32):
        want, prompts, want_gen, mem = _serve_unsharded(arch, PROMPT)
        out = _serve_sharded(arch, rules, PROMPT, mesh, prompts, mem)
    _hold_served(arch, rules, out, want, want_gen)


@pytest.mark.parametrize("n", [8, 5, 3, 1],
                         ids=["runs2222", "runs2210", "runs1110", "runs1000"])
def test_seq_last_is_the_last_position_on_every_rank(n):
    """``AxisRules.seq_last``: the row of position ``n - 1`` on every rank
    of a sequence split over 4, from the last rank that holds a run (the
    ranks past the end hold none)."""
    cfg = get_config("gemma3-1b").reduced()
    mesh = StandInMesh((1, 4))
    rules = make_rules(cfg, mesh, PREFILL_32K)
    x = torch.arange(2 * n * 3, dtype=torch.float32).reshape(2, n, 3)

    def rank(coord):
        lo, m = rules.seq_slice("seq", n)
        return m, rules.seq_last(x[:, lo:lo + m], "res_seq", n)
    got = mesh.run(rank)
    assert [got[(0, r)][0] for r in range(4)] == \
        [b for _, b in rules.seq_slices("seq", n)]
    for _, row in got.values():
        assert torch.equal(row, x[:, -1:])


def test_a_sequence_that_leaves_a_rank_empty(arch):
    """5 positions over 4 ranks (runs of 2, 2, 1, 0): the last rank
    computes on an empty run, the forward's logits (whole vocabulary) are
    the unsharded forward's, and the prefill's last logits, which come
    from the rank that holds position 4, the unsharded prefill's
    (fp32)."""
    cfg, model = arch["cfg"], arch["model"]
    mesh = StandInMesh((1, 4))
    toks = arch["tokens"][:, :5]
    mem = None if arch["memory"] is None else arch["memory"].float()
    p = arch["params32"]
    with activations(torch.float32):
        for cell in (TRAIN_4K, PREFILL_32K):
            rules = make_rules(cfg, mesh, cell)
            assert [b for _, b in rules.seq_slices("seq", 5)] == \
                [2, 2, 1, 0]
            if cell is TRAIN_4K:
                want = model.forward(p, toks, mem)[0]
                got = mesh.run(lambda c: vocab_logits(model.forward(
                    rules.rank_tree(p), toks, mem, rules=rules)[0], rules))
            else:
                want = model.prefill(p, toks, CACHE_LEN, memory=mem)[0]
                got = mesh.run(lambda c: vocab_logits(model.prefill(
                    rules.rank_tree(p), toks, CACHE_LEN, memory=mem,
                    rules=rules)[0], rules))
            for v in got.values():
                assert _close(v, want) <= 1, cell.name


# -- kv_seq: a decode cache's sequence over ranks ----------------------------

KV_SEQ = (("gemma3-1b", (1, 2), DECODE_32K),
          ("gemma3-1b", (1, 4), DECODE_32K),
          ("granite-moe-1b-a400m", (1, 4), DECODE_32K),
          ("whisper-tiny", (1, 4), DECODE_32K),
          ("gemma3-1b", (2, 1), LONG_500K),
          ("gemma3-1b", (2, 2), LONG_500K))


@pytest.mark.parametrize("name,shape,cell", KV_SEQ,
                         ids=[f"{n}-{c.name}-{_ids(s)}" for n, s, c in KV_SEQ])
def test_kv_seq_decode_matches_unsharded(name, shape, cell):
    """A rank keeps its run of each full-length cache (every KV head), the
    token's slot is written where it lies, and the ranks' partials are
    combined by their log-sum-exp; 8 prompt tokens and 4 steps of a
    24-slot cache leave the last rank's slice empty throughout at 4
    ranks (no NaN)."""
    arch = _load(name)
    cfg = arch["cfg"]
    batch = 1 if cell is LONG_500K else B
    mesh = StandInMesh(shape)
    rules = make_rules(cfg, mesh, cell)
    ranks = rules.shards("kv_seq")
    assert ranks == shape[0] * shape[1] if cell is LONG_500K \
        else ranks == shape[1]
    with activations(torch.float32):
        want, prompts, want_gen, mem = _serve_unsharded(
            arch, PROMPT, batch=batch)
        out = _serve_sharded(arch, rules, PROMPT, mesh, prompts, mem,
                             batch=batch)
    _hold_served(arch, rules, out, want, want_gen)
    n = -(-CACHE_LEN // ranks)
    for coord, (_, caches, _) in out.items():
        for kind, c in zip(layer_kinds(cfg), caches):
            kv = c.self_kv if kind == "cross" else c
            if kind == "local":
                assert type(kv) is KVCache and kv.k.shape[1] == cfg.window
                continue
            assert type(kv) is KVSlice and kv.start % n == 0
            assert kv.k.shape[1] == min(n, CACHE_LEN - kv.start)
            assert kv.k.shape[2] == cfg.n_kv_heads
            if kind == "cross":
                assert c.mem_k.shape[1] == cfg.memory_len()


def test_an_empty_slice_gives_no_nan():
    """A rank's slice past ``cur_len`` (or a rank with no slot at all):
    its partial is ``out = 0``, ``lse = -inf`` (the plain decode and the
    kernel's plain version alike), it weighs nothing in the combine, and the ranks' combine over
    a cache of 4 slices with 2 of them empty is the attention over the
    whole cache."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16))).float()
    k = torch.from_numpy(rng.standard_normal((2, 24, 1, 16))).float()
    v = torch.from_numpy(rng.standard_normal((2, 24, 1, 16))).float()
    o, lse = decode_attention(q, k[:, :6], v[:, :6], 0, softcap=None,
                              return_lse=True)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.isneginf(lse).all()
    o2, lse2 = ring_decode_attention_plain(q[:, 0], k[:, :6], v[:, :6], 0,
                                           window=6, return_lse=True)
    assert torch.equal(o2, torch.zeros_like(o2))
    assert torch.isneginf(lse2).all()
    # a rank past the end of a cache shorter than the ranks (no slot)
    o3, lse3 = transformer._decode_attn(q, k[:, :0], v[:, :0], 0,
                                        softcap=None, ring=False, window=0,
                                        plain=True, return_lse=True)
    assert torch.equal(o3, torch.zeros_like(o3))
    assert torch.isneginf(lse3).all()
    cur = 10
    want = decode_attention(q, k, v, cur, softcap=None)
    mesh = StandInMesh((1, 4))
    rules = make_rules(get_config("gemma3-1b").reduced(), mesh, DECODE_32K)

    def rank(coord):
        lo, n = rules.seq_slice("kv_seq", 24)
        local = min(max(cur - lo, 0), n)
        o, lse = decode_attention(q, k[:, lo:lo + n], v[:, lo:lo + n], local,
                                  softcap=None, return_lse=True)
        return local, combine_partials(o, lse, rules)
    out = mesh.run(rank)
    assert [out[(0, m)][0] for m in range(4)] == [6, 4, 0, 0]
    for _, got in out.values():
        assert not torch.isnan(got).any()
        assert _close(got, want) <= 1


@pytest.mark.parametrize("case", SLICE_DECODE_CASES, ids=lambda c: c.name)
def test_return_lse_of_the_plain_version(case):
    """``ring_decode_attention_plain(..., return_lse=True)`` on the
    slices the card runs: the output of the call without it where a row
    has valid slots, 0 where it has none, and ``lse`` the exact
    log-sum-exp of the valid scores (``-inf`` on an empty row)."""
    q, k, v, seq = decode_inputs(case)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    seq = seq if isinstance(seq, int) else torch.from_numpy(seq)
    out, lse = ring_decode_attention_plain(*args, seq, **case.kwargs,
                                           return_lse=True)
    rows = torch.as_tensor(seq).expand(case.batch)
    full = ring_decode_attention_plain(*args, seq, **case.kwargs)
    exact = ring_decode_ref(*args, seq, window=case.window)
    qf = args[0].float().reshape(case.batch, case.kv_heads, -1,
                                 case.head_dim) * case.head_dim ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qf, args[1].float())
    slot = torch.arange(case.window)
    valid = slot < rows[:, None, None, None]
    want = torch.logsumexp(s.masked_fill(~valid, float("-inf")), -1) \
        .reshape(case.batch, -1)
    _, bad = compare_lse(lse.numpy(), want.numpy())
    assert bad is None, bad
    for b in range(case.batch):
        if int(rows[b]) < 1:
            assert torch.equal(out[b], torch.zeros_like(out[b]))
        else:
            assert torch.equal(out[b], full[b])
            assert (out[b].float() - exact[b].float()).abs().max() <= \
                2 ** -7 * float(exact[b].float().abs().max())


# -- sp_residual against tp ---------------------------------------------------

@pytest.mark.parametrize("shape", ((1, 2), (2, 2)), ids=_ids)
def test_sp_residual_matches_tp(tp_arch, shape, monkeypatch):
    """Megatron-SP: the residual split on ``model``, each block gathering
    it at its entry and scattering its row-parallel sums; the forward
    logits and one step's gradients are ``tp``'s exactly (fp32), and the
    bf16 logits too."""
    arch = tp_arch
    cfg, model = arch["cfg"], arch["model"]
    mesh = StandInMesh(shape)
    tp = make_rules(cfg, mesh, TRAIN_4K)
    sp = dataclasses.replace(tp, sp_residual=True)
    assert sp.scatters_residual() and not tp.scatters_residual()
    seen = _counting(monkeypatch)
    for dtype, key in ((torch.float32, "params32"),
                       (torch.bfloat16, "params16")):
        got = {}
        with activations(dtype):
            mem = None if arch["memory"] is None else \
                arch["memory"].to(dtype)
            for name, rules in (("tp", tp), ("sp", sp)):
                def forward(coord):
                    m = None if mem is None else _rows(rules, mem)
                    logits, aux = model.forward(
                        rules.rank_tree(arch[key]),
                        _rows(rules, arch["tokens"]), m, rules=rules)
                    return vocab_logits(logits, rules), aux
                got[name] = mesh.run(forward)
        for c in got["tp"]:
            assert torch.equal(got["sp"][c][0], got["tp"][c][0]), dtype
    assert "res_seq" in seen
    with activations(torch.float32):
        batch = _batch(cfg)
        grads = {}
        for name, rules in (("tp", tp), ("sp", sp)):
            states = standin_states(rules, arch["ttree"])
            grads[name] = standin_loss_and_grads(
                model, rules, {c: s.params for c, s in states.items()},
                batch)
    assert torch.equal(grads["sp"][0], grads["tp"][0])
    for c in grads["tp"][1]:
        for g, w in zip(grads["sp"][1][c], grads["tp"][1][c]):
            assert _close(g, w) <= 1


# -- the recurrence's carry and halo ------------------------------------------

@pytest.mark.parametrize("n", [14, 3], ids=["runs4442", "runs1110"])
def test_the_scan_carry_and_conv_halo_are_the_whole_sequences(n):
    """rglru over a sequence split on 4 ranks (runs of 4, 4, 4, 2; and of
    1, 1, 1, 0, shorter than the conv's halo): each rank's output is its
    run of the whole sequence's, whose conv is ``_conv`` and scan
    ``_assoc_scan`` over all of it, and every rank returns the whole
    sequence's cache (last ``h``, conv tail).  With ``lru_lambda`` as
    drawn, ``a_t`` is near ``exp(-30)`` and the carry is gone a step into
    a run; so the block is also held with it slowed to [-1.2, -0.9]
    (``a_t`` near ``1 - 1e-3``), where every earlier rank's carry reaches
    each run: rank 2's run of 4 scanned from zero state (no carry, no
    halo) then misses the whole sequence's by over 100 times the
    tolerance."""
    arch = _load("recurrentgemma-2b")
    cfg = arch["cfg"]
    assert layer_kinds(cfg)[0] == "rec"
    drawn = train_params(cfg, arch["ttree"])["layers"][0]["rec"]
    slow = dict(drawn, lru_lambda=torch.linspace(
        -1.2, -0.9, drawn["lru_lambda"].numel()))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, n, cfg.d_model)).astype(np.float32))
    mesh = StandInMesh((1, 4))
    rules = make_rules(cfg, mesh, TRAIN_4K)
    for p in (drawn, slow):
        want, cache = rglru.rec_forward(p, x, cfg, return_cache=True)
        # the whole sequence's conv and scan, written out
        h = rglru.apply_norm(p["ln"], x, cfg)
        xs = rglru.matmul(h, p["lru_w_x"])
        K = p["lru_conv"].shape[0]
        full = torch.cat([torch.zeros_like(xs[:, :K - 1]), xs], 1) \
            if n >= K - 1 else torch.cat(
                [xs.new_zeros((2, K - 1, xs.shape[2])), xs], 1)
        a, bx = rglru._gates(p, rglru._conv(full, p["lru_conv"], n))
        hseq = rglru._assoc_scan(a, bx)

        def rank(coord):
            lo, m = rules.seq_slice("seq", n)
            out, c = rglru.rec_forward(p, x[:, lo:lo + m], cfg,
                                       return_cache=True, rules=rules,
                                       total=n)
            return lo, m, out, c
        got = mesh.run(rank)
        assert [got[(0, r)][1] for r in range(4)] == \
            ([4, 4, 4, 2] if n == 14 else [1, 1, 1, 0])
        whole = torch.cat([got[(0, r)][2] for r in range(4)], dim=1)
        if n >= K - 1:
            assert _close(whole, want) <= 1
        for _, _, _, c in got.values():
            assert _close(c.h, hseq[:, -1]) <= 1
            assert torch.equal(c.conv, full[:, -(K - 1):])
            if n >= K - 1:
                assert _close(c.h, cache.h) <= 1
                assert torch.equal(c.conv, cache.conv)
        if p is slow and n == 14:
            lo, m = got[(0, 2)][:2]
            alone, _ = rglru.rec_forward(p, x[:, lo:lo + m], cfg)
            assert _close(alone, want[:, lo:lo + m]) > 100


@pytest.mark.parametrize("name", ["gemma3-1b", "recurrentgemma-2b",
                                  "whisper-tiny"])
def test_every_rank_enters_every_gathers_backward(name, monkeypatch):
    """Over a process group a gather's backward is a collective that every
    rank must enter, so every gather's result must lie in every rank's
    loss graph, though the first rank reads no row of the halo and the
    carry that the ranks before it would send: the gradient of each
    rank's loss reaches each of its gathers (``allow_unused=False``)."""
    from repro_torch.parallel import collectives

    arch = _load(name)
    cfg, model = arch["cfg"], arch["model"]
    mesh = StandInMesh((1, 4))
    rules = make_rules(cfg, mesh, TRAIN_4K)
    real = collectives.mesh_cat
    seen = {c: [] for c in mesh.coords()}

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen[tuple(mesh.get_coordinate())].append(out)
        return out
    monkeypatch.setattr(collectives, "mesh_cat", spy)
    batch = _batch(cfg)
    with activations(torch.float32):
        params = tree_map(lambda t: t.clone().requires_grad_(True),
                          arch["ttree"])
        losses = mesh.run(lambda c: model.loss(
            params, {k: _rows(rules, v) for k, v in batch.items()},
            remat_policy="none", rules=rules)[0])
    for c, loss in losses.items():
        assert seen[c]
        grads = torch.autograd.grad(loss, seen[c], retain_graph=True)
        assert all(g is not None for g in grads)


# -- check_executable over every cell -----------------------------------------

@pytest.mark.parametrize("mesh", [((16, 16), ("data", "model"), False),
                                  ((2, 16, 16), ("pod", "data", "model"),
                                   True)], ids=["16x16", "2x16x16"])
def test_check_executable_takes_every_cell(mesh):
    """Every ``(arch, cell)`` pair of ``cells_for`` (34) on the dry-run's
    meshes passes ``check_executable``; a width that does not divide
    still raises ``ValueError``."""
    shape, names, multi_pod = mesh
    pairs = [(arch, cell) for arch in sorted(ARCH_REGISTRY)
             for cell in cells_for(get_config(arch))]
    assert len(pairs) == 34
    for arch, cell in pairs:
        cfg = get_config(arch)
        check_executable(cfg, make_rules(cfg, FakeMesh(names, shape), cell,
                                         multi_pod=multi_pod))
    odd = shape[:-1] + (3,)   # 262,144 vocabulary rows over 3 ranks
    cfg = get_config("gemma3-1b")
    with pytest.raises(ValueError, match="does not divide"):
        check_executable(cfg, make_rules(cfg, FakeMesh(names, odd),
                                         TRAIN_4K, multi_pod=multi_pod))
