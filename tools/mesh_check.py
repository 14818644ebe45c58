#!/usr/bin/env python3
"""Hold the port's mesh path on several gloo ranks against one process,
on the host CPU.

    python3 tools/mesh_check.py [--ranks RANKS] [--timeout 600]

It spawns ``--ranks`` processes (``RANKS``, 4, by default), joined into one gloo
group over a ``FileStore`` in a temporary directory (no port, no
environment variables).  They import no JAX and run every kernel's
plain version (the tensors lie on the CPU).  Each rank holds, against
the same work done in one process (which each rank also does):

* the collectives: ``compressed_psum`` and ``bucketed_psum`` (compressed
  and not) over the group equal ``*_psum_stacked`` over the ranks'
  inputs, bitwise when compressed, else within rtol 1e-6, atol 1e-6 x
  max (the fp32 sums run in another order); ``mesh_cat`` (all-gather,
  backward reduce-scatter) and ``mesh_scatter_sum`` (reduce-scatter,
  backward all-gather) on uneven runs over one and two mesh dims, the
  forward and the gradient against the sums in one process;
* training: reduced gemma3-1b, ``STEPS`` steps of ``make_train_step`` at
  ``BATCH`` x ``SEQ`` tokens on DTensor state placed by
  ``params_shardings``, the batch from ``sharded_batch``, on a ``data``
  mesh of every rank and on a ``(pod, data, model) = (2, ranks / 2, 1)``
  mesh under ``multi_pod``.  With fp32 activations (the model's
  ``ACT_DTYPE``; only the order of the fp32 sums differs) each step's
  loss and grad_norm lie within rtol 1e-5 of the one-process step's,
  and every parameter after the last step, gathered, within rtol 1e-5,
  atol 1e-6 x its max.  With bf16 activations (on the ``data`` mesh)
  each rank's partial weight gradient is rounded to bf16 before the
  ranks' sum, as in any bf16 data-parallel step (it moves a gradient by
  about 0.5% of its leaf's max), so there the losses and grad_norms are
  held within the train golden's rtol 2e-2;
* the checkpoint: a checkpoint that one process wrote, restored with
  ``shardings=`` on the mesh, gives each rank exactly its piece (the
  slice ``Sharding.local`` cuts, and the local tensor of DTensor's own
  ``distribute_tensor``); the mesh's save of its trained state writes
  the files one process writes of the same values (every npz member
  byte for byte; the manifests alike but for their clock time);
* the trainer: ``train_loop(..., rules=)`` on the ``data`` mesh for 2
  steps, then again to step 3 from its checkpoint (restored onto the
  mesh with ``shardings=``), with fp32 activations: its last loss within
  rtol 1e-5 of one process's 3-step ``train_loop``;
* serving: reduced gemma3-1b, ``len(PROMPT_LENS)`` prompts over the
  ``data`` mesh, params placed by ``params_shardings``: the one-process
  engine's tokens;
* tensor parallelism: reduced granite-moe and mamba2 (``tp``) on
  ``(data, model) = (1, ranks)`` and ``(2, ranks / 2)``, with fp32
  activations on DTensor state (each block's weights the rank's
  ``model`` shard; the model's sums over the ``model`` process group):
  the first step's gradient of every leaf, in its placements gathered
  whole, within rtol 1e-5, atol 1e-6 x max of one process's, and each
  of ``STEPS`` steps' loss and grad_norm within rtol 1e-5 (the
  parameters after three steps are not held element by element: AdamW
  magnifies a rounding of a gradient element near its ``eps``, 1e-8, so
  that a few of some 90,000 lie up to 5x past the tolerance; the
  one-process stand-in shows the same); served, the one-process
  engine's tokens (with fp32 activations: the ranks' bf16 products
  round apart from one device's, and a near tie may flip a token);
* global MoE routing: reduced granite-moe on a ``data`` mesh of every
  rank, the same checks and its parameters after the last step at the
  training tolerances above;
* sequence parallelism: reduced gemma3-1b and recurrentgemma-2b
  (``fsdp_sp``: each rank a run of the positions, K/V, the scan carry
  and the conv halo gathered over the ``model`` process group, whose
  gathers' backward reduce-scatters the gradients to the runs' ranks) on
  ``(data, model) = (1, ranks)`` and ``(2, ranks / 2)``, the same checks
  as tensor parallelism's; served under the decode cell's rules
  (gemma3-1b's global caches split on ``kv_seq`` over the ``model``
  ranks, the partial attentions combined by their log-sum-exp), the
  one-process engine's tokens;
* the refusals: a ``rec`` block under ``tp`` over a ``model`` axis above
  1 raises ``NotImplementedError``; ``fsdp_sp`` over a ``model`` axis,
  an MoE config under a batch axis and a ``tp`` one over a ``model``
  axis do not.

A rank that fails or outlives ``--timeout`` fails the check (exit 1);
the others are ended.  The last line of the output is the JSON record.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import io
import json
import os
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = 4
SEED = 0
ARCH = "gemma3-1b"
MOE_ARCH = "granite-moe-1b-a400m"
#: The tensor-parallel checks' configs (``shard_mode`` ``"tp"``).
TP_ARCHS = (MOE_ARCH, "mamba2-780m")
SP_ARCHS = (ARCH, "recurrentgemma-2b")
STEPS, BATCH, SEQ = 3, 8, 32
PROMPT_LENS = (5, 9, 12, 16)
MAX_NEW, CACHE_LEN = 8, 48
RTOL, ATOL_REL = 1e-5, 1e-6
SUM_RTOL = SUM_ATOL_REL = 1e-6
#: Seconds a collective may wait for a rank before it fails.
COLLECTIVE_TIMEOUT_S = 120


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"mesh check: {what}")


def _close(got, want, rtol, atol_rel) -> float:
    """The largest |got - want| over (atol + rtol |want|), 0 if empty."""
    import torch

    got, want = got.double(), want.double()
    if want.numel() == 0:
        return 0.0
    atol = atol_rel * float(want.abs().max())
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


# -- the checks, on every rank ------------------------------------------------

def check_collectives(rank: int, world: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.parallel import (bucketed_psum, bucketed_psum_stacked,
                                      compressed_psum,
                                      compressed_psum_stacked)

    def draw(r):
        rng = np.random.default_rng([SEED, r])
        x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
        tree = {"w": torch.from_numpy(
                    (rng.standard_normal((13, 17)) * 3).astype(np.float32)),
                "b": torch.from_numpy(rng.standard_normal(7)
                                      .astype(np.float32)).to(torch.bfloat16)}
        return x * (r + 1), tree
    mine, everyone = draw(rank), [draw(r) for r in range(world)]
    got = compressed_psum(mine[0])
    want = compressed_psum_stacked([x for x, _ in everyone])[rank]
    _check(torch.equal(got, want), "compressed_psum differs from the "
           "one-process form")
    worst = 0.0
    for compressed in (True, False):
        got = bucketed_psum(mine[1], bucket_bytes=256, compressed=compressed)
        want = bucketed_psum_stacked([t for _, t in everyone],
                                     bucket_bytes=256,
                                     compressed=compressed)[rank]
        for k in want:
            _check(got[k].dtype == want[k].dtype, f"bucketed {k} dtype")
            if compressed:
                _check(torch.equal(got[k], want[k]),
                       f"compressed bucketed_psum {k} differs")
            else:
                err = _close(got[k], want[k], SUM_RTOL, SUM_ATOL_REL)
                _check(err <= 1, f"bucketed_psum {k} off by {err:.3g} of "
                       "the tolerance")
                worst = max(worst, err)
    return {"compressed": "bitwise", "bucketed_worst_of_tolerance": worst}


def check_runs(rank: int, world: int) -> dict:
    """``mesh_cat`` (an all-gather, its backward a reduce-scatter) and
    ``mesh_scatter_sum`` (a reduce-scatter, its backward an all-gather)
    on runs of a dim of 7 (2, 2, 2, 1 over four ranks; 4, 3 over two)
    along the ``model`` dim of ``(1, ranks)`` and ``(2, ranks / 2)``
    meshes and along both dims of the latter: each rank's forward and
    gradient against the same sums over every rank's draws in one
    process."""
    import itertools

    import numpy as np
    import torch

    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import run_of

    n, out, worst = 7, {}, 0.0
    for shape, dims in (((1, world), (1,)), ((2, world // 2), (1,)),
                        ((2, world // 2), (0, 1))):
        mesh = _mesh(shape, ("data", "model"))
        coord = mesh.get_coordinate()
        counts = [shape[d] for d in dims]
        idx = list(itertools.product(*(range(c) for c in counts)))
        runs = [run_of(n, counts, i) for i in idx]
        lengths = [m for _, m in runs]
        me = idx.index(tuple(coord[d] for d in dims))
        peers = [tuple(c[d] if d in dims else coord[d] for d in range(2))
                 for c in itertools.product(*(range(k) for k in shape))
                 if all(c[d] == coord[d] for d in range(2) if d not in dims)]

        def draw(c, what, rows):
            rng = np.random.default_rng([SEED, 7, *c, what])
            return torch.from_numpy(rng.standard_normal((3, rows, 5))
                                    .astype(np.float32))
        x = draw(coord, 0, lengths[me]).requires_grad_()
        whole = collectives.mesh_cat(mesh, dims, x, 1, lengths, me)
        want = torch.cat([draw(c, 0, m) for c, m in zip(peers, lengths)], 1)
        _check(torch.equal(whole.detach(), want),
               f"mesh_cat on {shape} over dims {dims} differs from the "
               "runs joined")
        (gx,) = torch.autograd.grad((whole * draw(coord, 1, n)).sum(), x)
        lo, m = runs[me]
        want = sum(draw(c, 1, n) for c in peers).narrow(1, lo, m)
        err = _close(gx, want, SUM_RTOL, SUM_ATOL_REL)
        _check(err <= 1, f"mesh_cat's gradient on {shape} over dims "
               f"{dims} off by {err:.3g} of the tolerance")
        worst = max(worst, err)
        y = draw(coord, 2, n).requires_grad_()
        part = collectives.mesh_scatter_sum(mesh, dims, y, 1, lengths, me)
        want = sum(draw(c, 2, n) for c in peers).narrow(1, lo, m)
        err = _close(part.detach(), want, SUM_RTOL, SUM_ATOL_REL)
        _check(err <= 1 and part.shape == want.shape,
               f"mesh_scatter_sum on {shape} over dims {dims} off by "
               f"{err:.3g} of the tolerance")
        (gy,) = torch.autograd.grad((part * draw(coord, 3, m)).sum(), y)
        want = torch.cat([draw(c, 3, k) for c, k in zip(peers, lengths)], 1)
        _check(torch.equal(gy, want), f"mesh_scatter_sum's gradient on "
               f"{shape} over dims {dims} differs from the runs joined")
        worst = max(worst, err)
        out[f"{shape} over dims {dims}"] = lengths
    return {"runs": out, "sums_worst_of_tolerance": worst}


def _mesh(shape, names):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(
        int(torch.tensor(shape).prod())).reshape(shape),
        mesh_dim_names=names)


def _state_shardings(rules, state):
    return state._replace(step=None,
                          params=rules.params_shardings(state.params),
                          mu=rules.params_shardings(state.mu),
                          nu=rules.params_shardings(state.nu))


def _whole(tree):
    from repro_torch.parallel.sharding import is_dtensor
    from repro_torch.train.tree import tree_map

    return tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x, tree)


def _fresh_state(tree):
    import numpy as np
    import torch

    from repro_torch.train import init_state
    from repro_torch.train.tree import leaves, unflatten_like

    return init_state(unflatten_like(tree, [
        torch.from_numpy(np.array(a, np.float32)) for a in leaves(tree)]))


@contextlib.contextmanager
def activations(dtype):
    """The model's activations in ``dtype`` while open."""
    from repro_torch.models import transformer

    saved = transformer.ACT_DTYPE
    transformer.ACT_DTYPE = dtype
    try:
        yield
    finally:
        transformer.ACT_DTYPE = saved


def one_process_training(cfg, tree):
    """``(metrics a step, state)`` of ``STEPS`` plain steps."""
    from repro_torch.kernels.cases import TRAIN_GOLDEN_OPT
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, make_train_step,
                                   synthetic_batch)

    step = make_train_step(build_model(cfg),
                           opt=AdamWConfig(**TRAIN_GOLDEN_OPT))
    state, metrics = _fresh_state(tree), []
    for i in range(STEPS):
        state, m = step(state, synthetic_batch(cfg, BATCH, SEQ, i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def mesh_training(cfg, tree, rules):
    """``(metrics a step, DTensor state)`` of ``STEPS`` steps on the
    mesh of ``rules``."""
    from repro_torch.kernels.cases import TRAIN_GOLDEN_OPT
    from repro_torch.models import build_model
    from repro_torch.parallel import place_tree
    from repro_torch.train import AdamWConfig, make_train_step, sharded_batch

    step = make_train_step(build_model(cfg), rules,
                           opt=AdamWConfig(**TRAIN_GOLDEN_OPT))
    state = _fresh_state(tree)
    state = place_tree(state, _state_shardings(rules, state))
    rows = {"tokens": rules.sharding("batch", None),
            "labels": rules.sharding("batch", None)}
    metrics = []
    for i in range(STEPS):
        state, m = step(state, sharded_batch(cfg, BATCH, SEQ, i, rows))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def check_training(world: int, cfg, tree, one, bf16_one) -> dict:
    import torch

    from repro_torch.configs.base import TRAIN_4K
    from repro_torch.kernels.cases import TRAIN_RTOL
    from repro_torch.launch.specs import make_rules
    from repro_torch.train.tree import leaves, leaves_with_paths

    want_m, want_state = one
    out, states = {}, {}
    meshes = {f"data={world}": (_mesh((world, 1), ("data", "model")),
                                False),
              f"(pod, data, model)=(2, {world // 2}, 1)":
              (_mesh((2, world // 2, 1), ("pod", "data", "model")), True)}
    for label, (mesh, multi_pod) in meshes.items():
        rules = make_rules(cfg, mesh, TRAIN_4K, multi_pod=multi_pod)
        _check(rules.batch_shards() == world, f"{label}: the batch is "
               f"split {rules.batch_shards()} ways")
        if not multi_pod:
            bf16_m, _ = mesh_training(cfg, tree, rules)
            bf16_errs = {}
            for k in ("loss", "grad_norm"):
                bf16_errs[k] = max(abs(g[k] - w[k]) / abs(w[k])
                                   for g, w in zip(bf16_m, bf16_one))
                _check(bf16_errs[k] <= TRAIN_RTOL, f"{label}: bf16 {k} "
                       f"{[g[k] for g in bf16_m]} against one process's "
                       f"{[w[k] for w in bf16_one]}")
        with activations(torch.float32):
            got_m, state = mesh_training(cfg, tree, rules)
        errs = {}
        for k in ("loss", "grad_norm"):
            errs[k] = max(abs(g[k] - w[k]) / abs(w[k])
                          for g, w in zip(got_m, want_m))
            _check(errs[k] <= RTOL, f"{label}: {k} {[g[k] for g in got_m]}"
                   f" against one process's {[w[k] for w in want_m]}")
        placed = [p.placements for p in leaves(state.params)]
        whole = leaves(_whole(state.params))
        worst = 0.0
        for (path, w), g in zip(leaves_with_paths(want_state.params), whole):
            err = _close(g, w, RTOL, ATOL_REL)
            _check(err <= 1, f"{label}: parameter {'/'.join(path)} after "
                   f"step {STEPS} off by {err:.3g} of the tolerance")
            worst = max(worst, err)
        out[label] = {"loss": [m["loss"] for m in got_m],
                      "grad_norm": [m["grad_norm"] for m in got_m],
                      "rel_err": errs, "params_worst_of_tolerance": worst,
                      "sharded_leaves": sum(
                          any(type(p).__name__ == "Shard" for p in pl)
                          for pl in placed),
                      "leaves": len(placed)}
        if not multi_pod:
            out[label].update(bf16_loss=[m["loss"] for m in bf16_m],
                              bf16_rel_err=bf16_errs)
        states[label] = (rules, state)
    out["one_process"] = {"loss": [m["loss"] for m in want_m],
                          "grad_norm": [m["grad_norm"] for m in want_m],
                          "bf16_loss": [m["loss"] for m in bf16_one]}
    return out, states


def _same_files(a: str, b: str) -> None:
    import zipfile

    names = sorted(os.listdir(a))
    _check(names == sorted(os.listdir(b)), f"files {names} against "
           f"{sorted(os.listdir(b))}")
    with open(os.path.join(a, "MANIFEST.json")) as f, \
            open(os.path.join(b, "MANIFEST.json")) as g:
        ma, mb = json.load(f), json.load(g)
    ma.pop("time")
    mb.pop("time")
    _check(ma == mb, "the manifests differ")
    with zipfile.ZipFile(os.path.join(a, "shard_00000.npz")) as za, \
            zipfile.ZipFile(os.path.join(b, "shard_00000.npz")) as zb:
        _check(za.namelist() == zb.namelist(), "npz members differ")
        for n in za.namelist():
            _check(za.read(n) == zb.read(n), f"npz member {n} differs")


def check_checkpoint(rank: int, tmp: str, one_state, states) -> dict:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train.tree import leaves, leaves_with_paths

    label = next(iter(states))
    rules, mesh_state = states[label]
    like = one_state
    shardings = _state_shardings(rules, like)
    # written by one process (rank 0), restored on every rank
    one_dir = os.path.join(tmp, "one")
    if rank == 0:
        CheckpointManager(one_dir).save(STEPS, one_state)
    dist.barrier()
    restored = CheckpointManager(one_dir).restore(like, shardings=shardings)
    by_path = dict(leaves_with_paths(shardings))
    n = 0
    for (path, got), want in zip(leaves_with_paths(restored),
                                 leaves(one_state)):
        sh = by_path.get(path)
        if sh is None:
            _check(torch.equal(got, want), f"{path} restored unplaced")
            continue
        mine = got.to_local()
        _check(torch.equal(mine, sh.local(want)), f"rank {rank}'s piece "
               f"of {'|'.join(path)} is not its slice")
        _check(torch.equal(mine, distribute_tensor(
            want, sh.mesh, sh.placements).to_local()),
            f"rank {rank}'s piece of {'|'.join(path)} is not DTensor's")
        n += 1
    # the mesh's save against one process's save of the same values
    mesh_dir, same_dir = os.path.join(tmp, "mesh"), os.path.join(tmp, "same")
    CheckpointManager(mesh_dir).save(STEPS, mesh_state)
    same = _whole(mesh_state)   # every rank gathers; rank 0 saves
    if rank == 0:
        CheckpointManager(same_dir).save(STEPS, same)
        _same_files(os.path.join(mesh_dir, f"step_{STEPS:010d}"),
                    os.path.join(same_dir, f"step_{STEPS:010d}"))
    return {"placed_leaves_restored": n, "mesh": label,
            "files": "npz members byte for byte, manifests but the time"}


def check_train_loop(rank: int, world: int, tmp: str, cfg, tree) -> dict:
    import torch

    from repro_torch.configs.base import TRAIN_4K
    from repro_torch.launch.specs import make_rules
    from repro_torch.launch.train import train_loop

    kw = dict(batch=BATCH, seq=SEQ // 2, ckpt_every=100, log_every=100,
              device="cpu", params=tree)
    rules = make_rules(cfg, _mesh((world, 1), ("data", "model")), TRAIN_4K)
    mesh_dir = os.path.join(tmp, "loop")
    with activations(torch.float32), \
            contextlib.redirect_stdout(io.StringIO()):   # its step lines
        want = train_loop(cfg, steps=3, ckpt_dir=os.path.join(
            tmp, f"loop_one_{rank}"), **kw)["final_loss"]
        train_loop(cfg, steps=2, ckpt_dir=mesh_dir, rules=rules, **kw)
        got = train_loop(cfg, steps=3, ckpt_dir=mesh_dir, rules=rules,
                         **kw)["final_loss"]
    _check(abs(got - want) <= RTOL * abs(want), f"train_loop resumed on "
           f"the mesh: loss {got} against one process's {want}")
    return {"resumed_loss": got, "one_process_loss": want}


def _params_worst(label, want, got, when=f" after step {STEPS}") -> float:
    """The largest error of ``got``'s leaves against ``want``'s over the
    tolerance (both whole trees); fails past it."""
    from repro_torch.train.tree import leaves, leaves_with_paths

    worst = 0.0
    for (path, w), g in zip(leaves_with_paths(want), leaves(got)):
        err = _close(g, w, RTOL, ATOL_REL)
        _check(err <= 1, f"{label}: parameter {'/'.join(path)}{when} off "
               f"by {err:.3g} of the tolerance")
        worst = max(worst, err)
    return worst


def _metric_errs(label, got_m, want_m) -> dict:
    errs = {}
    for k in ("loss", "grad_norm"):
        errs[k] = max(abs(g[k] - w[k]) / abs(w[k])
                      for g, w in zip(got_m, want_m))
        _check(errs[k] <= RTOL, f"{label}: {k} {[g[k] for g in got_m]} "
               f"against {[w[k] for w in want_m]}")
    return errs


def _first_grads(cfg, tree, rules):
    """The first step's gradients, whole: one process's (``rules`` None)
    or the mesh's (DTensor state placed by ``rules``, gathered)."""
    from repro_torch.models import build_model
    from repro_torch.parallel import place_tree
    from repro_torch.parallel.sharding import local_tree, no_sharding
    from repro_torch.train import sharded_batch, synthetic_batch
    from repro_torch.train.train_step import rank_loss_and_grads

    state = _fresh_state(tree)
    if rules is None:
        return rank_loss_and_grads(build_model(cfg), state.params,
                                   synthetic_batch(cfg, BATCH, SEQ, 0),
                                   no_sharding())[1]
    state = place_tree(state, _state_shardings(rules, state))
    rows = {"tokens": rules.sharding("batch", None),
            "labels": rules.sharding("batch", None)}
    batch = local_tree(sharded_batch(cfg, BATCH, SEQ, 0, rows))
    return _whole(rank_loss_and_grads(build_model(cfg), state.params, batch,
                                      rules)[1])


def _tokens(world, cfg, tree, shape) -> tuple[list, list]:
    """``(mesh's tokens, one process's)`` of the serve prompts, the mesh
    ``(data, model) = shape`` (the decode cell's rules where the decode
    cache may stay whole, else the prefill cell's)."""
    import numpy as np

    from repro_torch.configs.base import DECODE_32K, PREFILL_32K
    from repro_torch.launch.specs import make_rules
    from repro_torch.models import build_model, params_from_reference
    from repro_torch.parallel import place_tree
    from repro_torch.serve import ServingEngine

    model = build_model(cfg)
    params = params_from_reference(cfg, tree, "cpu")
    rng = np.random.default_rng([SEED, 3])
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, n)]
               for n in PROMPT_LENS]
    want = ServingEngine(model, params, cache_len=CACHE_LEN) \
        .generate(prompts, MAX_NEW)
    mesh = _mesh(shape, ("data", "model"))
    rules = make_rules(cfg, mesh, DECODE_32K)
    try:
        rules.check(cfg)
    except NotImplementedError:
        rules = make_rules(cfg, mesh, PREFILL_32K)
    placed = place_tree(params, rules.params_shardings(params))
    got = ServingEngine(model, placed, rules=rules, cache_len=CACHE_LEN) \
        .generate(prompts, MAX_NEW)
    return got, want


def check_tensor_parallel(world: int, archs=TP_ARCHS) -> dict:
    """The tensor-parallel and global-routing checks of every arch of
    :data:`TP_ARCHS`, or the sequence-parallel ones of
    :data:`SP_ARCHS` (see the module's docstring)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TRAIN_4K
    from repro_torch.kernels.cases import lm_params
    from repro_torch.launch.specs import make_rules

    out = {}
    for arch in archs:
        cfg = get_config(arch).reduced()
        tree = lm_params(cfg, SEED)
        with activations(torch.float32):
            one_m, one_state = one_process_training(cfg, tree)
            one_g = _first_grads(cfg, tree, None)
        shapes = [(1, world), (2, world // 2)]
        if cfg.n_experts:
            shapes.append((world, 1))
        for shape in shapes:
            label = f"{arch} (data, model)={shape}"
            rules = make_rules(cfg, _mesh(shape, ("data", "model")),
                               TRAIN_4K)
            with activations(torch.float32):
                grads = _first_grads(cfg, tree, rules)
                got_m, state = mesh_training(cfg, tree, rules)
            row = {"loss": [m["loss"] for m in got_m],
                   "rel_err": _metric_errs(label, got_m, one_m),
                   "grads_worst_of_tolerance": _params_worst(
                       f"{label}: the first step's gradient of", one_g,
                       grads, "")}
            if shape[1] == 1:
                row["params_worst_of_tolerance"] = _params_worst(
                    label, one_state.params, _whole(state.params))
            # over a model axis the ranks' bf16 products round apart from
            # one device's, and a near tie may flip: the tokens are held
            # with fp32 activations there
            with activations(torch.float32 if shape[1] > 1
                             else torch.bfloat16):
                got, want = _tokens(world, cfg, tree, shape)
            _check(got == want, f"{label}: the mesh's tokens {got} differ "
                   f"from one process's {want}")
            row["tokens"] = "one process's"
            out[label] = row
        out[f"{arch} one_process"] = {"loss": [m["loss"] for m in one_m]}
    return out


def check_serving(world: int, cfg, tree) -> dict:
    import numpy as np

    from repro_torch.configs.base import DECODE_32K
    from repro_torch.launch.specs import make_rules
    from repro_torch.models import build_model, params_from_reference
    from repro_torch.parallel import place_tree
    from repro_torch.serve import ServingEngine

    model = build_model(cfg)
    params = params_from_reference(cfg, tree, "cpu")
    rng = np.random.default_rng([SEED, 3])
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, n)]
               for n in PROMPT_LENS]
    want = ServingEngine(model, params, cache_len=CACHE_LEN) \
        .generate(prompts, MAX_NEW)
    rules = make_rules(cfg, _mesh((world, 1), ("data", "model")),
                       DECODE_32K)
    placed = place_tree(params, rules.params_shardings(params))
    got = ServingEngine(model, placed, rules=rules, cache_len=CACHE_LEN) \
        .generate(prompts, MAX_NEW)
    _check(got == want, f"the mesh's tokens {got} differ from one "
           f"process's {want}")
    return {"prompts": list(PROMPT_LENS), "tokens": got}


def check_refusals(world: int) -> dict:
    """A ``rec`` block under ``tp`` over a ``model`` axis raises;
    ``fsdp_sp`` (sequence parallelism) over a ``model`` axis, an MoE
    config under a batch axis and a ``tp`` one over a ``model`` axis do
    not."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TRAIN_4K
    from repro_torch.launch.specs import make_rules
    from repro_torch.models import build_model
    from repro_torch.train import make_train_step

    out = {}
    cases = {"rec under tp": ("recurrentgemma-2b", (world // 2, 2), True),
             "sequence parallelism": (ARCH, (world // 2, 2), False),
             "MoE under a batch axis": (MOE_ARCH, (world, 1), False),
             "tp over a model axis": (MOE_ARCH, (world // 2, 2), False)}
    for label, (arch, shape, raises) in cases.items():
        cfg = get_config(arch).reduced()
        if raises:
            cfg = dataclasses.replace(cfg, shard_mode="tp")
        rules = make_rules(cfg, _mesh(shape, ("data", "model")), TRAIN_4K)
        try:
            make_train_step(build_model(cfg), rules)
        except NotImplementedError as e:
            _check(raises, f"{label}: {arch} on {shape} raised {e}")
            out[label] = str(e)
            continue
        _check(not raises, f"{label}: {arch} on {shape} did not raise")
        out[label] = "runs"
    return out


def _rank_main(rank: int, world: int, store: str, out: str,
               threads: int) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels.cases import lm_params

        cfg = get_config(ARCH).reduced()
        tree = lm_params(cfg, SEED)
        record = {"ranks": world, "device": "cpu (gloo)", "seconds": {}}
        clock = time.perf_counter()

        def lap(name):
            nonlocal clock
            now = time.perf_counter()
            record["seconds"][name] = now - clock
            clock = now
        record["collectives"] = check_collectives(rank, world)
        record["collectives"].update(check_runs(rank, world))
        lap("collectives")
        bf16_one, _ = one_process_training(cfg, tree)
        with activations(torch.float32):
            one = one_process_training(cfg, tree)
        lap("one-process training")
        record["training"], states = check_training(world, cfg, tree, one,
                                                    bf16_one)
        lap("mesh training")
        record["checkpoint"] = check_checkpoint(rank, os.path.dirname(out),
                                                one[1], states)
        lap("checkpoint")
        record["train_loop"] = check_train_loop(
            rank, world, os.path.dirname(out), cfg, tree)
        lap("train_loop")
        record["serving"] = check_serving(world, cfg, tree)
        lap("serving")
        record["tensor_parallel"] = check_tensor_parallel(world)
        lap("tensor parallel")
        record["sequence_parallel"] = check_tensor_parallel(world, SP_ARCHS)
        lap("sequence parallel")
        record["refusals"] = check_refusals(world)
        lap("refusals")
        if rank == 0:
            with open(out, "w") as f:
                json.dump(record, f)
    finally:
        dist.destroy_process_group()


def run(ranks: int = RANKS, timeout: float = 600.0) -> dict:
    """Spawn the ranks, wait for them (each at most ``timeout`` seconds
    in all), and return rank 0's record; raise ``SystemExit`` if a rank
    failed or ran over."""
    import multiprocessing as mp

    if ranks < 2 or ranks % 2:
        raise SystemExit("mesh check: --ranks must be even and at least 2")
    ctx = mp.get_context("spawn")
    threads = max(1, (os.cpu_count() or ranks) // ranks)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "record.json")
        procs = [ctx.Process(target=_rank_main, args=(
            r, ranks, os.path.join(tmp, "store"), out, threads))
            for r in range(ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            late = [i for i, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        codes = [p.exitcode for p in procs]
        if late or any(codes):
            raise SystemExit(f"mesh check: ranks {late} ran over "
                             f"{timeout} s; exit codes {codes}")
        with open(out) as f:
            return json.load(f)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python3 tools/mesh_check.py")
    ap.add_argument("--ranks", type=int, default=RANKS)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    record = run(args.ranks, args.timeout)
    print(f"mesh check: {args.ranks} gloo ranks on the host CPU held the "
          f"one-process collectives, training, checkpoint, tokens, tensor "
          f"and sequence parallelism and global MoE routing in "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps(record))


if __name__ == "__main__":
    main()
