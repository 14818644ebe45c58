"""The mesh path's per-rank step (``train_step.rank_loss_and_grads``, the
function each rank of a mesh runs on its own rows) against the one-batch
step, on the CPU, in one process.

The gradient reduction over the ranks, which the mesh does through
DTensor's reduce-scatter, is injected here: a sum over the 4 shards'
gradients.  The rules carry a stand-in for a ``data=4`` mesh (the
attributes a ``DeviceMesh`` has that the rules read), so the model runs
the mesh path's code (``AxisRules.check``, the per-block ``gather``,
``act``) on plain tensors; no process group is opened.

* reduced gemma3-1b, recurrentgemma-2b, mamba2-780m and whisper-tiny: a
  step over 4 batch shards (each shard's loss and gradients, the
  gradients summed, then AdamW with their global norm) equals
  ``make_train_step``'s one-batch step, with fp32 activations (the
  model's ``ACT_DTYPE``, so only the order of the fp32 sums differs; in
  bf16 each shard's weight gradient is rounded before the sum): loss
  and grad_norm within rtol 1e-5, every new parameter, mu and nu within
  rtol 1e-5, atol 1e-6 x the leaf's max;
* reduced granite-moe under a batch axis of 4 (the stand-in's threads:
  global MoE routing) takes the one-batch step's loss and grad_norm, and
  so does gemma3-1b (``fsdp_sp``, its sequence split over the model
  ranks) under a ``(data, model) = (2, 2)`` mesh, whose
  ``make_train_step`` builds;
* every rank's rows of the batch (``Sharding.local``, the cut
  ``sharded_batch`` places) are the reference's ``synthetic_batch``
  rows, on a ``data`` mesh and, data-major, on a ``(pod, data)`` one.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.train.data import synthetic_batch as ref_synthetic_batch
from repro_torch.configs import get_config
from repro_torch.configs.base import TRAIN_4K
from repro_torch.kernels.cases import TRAIN_GOLDEN_OPT, lm_params
from repro_torch.launch.specs import make_rules
from repro_torch.models import build_model, transformer
from repro_torch.parallel.sharding import Sharding
from repro_torch.parallel.standin import StandInMesh
from repro_torch.train import (AdamWConfig, adamw_update, init_state,
                               make_train_step, sharded_batch,
                               synthetic_batch)
from repro_torch.train.optimizer import global_norm
from repro_torch.train.train_step import (rank_loss_and_grads,
                                          standin_states,
                                          standin_train_step)
from repro_torch.train.tree import leaves, leaves_with_paths, unflatten_like
from test_torch_sharding import FakeMesh

torch.set_num_threads(2)

ARCHS = ("gemma3-1b", "recurrentgemma-2b", "mamba2-780m", "whisper-tiny")
SHARDS, B, S = 4, 8, 16
RTOL, ATOL_REL = 1e-5, 1e-6


@contextlib.contextmanager
def float32_activations():
    saved = transformer.ACT_DTYPE
    transformer.ACT_DTYPE = torch.float32
    try:
        yield
    finally:
        transformer.ACT_DTYPE = saved


def _state(cfg):
    tree = lm_params(cfg, 0)
    return init_state(unflatten_like(tree, [
        torch.from_numpy(np.array(a, np.float32)) for a in leaves(tree)]))


def _rules(cfg, shape=(SHARDS, 1), names=("data", "model"), **kw):
    return make_rules(cfg, FakeMesh(names, shape), TRAIN_4K, **kw)


def _rows(rules, batch: dict, coord) -> dict:
    """The rows of ``batch`` that the rank at ``coord`` holds."""
    out = {}
    for k, v in batch.items():
        spec = rules.spec(*(("batch",) + (None,) * (v.dim() - 1)))
        sh = Sharding(FakeMesh(rules.mesh.mesh_dim_names, rules.mesh.shape,
                               coord), spec, rules.placements(spec))
        out[k] = sh.local(v)
    return out


def _close(got, want) -> float:
    got, want = got.double(), want.double()
    atol = ATOL_REL * float(want.abs().max())
    return float(((got - want).abs() / (atol + RTOL * want.abs())).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_a_step_over_four_shards_is_the_one_batch_step(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    opt = AdamWConfig(**TRAIN_GOLDEN_OPT)
    rules = _rules(cfg)
    assert rules.batch_shards() == SHARDS
    with float32_activations():
        batch = synthetic_batch(cfg, B, S, 0)
        if "memory" in batch:
            batch["memory"] = batch["memory"].float()
        one, m1 = make_train_step(model, opt=opt)(_state(cfg), batch)
        state = _state(cfg)
        losses, grads = [], None
        for r in range(SHARDS):
            loss, g = rank_loss_and_grads(model, state.params,
                                          _rows(rules, batch, (r, 0)), rules)
            losses.append(loss)
            grads = leaves(g) if grads is None else \
                [a + b for a, b in zip(grads, leaves(g))]
        grads = unflatten_like(state.params, grads)
        mesh, m4 = adamw_update(state, grads, opt, gnorm=global_norm(grads))
    loss = sum(losses) / SHARDS
    assert abs(float(loss) - float(m1["loss"])) <= RTOL * abs(float(m1["loss"]))
    assert abs(float(m4["grad_norm"]) - float(m1["grad_norm"])) <= \
        RTOL * float(m1["grad_norm"])
    for part in ("params", "mu", "nu"):
        for (path, got), want in zip(leaves_with_paths(getattr(mesh, part)),
                                     leaves(getattr(one, part))):
            assert _close(got, want) <= 1, (part, path)


def test_moe_under_a_batch_axis_and_a_model_axis_raise():
    moe = get_config("granite-moe-1b-a400m").reduced()
    model = build_model(moe)
    opt = AdamWConfig(**TRAIN_GOLDEN_OPT)
    mesh = StandInMesh((SHARDS, 1))
    rules = make_rules(moe, mesh, TRAIN_4K)
    with float32_activations():
        batch = synthetic_batch(moe, B, S, 0)
        _, m1 = make_train_step(model, opt=opt, remat_policy="none")(
            _state(moe), batch)
        states = standin_states(rules, _state(moe).params)
        _, m4 = standin_train_step(model, rules, opt=opt)(states, batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(m4[k]) - float(m1[k])) <= RTOL * float(m1[k]), k
    dense = get_config("gemma3-1b").reduced()
    make_train_step(build_model(dense), _rules(dense, shape=(2, 2)))
    rules = make_rules(dense, StandInMesh((2, 2)), TRAIN_4K)
    assert rules.mode == "fsdp_sp" and rules.shards("seq") == 2
    with float32_activations():
        batch = synthetic_batch(dense, B, S, 0)
        _, m1 = make_train_step(build_model(dense), opt=opt,
                                remat_policy="none")(_state(dense), batch)
        states = standin_states(rules, _state(dense).params)
        _, m4 = standin_train_step(build_model(dense), rules, opt=opt)(
            states, batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(m4[k]) - float(m1[k])) <= RTOL * float(m1[k]), k


@pytest.mark.parametrize("arch", ["gemma3-1b", "whisper-tiny"])
@pytest.mark.parametrize("mesh", ["data", "pod-data"])
def test_every_ranks_rows_are_the_references(arch, mesh):
    cfg, rcfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    if mesh == "data":
        rules, coords = _rules(cfg), [(r, 0) for r in range(SHARDS)]
    else:
        rules = _rules(cfg, shape=(2, 2, 1),
                       names=("pod", "data", "model"), multi_pod=True)
        coords = [(p, d, 0) for p in range(2) for d in range(2)]
    ref = ref_synthetic_batch(rcfg, B, S, 3, 1)
    full = synthetic_batch(cfg, B, S, 3, 1)
    # no sharding given: sharded_batch is the whole batch
    whole = sharded_batch(cfg, B, S, 3, {}, seed=1)
    for k in full:
        assert torch.equal(whole[k], full[k])
    per = B // SHARDS
    for i, coord in enumerate(coords):
        mine = _rows(rules, full, coord)
        for k, v in mine.items():
            want = np.asarray(ref[k][i * per:(i + 1) * per])
            if v.dtype == torch.bfloat16:
                v, want = v.view(torch.int16), want.view(np.int16)
            np.testing.assert_array_equal(v.numpy(), want)
