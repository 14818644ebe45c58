"""The train step: microbatched gradient accumulation, mixed precision,
remat policy (the port of ``repro.train.train_step``), on one device or
on a mesh.

On a mesh (``rules`` with one) the state's leaves are DTensors placed by
``rules.params_shardings`` and the batch is split over the ranks on its
first axis (``train.data.sharded_batch``).  Each rank runs
:func:`rank_loss_and_grads` on its own rows, each block's weights
gathered whole just before the block (``AxisRules.gather``), and its
loss is the mean over its rows; the gradients of those losses over the
number of batch shards come back, summed over the ranks, in the
parameters' own placements (a reduce-scatter).  AdamW then runs on each
rank's local shards, with ``grad_norm`` the global norm.
"""
from __future__ import annotations

from typing import Any

import torch

from .optimizer import AdamWConfig, TrainState, adamw_update, init_state
from .tree import leaves, tree_map, unflatten_like

F32 = torch.float32


def _to_bf16(p):
    return p.to(torch.bfloat16) if p.dtype == F32 else p


def rank_loss_and_grads(model, params, rows: dict, rules, *,
                        remat_policy: str | None = None,
                        cast_params_bf16: bool = False,
                        constrain_grads: bool = False):
    """One rank's share of a step: ``(loss, grads)`` of ``rows`` (the
    rank's rows of the batch, plain tensors), the loss the mean over
    them, the gradients those of ``loss / rules.batch_shards()`` with
    respect to every leaf of ``params`` (None-free, each in its leaf's
    structure): summed over the ranks, they are the whole batch's.
    Without a mesh this is the whole step's."""
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    tree = unflatten_like(params, live)
    if constrain_grads:
        tree = rules.constrain_tree(tree)
    if cast_params_bf16:
        tree = tree_map(_to_bf16, tree)
        if constrain_grads:   # keep the bf16 copies placed too
            tree = rules.constrain_tree(tree)
    loss, _ = model.loss(tree, rows, remat_policy=remat_policy, rules=rules)
    shards = rules.batch_shards()
    grads = torch.autograd.grad(loss / shards if shards > 1 else loss, live,
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), unflatten_like(params, grads)


def make_train_step(model, rules=None, *, opt: AdamWConfig | None = None,
                    microbatches: int = 1, remat_policy: str | None = None,
                    cast_params_bf16: bool = False,
                    constrain_grads: bool = False, two_copy: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``, metrics
    ``{"loss", "grad_norm", "lr"}`` (fp32 scalars on the state's device).

    * ``two_copy``: forward and backward consume the state's bf16 copy
      (``state.cast``); its gradients arrive in bf16 and the optimizer
      takes them up to fp32.
    * ``cast_params_bf16``: the fp32 masters are cast to bf16 inside the
      differentiated function, so the gradients flow back through the
      casts to the masters.
    * ``constrain_grads``: the params are pinned to their rule placements
      inside the differentiated function, so their gradients are placed
      there too (a no-op where the state already lies so, as
      ``rules.params_shardings`` places it; without a mesh, nothing).
    * ``microbatches``: the batch (on a mesh, each rank's rows) is split
      on its first axis; the gradients are summed in fp32 and divided,
      and so is the loss.

    The state is updated in place (``optimizer.adamw_update``).  A mesh
    whose ``model`` axis is larger than 1, or an MoE config under a
    batch axis larger than 1, raises ``NotImplementedError``
    (``parallel.sharding.check_executable``)."""
    # here, not at the top: parallel.sharding imports train.tree, and so
    # this package, first
    from ..parallel.sharding import local_tree, no_sharding

    rules = rules or no_sharding()
    rules.check(model.cfg)
    opt = opt or AdamWConfig()
    kwargs = dict(remat_policy=remat_policy,
                  cast_params_bf16=cast_params_bf16,
                  constrain_grads=constrain_grads)

    def train_step(state: TrainState, batch: dict):
        fwd_params = state.cast if (two_copy and state.cast is not None) \
            else state.params
        rows = local_tree(batch)
        if microbatches == 1:
            loss, grads = rank_loss_and_grads(model, fwd_params, rows, rules,
                                              **kwargs)
        else:
            def split(x):
                return x.reshape((microbatches, x.shape[0] // microbatches)
                                 + tuple(x.shape[1:]))
            mb = {k: split(torch.as_tensor(v)) for k, v in rows.items()}
            gacc = [torch.zeros_like(p, dtype=F32)
                    for p in leaves(state.params)]
            lacc = torch.zeros((), dtype=F32, device=state.step.device)
            for i in range(microbatches):
                loss, grads = rank_loss_and_grads(
                    model, fwd_params, {k: v[i] for k, v in mb.items()},
                    rules, **kwargs)
                gacc = [a + g.to(F32) for a, g in zip(gacc, leaves(grads))]
                lacc = lacc + loss
            grads = unflatten_like(state.params,
                                   [g / microbatches for g in gacc])
            loss = lacc / microbatches
        if rules.mesh is None:
            new_state, opt_metrics = adamw_update(state, grads, opt)
        else:
            loss = rules.batch_sum(loss / rules.batch_shards())
            new_state, opt_metrics = adamw_update(
                local_tree(state), local_tree(grads), opt,
                gnorm=rules.global_norm(grads))
            new_state = TrainState(new_state.step, state.params, state.mu,
                                   state.nu, state.cast)
        return new_state, {"loss": loss, **opt_metrics}

    return train_step


def init_train_state(model, generator: torch.Generator, two_copy: bool = False,
                     device=None) -> TrainState:
    """The state of ``model.init(generator)`` (fp32, on the generator's
    device or ``device``)."""
    return init_state(model.init(generator, device=device),
                      two_copy=two_copy)


def eval_state_shapes(model) -> Any:
    """The train state's tree on the ``meta`` device: shapes and dtypes,
    nothing allocated."""
    return init_train_state(model, torch.Generator(), device="meta")


__all__ = ["eval_state_shapes", "init_train_state", "make_train_step",
           "rank_loss_and_grads"]
