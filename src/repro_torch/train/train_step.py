"""The train step: microbatched gradient accumulation, mixed precision,
remat policy (the port of ``repro.train.train_step``).

One card, no mesh: the reference's ``rules`` (its sharding constraints)
and ``constrain_grads`` act only under a mesh, and wait for the port of
``parallel/`` (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

from typing import Any

import torch

from .optimizer import AdamWConfig, TrainState, adamw_update, init_state
from .tree import leaves, tree_map, unflatten_like

F32 = torch.float32


def _to_bf16(p):
    return p.to(torch.bfloat16) if p.dtype == F32 else p


def make_train_step(model, *, opt: AdamWConfig | None = None,
                    microbatches: int = 1, remat_policy: str | None = None,
                    cast_params_bf16: bool = False, two_copy: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``, metrics
    ``{"loss", "grad_norm", "lr"}`` (fp32 scalars on the state's device).

    * ``two_copy``: forward and backward consume the state's bf16 copy
      (``state.cast``); its gradients arrive in bf16 and the optimizer
      takes them up to fp32.
    * ``cast_params_bf16``: the fp32 masters are cast to bf16 inside the
      differentiated function, so the gradients flow back through the
      casts to the masters.
    * ``microbatches``: the batch is split on its first axis; the
      gradients are summed in fp32 and divided, and so is the loss.

    The state is updated in place (``optimizer.adamw_update``)."""
    opt = opt or AdamWConfig()

    def grad_fn(fwd_params, batch):
        live = [p.detach().requires_grad_(True) for p in leaves(fwd_params)]
        params = unflatten_like(fwd_params, live)
        if cast_params_bf16:
            params = tree_map(_to_bf16, params)
        loss, _ = model.loss(params, batch, remat_policy=remat_policy)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        return loss.detach(), unflatten_like(fwd_params, grads)

    def train_step(state: TrainState, batch: dict):
        fwd_params = state.cast if (two_copy and state.cast is not None) \
            else state.params
        if microbatches == 1:
            loss, grads = grad_fn(fwd_params, batch)
        else:
            def split(x):
                return x.reshape((microbatches, x.shape[0] // microbatches)
                                 + tuple(x.shape[1:]))
            mb = {k: split(torch.as_tensor(v)) for k, v in batch.items()}
            gacc = [torch.zeros(p.shape, dtype=F32, device=p.device)
                    for p in leaves(state.params)]
            lacc = torch.zeros((), dtype=F32, device=state.step.device)
            for i in range(microbatches):
                loss, grads = grad_fn(fwd_params,
                                      {k: v[i] for k, v in mb.items()})
                gacc = [a + g.to(F32) for a, g in zip(gacc, leaves(grads))]
                lacc = lacc + loss
            grads = unflatten_like(state.params,
                                   [g / microbatches for g in gacc])
            loss = lacc / microbatches
        new_state, opt_metrics = adamw_update(state, grads, opt)
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
