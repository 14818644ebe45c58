"""The train step: microbatched gradient accumulation, mixed precision,
remat policy (the port of ``repro.train.train_step``), on one device or
on a mesh.

On a mesh (``rules`` with one) the state's leaves are DTensors placed by
``rules.params_shardings`` and the batch is split over the ranks on its
first axis (``train.data.sharded_batch``).  Each rank runs
:func:`rank_loss_and_grads` on its own rows, each block's weights
gathered just before the block (``AxisRules.gather``: whole over the
batch dims, the rank's shard on ``model``), and its loss is the mean
over its rows, the same on every rank of a ``model`` axis.  Each rank
differentiates its share of the global loss, its loss over the number
of ranks (batch shards times ``model`` ranks): the gradients come back
summed over the ranks in the parameters' own placements (a
reduce-scatter; the ``model`` sums' backward sums the ranks' gradients
of the values they hold alike).  AdamW then runs on each rank's local
shards, with ``grad_norm`` the global norm.

On a one-process ``StandInMesh`` the ranks are threads:
:func:`standin_train_step` runs their forwards in lockstep, one backward
of their summed shares, and AdamW on each rank's own tree.
"""
from __future__ import annotations

from typing import Any

import torch

from .optimizer import AdamWConfig, TrainState, adamw_update, init_state
from .tree import leaves, leaves_with_paths, tree_map, unflatten_like

F32 = torch.float32


def _to_bf16(p):
    return p.to(torch.bfloat16) if p.dtype == F32 else p


def rank_loss_and_grads(model, params, rows: dict, rules, *,
                        remat_policy: str | None = None,
                        cast_params_bf16: bool = False,
                        constrain_grads: bool = False):
    """One rank's share of a step: ``(loss, grads)`` of ``rows`` (the
    rank's rows of the batch, plain tensors), the loss the mean over
    them, the gradients those of ``loss / ranks`` (:func:`loss_share`)
    with respect to every leaf of ``params`` (None-free, each in its
    leaf's structure): summed over the ranks, they are the whole
    batch's.  Without a mesh this is the whole step's."""
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    tree = unflatten_like(params, live)
    if constrain_grads:
        tree = rules.constrain_tree(tree)
    if cast_params_bf16:
        tree = tree_map(_to_bf16, tree)
        if constrain_grads:   # keep the bf16 copies placed too
            tree = rules.constrain_tree(tree)
    loss, _ = model.loss(tree, rows, remat_policy=remat_policy, rules=rules)
    grads = torch.autograd.grad(loss_share(loss, rules), live,
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), unflatten_like(params, grads)


def loss_share(loss, rules):
    """A rank's share of the global loss: ``loss`` over the ranks that
    hold a share of it (the batch shards times the ``model`` ranks, which
    hold the loss alike); ``loss`` itself off a mesh.  The ranks that
    split the sequence (``seq``, ``res_seq``) are the ``model`` ranks:
    each holds a run of the positions, and the hidden sequence is
    gathered whole before the logits, so each holds the whole loss."""
    ranks = rules.batch_shards() * rules.model_ranks()
    return loss / ranks if ranks > 1 else loss


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
    whose rules shard a sequence dim (``fsdp_sp`` over a ``model`` axis
    above 1) runs it as the model code does (``parallel.sharding``);
    ``parallel.sharding.check_executable`` says what it refuses."""
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


def standin_states(rules, tree) -> dict:
    """``{coord: TrainState}`` of every rank of a ``StandInMesh``: step 0
    of its own copy of :meth:`~repro_torch.parallel.sharding.AxisRules.
    rank_tree` of the whole fp32 ``tree`` (AdamW writes in place, so no
    two ranks may share a tensor)."""
    return {c: init_state(tree_map(lambda t: t.detach().clone(),
                                   rules.rank_tree(tree, c)))
            for c in rules.mesh.coords()}


def _reduce_standin(rules, grads: dict, like) -> dict:
    """Each rank's gradients summed over the ranks that hold the leaf
    alike, in rank order: the batch ranks, and the ``model`` ranks where
    the rank computes on the leaf whole (what a process group's
    reduce-scatter and all-reduce give each rank)."""
    mesh, coords = rules.mesh, rules.mesh.coords()
    names = tuple(mesh.mesh_dim_names)
    batch = set(rules.mesh_dims("batch"))
    model = names.index("model") if "model" in names else None
    out = {c: [] for c in coords}
    for i, (path, x) in enumerate(leaves_with_paths(like)):
        over = set(batch)
        if model is not None and rules.model_dim(path, x.ndim) is None:
            over.add(model)
        for c in coords:
            group = [o for o in coords if all(
                o[d] == c[d] for d in range(mesh.ndim) if d not in over)]
            total = grads[group[0]][i]
            for o in group[1:]:
                total = total + grads[o][i]
            out[c].append(total)
    return out


def _standin_norm(rules, grads: dict, like) -> torch.Tensor:
    """The global norm of the reduced gradients, in fp32: each leaf's sum
    of squares over its ``model`` shards (once, where the ranks hold it
    alike), the leaves added in their order."""
    names = tuple(rules.mesh.mesh_dim_names)
    first = rules.mesh.coords()[0]
    acc = None
    for i, (path, x) in enumerate(leaves_with_paths(like)):
        if "model" in names and rules.model_dim(path, x.ndim) is not None:
            m = names.index("model")
            owners = [c for c in rules.mesh.coords()
                      if all(c[d] == first[d] for d in range(len(c))
                             if d != m)]
        else:
            owners = [first]
        sq = None
        for c in owners:
            t = grads[c][i].detach().to(F32).square().sum()
            sq = t if sq is None else sq + t
        acc = sq if acc is None else acc + sq
    return torch.sqrt(acc)


def standin_loss_and_grads(model, rules, params: dict, batch: dict):
    """``(loss, {coord: grads})`` of the whole ``batch`` on a
    ``StandInMesh``, ``params`` each rank's tree (``{coord: tree}``).
    Each rank's forward runs on its thread over its rows, the ranks in
    lockstep (remat ``"none"``: a recompute in the backward would run one
    rank alone); one backward of the sum of their loss shares
    (:func:`loss_share`) gives every rank's leaves their gradients, each
    then summed over the ranks that hold the leaf alike (each rank's
    gradients as a list in its tree's leaf order).  ``loss`` is the mean
    of the batch ranks' losses."""
    mesh = rules.mesh
    coords = mesh.coords()
    live = {c: [p.detach().requires_grad_(True) for p in leaves(params[c])]
            for c in coords}

    def forward(coord):
        rows = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            rows[k] = rules.sharding(
                *(("batch",) + (None,) * (v.dim() - 1))).local(v)
        tree = unflatten_like(params[coord], live[coord])
        return model.loss(tree, rows, remat_policy="none", rules=rules)[0]
    losses = mesh.run(forward)
    total = None
    for c in coords:
        share = loss_share(losses[c], rules)
        total = share if total is None else total + share
    flat = [p for c in coords for p in live[c]]
    got = torch.autograd.grad(total, flat, allow_unused=True)
    got = [torch.zeros_like(p) if g is None else g
           for p, g in zip(flat, got)]
    n = len(live[coords[0]])
    grads = _reduce_standin(rules, {c: got[i * n:(i + 1) * n]
                                    for i, c in enumerate(coords)},
                            params[coords[0]])
    batch_dims = rules.mesh_dims("batch")
    firsts = [c for c in coords if all(
        c[d] == 0 for d in range(mesh.ndim) if d not in batch_dims)]
    loss = sum(losses[c].detach() for c in firsts) / len(firsts)
    return loss, grads


def standin_train_step(model, rules, *, opt: AdamWConfig | None = None):
    """``make_train_step(model, rules)``'s step on a ``StandInMesh``:
    ``step(states, batch) -> (states, metrics)``, ``states`` as
    :func:`standin_states` gives them and ``batch`` the whole batch: the
    gradients of :func:`standin_loss_and_grads`, then AdamW on each
    rank's tree with their global norm."""
    rules.check(model.cfg)
    opt = opt or AdamWConfig()

    def step(states: dict, batch: dict):
        params = {c: s.params for c, s in states.items()}
        loss, grads = standin_loss_and_grads(model, rules, params, batch)
        like = next(iter(params.values()))
        gnorm = _standin_norm(rules, grads, like)
        new, metrics = {}, None
        for c, s in states.items():
            new[c], metrics = adamw_update(
                s, unflatten_like(like, grads[c]), opt, gnorm=gnorm)
        return new, {"loss": loss, **metrics}

    return step


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


__all__ = ["eval_state_shapes", "init_train_state", "loss_share",
           "make_train_step", "rank_loss_and_grads",
           "standin_loss_and_grads", "standin_states",
           "standin_train_step"]
