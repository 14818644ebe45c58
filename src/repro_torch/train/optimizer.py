"""AdamW and its schedule (the port of ``repro.train.optimizer``).

Master weights are fp32 and the model casts them to bf16 where it uses
them, so the state is (params, mu, nu) fp32, 12 bytes a parameter, and
optionally a bf16 working copy (``cast``, the two-copy scheme).  The
maths is the reference's, in its order and in fp32, leaf by leaf in its
flatten order (``train.tree``).  ``adamw_update`` writes the new params,
mu, nu and cast into the state's own tensors (the reference's train
loop donates the state to its step in the same way): the state passed
in is consumed, and a snapshot of it must be a copy
(``CheckpointManager.save_async`` makes one).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from .tree import leaves, tree_map

F32 = torch.float32


class TrainState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    params: Any          # fp32 masters, the reference's tree layout
    mu: Any
    nu: Any
    # the bf16 working copy that forward and backward consume under the
    # two-copy scheme; None when it is off
    cast: Any = None


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as an fp32 scalar on ``like``'s device: JAX rounds
    a weakly typed constant to fp32 before it meets an fp32 array."""
    return torch.tensor(value, dtype=F32, device=like.device)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor) as an
    fp32 scalar: linear warmup to ``peak_lr`` over ``warmup_steps``, then
    a cosine to 0 at ``total_steps``."""
    step = torch.as_tensor(step, dtype=torch.int32)
    s = step.to(F32)
    warm = _f32(cfg.peak_lr, s) * (step + 1).to(F32) / cfg.warmup_steps
    frac = torch.clamp((step - cfg.warmup_steps).to(F32)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    # the cosine of the fp32 angle, correctly rounded to fp32 (through
    # fp64), as XLA's: torch's fp32 cos is one ulp off at some angles,
    # and 1 + cos cancels to 2e-5 of lr near the end of the decay
    angle = _f32(math.pi, s) * frac
    cos = _f32(cfg.peak_lr * 0.5, s) * (1 + torch.cos(angle.double())
                                        .to(F32))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def cast_tree(params: Any) -> Any:
    """Every fp32 leaf as a new bf16 tensor, the others as they are."""
    return tree_map(lambda p: p.detach().to(torch.bfloat16)
                    if p.dtype == F32 else p, params)


def init_state(params: Any, *, two_copy: bool = False) -> TrainState:
    """Step 0 with zero moments (fp32, on each param's device)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=F32)
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    return TrainState(step=step, params=params, mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params),
                      cast=cast_tree(params) if two_copy else None)


def global_norm(tree: Any) -> torch.Tensor:
    """``sqrt`` of the sum of every leaf's sum of squares, in fp32, the
    leaves added one by one in the reference's order."""
    total = None
    for x in leaves(tree):
        sq = x.detach().to(F32).square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(state: TrainState, grads: Any, cfg: AdamWConfig, *,
                 gnorm: torch.Tensor | None = None
                 ) -> tuple[TrainState, dict]:
    """One AdamW step with global-norm clipping -> (state, {"grad_norm",
    "lr"}); params, mu, nu (and cast) are updated in place, the step is
    a new tensor.  ``gnorm`` is the gradients' global norm where the
    caller has it (on a mesh, where ``grads`` are one rank's shards);
    else :func:`global_norm` of ``grads``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, state.step)
    t = (state.step + 1).to(F32)
    bc1 = 1 - torch.pow(_f32(cfg.b1, t), t)
    bc2 = 1 - torch.pow(_f32(cfg.b2, t), t)
    b1, b2 = _f32(cfg.b1, t), _f32(cfg.b2, t)
    c1, c2 = _f32(1 - cfg.b1, t), _f32(1 - cfg.b2, t)
    eps, wd = _f32(cfg.eps, t), _f32(cfg.weight_decay, t)
    for p, g, m, v in zip(leaves(state.params), leaves(grads),
                          leaves(state.mu), leaves(state.nu)):
        g = g.to(F32) * scale
        m.mul_(b1).add_(c1 * g)
        v.mul_(b2).add_(c2 * g.square())
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p
        p.sub_(lr * upd)
    if state.cast is not None:
        for c, p in zip(leaves(state.cast), leaves(state.params)):
            if p.dtype == F32:
                c.copy_(p)
    return (TrainState(state.step + 1, state.params, state.mu, state.nu,
                       state.cast), {"grad_norm": gnorm, "lr": lr})
