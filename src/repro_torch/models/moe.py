"""Mixture-of-Experts FFN: top-k routing with capacity dispatch, the port
of ``repro.models.moe``.

Each token's ``k`` choices take slots in their experts' buffers of
``cap`` rows; a choice's slot is its rank among the choices of its
expert in token-major order of the flattened ``[T * k]`` choices, and a
choice ranked at or past ``cap`` is dropped (it adds nothing).  The
expert products are batched matmuls over ``[E, cap, d]``; the shared
experts (deepseek) are one dense gated MLP beside them.  Returns the
output, the reference's load-balance + router z-loss aux, and the
routing it chose (:class:`Routing`), which checks compare across runs.

On a mesh the routing is the whole batch's, as the reference's GSPMD
program computes it: where the batch is split over ranks, the capacity
is that of the global token count, a choice's rank within its expert is
offset by the choices of that expert on the lower batch ranks (each
rank's ``[E]`` counts exchanged; token-major order runs over the ranks'
rows in turn), and the aux loss's means are over every token.  A
token's output depends only on its slot and its ``keep``, so no token
row crosses ranks.  Over a ``model`` axis (``tp``: experts on
``model``), each rank runs its ``E / R`` experts (and its ``d_ff``
columns of the shared experts) on every token, which the ranks hold
alike, and the ranks' outputs are summed.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..parallel.sharding import NO_SHARDING, AxisRules
from .common import (F32, _gelu, _silu, apply_norm, init_norm, matmul,
                     normal, reduce_partial)


class Routing(NamedTuple):
    """One MoE call's routing, ``[B, S, k]`` each: every token's chosen
    experts in the router's order, and whether each choice took a slot
    (False: the capacity dropped it)."""
    experts: torch.Tensor
    keep: torch.Tensor

    def codes(self):
        """``[B, S, k]``: each token's kept experts as their ids and its
        dropped ones as ``-1 - id``, sorted; two runs sent a token alike
        where its codes are equal."""
        return torch.where(self.keep, self.experts, -1 - self.experts) \
            .sort(dim=-1).values


def init_moe(gen: torch.Generator, cfg, device=None) -> dict:
    """The FFN's params (reference ``moe.py:25``): the router and every
    expert's gate and up at 1/sqrt(d_model), down at 1/sqrt(d_ff), then
    the shared experts' (d_ff times their count wide)."""
    device = device or gen.device
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"ln": init_norm(cfg, device=device),
         "router": normal(gen, (d, E), s_in, device),
         "moe_gate": normal(gen, (E, d, f), s_in, device),
         "moe_up": normal(gen, (E, d, f), s_in, device),
         "moe_down": normal(gen, (E, f, d), s_out, device)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_gate"] = normal(gen, (d, fs), s_in, device)
        p["shared_up"] = normal(gen, (d, fs), s_in, device)
        p["shared_down"] = normal(gen, (fs, d), s_out, device)
    return p


def _act(cfg, g, u):
    return (_silu(g) if cfg.mlp == "swiglu" else _gelu(g)) * u


def capacity(cfg, T: int) -> int:
    """Slots per expert for ``T`` tokens: capacity-factor scaled, but
    never below ``min(T, 16)``, so a decode step drops nothing."""
    return max(1, int(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts),
               min(T, 16))


def _prefix_sum(x):
    """Inclusive prefix sum over axis 0 in ``ceil(log2 n)`` whole-tensor
    rounds (the reference's ``associative_scan`` dispatch)."""
    off = 1
    while off < x.shape[0]:
        x = torch.cat([x[:off], x[off:] + x[:-off]], dim=0)
        off *= 2
    return x


def top_k(probs, k: int):
    """``(values, ids)`` of the ``k`` largest along the last axis, by a
    stable descending sort: equal values go to the lower id first, as
    ``lax.top_k`` orders them (``torch.topk`` promises no order)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def route(p: dict, ht, cfg):
    """``(logits fp32 [T, E], probs, gate [T, k], expert ids [T, k])``
    of the normed tokens ``ht [T, d]``, the gates renormalised over the
    top ``k``.  The logits are ht's products with the router summed in
    fp32 and kept so: the reference casts its product to fp32, and XLA
    fuses the cast into the dot and drops the bf16 rounding between."""
    logits = ht.to(F32) @ p["router"].to(ht.dtype).to(F32)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = top_k(probs, cfg.top_k)
    return logits, probs, gate / gate.sum(dim=-1, keepdim=True), eidx


def dispatch(flat_e, E: int, cap: int, mode: str,
             rules: AxisRules = NO_SHARDING):
    """``(rank, keep)`` of each flattened choice: its rank among the
    choices of its expert in token-major order over the whole batch (on
    a mesh, after the choices of the lower batch ranks), and ``rank <
    cap``."""
    onehot = torch.nn.functional.one_hot(flat_e, E).to(torch.int32)
    csum = _prefix_sum(onehot) if mode == "scan" \
        else torch.cumsum(onehot, dim=0, dtype=torch.int32)
    rank = (csum * onehot).sum(dim=-1) - 1
    if rules.shards("batch") > 1:
        counts = rules.pgather(onehot.sum(dim=0), "batch")     # [D, E]
        below = counts[:rules.shard_index("batch")].sum(dim=0)
        rank = rank + below[flat_e]
    return rank, rank < cap


def _mean0(x, rules: AxisRules, T: int):
    """The mean over the whole batch's ``T`` tokens of ``x [t, ...]``,
    the rank's ``t`` tokens' rows (``x.mean(0)`` where the batch is
    whole)."""
    if rules.shards("batch") == 1:
        return x.mean(0)
    return rules.psum(x.sum(0), "batch") / T


def moe_forward(p: dict, x, cfg, rules: AxisRules = NO_SHARDING):
    """x ``[B, S, d]`` -> (out ``[B, S, d]``, aux loss (a 0-d fp32
    tensor), :class:`Routing`)."""
    B, S, d = x.shape
    dt = x.dtype
    h = apply_norm(p["ln"], x, cfg)
    T = B * S
    Tg = T * rules.shards("batch")          # the whole batch's tokens
    ht = h.reshape(T, d)
    E, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, Tg)
    logits, probs, gate, eidx = route(p, ht, cfg)

    # load-balance aux loss (Switch-style) + router z-loss
    density = _mean0(torch.nn.functional.one_hot(eidx[:, 0], E).to(F32),
                     rules, Tg)
    aux = E * torch.sum(density * _mean0(probs, rules, Tg))
    aux = aux + 1e-3 * _mean0(torch.logsumexp(logits, -1).square(), rules,
                              Tg)

    flat_e = eidx.reshape(-1)                                   # [T*k]
    rank, keep = dispatch(flat_e, E, cap, cfg.moe_dispatch, rules)
    # this rank's experts (all of them off a model axis)
    El = p["moe_gate"].shape[0]
    e0 = rules.shard_index("experts") * El
    mine = keep if El == E else keep & (flat_e >= e0) & (flat_e < e0 + El)
    slot = (flat_e - e0).clamp(0, El - 1) * cap + rank.clamp(0, cap - 1)
    xk = torch.repeat_interleave(ht, k, dim=0)
    xk = torch.where(mine[:, None], xk, torch.zeros((), dtype=dt,
                                                    device=x.device))
    # a kept choice owns its slot; a dropped one adds zeros
    buf = torch.zeros((El, cap, d), dtype=dt, device=x.device)
    if cfg.moe_dispatch == "scan":   # expert-major before the scatter
        buf = rules.act(buf, "heads", None, None)
    xe = buf.reshape(El * cap, d).index_add_(0, slot, xk) \
        .reshape(El, cap, d)
    xe = rules.act(xe, "heads", None, None)   # experts on the model axis

    g = matmul(xe, p["moe_gate"])
    u = matmul(xe, p["moe_up"])
    y = rules.act(matmul(_act(cfg, g, u), p["moe_down"]), "heads", None,
                  None)

    out = y.reshape(El * cap, d)[slot] * mine[:, None].to(dt)
    out = out.reshape(T, k, d) * gate[..., None].to(dt)
    # over a model axis the ranks' partial outputs are summed in fp32 and
    # rounded once (``common.row_parallel``); the experts' ranks and the
    # shared experts' d_ff ranks are the same ones (``experts`` and
    # ``ff`` both on ``model`` under tp)
    split = rules.shards("experts") > 1
    out = out.to(F32).sum(dim=1) if split else out.sum(dim=1)
    if cfg.n_shared_experts:
        sg = matmul(ht, p["shared_gate"])
        su = matmul(ht, p["shared_up"])
        h = _act(cfg, sg, su)
        out = out + (h.to(F32) @ p["shared_down"].to(dt).to(F32) if split
                     else matmul(h, p["shared_down"]))
    if split:   # under sp_residual, this rank's run of the sum
        out = reduce_partial(out.reshape(B, S, d), rules, "experts").to(dt)
    out = rules.act(out.reshape(B, -1, d), "batch", "res_seq", None)
    return out, aux, Routing(eidx.reshape(B, S, k),
                                              keep.reshape(B, S, k))
