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
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..parallel.sharding import NO_SHARDING, AxisRules
from .common import F32, _gelu, _silu, apply_norm, init_norm, matmul, normal


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


def dispatch(flat_e, E: int, cap: int, mode: str):
    """``(rank, keep)`` of each flattened choice: its rank among the
    choices of its expert in token-major order, and ``rank < cap``."""
    onehot = torch.nn.functional.one_hot(flat_e, E).to(torch.int32)
    csum = _prefix_sum(onehot) if mode == "scan" \
        else torch.cumsum(onehot, dim=0, dtype=torch.int32)
    rank = (csum * onehot).sum(dim=-1) - 1
    return rank, rank < cap


def moe_forward(p: dict, x, cfg, rules: AxisRules = NO_SHARDING):
    """x ``[B, S, d]`` -> (out ``[B, S, d]``, aux loss (a 0-d fp32
    tensor), :class:`Routing`)."""
    B, S, d = x.shape
    dt = x.dtype
    h = apply_norm(p["ln"], x, cfg)
    T = B * S
    ht = h.reshape(T, d)
    E, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, T)
    logits, probs, gate, eidx = route(p, ht, cfg)

    # load-balance aux loss (Switch-style) + router z-loss
    density = torch.nn.functional.one_hot(eidx[:, 0], E).to(F32).mean(0)
    aux = E * torch.sum(density * probs.mean(0))
    aux = aux + 1e-3 * torch.logsumexp(logits, -1).square().mean()

    flat_e = eidx.reshape(-1)                                   # [T*k]
    rank, keep = dispatch(flat_e, E, cap, cfg.moe_dispatch)
    slot = flat_e * cap + rank.clamp(0, cap - 1)
    xk = torch.repeat_interleave(ht, k, dim=0)
    xk = torch.where(keep[:, None], xk, torch.zeros((), dtype=dt,
                                                    device=x.device))
    # a kept choice owns its slot; a dropped one adds zeros
    buf = torch.zeros((E, cap, d), dtype=dt, device=x.device)
    if cfg.moe_dispatch == "scan":   # expert-major before the scatter
        buf = rules.act(buf, "heads", None, None)
    xe = buf.reshape(E * cap, d).index_add_(0, slot, xk).reshape(E, cap, d)
    xe = rules.act(xe, "heads", None, None)   # experts on the model axis

    g = matmul(xe, p["moe_gate"])
    u = matmul(xe, p["moe_up"])
    y = rules.act(matmul(_act(cfg, g, u), p["moe_down"]), "heads", None,
                  None)

    out = y.reshape(E * cap, d)[slot] * keep[:, None].to(dt)
    out = (out.reshape(T, k, d) * gate[..., None].to(dt)).sum(dim=1)

    if cfg.n_shared_experts:
        sg = matmul(ht, p["shared_gate"])
        su = matmul(ht, p["shared_up"])
        out = out + matmul(_act(cfg, sg, su), p["shared_down"])
    out = rules.act(out.reshape(B, S, d), "batch", "res_seq", None)
    return out, aux, Routing(eidx.reshape(B, S, k),
                                              keep.reshape(B, S, k))
