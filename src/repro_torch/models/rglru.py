"""RG-LRU recurrent block (Griffin / RecurrentGemma), the port of
``repro.models.rglru``.

Recurrence: ``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)`` with
``a_t = exp(-c * softplus(8 * lambda) * sigmoid(r_t))``.  The full
sequence (prefill) runs a log-depth scan in torch ops: ``ceil(log2 S)``
rounds of whole-tensor products and sums, not one step per token.  The
decode step is the O(1)-state update.  Gates are diagonal
(per-channel), as in the reference.  The state ``h`` is fp32; the conv
state is in the activations' dtype.

Over a sequence split on ranks (``seq`` on a mesh dim, ``fsdp_sp``), two
things cross the ranks' boundaries: the conv's halo (the ``K - 1`` rows
of ``xs`` before a rank's run, from the ranks before it; zeros or the
cache's conv state before the first) and the scan's carry (each rank
scans its run from ``h = 0`` keeping the prefix product of ``a``; the
ranks' ``(prod a, h_end)`` are gathered and each folds those of the
ranks before it into the ``h`` its run starts from).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..parallel.sharding import NO_SHARDING, AxisRules
from .common import F32, _gelu, apply_norm, init_norm, matmul, normal, \
    uniform

_C = 8.0  # Griffin's fixed temperature


class LRUCache(NamedTuple):
    h: torch.Tensor       # [B, W] fp32
    conv: torch.Tensor    # [B, K-1, W]


def init_rec(gen: torch.Generator, cfg, device=None) -> dict:
    """The block's params (reference ``rglru.py:31``), drawn in the
    reference's key order: w_y, w_x, conv, lambda, gate_a, gate_i, out."""
    device = device or gen.device
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    s = 1.0 / math.sqrt(d)
    return {
        "ln": init_norm(cfg, device=device),
        "lru_w_y": normal(gen, (d, w), s, device),
        "lru_w_x": normal(gen, (d, w), s, device),
        "lru_conv": normal(gen, (cfg.ssm_conv, w), 0.1, device),
        "lru_lambda": uniform(gen, (w,), 0.9, 0.999, device),
        "lru_gate_a": normal(gen, (w,), 0.1, device),
        "lru_gate_i": normal(gen, (w,), 0.1, device),
        "lru_out": normal(gen, (w, d), 1.0 / math.sqrt(w), device),
    }


def _gates(p: dict, x):
    """``(a_t, gated input)`` of x ``[..., W]`` fp32."""
    log_lam = torch.nn.functional.softplus(8.0 * p["lru_lambda"])
    r = torch.sigmoid(x * p["lru_gate_a"])
    i = torch.sigmoid(x * p["lru_gate_i"])
    log_a = -_C * log_lam * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, beta * i * x


def _assoc_scan(a, bx, h0=None, with_prod: bool = False):
    """``h_t = a_t h_{t-1} + bx_t`` over axis 1, with ``h_{-1} = h0``
    (zero when None): a Hillis-Steele scan, ``ceil(log2 S)`` rounds of
    the combine ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``.  Each
    round builds new tensors (no write into one that autograd saved), so
    the scan trains as it serves.  ``with_prod``: ``(prefix products of
    a, h)``."""
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], 1)
    S = a.shape[1]
    off = 1
    while off < S:
        bx = torch.cat([bx[:, :off], bx[:, off:] + a[:, off:] * bx[:, :-off]],
                       dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return (a, bx) if with_prod else bx


def _conv(full, w, S: int):
    """The reference's causal depthwise conv: ``sum_i full[:, i:i+S] *
    w[i]``, each product and sum rounded in the activations' dtype."""
    out = 0
    for i in range(w.shape[0]):
        out = out + full[:, i:i + S] * w[i].to(full.dtype)
    return out


def _last_rows(x, m: int):
    """The last ``m`` rows of ``x`` on axis 1, zeros before a shorter
    one."""
    S = x.shape[1]
    if S >= m:
        return x[:, S - m:]
    return torch.cat([x.new_zeros((x.shape[0], m - S) + x.shape[2:]), x], 1)


def _rows_before(pad, tails, runs, upto: int, m: int):
    """The last ``m`` rows of the sequence before rank ``upto``'s run:
    ``pad``, then the real rows of each earlier rank's tail (``tails[j]``
    its last ``m`` rows, zero-padded; ``runs[j]`` its ``(offset,
    length)``)."""
    parts = [pad] + [tails[j][:, m - min(runs[j][1], m):]
                     for j in range(upto)]
    return _last_rows(torch.cat(parts, dim=1), m)


def _joined(x, gathered):
    """``x`` with ``gathered`` in its graph at weight 0 (exactly ``x``): a
    rank whose result reads none of a gather's rows (the first rank, of
    the halo and the carry) still enters the gather's backward, a
    collective that every rank of a process group must enter."""
    return x + 0 * gathered.sum()


def _carried(a, bx, h0, rules: AxisRules):
    """``(h over the rank's run, h after the whole sequence)`` of the scan
    split over the ``seq`` ranks: the run scanned from 0 with its prefix
    products ``A``, the ranks' ``(A_end, h_end)`` gathered, the carry in
    ``h_in`` the fold of the earlier ranks' from ``h0``, and ``h = h_run +
    A h_in``."""
    B, S, W = a.shape
    A, hloc = _assoc_scan(a, bx, with_prod=True)
    ends = torch.stack([A[:, -1], hloc[:, -1]]) if S else \
        torch.stack([torch.ones_like(h0), torch.zeros_like(h0)])
    ends = rules.pgather(ends, "seq")                  # [R, 2, B, W]
    r = rules.shard_index("seq")
    h_in, h_last = h0, None
    for j in range(ends.shape[0]):
        if j == r:
            h_run = hloc + A * h_in[:, None]
        h_in = ends[j, 0] * h_in + ends[j, 1]
        h_last = h_in
    return _joined(h_run, ends), h_last


def rec_forward(p: dict, x, cfg, cache: LRUCache | None = None, *,
                return_cache: bool = False, rules: AxisRules = NO_SHARDING,
                total: int | None = None):
    """x ``[B, S, d]`` -> (mixed output, pre-residual; the cache or None).
    Over a sequence split on ``seq`` (``total`` positions in all), x is
    the rank's run, and the cache returned on every rank is the whole
    sequence's (the last rank's ``h`` and the sequence's conv tail)."""
    B, S, d = x.shape
    dt = x.dtype
    h = apply_norm(p["ln"], x, cfg)
    y_gate = _gelu(matmul(h, p["lru_w_y"]))
    xs = matmul(h, p["lru_w_x"])
    K = p["lru_conv"].shape[0]
    split = bool(rules.mesh_dims("seq"))
    pad = cache.conv.to(dt) if cache is not None else \
        torch.zeros_like(_last_rows(xs, K - 1) if split else xs[:, :K - 1])
    if split:
        runs = rules.seq_slices("seq", total)
        r = rules.shard_index("seq")
        tails = rules.pgather(_last_rows(xs, K - 1), "seq")
        full = torch.cat([_joined(_rows_before(pad, tails, runs, r, K - 1),
                                  tails), xs], 1)
        conv_tail = _rows_before(pad, tails, runs, len(runs), K - 1)
    else:
        full = torch.cat([pad, xs], dim=1)
        conv_tail = full[:, full.shape[1] - (K - 1):]
    xs = rules.act(_conv(full, p["lru_conv"], S), "batch", "seq", "tp")
    a, bx = _gates(p, xs.to(F32))
    if split:
        h0 = torch.zeros((B, a.shape[-1]), dtype=F32, device=x.device) \
            if cache is None else cache.h
        hseq, h_last = _carried(a, bx, h0, rules)
    else:
        hseq = _assoc_scan(a, bx, None if cache is None else cache.h)
        h_last = hseq[:, -1]
    out = rules.act(matmul(hseq.to(dt) * y_gate, p["lru_out"]), "batch",
                    "res_seq", None)
    if not return_cache:
        return out, None
    return out, LRUCache(h=h_last.contiguous(), conv=conv_tail.contiguous())


def rec_step(p: dict, x, cfg, cache: LRUCache):
    """One decode token, x ``[B, 1, d]`` -> (output ``[B, 1, d]``, new
    cache)."""
    dt = x.dtype
    h = apply_norm(p["ln"], x, cfg)[:, 0]
    y_gate = _gelu(matmul(h, p["lru_w_y"]))
    xs = matmul(h, p["lru_w_x"])
    full = torch.cat([cache.conv.to(dt), xs[:, None]], dim=1)
    # the reference's einsum "bkw,kw->bw": one dot, fp32 sums, one rounding
    xs = (full.to(F32) * p["lru_conv"].to(dt).to(F32)).sum(dim=1).to(dt)
    a, bx = _gates(p, xs.to(F32))
    h_new = a * cache.h + bx
    out = matmul(h_new.to(dt) * y_gate, p["lru_out"])[:, None]
    return out, LRUCache(h=h_new, conv=full[:, 1:].contiguous())


def init_rec_cache(cfg, batch: int, dtype=torch.bfloat16,
                   device="cuda") -> LRUCache:
    w = cfg.lru_width or cfg.d_model
    return LRUCache(
        h=torch.zeros((batch, w), dtype=F32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, w), dtype=dtype,
                         device=device))
