"""Shared layers: norms, RoPE, attention (prefill and decode), dense MLPs
and their initialisers, as plain functions on tensors (the port of
``repro.models.common``).

The reference's order of operations and dtypes are kept: norms and RoPE
compute in fp32 and cast back, attention scores and softmax are fp32,
activations stay in the residual stream's dtype (bf16 on the serve
path) and every matmul weight is cast to it.  Each ``rules.act`` of the
reference is kept (``parallel.sharding.AxisRules``): it acts only on a
DTensor, and the mesh path hands these functions plain tensors, the
rank's own rows.  Over a ``model`` axis (``tp``) the weights are the
rank's shards: its query heads (and KV heads, or the KV heads its query
heads read where they do not divide: :func:`local_heads`), its
``d_ff`` columns; a row-parallel product (``w_o``, ``w_down``) gives
the rank's partial sum, which :func:`row_parallel` adds up over the
ranks in fp32 before it rounds to the activations' dtype (under
``sp_residual`` each rank keeps its run of the sequence of that sum:
:func:`reduce_partial`).  Where the sequence is split over ranks
(``seq`` on a mesh dim) q is the rank's run and :func:`attention` takes
K and V gathered whole with the run's offset; where a decode cache's
sequence is (``kv_seq``), each rank attends over its slice and
:func:`combine_partials` joins the ranks' results by their
log-sum-exp.

The initialisers (``init_norm``, ``init_attn``, ``init_mlp``) draw from
an explicit ``torch.Generator`` on its device (or on ``device``, which
may be ``"meta"`` for shapes alone): the layout, dtypes and
distributions are the reference's, the values cannot be the JAX PRNG's.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..parallel.sharding import NO_SHARDING, AxisRules

F32 = torch.float32
NEG_INF = -2.3819763e38  # large negative for masking (bf16-safe)


def matmul(x, w):
    """``x @ w`` in x's dtype, ``w`` cast to it.  On the CPU a bf16
    product is computed in fp32 and rounded once, as XLA's CPU backend
    computes the reference's bf16 dots (bit for bit at the reduced
    widths the tests use; PyTorch's own CPU bf16 kernel sums in another
    order); on the card cuBLAS's bf16 GEMM accumulates in fp32."""
    w = w.to(x.dtype)
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return (x.to(F32) @ w.to(F32)).to(x.dtype)
    return x @ w


def reduce_partial(part, rules: AxisRules, logical: str):
    """The sum over ``logical``'s ranks of their partial sums ``part``
    ``[B, S, ...]``; under ``sp_residual`` (the residual's sequence split
    where the block's is not) this rank's run of the sequence of it, a
    reduce-scatter in place of the full sum."""
    if rules.scatters_residual():
        return rules.scatter_sum(part, "res_seq", dim=1)
    return rules.psum(part, logical)


def row_parallel(x, w, rules: AxisRules, logical: str, product=None):
    """``x @ w`` of a product whose rows ``w`` holds this rank's shard of
    over ``logical`` (``heads``, ``ff``): the ranks' fp32 partial sums are
    summed (:func:`reduce_partial`), then rounded to x's dtype once, as
    one device rounds its product's fp32 sum once (a bf16 partial rounded
    on each rank before the sum would add a rounding a rank);
    ``product`` (:func:`matmul` by default) where ``logical`` is whole."""
    if rules.shards(logical) == 1:
        return (product or matmul)(x, w)
    part = x.to(F32) @ w.to(x.dtype).to(F32)
    return reduce_partial(part, rules, logical).to(x.dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.to(F32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(F32))).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.to(F32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(F32) + bias.to(F32)).to(x.dtype)


def apply_norm(p: dict, x, cfg):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# --------------------------------------------------------------------------
# Initialisers
# --------------------------------------------------------------------------

def normal(gen: torch.Generator, shape, scale: float = 1.0, device=None):
    """``scale * N(0, 1)`` of ``shape``, fp32, drawn from ``gen`` on its
    device (or on ``device``)."""
    t = torch.empty(shape, dtype=F32, device=device or gen.device)
    return t.normal_(generator=gen).mul_(scale)


def uniform(gen: torch.Generator, shape, low: float, high: float,
            device=None):
    """U[low, high) of ``shape``, fp32, drawn from ``gen``."""
    t = torch.empty(shape, dtype=F32, device=device or gen.device)
    return t.uniform_(low, high, generator=gen)


def init_norm(cfg, d: int | None = None, device="cpu") -> dict:
    d = d or cfg.d_model
    p = {"scale": torch.zeros((d,), dtype=F32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=F32, device=device)
    return p


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S] (broadcastable), or one int
    position for S = 1 (a decode step: no host-to-device copy)."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.pow(theta, -torch.arange(0, half, dtype=F32,
                                          device=x.device) / half)
    if isinstance(positions, int):
        ang = (freq * positions)[None]                  # [1, half]
    else:
        ang = positions[..., None].to(F32) * freq       # [..., S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

def _softcap(s, cap: float | None):
    if cap is None:
        return s
    return torch.tanh(s / cap) * cap


def _expand_kv(k, n_heads: int):
    """GQA: repeat KV heads to the full head count (on the head axis,
    dim 2)."""
    group = n_heads // k.shape[2]
    return torch.repeat_interleave(k, group, dim=2) if group > 1 else k


def attention(q, k, v, *, causal: bool, window: int | None,
              softcap: float | None, q_offset: int = 0, chunk: int = 2048,
              bf16_einsum: bool = False):
    """q: [B,Sq,H,D]; k/v: [B,Skv,KV,D] (GQA).  Query-chunked so the
    score matrix never exceeds [B,H,chunk,Skv], as the reference.

    ``bf16_einsum``: the reference's bf16 score pipeline.  The scores are
    the products of q and k in their own dtype summed in fp32, then
    rounded to q's dtype; softcap, mask (at that dtype's lowest value),
    ``exp(s - max)`` and ``p / sum`` stay in it, the max and the sum are
    taken in fp32, and ``p @ v`` sums in fp32 before it is rounded to q's
    dtype.  An fp32 product of operands that were bf16 is exact, so
    multiplying the upcast operands is bf16 operands with fp32
    accumulation.

    ``q_offset`` is the position of q's first row: a rank's run of a
    sequence split over ranks attends K and V gathered whole."""
    B, Sq, H, D = q.shape
    if Sq == 0:   # a rank past the end of a short split sequence
        return q.new_zeros((B, 0, H, v.shape[-1]))
    k = _expand_kv(k, H).to(F32)
    v = _expand_kv(v, H).to(F32)
    qs = q * _const(D ** -0.5, q)
    kpos = torch.arange(k.shape[1], device=q.device)

    def chunk_attn(qc, cstart: int):
        s = torch.einsum("bqhd,bshd->bhqs", qc.to(F32), k)
        if bf16_einsum:
            s = s.to(q.dtype)
        s = _softcap(s, softcap)
        qpos = (cstart + q_offset
                + torch.arange(qc.shape[1], device=q.device))[:, None]
        mask = torch.ones_like(s, dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = s.masked_fill(~mask, NEG_INF if s.dtype == F32
                          else torch.finfo(s.dtype).min)
        if bf16_einsum:
            m = s.to(F32).amax(dim=-1, keepdim=True)
            p = torch.exp(s - m.to(s.dtype))
            total = p.sum(dim=-1, keepdim=True, dtype=F32)
            p = p / total.to(s.dtype)
            return torch.einsum("bhqs,bshd->bqhd", p.to(F32),
                                v).to(q.dtype)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqs,bshd->bqhd", p, v).to(q.dtype)

    return torch.cat([chunk_attn(qs[:, c0:c0 + chunk], c0)
                      for c0 in range(0, Sq, chunk)], dim=1)


def decode_attention(q, k, v, cur_len, *, softcap: float | None,
                     ring: bool = False, window: int = 0,
                     return_lse: bool = False):
    """Single-step decode, the plain version.  q: [B,1,H,D]; k/v:
    [B,S,KV,D] (S = cache length or ring window).  ``cur_len``: tokens so
    far *including* the current one.  For ``ring`` caches, slot validity
    is the vMCU boundary check.  ``return_lse``: also each q row's
    log-sum-exp ``[B, H]`` (fp32), the output in fp32, and a slice with
    no valid slot gives 0 and ``-inf`` (the partial a rank of a split
    cache adds: :func:`combine_partials`)."""
    B, _, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = (q.to(F32) * D ** -0.5).reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.to(F32))
    s = _softcap(s, softcap)
    slot = torch.arange(S, device=q.device)
    if ring:
        valid = (slot < cur_len) | (cur_len >= window)
    else:
        valid = slot < cur_len
    s = s.masked_fill(~valid, NEG_INF)
    if return_lse:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        total = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bkgs,bskd->bkgd", p / total, v.to(F32))
        lse = (m + torch.log(total))[..., 0].reshape(B, H)
        empty = torch.as_tensor(cur_len, device=q.device) < 1
        o = torch.where(empty, torch.zeros((), device=q.device), o)
        lse = torch.where(empty, torch.full((), float("-inf"),
                                            device=q.device), lse)
        return o.reshape(B, 1, H, D), lse
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.to(F32))
    return o.reshape(B, 1, H, D).to(q.dtype)


def combine_partials(o, lse, rules: AxisRules, logical: str = "kv_seq"):
    """The ranks' partial attentions over their slices of a split cache
    joined into the attention over the whole, in fp32: ``o [B, 1, H, D]``
    and ``lse [B, H]`` of this rank; ``m = pmax(lse)``, ``w = exp(lse -
    m)``, ``psum(w o) / psum(w)`` over ``logical``'s ranks (an empty
    slice, ``lse = -inf``, weighs 0)."""
    m = rules.pmax(lse, logical)
    w = torch.exp(lse - m)[:, None, :, None]
    num = rules.psum(w * o.to(F32), logical)
    return num / rules.psum(w, logical)


# --------------------------------------------------------------------------
# Attention block
# --------------------------------------------------------------------------

def init_attn(gen: torch.Generator, cfg, *, cross: bool = False,
              device=None) -> dict:
    """An attention sub-layer's params (reference ``common.py:186``):
    w_q, w_k, w_v, w_o drawn N(0, 1) / sqrt(d_model), in that order."""
    device = device or gen.device
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = 1.0 / math.sqrt(d)
    p = {"ln": init_norm(cfg, device=device),
         "w_q": normal(gen, (d, qd), s, device),
         "w_k": normal(gen, (d, kvd), s, device),
         "w_v": normal(gen, (d, kvd), s, device),
         "w_o": normal(gen, (qd, d), s, device)}
    if cfg.post_norms:
        p["post_ln"] = init_norm(cfg, device=device)
    return p


class KVCache(NamedTuple):
    k: torch.Tensor   # [B, S_or_window, KV, D]
    v: torch.Tensor


class KVSlice(NamedTuple):
    """A rank's run of a cache split on ``kv_seq``: slots ``start ..
    start + n`` of the whole cache, every KV head."""
    k: torch.Tensor   # [B, n, KV, D]
    v: torch.Tensor
    start: int


def local_heads(cfg, rules: AxisRules = NO_SHARDING) -> tuple[int, int, int]:
    """``(query heads, KV heads, first KV head)`` of this rank: its
    ``n_heads / R`` query heads where ``heads`` is split over R ranks,
    and its ``n_kv_heads / R`` KV heads where those divide (``kv_heads``
    split too); else every rank holds the KV projections whole and uses
    the KV heads its query heads read (GQA groups of ``n_heads /
    n_kv_heads`` heads; :func:`~repro_torch.parallel.sharding.
    check_executable` refuses a split whose runs differ in length)."""
    R = rules.shards("heads")
    hq = cfg.n_heads // R
    if R == 1 or rules.shards("kv_heads") > 1:
        kv = cfg.n_kv_heads // R
        return hq, kv, rules.shard_index("heads") * kv
    group = cfg.n_heads // cfg.n_kv_heads
    return hq, max(1, hq // group), rules.shard_index("heads") * hq // group


def kv_weights(p: dict, cfg, rules: AxisRules = NO_SHARDING):
    """``(w_k, w_v)`` of the KV heads this rank computes
    (:func:`local_heads`): the leaves as they are, or the columns of the
    KV heads its query heads read where every rank holds them whole."""
    _, kv, first = local_heads(cfg, rules)
    w_k, w_v = p["w_k"], p["w_v"]
    if w_k.shape[-1] == kv * cfg.head_dim:
        return w_k, w_v
    cols = slice(first * cfg.head_dim, (first + kv) * cfg.head_dim)
    return w_k[:, cols], w_v[:, cols]


def project_qkv(p: dict, x, cfg, positions, *, rope_q: bool = True,
                rope_k: bool = True, rules: AxisRules = NO_SHARDING,
                all_kv: bool = False):
    """q ``[B, S, heads, D]`` and k, v ``[B, S, KV heads, D]`` of this
    rank's heads (all of them off a ``model`` axis); ``all_kv``: k and v
    of every KV head (a cache split on ``kv_seq`` under ``tp``, where each
    rank attends every head over its slice; the projections are whole
    there, ``AxisRules.whole_on_model``)."""
    B, S, _ = x.shape
    w_k, w_v = (p["w_k"], p["w_v"]) if all_kv else kv_weights(p, cfg, rules)
    D = cfg.head_dim   # head counts from the weights: S may be 0
    q = matmul(x, p["w_q"]).reshape(B, S, p["w_q"].shape[-1] // D, D)
    k = matmul(x, w_k).reshape(B, S, w_k.shape[-1] // D, D)
    v = matmul(x, w_v).reshape(B, S, w_v.shape[-1] // D, D)
    if rope_q:
        q = rope(q, positions, cfg.rope_theta)
    if rope_k:
        k = rope(k, positions, cfg.rope_theta)
    q = rules.act(q, "batch", "seq", "heads", None)
    k = rules.act(k, "batch", None, "kv_heads", None)
    v = rules.act(v, "batch", None, "kv_heads", None)
    return q, k, v


# --------------------------------------------------------------------------
# Dense MLPs
# --------------------------------------------------------------------------

@functools.cache
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: JAX rounds a
    weakly typed Python float to the array's dtype before the operation,
    and torch computes a bf16 operation with a Python scalar in fp32,
    where the rounded value is exact (no device tensor, so no copy to
    the card and no wait for it)."""
    return torch.tensor(value, dtype=dtype).item()


def _const(value: float, like) -> float:
    return _rounded(value, like.dtype)


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh form, one operation at a time
    in x's dtype as the reference computes it (in bf16 every product and
    sum is rounded; one rounding of the fp32 result differs from it in
    about 45% of bf16 outputs)."""
    inner = x + _const(0.044715, x) * (x * x * x)
    cdf = 0.5 * (1.0 + torch.tanh(_const(math.sqrt(2 / math.pi), x) * inner))
    return x * cdf


def _silu(x):
    """``jax.nn.silu``, ``x * sigmoid(x)``, one operation at a time in x's
    dtype as the reference computes it: XLA expands the sigmoid to ``1 /
    (1 + exp(-x))`` and rounds every step in bf16 (``torch.sigmoid``,
    one rounding of the sigmoid, differs from it in about 28% of bf16
    outputs)."""
    return x * (1 / (1 + torch.exp(-x)))


def init_mlp(gen: torch.Generator, cfg, d_ff: int | None = None,
             device=None) -> dict:
    """A dense MLP's params (reference ``common.py:231``): w_gate (gated
    MLPs), w_up at 1/sqrt(d_model), w_down at 1/sqrt(d_ff)."""
    device = device or gen.device
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"ln": init_norm(cfg, device=device)}
    if cfg.mlp in ("geglu", "swiglu"):
        p["w_gate"] = normal(gen, (d, f), s_in, device)
    p["w_up"] = normal(gen, (d, f), s_in, device)
    p["w_down"] = normal(gen, (f, d), s_out, device)
    if cfg.post_norms:
        p["post_ln"] = init_norm(cfg, device=device)
    return p


def mlp_forward(p: dict, x, cfg, rules: AxisRules = NO_SHARDING):
    h = apply_norm(p["ln"], x, cfg)
    up = matmul(h, p["w_up"])
    up = rules.act(up, "batch", "seq", "ff")
    if cfg.mlp == "geglu":
        up = _gelu(matmul(h, p["w_gate"])) * up
    elif cfg.mlp == "swiglu":
        up = _silu(matmul(h, p["w_gate"])) * up
    else:
        up = _gelu(up)
    out = rules.act(row_parallel(up, p["w_down"], rules, "ff"), "batch",
                    "res_seq", None)
    if cfg.post_norms:
        out = apply_norm(p["post_ln"], out, cfg)
    return out
