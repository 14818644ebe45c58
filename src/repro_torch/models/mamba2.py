"""Mamba-2 SSD block (state-space duality), the port of
``repro.models.mamba2``.

Chunked SSD as the reference writes it: the sequence is split into
chunks (padded to a whole number with ``dt = 0``, a no-op on the state
recurrence); within a chunk the quadratic, attention-like form; across
chunks a scan of the small ``[H, P, N]`` state.  The decode hand-off
state is recomputed from a cumsum over the whole sequence, as the
reference does.  ``ssm_step`` is the one-token recurrence.  The SSM
state is fp32; the conv state is in the activations' dtype.

Over a ``model`` axis (``tp``) a rank holds its SSD heads' columns of
``ssm_w_z`` and ``ssm_w_x`` and their rows of ``ssm_out`` (row-parallel:
the ranks' products are summed); ``ssm_w_b``, ``ssm_w_c``, ``ssm_w_dt``,
``ssm_conv`` and the per-head and norm vectors are whole on every rank,
which takes its heads' slice of them (:func:`_local`).  The gated norm is
an RMS over the whole ``d_inner``: its sum of squares is summed over the
ranks.  The caches hold the rank's heads.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..parallel.sharding import NO_SHARDING, AxisRules
from .common import (F32, _silu, apply_norm, init_norm, normal, rmsnorm,
                     row_parallel)


class SSMCache(NamedTuple):
    state: torch.Tensor       # [B, H, P, N] fp32
    conv: torch.Tensor        # [B, K-1, conv_dim]


def init_ssm(gen: torch.Generator, cfg, device=None) -> dict:
    """The block's params (reference ``mamba2.py:29``): the projections
    at 1/sqrt(d_model), the conv at 0.1, ``A_log`` and ``dt_bias``
    zeros, ``D`` ones, the gated norm's scale zeros, the output
    projection at 1/sqrt(d_inner)."""
    device = device or gen.device
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    s = 1.0 / math.sqrt(d)
    conv_dim = di + 2 * G * N

    def zeros(n):
        return torch.zeros((n,), dtype=F32, device=device)
    return {
        "ln": init_norm(cfg, device=device),
        "ssm_w_z": normal(gen, (d, di), s, device),
        "ssm_w_x": normal(gen, (d, di), s, device),
        "ssm_w_b": normal(gen, (d, G * N), s, device),
        "ssm_w_c": normal(gen, (d, G * N), s, device),
        "ssm_w_dt": normal(gen, (d, H), s, device),
        "ssm_conv": normal(gen, (cfg.ssm_conv, conv_dim), 0.1, device),
        "ssm_a_log": zeros(H),
        "ssm_dt_bias": zeros(H),
        "ssm_d": torch.ones((H,), dtype=F32, device=device),
        "ssm_norm": zeros(di),
        "ssm_out": normal(gen, (di, d), 1.0 / math.sqrt(di), device),
    }


def _causal_conv(seq, w, state=None):
    """Depthwise causal conv1d, then silu.  seq ``[B, S, C]``; w ``[K,
    C]``; state ``[B, K-1, C]`` -> (out, the last K-1 rows)."""
    K, S = w.shape[0], seq.shape[1]
    pad = torch.zeros_like(seq[:, :K - 1]) if state is None \
        else state.to(seq.dtype)
    full = torch.cat([pad, seq], dim=1)
    out = 0
    for i in range(K):
        out = out + full[:, i:i + S] * w[i].to(seq.dtype)
    return _silu(out), full[:, full.shape[1] - (K - 1):]


def _ssd_chunked(x, dt, A, B_, C, chunk: int):
    """Chunked SSD scan.  x ``[B, S, H, P]``; dt ``[B, S, H]``; A
    ``[H]``; B_/C ``[B, S, G, N]``; S a multiple of ``chunk``.  Returns
    y ``[B, S, H, P]``."""
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    nc = S // chunk
    rep = H // G
    xc = x.reshape(Bb, nc, chunk, H, P)
    dtc = dt.reshape(Bb, nc, chunk, H)
    Bc = torch.repeat_interleave(B_.reshape(Bb, nc, chunk, G, N), rep, 3)
    Cc = torch.repeat_interleave(C.reshape(Bb, nc, chunk, G, N), rep, 3)

    dA = dtc * (-torch.exp(A))                             # [B,nc,c,H] (<0)
    seg = torch.cumsum(dA, dim=2)                          # within a chunk
    total = seg[:, :, -1]                                  # [B,nc,H]

    # intra-chunk (quadratic within a chunk)
    li = seg[:, :, :, None, :] - seg[:, :, None, :, :]     # [B,nc,ci,cj,H]
    ii = torch.arange(chunk, device=x.device)
    mask = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    decay = torch.where(mask, torch.exp(li), torch.zeros((), device=x.device))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores * dtc[:, :, None],
                           xc)

    # chunk states, then the recurrence across chunks
    decay_in = torch.exp(total[:, :, None, :] - seg)       # [B,nc,c,H]
    chunk_state = torch.einsum("bcjhn,bcjhp->bchpn",
                               Bc * (decay_in * dtc)[..., None], xc)
    st = torch.zeros((Bb, H, P, N), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * torch.exp(total[:, c])[..., None, None] + chunk_state[:, c]
    prev_states = torch.stack(prev, dim=1)                 # [B,nc,H,P,N]

    decay_out = torch.exp(seg)                             # [B,nc,c,H]
    y_inter = torch.einsum("bcihn,bchpn->bcihp",
                           Cc * decay_out[..., None], prev_states)
    return (y_intra + y_inter).reshape(Bb, S, H, P)


def _matmul(x, w):
    """``x @ w`` in x's dtype, the products summed in IEEE fp32 and
    rounded once on every device (``common.matmul``'s rule on the CPU),
    as the reference's dots sum them.  The card's bf16 tensor-core GEMM
    rounds its fp32 partial sums otherwise (a [24, 1536] x [1536, 3072]
    product agrees with the IEEE sum in 99.935% of outputs, an fp32 GEMM
    in 99.986%), and 48 SSM layers carry those last bits past the logits'
    tolerance of the reference's golden; the cost is fp32 GEMMs in this
    block (on an H100, mamba2-780m's prefill of 4 x 600 tokens took
    256 ms where it took 175)."""
    return (x.to(F32) @ w.to(x.dtype).to(F32)).to(x.dtype)


def _gated_norm(y, z, scale, rules: AxisRules = NO_SHARDING):
    """``rmsnorm(y * silu(z))`` in y's dtype, the gate's product taken in
    fp32 into the norm: the reference writes it in bf16, but XLA fuses
    the product into the norm's fp32 cast and drops its bf16 rounding
    (rounding it here differs in about 26% of the outputs).  Over heads
    split on ``model`` (y, z and ``scale`` the rank's columns) the sum
    of squares is summed over the ranks."""
    g = y.to(F32) * _silu(z).to(F32)
    R = rules.shards("heads")
    if R == 1:
        return rmsnorm(g, scale).to(y.dtype)
    var = rules.psum(g.square().sum(dim=-1, keepdim=True), "heads") \
        / (g.shape[-1] * R)
    out = g * torch.rsqrt(var + 1e-6) * (1.0 + scale.to(F32))
    return out.to(y.dtype)


def _local(p: dict, cfg, rules: AxisRules) -> tuple[dict, int]:
    """``(params, heads)``: the block's params as this rank computes with
    them, and its SSD head count (all of them off a ``model`` axis): the
    columns of ``ssm_w_z`` / ``ssm_w_x`` and the rows of ``ssm_out`` are
    its own; of the leaves that every rank holds whole, its heads' slice
    (``ssm_w_dt``, ``ssm_a_log``, ``ssm_dt_bias``, ``ssm_d``, its
    ``d_inner`` columns of ``ssm_norm`` and of the conv's x channels; the
    conv's B and C channels whole)."""
    P, di = cfg.ssm_head_dim, cfg.d_inner
    H = p["ssm_w_x"].shape[-1] // P
    if H == cfg.ssm_heads:
        return p, H
    h0 = rules.shard_index("heads") * H
    heads, cols = slice(h0, h0 + H), slice(h0 * P, (h0 + H) * P)
    q = dict(p)
    q["ssm_w_dt"] = p["ssm_w_dt"][:, heads]
    for name in ("ssm_a_log", "ssm_dt_bias", "ssm_d"):
        q[name] = p[name][heads]
    q["ssm_norm"] = p["ssm_norm"][cols]
    q["ssm_conv"] = torch.cat([p["ssm_conv"][:, cols], p["ssm_conv"][:, di:]],
                              dim=1)
    return q, H


def _project(p: dict, h, cfg):
    """``(z, conv input, dt)`` of the normed input ``h``: a sequence's
    ``[B, S, d]`` or one token's ``[B, d]``.  The ``dt`` product is
    rounded to h's dtype for a sequence; for one token XLA fuses it into
    its fp32 cast and keeps it fp32 (the bf16 products summed in fp32),
    as here."""
    z = _matmul(h, p["ssm_w_z"])
    conv_in = torch.cat([_matmul(h, p["ssm_w_x"]), _matmul(h, p["ssm_w_b"]),
                         _matmul(h, p["ssm_w_c"])], dim=-1)
    if h.dim() == 2:
        dt = h.to(F32) @ p["ssm_w_dt"].to(h.dtype).to(F32)
    else:
        dt = _matmul(h, p["ssm_w_dt"]).to(F32)
    return z, conv_in, F.softplus(dt + p["ssm_dt_bias"])


def ssm_forward(p: dict, x, cfg, cache: SSMCache | None = None, *,
                return_cache: bool = False, rules: AxisRules = NO_SHARDING):
    """Full-sequence forward (prefill): x ``[B, S, d]`` -> (output,
    pre-residual; the cache or None)."""
    B, S, d = x.shape
    dt_ = x.dtype
    p, H = _local(p, cfg, rules)
    G, N, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    di = H * P
    h = apply_norm(p["ln"], x, cfg)
    z, conv_in, dt = _project(p, h, cfg)
    conv_out, conv_state = _causal_conv(conv_in, p["ssm_conv"])
    xs, Bp, Cp = torch.split(conv_out, [di, G * N, G * N], dim=-1)
    xs = rules.act(xs.reshape(B, S, H, P), "batch", "seq", "heads", None)
    Bp = Bp.reshape(B, S, G, N).to(F32)
    Cp = Cp.reshape(B, S, G, N).to(F32)

    chunk = min(cfg.ssm_chunk, S)
    pad = (-S) % chunk
    xp, Bq, Cq, dtp = xs, Bp, Cp, dt
    if pad:  # zero-dt padding is a no-op on the state recurrence
        xp = F.pad(xs, (0, 0, 0, 0, 0, pad))
        Bq = F.pad(Bp, (0, 0, 0, 0, 0, pad))
        Cq = F.pad(Cp, (0, 0, 0, 0, 0, pad))
        dtp = F.pad(dt, (0, 0, 0, pad))
    y = _ssd_chunked(xp.to(F32), dtp, p["ssm_a_log"], Bq, Cq, chunk)[:, :S]
    y = y + xs.to(F32) * p["ssm_d"][:, None]
    y = _gated_norm(y.reshape(B, S, di).to(dt_), z, p["ssm_norm"], rules)
    out = rules.act(row_parallel(y, p["ssm_out"], rules, "heads", _matmul),
                    "batch", "res_seq", None)
    if not return_cache:
        return out, None
    # the final state for the decode hand-off, from a cumsum over S
    dA = dt * (-torch.exp(p["ssm_a_log"]))
    seg = torch.cumsum(dA, dim=1)
    decay_in = torch.exp(seg[:, -1:, :] - seg)
    Bh = torch.repeat_interleave(Bp, H // G, dim=2)
    state = torch.einsum("bshn,bshp->bhpn", Bh * (decay_in * dt)[..., None],
                         xs.to(F32))
    return out, SSMCache(state=state.to(F32).contiguous(),
                         conv=conv_state.to(dt_).contiguous())


def ssm_step(p: dict, x, cfg, cache: SSMCache,
             rules: AxisRules = NO_SHARDING):
    """One decode token, x ``[B, 1, d]`` -> (output ``[B, 1, d]``, new
    cache)."""
    B = x.shape[0]
    dt_ = x.dtype
    p, H = _local(p, cfg, rules)
    G, N, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    di = H * P
    h = apply_norm(p["ln"], x, cfg)[:, 0]
    z, conv_in, dt = _project(p, h, cfg)                      # dt [B,H]
    full = torch.cat([cache.conv.to(dt_), conv_in[:, None]], dim=1)
    w = p["ssm_conv"].to(dt_)
    # the reference's einsum "bkc,kc->bc": fp32 sums, one rounding
    conv_out = _silu((full.to(F32) * w.to(F32)).sum(dim=1).to(dt_))
    xs, Bp, Cp = torch.split(conv_out, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(B, H, P).to(F32)
    Bp = torch.repeat_interleave(Bp.reshape(B, G, N), H // G, 1).to(F32)
    Cp = torch.repeat_interleave(Cp.reshape(B, G, N), H // G, 1).to(F32)
    dA = torch.exp(dt * (-torch.exp(p["ssm_a_log"])))          # [B,H]
    state = (cache.state * dA[..., None, None]
             + (dt[..., None] * xs)[..., None] * Bp[:, :, None, :])
    y = torch.einsum("bhn,bhpn->bhp", Cp, state)
    y = y + xs * p["ssm_d"][:, None]
    y = _gated_norm(y.reshape(B, di).to(dt_), z, p["ssm_norm"], rules)
    out = row_parallel(y, p["ssm_out"], rules, "heads", _matmul)[:, None]
    return out, SSMCache(state=state, conv=full[:, 1:].contiguous())


def init_ssm_cache(cfg, batch: int, dtype=torch.bfloat16, device="cuda",
                   rules: AxisRules = NO_SHARDING) -> SSMCache:
    """An empty cache of this rank's SSD heads."""
    R = rules.shards("heads")
    conv_dim = cfg.d_inner // R + 2 * cfg.ssm_groups * cfg.ssm_state
    return SSMCache(
        state=torch.zeros((batch, cfg.ssm_heads // R, cfg.ssm_head_dim,
                           cfg.ssm_state), dtype=F32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device))
