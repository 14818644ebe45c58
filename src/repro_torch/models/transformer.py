"""The decoder LM for serving (the port of ``repro.models.transformer``:
``forward``, ``prefill``, ``decode_step`` and ``init_caches`` for the
attention block kinds ``full``, ``local`` and ``global`` with a dense
FFN).

Modes:
  * ``forward``      full sequence -> logits ``[B, S, V]``
  * ``prefill``      full sequence + caches -> (last logits, caches, S)
  * ``decode_step``  one token against the caches

Cache kinds: a full or global layer keeps ``[B, cache_len, KV, D]``; a
sliding-window (``local``) layer keeps the vMCU ring of ``window`` slots,
where slot ``t % window`` holds token ``t``.  A decode step writes its
token's K/V into its slot in place (the reference builds a new cache
with a one-hot masked add; a token past the end of a global cache is
dropped by both) and runs the decode attention: on a CUDA card through
the hand-written ``ring_decode_attention`` kernel (one launch per layer
for the whole batch, a global cache taken as a ring of ``cache_len``
slots that never wraps), on the CPU — or with ``Model(cfg, plain=True)``
on the card — through the plain ``common.decode_attention``.

The reference scans over stacked layer groups; the port runs the same
layers in the same order (``lead``, then each group's pattern, then the
remainder: :func:`layer_kinds`) from a flat list.  Params are a dict:
``embed`` (fp32, also the tied unembedding), ``final_ln``, and
``layers``, one block dict per layer, matmul weights stored in bf16 once
at load (the value the reference's ``w.astype(bf16)`` gives at every
call).  :func:`params_from_reference` builds it from the reference's
params tree as numpy arrays.

The block kinds ``cross``, ``rec`` and ``ssm`` and MoE FFNs are not
ported (ROADMAP Queue 1 item 9): :class:`Model` raises
``NotImplementedError`` for them.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..kernels.ring_decode import ring_decode_attention
from .common import (KVCache, _softcap, apply_norm, attention,
                     decode_attention, matmul, mlp_forward, project_qkv,
                     rope)

ATTN_KINDS = ("full", "local", "global")
#: Weights every call casts to the activations' dtype: stored so at load.
MATMUL_WEIGHTS = ("w_q", "w_k", "w_v", "w_o", "w_gate", "w_up", "w_down")
#: Slots per online-softmax block of the decode kernel.
DECODE_BLOCK = 128
ACT_DTYPE = torch.bfloat16


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               "item 9: MoE, mamba2, rglru, cross-attention)")


def check_supported(cfg) -> None:
    """Raise for what the port's LM stack does not run yet."""
    bad = sorted(set(cfg.pattern) - set(ATTN_KINDS))
    if bad:
        raise _unported(f"block kind(s) {bad} of {cfg.name}")
    if cfg.n_experts:
        raise _unported(f"the MoE FFN of {cfg.name}")
    if cfg.encoder_layers or cfg.n_image_tokens:
        raise _unported(f"the encoder/image memory of {cfg.name}")


def _layer_seq(cfg) -> tuple[int, int, int]:
    """(lead layers, full groups, remainder layers), as the reference."""
    g, rem = cfg.n_groups()
    lead = cfg.first_dense_layers
    if lead:
        g = (cfg.n_layers - lead) // len(cfg.pattern)
        rem = (cfg.n_layers - lead) % len(cfg.pattern)
    return lead, g, rem


def layer_kinds(cfg) -> list[str]:
    """The block kind of every layer in execution order: ``lead``
    layers, then ``g`` groups of the pattern, then the remainder."""
    lead, g, rem = _layer_seq(cfg)
    return ([cfg.pattern[0]] * lead + list(cfg.pattern) * g
            + list(cfg.pattern[:rem]))


def _index(tree, i: int):
    """Leaf ``[i]`` of every array of a stacked subtree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_index(v, i) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return tree[i]


def layers_from_tree(cfg, tree) -> list:
    """Per-layer subtrees, in :func:`layer_kinds` order, of a tree laid
    out as the reference's params or caches: ``lead`` (a tuple),
    ``groups`` (a tuple over pattern positions of subtrees stacked
    ``[g, ...]``) and ``rem`` (a tuple)."""
    _, g, _ = _layer_seq(cfg)
    layers = list(tree.get("lead", ()))
    for gi in range(g):
        layers += [_index(sub, gi) for sub in tree["groups"]]
    return layers + list(tree.get("rem", ()))


def params_from_reference(cfg, tree, device="cuda") -> dict:
    """The port's params from the reference's params tree (numpy arrays
    laid out as ``Model.init`` builds them, ``transformer.py:301-340``):
    the embedding and norm scales as fp32, matmul weights as bf16, on
    ``device``."""
    check_supported(cfg)
    if "unembed" in tree:
        raise _unported("an untied unembedding")

    def put(name, a):
        a = np.ascontiguousarray(a, np.float32)
        if not a.flags.writeable:   # torch wants memory it may write
            a = a.copy()
        t = torch.from_numpy(a).to(device)
        return t.to(ACT_DTYPE) if name in MATMUL_WEIGHTS else t

    def convert(sub):
        return {k: convert(v) if isinstance(v, dict) else put(k, v)
                for k, v in sub.items()}

    return {"embed": put("embed", tree["embed"]),
            "final_ln": convert(tree["final_ln"]),
            "layers": [convert(p) for p in layers_from_tree(cfg, tree)]}


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def _attn_sub(p: dict, x, cfg, kind: str, positions, *,
              make_cache: bool = False, cache_len: int = 0):
    """Self-attention sub-layer, full sequence (reference ``:84-118``)."""
    B, S, _ = x.shape
    h = apply_norm(p["ln"], x, cfg)
    q, k, v = project_qkv(p, h, cfg, positions)
    window = cfg.window if kind == "local" else None
    o = attention(q, k, v, causal=True, window=window,
                  softcap=cfg.attn_softcap, bf16_einsum=cfg.bf16_einsum)
    o = matmul(o.reshape(B, S, cfg.q_dim), p["w_o"])
    if cfg.post_norms:
        o = apply_norm(p["post_ln"], o, cfg)
    cache = None
    if make_cache:
        if kind == "local":
            w = cfg.window
            if S >= w:   # the ring roll: slot t % w holds token t
                cache = KVCache(torch.roll(k[:, S - w:], S % w, dims=1),
                                torch.roll(v[:, S - w:], S % w, dims=1))
            else:
                pad = (0, 0, 0, 0, 0, w - S)
                cache = KVCache(torch.nn.functional.pad(k, pad),
                                torch.nn.functional.pad(v, pad))
        else:
            pad = (0, 0, 0, 0, 0, max(cache_len, S) - S)
            cache = KVCache(torch.nn.functional.pad(k, pad),
                            torch.nn.functional.pad(v, pad))
    return o, cache


def _ffn_sub(p: dict, x, cfg):
    if "ffn" not in p:
        return torch.zeros_like(x)
    return mlp_forward(p["ffn"], x, cfg)


def block_forward(p: dict, x, cfg, kind: str, positions, *,
                  make_cache: bool = False, cache_len: int = 0):
    """Residual block, full sequence -> (x, cache)."""
    if kind not in ATTN_KINDS:
        raise _unported(f"block kind {kind!r}")
    o, cache = _attn_sub(p["attn"], x, cfg, kind, positions,
                         make_cache=make_cache, cache_len=cache_len)
    x = x + o
    return x + _ffn_sub(p, x, cfg), cache


def block_step(p: dict, x, cfg, kind: str, cache: KVCache, cur_len: int,
               *, plain: bool = False):
    """One-token decode step -> (x, cache), the cache written in place
    (reference ``:184-254``)."""
    if kind not in ATTN_KINDS:
        raise _unported(f"block kind {kind!r}")
    B = x.shape[0]
    pos = cur_len - 1
    ap = p["attn"]
    ring = kind == "local"
    h = apply_norm(ap["ln"], x, cfg)
    q = matmul(h, ap["w_q"]).reshape(B, 1, cfg.n_heads, cfg.head_dim)
    kn = matmul(h, ap["w_k"]).reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
    vn = matmul(h, ap["w_v"]).reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, pos, cfg.rope_theta)
    kn = rope(kn, pos, cfg.rope_theta)
    slot = pos % cfg.window if ring else pos
    S = cache.k.shape[1]
    if slot < S:   # a token past a full global cache is dropped
        cache.k[:, slot] = kn[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = vn[:, 0].to(cache.v.dtype)
    if q.device.type == "cuda" and not plain:
        # one launch for the batch; a global cache is a ring of S slots
        # that never wraps, where the validity rule is slot < cur_len
        o = ring_decode_attention(
            q.reshape(B, cfg.n_heads, cfg.head_dim).contiguous(), cache.k,
            cache.v, cur_len, window=S, block=DECODE_BLOCK,
            softcap=cfg.attn_softcap)
    else:
        o = decode_attention(q, cache.k, cache.v, cur_len,
                             softcap=cfg.attn_softcap, ring=ring,
                             window=cfg.window)
    o = matmul(o.reshape(B, 1, cfg.q_dim), ap["w_o"])
    if cfg.post_norms:
        o = apply_norm(ap["post_ln"], o, cfg)
    x = x + o
    return x + _ffn_sub(p, x, cfg), cache


def init_block_cache(cfg, kind: str, batch: int, cache_len: int,
                     dtype=ACT_DTYPE, device="cuda") -> KVCache:
    if kind not in ATTN_KINDS:
        raise _unported(f"the cache of block kind {kind!r}")
    S = cfg.window if kind == "local" else cache_len
    shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


# --------------------------------------------------------------------------
# Whole model
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Model:
    """Plain-function model facade built from a ModelConfig; runs on the
    device its params lie on.  ``plain`` sends the card's decode
    attention through the plain version (a reference path for checks)."""

    cfg: object
    plain: bool = False

    def __post_init__(self):
        check_supported(self.cfg)

    def _embed(self, params, tokens):
        x = params["embed"][tokens]
        return (x * math.sqrt(self.cfg.d_model)).to(ACT_DTYPE)

    def _unembed(self, params, x):
        w = params["embed"]
        logits = x.to(torch.float32) @ w.to(torch.float32).T
        return _softcap(logits, self.cfg.logit_softcap)

    def _tokens(self, params, tokens):
        return torch.as_tensor(tokens, device=params["embed"].device) \
            .to(torch.int64)

    def forward(self, params, tokens):
        """tokens ``[B, S]`` -> (logits ``[B, S, V]`` fp32, aux 0.0)."""
        cfg = self.cfg
        tokens = self._tokens(params, tokens)
        x = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=x.device)
        for p, kind in zip(params["layers"], layer_kinds(cfg)):
            x, _ = block_forward(p, x, cfg, kind, positions)
        x = apply_norm(params["final_ln"], x, cfg)
        return self._unembed(params, x), 0.0

    def init_caches(self, batch: int, cache_len: int, dtype=ACT_DTYPE,
                    device="cuda") -> list[KVCache]:
        return [init_block_cache(self.cfg, kind, batch, cache_len, dtype,
                                 device) for kind in layer_kinds(self.cfg)]

    def prefill(self, params, tokens, cache_len: int = 0):
        """Full-sequence pass materializing caches; returns (logits of
        the last position ``[B, V]``, caches, cur_len)."""
        cfg = self.cfg
        tokens = self._tokens(params, tokens)
        S = tokens.shape[1]
        cache_len = max(cache_len, S)
        x = self._embed(params, tokens)
        positions = torch.arange(S, device=x.device)
        caches = []
        for p, kind in zip(params["layers"], layer_kinds(cfg)):
            x, c = block_forward(p, x, cfg, kind, positions,
                                 make_cache=True, cache_len=cache_len)
            caches.append(c)
        x = apply_norm(params["final_ln"], x, cfg)
        return self._unembed(params, x[:, -1:])[:, 0], caches, S

    def decode_step(self, params, caches, token, cur_len: int):
        """token ``[B]`` -> (logits ``[B, V]``, caches written in place,
        cur_len + 1)."""
        cfg = self.cfg
        token = self._tokens(params, token)
        x = self._embed(params, token[:, None])
        cur = int(cur_len) + 1  # length including this token
        for p, kind, c in zip(params["layers"], layer_kinds(cfg), caches):
            x, _ = block_step(p, x, cfg, kind, c, cur, plain=self.plain)
        x = apply_norm(params["final_ln"], x, cfg)
        return self._unembed(params, x)[:, 0], caches, cur
