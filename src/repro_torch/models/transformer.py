"""The LM for serving (the port of ``repro.models.transformer``): one
engine for the decoder LM, MoE, hybrid, SSM, encoder-decoder and VLM
configs, with ``init``, ``forward``, ``prefill``, ``decode_step`` and
``init_caches`` for every block kind (``full``, ``local``, ``global``,
``cross``, ``rec``, ``ssm``) and FFN kind (dense, MoE, none).

Modes:
  * ``forward``      full sequence -> logits ``[B, S, V]`` and the aux
  * ``prefill``      full sequence + caches -> (last logits, caches, S)
  * ``decode_step``  one token against the caches

Cache kinds: a full or global layer keeps ``[B, cache_len, KV, D]``; a
sliding-window (``local``) layer keeps the vMCU ring of ``window`` slots,
where slot ``t % window`` holds token ``t``; a ``cross`` layer keeps its
self-attention cache and the memory's K/V (``CrossCache``), projected
once in prefill with no RoPE; ``rec`` and ``ssm`` layers keep their O(1)
state (``rglru.LRUCache``, ``mamba2.SSMCache``).  A decode step writes
its token's K/V into its slot in place (the reference builds a new cache
with a one-hot masked add; a token past the end of a global cache is
dropped by both) and runs the decode attention: on a CUDA card through
the hand-written ``ring_decode_attention`` kernel (one launch per
attention for the whole batch; a global cache is a ring of
``cache_len`` slots that never wraps, the cross memory one of
``memory_len`` slots, always full), on the CPU — or with
``Model(cfg, plain=True)`` on the card — through the plain
``common.decode_attention``.

The reference scans over stacked layer groups; the port runs the same
layers in the same order (``lead``, then each group's pattern, then the
remainder: :func:`layer_kinds`) from a flat list.  ``Model.init`` draws
the reference's tree layout (``lead``, ``groups`` stacked ``[g, ...]``,
``rem``, ``encoder``) from a ``torch.Generator``; :func:`train_params`
lays such a tree (torch or numpy arrays, the reference's own among them)
out as the port's params, and :func:`params_from_reference` copies that
layout to the serving device: ``embed`` (fp32,
also the tied unembedding), ``unembed`` (untied configs, fp32),
``final_ln``, ``layers`` (one block dict per layer) and ``encoder``
(``blocks``, ``final_ln``), every weight the reference casts to the
activations' dtype at each call stored so (bf16) once at load.

Training (``Model.loss``) takes the reference's tree itself, the fp32
masters (or a bf16 copy of them), and lays it out by
:func:`train_params` (differentiable slices, no copy and no cast); every
use casts a weight as the reference does, so the gradients land on the
tree's leaves.  ``loss`` is the reference's cross-entropy
(plus ``0.01 * aux`` for MoE), and its ``remat_policy`` checkpoints each
pattern group as the reference's ``jax.checkpoint`` of ``apply_pattern``:
``"none"`` keeps every activation, ``"dots"`` keeps the products with no
batch dims (``aten.mm``) and recomputes the rest, and ``"nothing"`` (the
configs' default) or any other name recomputes the whole group.

Every entry point takes the reference's ``rules`` (a keyword here):
each ``rules.act`` of the reference is kept, and on a mesh the params
may be DTensors: the leaves outside the blocks are gathered whole on
entry, each block's just before it runs (``AxisRules.gather``), and the
tokens, memory, caches and every op's operands are plain tensors of the
rank's own rows (``parallel.sharding`` says why and where that ends).

Sequence parallelism.  Where the rules split ``seq``/``res_seq`` over
ranks (``fsdp_sp`` over a ``model`` axis), the tokens (and an encoder's
frames) come whole and each rank computes on its run of the positions:
the embedding keeps the rank's run of the vocabulary's sum
(``AxisRules.scatter_sum``), each attention gathers K and V whole and
attends its queries from the run's offset (causal, windowed across the
ranks, or bidirectional), a ``rec`` block carries its conv halo and scan
state across the ranks (``rglru``), the caches are built from the
gathered K/V and the whole sequence's recurrent state, and the hidden
sequence is gathered whole before the vocabulary-split unembedding, so
the logits (and the loss) are those of every position on each rank's
vocabulary rows (prefill gathers only the last position's row,
``AxisRules.seq_last``).  Under ``sp_residual`` (``tp``) only the residual is
split: a block gathers it at its entry and scatters its row-parallel
sums.  Where the rules split ``kv_seq`` (a decode cache whose KV heads
do not divide the ``model`` axis, ``long_context`` over a data axis), a
rank keeps its run of every full-length cache (``common.KVSlice``; ring
windows and cross memories stay whole), writes a token's slot only where
it owns it, and the ranks' partial decode attentions (the kernel's
``return_lse``) are combined by their log-sum-exp.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.ring_decode import ring_decode_attention
from ..parallel.sharding import NO_SHARDING, AxisRules, local_tree
from .common import (F32, KVCache, KVSlice, _const, _softcap, apply_norm,
                     attention, combine_partials, decode_attention,
                     init_attn, init_mlp, init_norm, kv_weights,
                     local_heads, matmul, mlp_forward, normal, project_qkv,
                     row_parallel)
from .mamba2 import SSMCache, init_ssm, init_ssm_cache, ssm_forward, \
    ssm_step
from .moe import init_moe, moe_forward
from .rglru import LRUCache, init_rec, init_rec_cache, rec_forward, rec_step

SELF_KINDS = ("full", "local", "global")
ATTN_KINDS = SELF_KINDS + ("cross",)
BLOCK_KINDS = ATTN_KINDS + ("rec", "ssm")
#: Weights every call casts to the activations' dtype: stored so at load.
MATMUL_WEIGHTS = (
    "w_q", "w_k", "w_v", "w_o", "w_gate", "w_up", "w_down",
    "lru_w_y", "lru_w_x", "lru_conv", "lru_out",
    "ssm_w_z", "ssm_w_x", "ssm_w_b", "ssm_w_c", "ssm_w_dt", "ssm_conv",
    "ssm_out",
    "router", "moe_gate", "moe_up", "moe_down", "shared_gate", "shared_up",
    "shared_down")
#: Slots per online-softmax block of the decode kernel.
DECODE_BLOCK = 128
ACT_DTYPE = torch.bfloat16


class CrossCache(NamedTuple):
    self_kv: KVCache    # or, split on kv_seq, a KVSlice
    mem_k: torch.Tensor    # [B, S_mem, KV, D]
    mem_v: torch.Tensor


def check_supported(cfg) -> None:
    """Raise ``ValueError`` for a block kind no engine runs."""
    bad = sorted(set(cfg.pattern) - set(BLOCK_KINDS))
    if bad:
        raise ValueError(f"unknown block kind(s) {bad} in {cfg.name}")


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


def _stack(trees: list, template):
    """The leaves of ``trees`` stacked on a new first axis (``[0, ...]``
    of ``template``'s shapes when there are none)."""
    if isinstance(template, dict):
        return {k: _stack([t[k] for t in trees], v)
                for k, v in template.items()}
    if not trees:
        return template.new_zeros((0,) + tuple(template.shape))
    return torch.stack(trees)


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


def train_params(cfg, tree) -> dict:
    """The port's params laid out over a reference-layout tree (the
    reference's ``Model.init``, ``transformer.py:301-342``) without a
    copy or a cast: ``embed``, ``final_ln``, ``unembed`` and the
    encoder's ``final_ln`` are the tree's own arrays, and ``layers`` /
    the encoder's ``blocks`` slices of its stacked leaves, so autograd
    carries each layer's gradient back to the leaf it was sliced from."""
    check_supported(cfg)
    params = {"embed": tree["embed"], "final_ln": tree["final_ln"],
              "layers": layers_from_tree(cfg, tree)}
    if "unembed" in tree:
        params["unembed"] = tree["unembed"]
    if "encoder" in tree:
        enc = tree["encoder"]
        n = enc["blocks"]["attn"]["w_q"].shape[0]
        params["encoder"] = {
            "blocks": [_index(enc["blocks"], i) for i in range(n)],
            "final_ln": enc["final_ln"]}
    return params


def params_from_reference(cfg, tree, device="cuda") -> dict:
    """The serve path's params: :func:`train_params` of a reference-layout
    tree (numpy arrays or torch tensors, e.g. :meth:`Model.init`'s) with
    the embeddings and norm and gate vectors as fp32 and the weights of
    :data:`MATMUL_WEIGHTS` as bf16 copies, on ``device``."""
    def put(name, a):
        if isinstance(a, torch.Tensor):
            t = a.to(device=device, dtype=torch.float32)
        else:
            a = np.ascontiguousarray(a, np.float32)
            if not a.flags.writeable:   # torch wants memory it may write
                a = a.copy()
            t = torch.from_numpy(a).to(device)
        return t.to(ACT_DTYPE) if name in MATMUL_WEIGHTS else t

    def convert(name, sub):
        if isinstance(sub, dict):
            return {k: convert(k, v) for k, v in sub.items()}
        if isinstance(sub, list):
            return [convert(name, v) for v in sub]
        return put(name, sub)
    return convert(None, train_params(cfg, tree))


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` remat policy: keep the outputs of products with no
    batch dims (``jax.checkpoint_policies.dots_with_no_batch_dims_
    saveable``: ``aten.mm``), recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` under the remat ``policy`` (``"none"``: as it is)."""
    if policy == "none":
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    kwargs = {}
    if policy == "dots":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kwargs)


# --------------------------------------------------------------------------
# Block init
# --------------------------------------------------------------------------

def _ffn_init(gen, cfg, *, dense_ff: int | None = None, device=None):
    if cfg.d_ff == 0:
        return None
    if cfg.n_experts and dense_ff is None:
        return init_moe(gen, cfg, device)
    return init_mlp(gen, cfg, d_ff=dense_ff, device=device)


def init_block(gen: torch.Generator, cfg, kind: str, *,
               dense_ff: int | None = None, device=None) -> dict:
    """One block's params (reference ``transformer.py:60``)."""
    if kind in SELF_KINDS:
        p = {"attn": init_attn(gen, cfg, device=device)}
    elif kind == "cross":
        p = {"attn": init_attn(gen, cfg, device=device),
             "xattn": init_attn(gen, cfg, cross=True, device=device)}
    elif kind == "rec":
        p = {"rec": init_rec(gen, cfg, device)}
    elif kind == "ssm":
        p = {"ssm": init_ssm(gen, cfg, device)}
    else:
        raise ValueError(kind)
    ffn = _ffn_init(gen, cfg, dense_ff=dense_ff, device=device)
    if ffn is not None:
        p["ffn"] = ffn
    return p


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def kv_split(cfg, kind: str, cache_len: int, rules: AxisRules) -> bool:
    """Whether a ``kind`` layer's cache is split on ``kv_seq`` over ranks:
    only a full-length one (a ``full``/``global`` layer's, or a cross
    block's self cache) of ``cache_len != window`` slots, as the
    reference's ``cache_specs`` classifies it; ring windows and cross
    memories stay whole."""
    return bool(rules.mesh_dims("kv_seq")) and kind != "local" \
        and cache_len != cfg.window


def _attn_sub(p: dict, x, cfg, kind: str, positions, *,
              make_cache: bool = False, cache_len: int = 0,
              rules: AxisRules = NO_SHARDING, total: int | None = None):
    """Self-attention sub-layer, full sequence (reference ``:84-118``).
    Over a sequence split on ``seq`` (``total`` positions), x is the
    rank's run: K and V are gathered whole and q attends from the run's
    offset; a cache is built from the whole K/V (and split on
    ``kv_seq`` where the rules say: :func:`kv_split`)."""
    B, S, _ = x.shape
    n = total or S
    split = make_cache and kv_split(cfg, kind, cache_len, rules)
    all_kv = split and rules.shards("heads") > 1
    h = apply_norm(p["ln"], x, cfg)
    q, k, v = project_qkv(p, h, cfg, positions, rules=rules, all_kv=all_kv)
    if rules.mesh_dims("seq"):
        k, v = rules.seq_gather(k, "seq", n), rules.seq_gather(v, "seq", n)
    ka, va = k, v
    if all_kv:   # this rank's heads attend the KV heads they read
        _, kvh, first = local_heads(cfg, rules)
        ka, va = k[:, :, first:first + kvh], v[:, :, first:first + kvh]
    window = cfg.window if kind == "local" else None
    o = attention(q, ka, va, causal=True, window=window,
                  softcap=cfg.attn_softcap, bf16_einsum=cfg.bf16_einsum,
                  q_offset=rules.seq_slice("seq", n)[0])
    o = row_parallel(o.flatten(2), p["w_o"], rules, "heads")
    o = rules.act(o, "batch", "res_seq", None)
    if cfg.post_norms:
        o = apply_norm(p["post_ln"], o, cfg)
    cache = None
    if make_cache:
        if kind == "local":
            w = cfg.window
            if n >= w:   # the ring roll: slot t % w holds token t
                ring_k = torch.roll(k[:, n - w:], n % w, dims=1)
                ring_v = torch.roll(v[:, n - w:], n % w, dims=1)
            else:
                pad = (0, 0, 0, 0, 0, w - n)
                ring_k = torch.nn.functional.pad(k, pad)
                ring_v = torch.nn.functional.pad(v, pad)
            cache = KVCache(
                rules.act(ring_k, "batch", None, "kv_heads", None),
                rules.act(ring_v, "batch", None, "kv_heads", None))
        else:
            pad = (0, 0, 0, 0, 0, max(cache_len, n) - n)
            cache = KVCache(
                rules.act(torch.nn.functional.pad(k, pad), "batch",
                          "kv_seq", "kv_heads", None),
                rules.act(torch.nn.functional.pad(v, pad), "batch",
                          "kv_seq", "kv_heads", None))
            if split:   # the rank's run, copied so the whole is freed
                lo, m = rules.seq_slice("kv_seq", max(cache_len, n))
                cache = KVSlice(cache.k[:, lo:lo + m].contiguous(),
                                cache.v[:, lo:lo + m].contiguous(), lo)
    return o, cache


def _xattn_sub(p: dict, x, cfg, memory, *, make_cache: bool = False,
               rules: AxisRules = NO_SHARDING):
    """Cross-attention to the encoder/image memory: no causal mask, no
    RoPE (reference ``:121-140``) -> (out, (K, V) of the memory or
    None)."""
    if memory is None:
        raise ValueError(f"{cfg.name}'s cross blocks need memory")
    B, S, _ = x.shape
    h = apply_norm(p["ln"], x, cfg)
    w_k, w_v = kv_weights(p, cfg, rules)
    q = matmul(h, p["w_q"]).reshape(B, S, p["w_q"].shape[-1]
                                    // cfg.head_dim, cfg.head_dim)
    M = memory.shape[1]
    mk = matmul(memory, w_k).reshape(B, M, -1, cfg.head_dim)
    mv = matmul(memory, w_v).reshape(B, M, -1, cfg.head_dim)
    q = rules.act(q, "batch", "seq", "heads", None)
    mk = rules.act(mk, "batch", None, "kv_heads", None)
    mv = rules.act(mv, "batch", None, "kv_heads", None)
    o = attention(q, mk, mv, causal=False, window=None, softcap=None,
                  bf16_einsum=cfg.bf16_einsum)
    o = row_parallel(o.flatten(2), p["w_o"], rules, "heads")
    o = rules.act(o, "batch", "res_seq", None)
    return o, ((mk, mv) if make_cache else None)


def _ffn_sub(p: dict, x, cfg, routes=None, rules: AxisRules = NO_SHARDING):
    """The FFN sub-layer -> (out, aux): none, MoE (a ``router`` in its
    params; its ``moe.Routing`` appended to ``routes`` where that is a
    list) or dense (the ``lead`` layers of an MoE config too)."""
    if "ffn" not in p:
        return torch.zeros_like(x), 0.0
    if cfg.n_experts and "router" in p["ffn"]:
        out, aux, routing = moe_forward(p["ffn"], x, cfg, rules)
        if routes is not None:
            routes.append(routing)
        return out, aux
    return mlp_forward(p["ffn"], x, cfg, rules), 0.0


def block_forward(p: dict, x, cfg, kind: str, positions, *, memory=None,
                  make_cache: bool = False, cache_len: int = 0,
                  routes=None, rules: AxisRules = NO_SHARDING,
                  total: int | None = None):
    """Residual block, full sequence -> (x, cache, aux).  Over a sequence
    split on ranks (``total`` positions in all) x is the rank's run of
    the residual; under ``sp_residual`` each sub-layer gathers it whole
    at its entry (its row-parallel sum comes back as the rank's run)."""
    n = total or x.shape[1]

    def enter(t):   # a sub-layer's input
        return rules.block_input(t, n)
    cache = None
    if kind in SELF_KINDS:
        o, cache = _attn_sub(p["attn"], enter(x), cfg, kind, positions,
                             make_cache=make_cache, cache_len=cache_len,
                             rules=rules, total=n)
        x = x + o
    elif kind == "cross":
        o, sc = _attn_sub(p["attn"], enter(x), cfg, "full", positions,
                          make_cache=make_cache, cache_len=cache_len,
                          rules=rules, total=n)
        x = x + o
        xo, mkv = _xattn_sub(p["xattn"], enter(x), cfg, memory,
                             make_cache=make_cache, rules=rules)
        x = x + xo
        if make_cache:
            cache = CrossCache(sc, mkv[0].contiguous(), mkv[1].contiguous())
    elif kind == "rec":
        o, cache = rec_forward(p["rec"], enter(x), cfg,
                               return_cache=make_cache, rules=rules, total=n)
        x = x + o
    elif kind == "ssm":
        o, cache = ssm_forward(p["ssm"], enter(x), cfg,
                               return_cache=make_cache, rules=rules)
        x = x + o
    else:
        raise ValueError(kind)
    o, aux = _ffn_sub(p, enter(x) if "ffn" in p else x, cfg, routes, rules)
    return x + o, cache, aux


def _decode_attn(q, k, v, cur_len: int, *, softcap, ring: bool,
                 window: int, plain: bool, return_lse: bool = False):
    """Decode attention of q ``[B, 1, H, D]`` over k/v ``[B, S, KV,
    D]``: on a card the kernel, the cache taken as a ring of S slots
    (the ring rule gives the reference's ``slot < cur_len`` for a cache
    that never wraps); elsewhere, or ``plain``, the plain version.
    ``return_lse`` (a rank's slice of a split cache, ``cur_len`` its
    valid slots): ``(out, lse [B, H])``, an empty slice giving 0 and
    ``-inf``."""
    B, _, H, D = q.shape
    if return_lse and k.shape[1] == 0:   # a rank past the cache's end
        return (torch.zeros(q.shape, dtype=F32, device=q.device),
                torch.full((B, H), float("-inf"), device=q.device))
    if q.device.type != "cuda" or plain:
        return decode_attention(q, k, v, cur_len, softcap=softcap,
                                ring=ring, window=window,
                                return_lse=return_lse)
    # an fp32 memory (image tokens) takes q up to fp32, exactly, as the
    # plain version computes every score in fp32
    qk = q.reshape(B, H, D).to(k.dtype).contiguous()
    o = ring_decode_attention(qk, k, v, cur_len, window=k.shape[1],
                              block=DECODE_BLOCK, softcap=softcap,
                              return_lse=return_lse)
    if return_lse:
        return o[0].reshape(B, 1, H, D), o[1]
    return o.to(q.dtype).reshape(B, 1, H, D)


def _split_decode_attn(q, kv: KVSlice, cur_len: int, cfg, *, plain: bool,
                       rules: AxisRules):
    """Decode attention over a cache split on ``kv_seq``: this rank
    attends over its slice (its valid slots ``cur_len - start``, clamped)
    and the ranks' partials are combined (:func:`~.common.
    combine_partials`).  Under ``tp`` (heads split too) the ranks' q are
    gathered, every head attends, and the rank keeps its own heads."""
    hq = q.shape[2]
    heads = rules.shards("heads") > 1
    if heads:
        q = torch.cat(list(rules.pgather(q, "heads")), dim=2)
    n = kv.k.shape[1]
    local = min(max(cur_len - kv.start, 0), n)
    o, lse = _decode_attn(q, kv.k, kv.v, local, softcap=cfg.attn_softcap,
                          ring=False, window=n, plain=plain, return_lse=True)
    o = combine_partials(o, lse, rules)
    if heads:
        h0 = rules.shard_index("heads") * hq
        o = o[:, :, h0:h0 + hq]
    return o.to(q.dtype)


def _self_attn_step(ap: dict, x, cfg, kv: KVCache, cur_len: int, *,
                    ring: bool, plain: bool, rules: AxisRules = NO_SHARDING):
    """One token's self-attention (reference ``:191-232``): project,
    RoPE, write the token's slot in place, attend -> (out, kv)."""
    B = x.shape[0]
    pos = cur_len - 1
    split = isinstance(kv, KVSlice)
    h = apply_norm(ap["ln"], x, cfg)
    q, kn, vn = project_qkv(ap, h, cfg, pos, rules=rules,
                            all_kv=split and rules.shards("heads") > 1)
    slot = pos % cfg.window if ring else pos
    if split:   # the slot lies in one rank's slice, or past the cache
        slot -= kv.start
    if 0 <= slot < kv.k.shape[1]:   # a token past a full cache is dropped
        kv.k[:, slot] = kn[:, 0].to(kv.k.dtype)
        kv.v[:, slot] = vn[:, 0].to(kv.v.dtype)
    if split:
        o = _split_decode_attn(q, kv, cur_len, cfg, plain=plain,
                               rules=rules)
    else:
        o = _decode_attn(q, kv.k, kv.v, cur_len, softcap=cfg.attn_softcap,
                         ring=ring, window=cfg.window, plain=plain)
    o = row_parallel(o.reshape(B, 1, -1), ap["w_o"], rules, "heads")
    if cfg.post_norms:
        o = apply_norm(ap["post_ln"], o, cfg)
    return o, kv


def block_step(p: dict, x, cfg, kind: str, cache, cur_len: int, *,
               plain: bool = False, routes=None,
               rules: AxisRules = NO_SHARDING):
    """One-token decode step -> (x, cache); attention caches are written
    in place, recurrent states replaced (reference ``:184-254``)."""
    B = x.shape[0]
    if kind in SELF_KINDS:
        o, cache = _self_attn_step(p["attn"], x, cfg, cache, cur_len,
                                   ring=kind == "local", plain=plain,
                                   rules=rules)
        x_new = x + o
    elif kind == "cross":
        o, skv = _self_attn_step(p["attn"], x, cfg, cache.self_kv, cur_len,
                                 ring=False, plain=plain, rules=rules)
        x_new = x + o
        xp = p["xattn"]
        h = apply_norm(xp["ln"], x_new, cfg)
        q = matmul(h, xp["w_q"]).reshape(B, 1, -1, cfg.head_dim)
        M = cache.mem_k.shape[1]
        o = _decode_attn(q, cache.mem_k, cache.mem_v, M, softcap=None,
                         ring=False, window=0, plain=plain)
        x_new = x_new + row_parallel(o.reshape(B, 1, -1), xp["w_o"], rules,
                                     "heads")
        cache = CrossCache(skv, cache.mem_k, cache.mem_v)
    elif kind == "rec":
        o, cache = rec_step(p["rec"], x, cfg, cache)
        x_new = x + o
    elif kind == "ssm":
        o, cache = ssm_step(p["ssm"], x, cfg, cache, rules=rules)
        x_new = x + o
    else:
        raise ValueError(kind)
    o, _ = _ffn_sub(p, x_new, cfg, routes, rules)
    return x_new + o, cache


def init_block_cache(cfg, kind: str, batch: int, cache_len: int,
                     dtype=ACT_DTYPE, device="cuda",
                     rules: AxisRules = NO_SHARDING):
    """A layer's empty cache: of this rank's KV and SSM heads on a
    ``model`` axis (:func:`~.common.local_heads`); a full-length one split
    on ``kv_seq`` (:func:`kv_split`) the rank's slice of every KV head."""
    def kv(S, split=False):
        heads = local_heads(cfg, rules)[1]
        if split:
            start, S = rules.seq_slice("kv_seq", S)
            heads = cfg.n_kv_heads
        shape = (batch, S, heads, cfg.head_dim)
        k, v = (torch.zeros(shape, dtype=dtype, device=device)
                for _ in range(2))
        return KVSlice(k, v, start) if split else KVCache(k, v)
    split = kv_split(cfg, "full", cache_len, rules)
    if kind in ("full", "global"):
        return kv(cache_len, split)
    if kind == "local":
        return kv(cfg.window)
    if kind == "cross":
        mem = kv(cfg.memory_len())
        return CrossCache(kv(cache_len, split), mem.k, mem.v)
    if kind == "rec":
        return init_rec_cache(cfg, batch, dtype, device)
    if kind == "ssm":
        return init_ssm_cache(cfg, batch, dtype, device, rules)
    raise ValueError(kind)


# --------------------------------------------------------------------------
# The vocabulary over a model axis
# --------------------------------------------------------------------------

def log_softmax(logits, rules: AxisRules = NO_SHARDING):
    """The log-softmax of fp32 logits over the vocabulary: where it is
    split on ``model`` (each rank's logits its own rows'), the max and
    the sum of exponentials are taken over the ranks."""
    if rules.shards("vocab") == 1:
        return torch.log_softmax(logits, dim=-1)
    m = rules.pmax(logits.detach().amax(dim=-1, keepdim=True), "vocab")
    total = rules.psum(torch.exp(logits - m).sum(dim=-1, keepdim=True),
                       "vocab")
    return logits - (m + torch.log(total))


def label_logprob(logp, labels, rules: AxisRules = NO_SHARDING):
    """``[B, S]``: the label's log-probability, the reference's masked sum
    over the vocabulary (``transformer.py:449-456``: ``logp`` where the
    vocabulary id is the label, else 0).  Every other term of that sum is
    an exact 0, so the rank's term is read at the label where it lies in
    the rank's rows (``gather`` at the clamped id, masked) rather than
    summed over a ``[B, S, V]`` mask, and the sum over a ``model`` axis
    has one term that is not 0: both are exactly the masked sum."""
    labels = labels.to(torch.int64)
    n = logp.shape[-1]
    ids = labels - rules.shard_index("vocab") * n
    mine = (ids >= 0) & (ids < n)
    got = logp.gather(-1, ids.clamp(0, n - 1)[..., None])[..., 0]
    return rules.psum(torch.where(mine, got, torch.zeros((), dtype=got.dtype,
                                                         device=got.device)),
                      "vocab")


def vocab_logits(logits, rules: AxisRules = NO_SHARDING):
    """Logits over the whole vocabulary on every rank, from each rank's
    own rows' (``[..., V / R]``; as they are where the vocabulary is not
    split)."""
    if rules.shards("vocab") == 1:
        return logits
    parts = rules.pgather(logits, "vocab")          # [R, ..., V / R]
    return torch.cat(list(parts), dim=-1)


def greedy(logits, rules: AxisRules = NO_SHARDING):
    """``[B]``: each row's argmax over the vocabulary (the first of equal
    maxima, the lowest id, as ``jnp.argmax``): over a vocabulary split on
    ``model``, each rank's max and the global id of its first argmax,
    then the largest max, its lowest id among equals."""
    if rules.shards("vocab") == 1:
        return torch.argmax(logits, dim=-1)
    best, at = logits.max(dim=-1)
    at = at + rules.shard_index("vocab") * logits.shape[-1]
    vals = rules.pgather(best, "vocab")                # [R, B]
    ids = rules.pgather(at, "vocab")
    top = vals.amax(dim=0)
    return torch.where(vals == top, ids, torch.iinfo(ids.dtype).max) \
        .amin(dim=0)


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

    # ---- init -------------------------------------------------------------
    def init(self, generator: torch.Generator, device=None) -> dict:
        """A params tree laid out as the reference's ``Model.init``
        (``transformer.py:301-342``), fp32, drawn from ``generator`` on
        its device (or on ``device``; ``"meta"`` gives shapes alone):
        the embedding (and an untied unembedding) at 0.02, the ``lead``
        layers with a dense FFN of ``d_ff * (top_k + n_shared)``, each
        pattern position's ``g`` blocks stacked, the remainder, and the
        encoder's blocks stacked with its final norm."""
        cfg = self.cfg
        device = device or generator.device
        lead, g, rem = _layer_seq(cfg)
        tree = {"embed": normal(generator, (cfg.vocab, cfg.d_model), 0.02,
                                device),
                "final_ln": init_norm(cfg, device=device)}
        if not cfg.tie_embeddings:
            tree["unembed"] = normal(generator, (cfg.vocab, cfg.d_model),
                                     0.02, device)
        if lead:
            dense_ff = cfg.d_ff * (cfg.top_k + cfg.n_shared_experts)
            tree["lead"] = tuple(
                init_block(generator, cfg, cfg.pattern[0] if cfg.pattern
                           else "full", dense_ff=dense_ff, device=device)
                for _ in range(lead))

        def stacked(kind: str, n: int):
            blocks = [init_block(generator, cfg, kind, device=device)
                      for _ in range(n)]
            template = blocks[0] if blocks else init_block(
                generator, cfg, kind, device="meta")
            return _stack(blocks, template)
        tree["groups"] = tuple(stacked(kind, g) for kind in cfg.pattern)
        tree["rem"] = tuple(init_block(generator, cfg, cfg.pattern[i],
                                       device=device) for i in range(rem))
        if cfg.encoder_layers:
            tree["encoder"] = {"blocks": stacked("full", cfg.encoder_layers),
                               "final_ln": init_norm(cfg, device=device)}
        return tree

    # ---- helpers ------------------------------------------------------------
    def _on_rank(self, params, rules: AxisRules):
        """On a mesh (after :meth:`AxisRules.check`), ``params`` with the
        leaves outside the blocks (embeddings, final norms) gathered whole
        on this rank; each block gathers its own just before it runs."""
        if rules.mesh is None:
            return params
        rules.check(self.cfg)
        out = {k: v if k in ("layers", "encoder") else rules.gather(v)
               for k, v in params.items()}
        if "encoder" in params:
            out["encoder"] = {
                "blocks": params["encoder"]["blocks"],
                "final_ln": rules.gather(params["encoder"]["final_ln"])}
        return out

    def _embed(self, params, tokens, rules: AxisRules = NO_SHARDING,
               split: bool = True):
        """The embedded tokens; each caller constrains them (``rules.act(x,
        "batch", "res_seq", None)``, the reference's ``_embed``'s).  Over
        a vocabulary split on ``model`` a rank looks up the tokens in its
        range and puts zeros elsewhere; the sum over the ranks is the
        lookup, exactly (one term of it is not 0).  Where the residual's
        sequence is split (and ``split``: not a one-token step) the rank
        keeps its run of that sum (of the whole tokens it was given)."""
        table = params["embed"]
        runs = split and bool(rules.mesh_dims("res_seq"))
        if rules.shards("vocab") > 1:
            n = table.shape[0]
            ids = tokens - rules.shard_index("vocab") * n
            mine = (ids >= 0) & (ids < n)
            x = table[ids.clamp(0, n - 1)] * mine[..., None]
            x = rules.scatter_sum(x, "res_seq") if runs \
                else rules.psum(x, "vocab")
        else:
            x = table[tokens]
        return (x * _const(math.sqrt(self.cfg.d_model), x)).to(ACT_DTYPE)

    def _unembed(self, params, x):
        """The logits in fp32; with ``bf16_einsum`` the weights are
        rounded to x's dtype first (the reference's operands in x's
        dtype, summed in fp32)."""
        w = params.get("unembed", params["embed"])
        if self.cfg.bf16_einsum:
            w = w.to(x.dtype)
        logits = x.to(torch.float32) @ w.to(torch.float32).T
        return _softcap(logits, self.cfg.logit_softcap)

    def _logits(self, params, x, rules: AxisRules, total: int | None = None):
        """:meth:`_unembed`, constrained as the reference's ``_unembed``
        constrains its logits: over a vocabulary split on ``model``, the
        logits of this rank's vocabulary rows (``vocab_logits`` gathers
        them whole).  Given ``total``, x is the rank's run of a residual
        split on ``res_seq`` and is gathered whole first."""
        if total is not None:
            x = rules.seq_gather(x, "res_seq", total)
        return rules.act(self._unembed(params, x), "batch", None, "vocab")

    def _positions(self, x, rules: AxisRules, n: int):
        """The positions of the rank's run of ``n`` split on ``seq`` (all
        of them where nothing splits it), on x's device."""
        lo, m = rules.seq_slice("seq", n)
        return torch.arange(lo, lo + m, device=x.device)

    def _tokens(self, params, tokens):
        return torch.as_tensor(tokens, device=params["embed"].device) \
            .to(torch.int64)

    def _encode(self, params, frames, rules: AxisRules = NO_SHARDING):
        """The encoder over precomputed frame embeddings (reference
        ``:361-385``): bidirectional attention blocks, then its norm.
        Over a sequence split on ranks each rank encodes its run of the
        frames (K and V gathered whole), and the memory is gathered whole
        at the end."""
        cfg = self.cfg
        x = frames.to(ACT_DTYPE)
        B, n, _ = x.shape
        lo, m = rules.seq_slice("res_seq", n)
        x = x[:, lo:lo + m]
        pos = self._positions(x, rules, n)
        seq = bool(rules.mesh_dims("seq"))
        for bp in params["encoder"]["blocks"]:
            bp = rules.gather(bp)
            h = apply_norm(bp["attn"]["ln"], rules.block_input(x, n), cfg)
            q, k, v = project_qkv(bp["attn"], h, cfg, pos, rules=rules)
            if seq:
                k = rules.seq_gather(k, "seq", n)
                v = rules.seq_gather(v, "seq", n)
            o = attention(q, k, v, causal=False, window=None, softcap=None,
                          bf16_einsum=cfg.bf16_einsum)
            o = row_parallel(o.flatten(2),
                             bp["attn"]["w_o"], rules, "heads")
            x = x + rules.act(o, "batch", "res_seq", None)
            x = x + mlp_forward(bp["ffn"], rules.block_input(x, n), cfg,
                                rules)
        x = apply_norm(params["encoder"]["final_ln"], x, cfg)
        return rules.seq_gather(x, "res_seq", n)

    def _memory(self, params, memory, rules: AxisRules = NO_SHARDING):
        """The memory the cross blocks attend to: the encoder's output of
        ``memory`` (frames) where the config has an encoder, else the
        memory (image tokens) as given."""
        if memory is None:
            return None
        memory = torch.as_tensor(memory, device=params["embed"].device)
        if self.cfg.encoder_layers:
            memory = self._encode(params, memory, rules)
        return memory

    # ---- public: full-sequence forward ---------------------------------------
    def forward(self, params, tokens, memory=None, *, routes=None,
                remat_policy: str = "none", rules: AxisRules | None = None):
        """tokens ``[B, S]`` -> (logits ``[B, S, V]`` fp32, aux: 0.0, or
        the MoE layers' summed aux loss).  ``params`` are laid out as
        :func:`train_params` gives them.  Where ``routes`` is a list,
        each MoE layer appends its ``moe.Routing`` to it, in layer order
        (so do ``prefill`` and ``decode_step``); a remat policy other
        than ``"none"`` would record a recomputed group twice, so it
        takes no ``routes``.  On a mesh (``rules``), ``tokens`` and
        ``memory`` are this rank's rows (or DTensors of them) and the
        params may be DTensors: each block's are gathered whole just
        before it runs (inside its remat group, so a recompute gathers
        them again)."""
        cfg = self.cfg
        rules = rules or NO_SHARDING
        if routes is not None and remat_policy != "none":
            raise ValueError("routes= needs remat_policy='none'")
        params = self._on_rank(params, rules)
        tokens = self._tokens(params, local_tree(tokens))
        memory = self._memory(params, local_tree(memory), rules)
        x = rules.act(self._embed(params, tokens, rules), "batch", "res_seq",
                      None)
        n = tokens.shape[1]
        positions = self._positions(x, rules, n)

        def run(x, aux, layers, kinds):
            for p, kind in zip(layers, kinds):
                x, _, a = block_forward(rules.gather(p), x, cfg, kind,
                                        positions, memory=memory,
                                        routes=routes, rules=rules, total=n)
                aux = aux + a
            return x, aux

        # lead layers, then each pattern group under the remat policy,
        # then the remainder, as the reference's _scan_blocks
        lead, g, _ = _layer_seq(cfg)
        layers, kinds = params["layers"], layer_kinds(cfg)
        P = len(cfg.pattern)
        x, aux = run(x, 0.0, layers[:lead], kinds[:lead])
        group = _remat(run, remat_policy)
        for gi in range(lead, lead + g * P, P):
            x, aux = group(x, aux, layers[gi:gi + P], kinds[gi:gi + P])
        x, aux = run(x, aux, layers[lead + g * P:], kinds[lead + g * P:])
        x = apply_norm(params["final_ln"], x, cfg)
        return self._logits(params, x, rules, n), aux

    def loss(self, params, batch: dict, remat_policy: str | None = None, *,
             rules: AxisRules | None = None):
        """The reference's training loss (``transformer.py:443-461``) ->
        (loss, {"ce", "aux"}), fp32 scalars.  ``params`` is a
        reference-layout tree, the fp32 masters or a bf16 copy; ``batch``
        holds ``tokens`` and ``labels`` ``[B, S]`` and, for cross
        blocks, ``memory``.  The label's log-probability is the
        reference's masked sum over the vocabulary (:func:`label_logprob`),
        and over a vocabulary split on ``model`` the log-softmax takes its
        max and its sum of exponentials over the ranks.  On a mesh the
        batch's arrays are this rank's rows (or DTensors of them) and the
        loss is their mean: the global loss is the mean of the ranks'
        (``make_train_step`` takes it), and every rank of a ``model``
        axis holds it alike."""
        cfg = self.cfg
        rules = rules or NO_SHARDING
        batch = local_tree(batch)
        logits, aux = self.forward(train_params(cfg, params),
                                   batch["tokens"],
                                   batch.get("memory"),
                                   remat_policy=remat_policy
                                   or cfg.remat_policy, rules=rules)
        labels = torch.as_tensor(batch["labels"], device=logits.device)
        ll = label_logprob(log_softmax(logits, rules), labels, rules)
        ce = -ll.mean()
        aux = torch.as_tensor(aux, dtype=F32, device=logits.device)
        loss = ce + 0.01 * aux if cfg.n_experts else ce
        return loss, {"ce": ce, "aux": aux}

    # ---- public: serving ----------------------------------------------------
    def init_caches(self, batch: int, cache_len: int, dtype=ACT_DTYPE,
                    device="cuda", rules: AxisRules | None = None) -> list:
        return [init_block_cache(self.cfg, kind, batch, cache_len, dtype,
                                 device, rules or NO_SHARDING)
                for kind in layer_kinds(self.cfg)]

    def prefill(self, params, tokens, cache_len: int = 0, *, memory=None,
                routes=None, rules: AxisRules | None = None):
        """Full-sequence pass materializing caches; returns (logits of
        the last position ``[B, V]``, caches, cur_len).  On a mesh, as
        :meth:`forward`: the rank's rows, each block's params gathered
        just before it, and caches of the rank's rows."""
        cfg = self.cfg
        rules = rules or NO_SHARDING
        params = self._on_rank(params, rules)
        tokens = self._tokens(params, local_tree(tokens))
        memory = self._memory(params, local_tree(memory), rules)
        S = tokens.shape[1]
        cache_len = max(cache_len, S)
        x = rules.act(self._embed(params, tokens, rules), "batch", "res_seq",
                      None)
        positions = self._positions(x, rules, S)
        caches = []
        for p, kind in zip(params["layers"], layer_kinds(cfg)):
            x, c, _ = block_forward(rules.gather(p), x, cfg, kind, positions,
                                    memory=memory, make_cache=True,
                                    cache_len=cache_len, routes=routes,
                                    rules=rules, total=S)
            caches.append(c)
        x = apply_norm(params["final_ln"], x, cfg)
        x = rules.seq_last(x, "res_seq", S)
        return self._logits(params, x, rules)[:, 0], caches, S

    def decode_step(self, params, caches, token, cur_len: int, *,
                    routes=None, rules: AxisRules | None = None):
        """token ``[B]`` -> (logits ``[B, V]``, caches (attention caches
        written in place), cur_len + 1).  On a mesh, as :meth:`prefill`:
        the decode attention runs on the rank's rows of plain caches."""
        cfg = self.cfg
        rules = (rules or NO_SHARDING).one_token()
        params = self._on_rank(params, rules)
        token = self._tokens(params, local_tree(token))
        x = rules.act(self._embed(params, token[:, None], rules, split=False),
                      "batch", "res_seq", None)
        cur = int(cur_len) + 1  # length including this token
        new = []
        for p, kind, c in zip(params["layers"], layer_kinds(cfg), caches):
            x, c = block_step(rules.gather(p), x, cfg, kind, c, cur,
                              plain=self.plain, routes=routes, rules=rules)
            new.append(c)
        x = apply_norm(params["final_ln"], x, cfg)
        return self._logits(params, x, rules)[:, 0], new, cur


__all__ = ["ATTN_KINDS", "BLOCK_KINDS", "CrossCache", "KVCache", "KVSlice",
           "LRUCache", "Model", "SSMCache", "block_forward", "block_step",
           "greedy", "init_block", "init_block_cache", "label_logprob",
           "layer_kinds", "layers_from_tree", "log_softmax",
           "params_from_reference", "train_params", "vocab_logits"]
