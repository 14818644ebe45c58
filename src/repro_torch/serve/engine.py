"""Batched serving engine: greedy lockstep decode over ring KV caches (the
port of ``repro.serve.engine``).

``prefill`` materializes the caches (full and global layers ->
``[B, cache_len, KV, D]``; sliding-window layers -> the vMCU ring of
``window`` slots; cross layers -> their memory's K/V beside that;
recurrent and SSM layers -> their O(1) state) and ``decode_step`` advances every row one token,
writing ring slots modulo the window; on a CUDA card each layer's decode
attention is one launch of the hand-written ``ring_decode_attention``
for the whole batch.  The engine runs where the params lie.  On a mesh
(``rules`` with one) each rank prefills and decodes only its own rows
of the batch, with plain caches and each block's weights gathered just
before it (the params may be DTensors, or the rank's own plain tree),
and the ranks' tokens are gathered at the end, so every rank returns
the whole batch's.  Over a ``model`` axis every rank of a row decodes
its heads, experts and vocabulary rows (caches of its KV and SSM
heads), and the greedy token is the argmax over the ranks' vocabulary
rows (``transformer.greedy``).  Where the rules split a decode cache's
sequence (``kv_seq``: KV heads that do not divide the ``model`` axis, or
``long_context`` over a data axis) each rank's prefill keeps its run of
every full-length cache, and each decode step combines the ranks'
partial attentions by their log-sum-exp (``transformer.Model``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models.transformer import Model, greedy
from ..obs.spans import active, span
from ..parallel.sharding import AxisRules, no_sharding


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new: int = 16
    generated: list[int] = dataclasses.field(default_factory=list)


def make_serve_fns(model: Model, rules: AxisRules | None = None, *,
                   cache_len: int):
    """The prefill and decode-step functions of ``model`` under ``rules``
    (plain calls: PyTorch runs eagerly, so there is nothing to
    compile)."""
    rules = rules or no_sharding()

    def prefill(params, tokens, memory=None):
        return model.prefill(params, tokens, cache_len=cache_len,
                             memory=memory, rules=rules)

    def decode_step(params, caches, token, cur_len):
        return model.decode_step(params, caches, token, cur_len,
                                 rules=rules)

    return prefill, decode_step


class ServingEngine:
    """Greedy batched generation; one prefill per batch, then lockstep
    decode (one ``cur_len`` for every row, as the reference)."""

    def __init__(self, model: Model, params: Any,
                 rules: AxisRules | None = None, cache_len: int = 256):
        self.model = model
        self.params = params
        self.rules = rules or no_sharding()
        self.rules.check(model.cfg)
        self.cache_len = cache_len
        self.prefill, self.decode = make_serve_fns(model, self.rules,
                                                   cache_len=cache_len)

    def generate(self, prompts: list[list[int]], max_new: int = 16,
                 memory=None) -> list[list[int]]:
        """Greedy tokens for each prompt; ``memory`` (``[B, S_mem, d]``,
        encoder frames or image tokens) is what the cross blocks attend
        to.  Pad tokens pass through the recurrences and take MoE
        capacity slots, as in the reference."""
        B = len(prompts)
        L = max(len(p) for p in prompts)
        device = self.params["embed"].device
        # left-pad with token 0, which is attended (no pad mask), as the
        # reference does
        toks = torch.tensor([[0] * (L - len(p)) + list(p) for p in prompts],
                            dtype=torch.int64)
        rows = self.rules.sharding("batch", None)
        if rows is not None:
            if B % self.rules.batch_shards():
                raise ValueError(f"a batch of {B} prompts does not split "
                                 f"evenly over {self.rules.batch_shards()} "
                                 "ranks")
            toks = rows.local(toks)
            if memory is not None:
                memory = rows.local(torch.as_tensor(memory))
        toks = toks.to(device)
        with span("serve.prefill", batch=B, prompt_len=L):
            logits, caches, cur = self.prefill(self.params, toks, memory)
            if active() and device.type == "cuda":  # sync only when timing
                torch.cuda.synchronize(device)
        out = [[] for _ in range(len(toks))]
        tok = greedy(logits, self.rules)
        with span("serve.decode", batch=B, steps=max_new):
            for _ in range(max_new):
                for i, t in enumerate(tok.tolist()):
                    out[i].append(t)
                logits, caches, cur = self.decode(self.params, caches, tok,
                                                  cur)
                tok = greedy(logits, self.rules)
        if rows is not None:   # every rank's rows, on every rank
            mine = torch.tensor(out, dtype=torch.int64, device=device) \
                .reshape(len(toks), max_new)
            out = self.rules.pgather(mine, "batch").reshape(B, max_new) \
                .tolist()
        return out
