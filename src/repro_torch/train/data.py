"""Synthetic, deterministic, restart-safe data (the port of
``repro.train.data``).

Batches are a pure function of (arch, step, seed), so a restarted job
regenerates exactly the stream it would have seen: the data half of
checkpoint/restart fault tolerance.  The draws are the reference's, one
``np.random.default_rng(seed * 1_000_003 + step)`` stream, so tokens,
labels and memory are bit for bit the reference's batch.
``sharded_batch`` gives each rank of a mesh only its own rows of it, as
DTensors.
"""
from __future__ import annotations

import numpy as np
import torch


def batch_spec(cfg, cell) -> dict:
    """``{name: (shape, torch dtype)}`` of a training batch of a
    ``ShapeCell``: int32 tokens and labels ``[B, S]``, and bf16 memory
    ``[B, memory_len, d_model]`` (image tokens or encoder frames) for a
    VLM or audio config."""
    B, S = cell.global_batch, cell.seq_len
    spec = {"tokens": ((B, S), torch.int32), "labels": ((B, S), torch.int32)}
    if cfg.family == "vlm":
        spec["memory"] = ((B, cfg.n_image_tokens, cfg.d_model),
                          torch.bfloat16)
    if cfg.family == "audio":
        spec["memory"] = ((B, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    return spec


def synthetic_batch(cfg, batch: int, seq: int, step: int, seed: int = 0,
                    device="cpu") -> dict[str, torch.Tensor]:
    """The reference's batch of ``step`` on ``device``: tokens and their
    next-token labels from one draw of ``[batch, seq + 1]`` ids, then
    (VLM, audio) N(0, 1) memory.  The memory's float64 draw goes to bf16
    through float32, as the reference's ``jnp.asarray(..., bfloat16)``
    takes it (JAX canonicalizes float64 to float32 first): one rounding
    straight from float64 differs in the last bf16 bit where the float32
    value lands on a bf16 midpoint."""
    return sharded_batch(cfg, batch, seq, step, {}, seed, device)


def sharded_batch(cfg, batch: int, seq: int, step: int, shardings: dict,
                  seed: int = 0, device="cpu") -> dict:
    """The batch of ``step`` with each array that ``shardings`` (name ->
    ``parallel.sharding.Sharding``, e.g. ``rules.sharding("batch",
    None)``) places as a DTensor of which this rank holds only its own
    rows, on the mesh's device; the others whole on ``device``.  The
    draw on the host is the whole batch (one numpy stream, which cannot
    be entered midway), so every rank's rows are the reference's."""
    rng = np.random.default_rng(np.uint64(seed) * 1_000_003
                                + np.uint64(step))
    toks = rng.integers(0, cfg.vocab, size=(batch, seq + 1), dtype=np.int64)
    toks = torch.from_numpy(toks.astype(np.int32))
    out = {"tokens": toks[:, :-1].contiguous(),
           "labels": toks[:, 1:].contiguous()}
    mem_len = {"vlm": cfg.n_image_tokens, "audio": cfg.encoder_seq} \
        .get(cfg.family)
    if mem_len:
        draw = rng.standard_normal((batch, mem_len, cfg.d_model))
        out["memory"] = torch.from_numpy(draw.astype(np.float32)) \
            .to(torch.bfloat16)

    def place(name, x):
        sh = shardings.get(name)
        return x.to(device) if sh is None else sh.place(x)
    return {k: place(k, v) for k, v in out.items()}
