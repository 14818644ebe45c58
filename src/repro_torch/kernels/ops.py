"""Public kernel entry points (the port of ``repro.kernels.ops``).

``segment_gemm`` and ``fused_mlp`` are one-call demonstrations of the
ring API: plan a :class:`PoolProgram`, allocate a :class:`VirtualPool`
on the input's device, stage the input, ``execute``, fetch the result.
Production code keeps the pool alive across a longer program.
``decode_attention`` is one step of attention over a ring KV cache.

The device of the tensors picks the route: on a CUDA card the
hand-written kernels (``ring_gemm``, ``ring_fused_mlp``,
``ring_decode_attention``), on the CPU their plain versions.
"""
from __future__ import annotations

import torch

from ..core.executors import execute
from ..core.program import FusedMLPSpec, GemmSpec, plan_program
from ..core.vpool import SEG_WIDTH, VirtualPool
from . import ref
from .ring_decode import (ring_cache_update, ring_decode_attention,
                          ring_decode_attention_plain)

F32 = torch.float32


def segment_gemm(x, w, b=None, *, block_rows: int = 8):
    """Plan, stage and run the fp32 ring GEMM ``x [m, d_in] @ w [d_in,
    d_out] (+ b)``; returns ``(y, plan_info)``."""
    m, d_in = x.shape
    d_out = w.shape[1]
    program = plan_program(m, d_in, [GemmSpec(d_out)], seg_width=SEG_WIDTH,
                           block_rows=block_rows, elem_bytes=4)
    pool = VirtualPool.alloc(program.spec(), x.device)
    pool.stage_rows(x.to(F32), program.input_ptr)
    execute(program, pool, [(w.to(F32), None if b is None else b.to(F32))])
    y = pool.fetch_rows(program.output_ptr, m, d_out).clone()
    op = program.ops[0]
    info = dict(n_segments=program.n_segments, in_ptr=op.in_ptr,
                out_ptr=op.out_ptr, delta=op.delta,
                pool_bytes=program.physical_pool_bytes,
                naive_bytes=program.naive_bytes)
    return y, info


def fused_mlp(x, w_gate, w_up, w_down, *, block_rows: int = 8,
              ff_tile: int = 512, gated: bool = True, residual: bool = True,
              activation: str = "gelu"):
    """The in-place fused MLP of ``x [m, d]`` through a fresh ring pool
    (delta 0)."""
    m, d = x.shape
    program = plan_program(
        m, d,
        [FusedMLPSpec(d_ff=w_up.shape[1], gated=gated, residual=residual,
                      activation=activation, ff_tile=ff_tile)],
        seg_width=SEG_WIDTH, block_rows=block_rows, elem_bytes=4)
    pool = VirtualPool.alloc(program.spec(), x.device)
    pool.stage_rows(x.to(F32), program.input_ptr)
    execute(program, pool, [tuple(None if t is None else t.to(F32)
                                  for t in (w_gate, w_up, w_down))])
    return pool.fetch_rows(program.output_ptr, m, d).clone()


def decode_attention(q, k_ring, v_ring, seq_len, *, window: int,
                     block: int = 128, softcap: float | None = None):
    """One decode step over a ring KV cache, as the reference's
    ``ops.decode_attention``: q ``[q_heads, d]``, k/v ``[window, kv_heads,
    d]`` (or batched); ``block`` must divide ``window``, as the Pallas
    grid needs."""
    if window % block:
        raise ValueError("block must divide window")
    fn = ring_decode_attention if q.device.type == "cuda" \
        else ring_decode_attention_plain
    return fn(q, k_ring, v_ring, seq_len, window=window, block=block,
              softcap=softcap)


__all__ = ["decode_attention", "fused_mlp", "ref", "ring_cache_update",
           "segment_gemm"]
