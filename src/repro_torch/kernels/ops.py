"""Public kernel entry points (the port of ``repro.kernels.ops``: only
``decode_attention`` and ``ring_cache_update`` so far; ``segment_gemm``
and ``fused_mlp`` need the planner, which is not ported).

The device of the tensors picks the route: on a CUDA card the
hand-written kernel, on the CPU its plain version.
"""
from __future__ import annotations

from .ring_decode import (ring_cache_update, ring_decode_attention,
                          ring_decode_attention_plain)


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


__all__ = ["decode_attention", "ring_cache_update"]
