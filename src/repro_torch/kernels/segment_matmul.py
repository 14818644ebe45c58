"""The fp32 ring GEMM (paper Fig. 4): CUDA wrapper and plain version.

Counterpart of :mod:`repro.kernels.segment_matmul`.  :func:`ring_gemm`
takes the reference kernel's arguments, raises its ``ValueError`` on a
misaligned pool or pointer, checks device, dtype, shape and contiguity,
and launches the hand-written kernel of ``csrc/ring_f32.cu`` on the
current CUDA stream without synchronising; it updates the pool in place
and returns it.  It never falls back to its plain version: it raises on
anything but CUDA tensors.  It counts its launches in
``ring_gemm.launches`` and records in ``ring_gemm.weights_staged``
whether its last launch staged the weights in shared memory.

:func:`ring_gemm_plain` is the port of the reference's jnp executor op
(``gemm_ring_scan``): gather every input row, ``act(x @ w + b)`` in
fp32, scatter.  It works on any device; the CPU path runs it and the
kernel is held against it.
"""
from __future__ import annotations

import math

import torch

from ..core.program import ACTIVATION_CODES, resolve_activation
from ..core.vpool import SEG_WIDTH, fetch_rows, segments_for, stage_rows
from ._launch import check_cuda, launch

F32 = torch.float32


def _segs(d: int) -> int:
    return segments_for(d, SEG_WIDTH)


def act_code(activation: str | None) -> int:
    """The fp32 CUDA epilogue's code of ``activation`` (None is the
    identity); an unknown name raises as the reference does."""
    resolve_activation(activation)
    return ACTIVATION_CODES[activation or "identity"]


def aligned_pool_geometry(m_rows: int, d_in: int, d_out: int,
                          delta_segments: int, block_rows: int
                          ) -> tuple[int, int, int]:
    """Round the planner's geometry to block alignment.

    Returns (n_segments, in_ptr, out_ptr) with in_ptr % bk == 0,
    out_ptr % bn == 0, n_segments % lcm(bk, bn) == 0 and
    in_ptr - out_ptr >= delta_segments.
    """
    k_segs, n_segs = _segs(d_in), _segs(d_out)
    bk, bn = block_rows * k_segs, block_rows * n_segs
    out_ptr = 0
    # smallest bk-multiple >= delta (shifting In UP is always safe)
    in_ptr = -(-delta_segments // bk) * bk
    span = max(in_ptr + m_rows * k_segs, m_rows * n_segs)
    align = math.lcm(bk, bn)
    n_segments = -(-span // align) * align
    return n_segments, in_ptr, out_ptr


def check_gemm(n_seg, m_rows, d_in, d_out, in_ptr, out_ptr, block_rows):
    """The reference kernel's alignment checks."""
    bk, bn = block_rows * _segs(d_in), block_rows * _segs(d_out)
    if m_rows % block_rows:
        raise ValueError("block_rows must divide m_rows")
    if n_seg % math.lcm(bk, bn) or in_ptr % bk or out_ptr % bn:
        raise ValueError("pool/pointers not block-aligned; use "
                         "aligned_pool_geometry()")


def ring_gemm(pool, w, b, *, m_rows: int, d_in: int, d_out: int,
              in_ptr: int, out_ptr: int, block_rows: int = 8,
              activation: str | None = None):
    """``Out[m_rows, d_out] = act(In[m_rows, d_in] @ w + b)`` inside the
    fp32 ring, ``block_rows`` rows per step (replaces ``ring_gemm``,
    ``src/repro/kernels/segment_matmul.py:117``)."""
    n_seg = pool.shape[0]
    check_gemm(n_seg, m_rows, d_in, d_out, in_ptr, out_ptr, block_rows)
    check_cuda(pool, (("w", w, F32, (d_in, d_out)), ("b", b, F32, (d_out,))),
               dtype=F32)
    ring_gemm.weights_staged = launch(
        "ring_gemm", pool, 4 * (block_rows * d_in + d_out), (w, b),
        (n_seg, m_rows, d_in, d_out, block_rows, in_ptr % n_seg,
         out_ptr % n_seg, act_code(activation)), w_bytes=4 * d_in * d_out)
    ring_gemm.launches += 1
    return pool


def ring_gemm_plain(pool, w, b, *, m_rows: int, d_in: int, d_out: int,
                    in_ptr: int, out_ptr: int, block_rows: int = 8,
                    activation: str | None = None):
    """Plain version of :func:`ring_gemm` (``gemm_ring_scan``)."""
    check_gemm(pool.shape[0], m_rows, d_in, d_out, in_ptr, out_ptr,
               block_rows)
    act = resolve_activation(activation)
    x = fetch_rows(pool, in_ptr, m_rows, d_in).to(F32)
    y = act(x @ w.to(F32) + b.to(F32))
    stage_rows(pool, y, out_ptr)
    return pool


KERNELS = {"ring_gemm": ring_gemm}
PLAIN = {"ring_gemm": ring_gemm_plain}

ring_gemm.launches = 0
ring_gemm.weights_staged = None
