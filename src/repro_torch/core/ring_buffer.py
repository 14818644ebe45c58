"""The legacy FC-chain API over one ring pool (the port of
``repro.core.ring_buffer``), thin adapters over the PoolProgram model.

``ChainPlan``/``plan_chain`` delegate planning to :func:`plan_program`
(``block_rows=None``: the exact, unaligned Eq.-(1) geometry);
``write_rows``/``read_rows`` are the one stage/fetch of
:mod:`repro_torch.core.vpool`; ``ring_chain_apply`` runs each layer in
the pool, in place: on a CUDA card through the hand-written
``ring_gemm`` kernel (which takes the 128-wide segments of the port's
kernels and the reference's alignment, and raises otherwise), on the
CPU through the coalesced gather, product and scatter of the
reference's ``gemm_ring_scan``.  New code uses ``plan_program`` and
``execute`` directly.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.segment_matmul import ring_gemm
from .program import GemmSpec, plan_program, resolve_activation
from .vpool import SEG_WIDTH, fetch_rows as _fetch_rows, segments_for
from .vpool import stage_rows as _stage_rows

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """Static plan for an FC chain ``d0 -> d1 -> ... -> dL`` over M rows:
    ``plan_program(m_rows, dims[0], [GemmSpec(d) for d in dims[1:]],
    seg_width=seg_width, block_rows=None)``."""

    m_rows: int
    dims: tuple[int, ...]
    seg_width: int
    n_segments: int
    # per layer: (in_ptr, out_ptr) segment offsets (virtual, pre-modulo)
    layer_ptrs: tuple[tuple[int, int], ...]

    @property
    def pool_bytes(self) -> int:  # fp32 pool
        return self.n_segments * self.seg_width * 4

    @property
    def naive_bytes(self) -> int:
        """Tensor-level chain: the worst adjacent in + out pair lives at
        once."""
        per = [self.m_rows * segments_for(d, self.seg_width)
               for d in self.dims]
        worst = max(per[i] + per[i + 1] for i in range(len(per) - 1))
        return worst * self.seg_width * 4


def plan_chain(m_rows: int, dims: list[int],
               seg_width: int = SEG_WIDTH) -> ChainPlan:
    """Solve Eq. (1) per layer and chain the pointers: layer i's output
    pointer sits ``delta_i`` segments below its input pointer; the next
    layer consumes it in place."""
    prog = plan_program(m_rows, dims[0], [GemmSpec(d) for d in dims[1:]],
                        seg_width=seg_width, block_rows=None)
    shift = prog.ops[0].in_ptr  # program pointers are shifted >= 0
    ptrs = tuple((op.in_ptr - shift, op.out_ptr - shift) for op in prog.ops)
    return ChainPlan(m_rows=m_rows, dims=tuple(dims), seg_width=seg_width,
                     n_segments=prog.n_segments, layer_ptrs=ptrs)


def write_rows(pool, rows, ptr: int, n_segments: int):
    """:func:`repro_torch.core.vpool.stage_rows` (in place)."""
    return _stage_rows(pool, rows, ptr, n_segments)


def read_rows(pool, ptr: int, m: int, d: int, n_segments: int):
    """:func:`repro_torch.core.vpool.fetch_rows`."""
    return _fetch_rows(pool, ptr, m, d, n_segments)


def init_chain_params(gen: torch.Generator, dims: list[int],
                      dtype=F32) -> list[tuple]:
    """Per layer ``(w [d_in, d_out] ~ N(0, 1) / sqrt(d_in), b = 0)``,
    drawn from ``gen`` on its device."""
    params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                        dtype=dtype) / math.sqrt(d_in)
        params.append((w, torch.zeros((d_out,), dtype=dtype,
                                      device=gen.device)))
    return params


def _gemm_ring_scan(pool, w, b, *, in_ptr: int, out_ptr: int, m_rows: int,
                    n_segments: int, activation):
    """One layer on the CPU: gather every input row, ``act(x @ w + b)``
    in fp32, scatter (the reference's ``gemm_ring_scan``)."""
    x = _fetch_rows(pool, in_ptr, m_rows, w.shape[0], n_segments).to(F32)
    y = resolve_activation(activation)(x @ w.to(F32) + b.to(F32))
    return _stage_rows(pool, y, out_ptr, n_segments)


def ring_chain_apply(pool, params, plan: ChainPlan, block_rows: int = 1):
    """Run the whole planned chain inside ``pool`` (``[n_segments,
    seg_width]`` fp32), in place; returns it.  Every layer but the last
    applies gelu."""
    if plan.m_rows % block_rows:
        raise ValueError("block_rows must divide m_rows")
    base = plan.layer_ptrs[-1][1]  # most negative pointer; shift all >= 0
    n_layers = len(params)
    for i, ((w, b), (in_ptr, out_ptr)) in enumerate(
            zip(params, plan.layer_ptrs)):
        act = None if i == n_layers - 1 else "gelu"
        kw = dict(in_ptr=in_ptr - base, out_ptr=out_ptr - base,
                  m_rows=plan.m_rows)
        if pool.device.type == "cuda":
            if plan.seg_width != SEG_WIDTH:
                raise ValueError(f"ring_gemm takes {SEG_WIDTH}-wide "
                                 f"segments, not {plan.seg_width}")
            ring_gemm(pool, w, b, d_in=w.shape[0], d_out=w.shape[1],
                      block_rows=block_rows, activation=act, **kw)
        else:
            _gemm_ring_scan(pool, w, b, n_segments=plan.n_segments,
                            activation=act, **kw)
    return pool


def naive_chain_apply(x, params):
    """Tensor-level reference: every intermediate fully materialized."""
    for i, (w, b) in enumerate(params):
        x = x @ w.to(x.dtype) + b.to(x.dtype)
        if i != len(params) - 1:
            x = resolve_activation("gelu")(x)
    return x


def run_chain_via_ring(x, params, plan: ChainPlan, block_rows: int = 1):
    """Stage ``x`` into a fresh pool on its device, run, read out."""
    base = plan.layer_ptrs[-1][1]
    pool = torch.zeros((plan.n_segments, plan.seg_width), dtype=x.dtype,
                       device=x.device)
    write_rows(pool, x, plan.layer_ptrs[0][0] - base, plan.n_segments)
    ring_chain_apply(pool, params, plan, block_rows)
    return read_rows(pool, plan.layer_ptrs[-1][1] - base, plan.m_rows,
                     plan.dims[-1], plan.n_segments).clone()
