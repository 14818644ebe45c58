"""The fp32 ring GEMM (paper Fig. 4): CUDA wrapper and plain version.

Counterpart of :mod:`repro.kernels.segment_matmul`.  :func:`ring_gemm`
takes the reference kernel's arguments, raises its ``ValueError`` on a
misaligned pool or pointer, checks device, dtype, shape and contiguity,
and launches the hand-written kernel of ``csrc/ring_f32.cu`` on the
current CUDA stream without synchronising; it updates the pool in place
and returns it.  It never falls back to its plain version: it raises on
anything but CUDA tensors.  It counts its launches in
``ring_gemm.launches``.

The kernel is one cooperative launch over the CTAs of
:func:`gemm_tiling` (blocks of rows x tiles of output columns, at most
one CTA per SM): each CTA stages its rows and its weight slice, computes
its outputs into shared memory, meets one grid-wide barrier, and only
then stores, so an op in place (every ToyADMOS layer but the last) reads
the pool from before the op, as the reference's sequential walk does.
Each output sums its inputs in slices of :data:`GEMM_KSLICE` (an FMA
chain each), then the partials in order: within the fp32 tolerance of
the plain version, and where ``d_in <= GEMM_KSLICE`` one chain in k
order, the sum of the one-block walk it replaced.
``block_rows`` is the reference's argument and is checked as the
reference checks it; it shapes nothing.  Every CTA stages its weight
slice, so ``ring_gemm.weights_staged`` is always True.

:func:`ring_gemm_plain` is the port of the reference's jnp executor op
(``gemm_ring_scan``): gather every input row, ``act(x @ w + b)`` in
fp32, scatter.  It works on any device; the CPU path runs it and the
kernel is held against it.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..core.program import ACTIVATION_CODES, resolve_activation
from ..core.vpool import SEG_WIDTH, fetch_rows, segments_for, stage_rows
from ._launch import H100_SMS, MAX_SMEM, _sm_count, check_cuda, launch

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


#: Output-column tiles a gemm CTA may take, narrowest first (a smaller
#: ``d_out`` is one tile): 8 fp32 columns are one 32-byte sector of a
#: weight row, the least a narrower tile would still read.
GEMM_COLUMN_TILES = (8, 16, 32, 64, 128, 256, 512, 1024)


#: Inputs one FMA chain of the kernel sums (``GEMM_KSLICE``): a wider
#: ``d_in`` is summed in slices of this many, their partials in order.
GEMM_KSLICE = 32


def gemm_smem(rows: int, ctile: int, d_in: int) -> int:
    """Bytes of a gemm CTA's shared memory (``gemm_smem_layout``): its
    rows ``[rows, xp]``, its weight slice transposed ``[ctile, wp]``, its
    bias ``[ctile]``, its outputs' k-slice partials ``[kslices, rows,
    ctile]`` and its outputs ``[rows, ctile]``; ``xp`` is ``d_in``
    rounded up to 4, ``wp`` to 32, plus 4 (no bank conflicts)."""
    xp, wp = -(-d_in // 4) * 4, -(-d_in // 32) * 32 + 4
    kslices = -(-d_in // GEMM_KSLICE)
    return 4 * (rows * xp + ctile * wp + ctile
                + (kslices + 1) * rows * ctile)


@dataclasses.dataclass(frozen=True)
class GemmTiling:
    """How :func:`ring_gemm` cuts an op of ``m_rows`` rows, ``d_in`` ->
    ``d_out``: CTA ``i`` owns ``rows`` rows (fewer in the last row block)
    x ``ctile`` output columns (fewer in the last column tile), column
    tiles fastest; ``ctas`` is at most the SM count, so all of them are
    resident at once.  ``smem`` is one CTA's shared memory in bytes,
    ``held`` the bytes of outputs it keeps across the grid barrier."""

    m_rows: int
    d_in: int
    d_out: int
    rows: int
    ctile: int

    @property
    def col_tiles(self) -> int:
        return -(-self.d_out // self.ctile)

    @property
    def ctas(self) -> int:
        return -(-self.m_rows // self.rows) * self.col_tiles

    @property
    def smem(self) -> int:
        return gemm_smem(self.rows, self.ctile, self.d_in)

    @property
    def held(self) -> int:
        return 4 * self.rows * self.ctile

    def tile(self, i: int) -> tuple[int, int, int, int]:
        """CTA ``i``'s ``(r0, nr, c0, cn)``: rows ``r0 .. r0 + nr - 1``,
        output columns ``c0 .. c0 + cn - 1`` (the kernel's own split)."""
        rb, cb = divmod(i, self.col_tiles)
        r0, c0 = rb * self.rows, cb * self.ctile
        return (r0, min(self.rows, self.m_rows - r0), c0,
                min(self.ctile, self.d_out - c0))


@functools.lru_cache(maxsize=4096)
def gemm_tiling(m_rows: int, d_in: int, d_out: int,
                n_sm: int = H100_SMS) -> GemmTiling:
    """The tiling of a ``ring_gemm`` call over at most ``n_sm`` CTAs.

    The narrowest column tile of :data:`GEMM_COLUMN_TILES` whose tiles
    fit ``n_sm``, with the fewest rows per block that keep the CTAs
    within ``n_sm``, whose CTA fits ``MAX_SMEM``: the weights (each read
    by one CTA per row block) spread over as many SMs as their 32-byte
    sectors allow, so a 1-row 640 -> 128 layer runs 16 CTAs of 20 KB of
    weights each, and a 64 -> 12 head 2.  Raises ``ValueError``, naming
    the op's shape, when no tile fits."""
    for ctile in sorted({min(d_out, t) for t in GEMM_COLUMN_TILES}):
        col_tiles = -(-d_out // ctile)
        if col_tiles > n_sm:
            continue
        rows = -(-m_rows // (n_sm // col_tiles))
        if gemm_smem(rows, ctile, d_in) <= MAX_SMEM:
            return GemmTiling(m_rows, d_in, d_out, rows, ctile)
    raise ValueError(
        f"ring_gemm: no tile of the op [{m_rows}, {d_in}] -> [{m_rows}, "
        f"{d_out}] fits {MAX_SMEM} B of shared memory over at most {n_sm} "
        "CTAs")


def ring_gemm(pool, w, b, *, m_rows: int, d_in: int, d_out: int,
              in_ptr: int, out_ptr: int, block_rows: int = 8,
              activation: str | None = None):
    """``Out[m_rows, d_out] = act(In[m_rows, d_in] @ w + b)`` inside the
    fp32 ring (replaces ``ring_gemm``,
    ``src/repro/kernels/segment_matmul.py:117``); ``block_rows`` is
    checked as the reference does and shapes nothing: the kernel runs the
    tiles of :func:`gemm_tiling`."""
    n_seg = pool.shape[0]
    check_gemm(n_seg, m_rows, d_in, d_out, in_ptr, out_ptr, block_rows)
    check_cuda(pool, (("w", w, F32, (d_in, d_out)), ("b", b, F32, (d_out,))),
               dtype=F32)
    t = gemm_tiling(m_rows, d_in, d_out, _sm_count(pool.device))
    launch("ring_gemm", pool, t.smem, (w, b),
           (n_seg, m_rows, d_in, d_out, in_ptr % n_seg, out_ptr % n_seg,
            act_code(activation), t.rows, t.ctile))
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
ring_gemm.weights_staged = True
