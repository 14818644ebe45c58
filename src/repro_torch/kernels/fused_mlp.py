"""The in-place fused MLP (the transformer analogue of paper Fig. 6):
CUDA wrapper and plain version.

Counterpart of :mod:`repro.kernels.fused_mlp`: over ``m_rows`` rows of
``d_model`` fp32 channels resident at ``ptr``, ``up = x @ W_up`` (and
``gate = x @ W_gate`` when gated), ``h = act(gate) * up`` or
``act(up)``, ``y = h @ W_down (+ x)``, stored over the rows it was read
from (delta 0).  The ``[m_rows, d_ff]`` intermediate never reaches the
ring: ``d_ff`` is walked in tiles.

:func:`ring_fused_mlp` takes the reference kernel's arguments and
raises ``ValueError`` on what its own kernel needs: ``ff_tile`` dividing
``d_ff`` (the op's accumulation order), and a run of rows that does not
wrap onto itself (``m_rows * segs(d_model) <= n_seg``).  Its kernel runs
one thread block per ``rows_per_block`` rows, so it does not demand the
reference's ``block_rows`` alignment of the pool or the pointer.  It
checks device, dtype, shape and contiguity and launches the
hand-written kernel of ``csrc/ring_f32.cu`` on the current CUDA stream
without synchronising; it never falls back to its plain version.  It
counts its launches in ``ring_fused_mlp.launches``, records its last
``(rows_per_block, tile)`` in ``ring_fused_mlp.tiles`` and, as every
weighted wrapper does, in ``.weights_staged`` where its weights were
read from (always global memory).  An ungated op's ``w_gate`` is never
read (the executor passes ``w_up`` in its place, as the reference
does).

:func:`ring_fused_mlp_plain` is the port of the reference's jnp
executor op (``mlp_ring_scan``): gather every row, accumulate over the
``ff_tile`` tiles of ``d_ff`` in order, store.  :func:`fused_mlp_ref`
is the port of ``repro.kernels.ref.fused_mlp_ref``, the pool-free oracle
``reference_forward`` runs.
"""
from __future__ import annotations

import torch

from ..core.program import ACTIVATIONS, resolve_activation
from ..core.vpool import fetch_rows, segments_for, stage_rows
from ._launch import MAX_SMEM, check_cuda, launch
from .segment_matmul import F32, act_code

#: Rows one thread of the kernel computes (``MLP_RPT`` in ``ring_f32.cu``);
#: ``rows_per_block`` is a multiple of it.
ROWS_PER_THREAD = 8
#: The shared memory the wrapper sizes a block for: two blocks per SM.
SMEM_TARGET = MAX_SMEM // 2


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def mlp_smem(rows_per_block: int, d_model: int, tile: int) -> int:
    """Shared memory of one block: x ``[rows, d_model]`` and the h tile
    ``[rows, tile]`` (rows padded to 4 floats) and the fp32 accumulator
    ``[rows, d_model]``."""
    return 4 * rows_per_block * (_round4(d_model) + _round4(tile) + d_model)


def mlp_tiles(m_rows: int, d_model: int, ff_tile: int) -> tuple[int, int]:
    """``(rows_per_block, tile)`` of a launch: 16 rows (fewer when the op
    has fewer) and the op's ``ff_tile``, then 8 rows, then halved tiles,
    until a block fits :data:`SMEM_TARGET` (82 KB at whisper-tiny's
    width, 16 rows; 90 KB at gemma3-1b's d_model 1152, 8 rows)."""
    rpt = ROWS_PER_THREAD
    rows = min(2 * rpt, -(-m_rows // rpt) * rpt)
    tile = ff_tile
    while mlp_smem(rows, d_model, tile) > SMEM_TARGET and tile > 4:
        if rows > rpt:
            rows = rpt
        else:
            tile = -(-tile // 2)
    return rows, tile


def _check(n_seg: int, m_rows: int, d_model: int, d_ff: int,
           ff_tile: int) -> None:
    if m_rows < 1 or d_model < 1:
        raise ValueError("a fused MLP needs m_rows >= 1 and d_model >= 1")
    if ff_tile < 1 or d_ff % ff_tile:
        raise ValueError("ff_tile | d_ff required")
    if m_rows * segments_for(d_model) > n_seg:
        raise ValueError(f"{m_rows} rows of {segments_for(d_model)} "
                         f"segments do not fit a ring of {n_seg}: the "
                         "rows would wrap onto themselves")


def _mlp_act(activation: str):
    """The reference kernel's activation: gelu (tanh form) for "gelu",
    silu for anything else."""
    return ACTIVATIONS["gelu" if activation == "gelu" else "silu"]


def fused_mlp_ref(x, w_gate, w_up, w_down, *, gated: bool = True,
                  residual: bool = True, activation: str = "gelu"):
    """Oracle: ``act(x @ W_gate) * (x @ W_up)`` (or ``act(x @ W_up)``)
    ``@ W_down (+ x)`` in fp32, in x's dtype (the reference's
    ``fused_mlp_ref``)."""
    act = _mlp_act(activation)
    xf = x.to(F32)
    up = xf @ w_up.to(F32)
    h = act(xf @ w_gate.to(F32)) * up if gated else act(up)
    y = h @ w_down.to(F32)
    if residual:
        y = y + xf
    return y.to(x.dtype)


def ring_fused_mlp(pool, w_gate, w_up, w_down, *, m_rows: int,
                   d_model: int, ptr: int, block_rows: int = 8,
                   ff_tile: int = 512, gated: bool = True,
                   residual: bool = True, activation: str = "gelu"):
    """In-place fused MLP over the ``m_rows`` rows at ``ptr`` (replaces
    ``ring_fused_mlp``, ``src/repro/kernels/fused_mlp.py:97``);
    ``block_rows`` is the plan's and goes unused."""
    n_seg = pool.shape[0]
    d_ff = w_up.shape[1]
    _check(n_seg, m_rows, d_model, d_ff, ff_tile)
    check_cuda(pool, (("w_gate", w_gate, F32, (d_model, d_ff)),
                      ("w_up", w_up, F32, (d_model, d_ff)),
                      ("w_down", w_down, F32, (d_ff, d_model))), dtype=F32)
    rows, tile = mlp_tiles(m_rows, d_model, ff_tile)
    launch("ring_fused_mlp", pool, mlp_smem(rows, d_model, tile),
           (w_gate, w_up, w_down),
           (n_seg, m_rows, d_model, d_ff, ptr % n_seg, int(gated),
            int(residual), act_code(activation), rows, tile))
    ring_fused_mlp.tiles = (rows, tile)
    ring_fused_mlp.weights_staged = False     # global memory, by design
    ring_fused_mlp.launches += 1
    return pool


def ring_fused_mlp_plain(pool, w_gate, w_up, w_down, *, m_rows: int,
                         d_model: int, ptr: int, block_rows: int = 8,
                         ff_tile: int = 512, gated: bool = True,
                         residual: bool = True, activation: str = "gelu"):
    """Plain version of :func:`ring_fused_mlp` (``mlp_ring_scan``): every
    row read, the ``d_ff`` tiles accumulated in order, every row
    stored."""
    d_ff = w_up.shape[1]
    _check(pool.shape[0], m_rows, d_model, d_ff, ff_tile)
    act = resolve_activation(activation)
    x = fetch_rows(pool, ptr, m_rows, d_model).to(F32)
    acc = torch.zeros((m_rows, d_model), dtype=F32, device=pool.device)
    for f0 in range(0, d_ff, ff_tile):
        sl = slice(f0, f0 + ff_tile)
        up = x @ w_up[:, sl].to(F32)
        h = act(x @ w_gate[:, sl].to(F32)) * up if gated else act(up)
        acc = acc + h @ w_down[sl].to(F32)
    stage_rows(pool, acc + x if residual else acc, ptr)
    return pool


KERNELS = {"ring_fused_mlp": ring_fused_mlp}
PLAIN = {"ring_fused_mlp": ring_fused_mlp_plain}

ring_fused_mlp.launches = 0
ring_fused_mlp.weights_staged = None
ring_fused_mlp.tiles = None
