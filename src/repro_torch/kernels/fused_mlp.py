"""The in-place fused MLP (the transformer analogue of paper Fig. 6):
CUDA wrapper and plain version.

Counterpart of :mod:`repro.kernels.fused_mlp`: over ``m_rows`` rows of
``d_model`` fp32 channels resident at ``ptr``, ``up = x @ W_up`` (and
``gate = x @ W_gate`` when gated), ``h = act(gate) * up`` or
``act(up)``, ``y = h @ W_down (+ x)``, stored over the rows it was read
from (delta 0).  The ``[m_rows, d_ff]`` intermediate never reaches the
ring: ``d_ff`` is walked in tiles.

:func:`ring_fused_mlp` takes the reference kernel's arguments and
raises ``ValueError`` on what its own kernels need: ``ff_tile`` dividing
``d_ff`` (the op's accumulation order), and a run of rows that does not
wrap onto itself (``m_rows * segs(d_model) <= n_seg``).  Its kernels do
not demand the reference's ``block_rows`` alignment of the pool or the
pointer.  It runs two kernels of ``csrc/ring_f32.cu`` on the current
CUDA stream without synchronising: the first, one CTA per (block of
rows, sub-tile of an ff tile) of :func:`mlp_tiling`, writes each
sub-tile's partial ``h @ W_down[sub-tile]`` into a scratch tensor the
wrapper allocates (``[n_sub, m_rows, segs(d_model) * 128]`` fp32) and
stores nothing into the pool; the second sums each row's partials in
order, adds the residual and stores the rows.  No whole row of x or of
the sum is held in shared memory, so ``d_model`` has no bound there.
It never falls back to its plain version.  It counts one launch per
call in ``ring_fused_mlp.launches``, records its last
:class:`MlpTiling` in ``ring_fused_mlp.tiles`` and, as every weighted
wrapper does, in ``.weights_staged`` whether its weights were staged
whole (never: they stream through shared memory in k-chunks).  An
ungated op's ``w_gate`` is never read (the executor passes ``w_up`` in
its place, as the reference does).

:func:`ring_fused_mlp_plain` is the port of the reference's jnp
executor op (``mlp_ring_scan``): gather every row, accumulate over the
``ff_tile`` tiles of ``d_ff`` in order, store.  :func:`fused_mlp_ref`
is the port of ``repro.kernels.ref.fused_mlp_ref``, the pool-free oracle
``reference_forward`` runs.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..core.program import ACTIVATIONS, resolve_activation
from ..core.vpool import SEG_WIDTH, fetch_rows, segments_for, stage_rows
from ._launch import MAX_SMEM, check_cuda, launch
from .conv2d import H100_SMS, _sm_count
from .segment_matmul import F32, act_code

#: A phase-1 CTA's k-chunk depth, its output block width and its k-chunks
#: in flight (``MLP_BK``, ``MLP_BN``, ``MLP_STAGES`` in ``ring_f32.cu``):
#: 16 x 16 threads, each TM rows x 8 columns of a [16 TM, 128] block.
MLP_BK, MLP_BN, MLP_STAGES = 32, 128, 2
#: Rows per thread (the kernel's template instances) and sub-tiles per ff
#: tile the tiling may take.
MLP_TM = range(1, 9)
MLP_SPLITS = range(1, 9)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def mlp_smem(tm: int, sub: int) -> int:
    """Bytes of a phase-1 CTA's shared memory (``mlp_smem_layout``): h
    ``[16 tm, round_up(sub, 32) + 4]``, two x chunks ``[16 tm, 36]`` and
    two weight chunks ``[32, 128]``; no term grows with d_model."""
    bm = 16 * tm
    return 4 * (bm * (_round_up(sub, MLP_BK) + 4)
                + MLP_STAGES * (bm * (MLP_BK + 4) + MLP_BK * MLP_BN))


@dataclasses.dataclass(frozen=True)
class MlpTiling:
    """How :func:`ring_fused_mlp` cuts an op: d_ff into its ``ff_tile``
    tiles and each tile into ``splits`` sub-tiles of ``sub`` columns (the
    last one shorter); the rows into blocks of ``rows = 16 * tm``.  CTA
    ``i`` of the first kernel owns (row block ``i // n_sub``, sub-tile ``i
    % n_sub``) and writes that sub-tile's partial of its rows into
    scratch plane ``i % n_sub`` (``scratch_bytes`` in all)."""

    m_rows: int
    d_model: int
    d_ff: int
    ff_tile: int
    tm: int
    sub: int
    splits: int

    @property
    def rows(self) -> int:
        return 16 * self.tm

    @property
    def n_sub(self) -> int:
        return self.d_ff // self.ff_tile * self.splits

    @property
    def ctas(self) -> int:
        return -(-self.m_rows // self.rows) * self.n_sub

    @property
    def smem(self) -> int:
        return mlp_smem(self.tm, self.sub)

    @property
    def scratch_shape(self) -> tuple[int, int, int]:
        return (self.n_sub, self.m_rows,
                segments_for(self.d_model) * SEG_WIDTH)

    @property
    def scratch_bytes(self) -> int:
        return 4 * math.prod(self.scratch_shape)

    @property
    def vec(self) -> bool:
        """Whether every weight chunk row starts 16-byte aligned (the
        kernel's 16-byte copies; else 4-byte ones)."""
        return not (self.d_model % 4 or self.d_ff % 4 or self.ff_tile % 4)

    def subtile(self, s: int) -> tuple[int, int]:
        """Sub-tile ``s``'s columns of d_ff, ``(f0, width)``."""
        tile, j = divmod(s, self.splits)
        f0 = tile * self.ff_tile + j * self.sub
        return f0, min(self.sub, (tile + 1) * self.ff_tile - f0)

    def tile(self, i: int) -> tuple[int, int, int, int]:
        """CTA ``i``'s ``(r0, n, f0, width)``: rows ``r0 .. r0 + n - 1``
        and d_ff columns ``f0 .. f0 + width - 1``."""
        rb, s = divmod(i, self.n_sub)
        r0 = rb * self.rows
        return (r0, min(self.rows, self.m_rows - r0), *self.subtile(s))


#: An SM's FMAs in the time the card moves one byte of device memory
#: (128 FMA lanes at about 1.75 GHz against 3.35 TB/s over 132 SMs),
#: to weigh the scratch traffic against the products.
FMA_PER_BYTE = 128 * 1.75e9 / 3.35e12


def _mlp_cost(t: MlpTiling, gated: bool, n_sm: int) -> float:
    """The busiest SM's work in FMAs: its CTAs (``ceil(ctas / n_sm)``)
    times a CTA's FMAs as the kernel runs them (16 tm rows, 128-column
    passes of the up products, whole 128-column blocks of the down
    product) over the FMA share of its issue slots (per 4 depths: 8 tm
    FMAs beside tm / 4 + 2 shared-memory loads and about 3 more); plus the
    scratch written and read back, at the device memory's rate."""
    ftp = _round_up(t.sub, MLP_BK)
    up = _round_up(t.d_model, MLP_BK) * _round_up(ftp, MLP_BN) \
        * (2 if gated else 1)
    down = ftp * _round_up(t.d_model, MLP_BN)
    share = 8 * t.tm / (8 * t.tm + t.tm / 4 + 3)
    return -(-t.ctas // n_sm) * t.rows * (up + down) / share \
        + 2 * t.scratch_bytes * FMA_PER_BYTE


@functools.lru_cache(maxsize=1024)
def mlp_tiling(m_rows: int, d_model: int, d_ff: int, ff_tile: int,
               gated: bool = False, n_sm: int = H100_SMS) -> MlpTiling:
    """The tiling of a ``ring_fused_mlp`` call on ``n_sm`` SMs: among the
    row blocks of 16 to 128 rows and the splits of each ff tile into 1 to
    8 sub-tiles (of a multiple of 4 columns, none empty) whose CTA fits
    ``MAX_SMEM``, the one of least :func:`_mlp_cost` (the busiest SM's
    FMAs), ties to fewer CTAs.  Shared memory grows with the rows and the
    sub-tile, never with d_model."""
    best = None
    for splits in MLP_SPLITS:
        sub = _round_up(-(-ff_tile // splits), 4)
        if (splits - 1) * sub >= ff_tile:
            continue
        for tm in MLP_TM:
            t = MlpTiling(m_rows, d_model, d_ff, ff_tile, tm, sub, splits)
            if t.smem > MAX_SMEM:
                continue
            key = (_mlp_cost(t, gated, n_sm), t.ctas)
            if best is None or key < best[0]:
                best = key, t
    if best is None:
        raise ValueError(f"ring_fused_mlp: no tiling of ff_tile {ff_tile} "
                         f"fits {MAX_SMEM} B of shared memory")
    return best[1]


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
    t = mlp_tiling(m_rows, d_model, d_ff, ff_tile, gated,
                   _sm_count(pool.device))
    scratch = torch.empty(t.scratch_shape, dtype=F32, device=pool.device)
    launch("ring_fused_mlp", pool, t.smem, (w_gate, w_up, w_down, scratch),
           (n_seg, m_rows, d_model, d_ff, ptr % n_seg, int(gated),
            int(residual), act_code(activation), ff_tile, t.tm, t.sub,
            t.splits, int(t.vec)))
    ring_fused_mlp.tiles = t
    ring_fused_mlp.weights_staged = False     # streamed in k-chunks
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
