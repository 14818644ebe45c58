"""Row-granular access schedules for whole-network PoolOps.

The single-layer Eq.-(1) closed form covers GEMM; the conv/pool/residual
ops a whole DNN needs have richer read frontiers (halos, strided reads,
resampled rows, a residual source read late).  This module is the ONE
source of truth for those schedules: for each op kind it enumerates, per
execution step, which input *rows* (contiguous segment chunks) are read
and which output rows are written.  From that one description both

  * the planner derives the byte/segment frontiers fed to
    :func:`repro_torch.core.graph_planner.solve_stream_offset` (Eq. 2), and
  * the ``sim`` executor replays the exact read/free/write sequence in
    the :class:`repro_torch.core.pool.SegmentPool` clobber oracle,

so the solved offset and the certified schedule can never drift apart.

A "row" here is one contiguous chunk of pool segments: one image row
(``W * segs(C)`` segments) for conv kinds, one matrix/pixel row for
``add``, one image row in / one channel row out for ``pool_avg``.

The port's copy of :mod:`repro.core.rowsched`, which is plain Python
and numpy.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .graph_planner import solve_stream_offset

_INF = np.iinfo(np.int64).max // 4


def resample_src(p: int, n_in: int, n_out: int) -> int:
    """Nearest-grid row map for resampling adapters: monotone, exact
    ``p * s`` when ``n_in == s * n_out``."""
    return (p * n_in) // n_out


@dataclasses.dataclass(frozen=True)
class RowSchedule:
    """Per-step row access schedule of one op, at chunk granularity.

    ``reads[t]``/``writes[t]`` are input/output row indices touched at
    step ``t`` (reads happen before writes within a step, matching the
    kernels); ``aux_reads`` are rows of a second, non-chained source
    tensor (the residual operand of ``add``).  ``in_chunk``/``out_chunk``
    are the chunk sizes in pool segments.
    """

    steps: int
    in_rows: int
    out_rows: int
    in_chunk: int
    out_chunk: int
    reads: tuple[tuple[int, ...], ...]
    writes: tuple[tuple[int, ...], ...]
    aux_reads: tuple[tuple[int, ...], ...] | None = None
    aux_rows: int = 0
    aux_chunk: int = 0

    # -- derived frontiers -------------------------------------------------
    def last_read(self) -> np.ndarray:
        """Per input row: the last step that reads it (-1 if never read)."""
        lr = np.full(self.in_rows, -1, dtype=np.int64)
        counts = np.fromiter((len(rows) for rows in self.reads),
                             dtype=np.int64, count=self.steps)
        flat = [r for rows in self.reads for r in rows]
        if flat:
            steps = np.repeat(np.arange(self.steps, dtype=np.int64),
                              counts)
            np.maximum.at(lr, np.asarray(flat, dtype=np.int64), steps)
        return lr

    def needed_min(self, lr: np.ndarray | None = None) -> np.ndarray:
        """``needed_min[t]`` — lowest input row still read at step >= t
        (length steps + 1; trailing entry is +inf).  Pass a precomputed
        ``last_read()`` array to avoid recomputing it."""
        if lr is None:
            lr = self.last_read()
        per_t = np.full(self.steps, _INF, dtype=np.int64)
        rows = np.nonzero(lr >= 0)[0]
        np.minimum.at(per_t, lr[rows], rows)
        out = np.full(self.steps + 1, _INF, dtype=np.int64)
        out[: self.steps] = per_t
        return np.minimum.accumulate(out[::-1])[::-1]

    def frees(self) -> list[list[int]]:
        """Per step: input rows that die after that step's reads.

        A read row dies at its last read; a row skipped by the access
        pattern (strided convs) dies as soon as the read frontier passes
        it — exactly the Eq.-(2) lifetime model.
        """
        lr = self.last_read()
        nm = self.needed_min()
        dead: list[list[int]] = [[] for _ in range(self.steps)]
        for r in range(self.in_rows):
            if lr[r] >= 0:
                dead[lr[r]].append(r)
            else:
                # first step t with needed_min[t + 1] > r
                t = int(np.searchsorted(nm[1:], r, side="right"))
                dead[min(t, self.steps - 1)].append(r)
        return dead

    def read_start_segments(self) -> np.ndarray:
        # clamp the _INF sentinel (steps with no remaining reads) to
        # in_rows BEFORE scaling by in_chunk — the product overflows
        # int64 for in_chunk >= 5 otherwise
        nm = np.minimum(self.needed_min()[: self.steps], self.in_rows)
        return nm * self.in_chunk

    def write_end_segments(self) -> np.ndarray:
        hi = np.fromiter(((max(rows) + 1) if rows else 0
                          for rows in self.writes),
                         dtype=np.int64, count=self.steps)
        return np.maximum.accumulate(hi) * self.out_chunk

    def solve_delta(self) -> int:
        """Minimal segment offset ``b_In - b_Out`` for this schedule."""
        return solve_stream_offset(self.write_end_segments(),
                                   self.read_start_segments())

    # -- execution-granularity view ---------------------------------------
    def coalesced(self, block: int) -> "RowSchedule":
        """The block-granular view: ``block`` consecutive steps fused
        into one super-step — the schedule the blocked ring kernels
        execute (DESIGN.md §15).

        A super-step's reads/writes are the concatenation (order kept,
        duplicates kept) of its member steps', so every aggregate
        counter — total row reads, total row writes, rows freed — is
        invariant under coalescing; only the step axis changes.  The
        planner, sim oracle and static verifier keep replaying the
        fine-grained schedule (certificates stay byte-identical); this
        view exists to state and test the superblock-coalescing
        property: a certified plan's stores only land on segments
        already freed at that step, so hoisting a block's reads above
        its stores cannot read a clobbered row.
        """
        if block < 1:
            raise ValueError("block must be >= 1")
        if block == 1:
            return self

        def group(seq):
            return tuple(tuple(r for step in seq[i:i + block]
                               for r in step)
                         for i in range(0, len(seq), block))

        aux = None if self.aux_reads is None else group(self.aux_reads)
        return dataclasses.replace(
            self, steps=-(-self.steps // block), reads=group(self.reads),
            writes=group(self.writes), aux_reads=aux)


# ---------------------------------------------------------------------------
# Schedule builders, one per op kind.
#
# All builders are pure functions of scalar geometry returning a frozen
# RowSchedule, and nets repeat module shapes heavily — so they memoize.
# Planning, sim replay and static verification of the same op thereby
# share one schedule INSTANCE, not just one derivation.
# ---------------------------------------------------------------------------

_memo = functools.lru_cache(maxsize=1024)


@_memo
def conv_pw_schedule(h_in: int, h_out: int, in_chunk: int, out_chunk: int,
                     *, stride: int = 1, resample: bool = False
                     ) -> RowSchedule:
    """Pointwise conv: output image row ``p`` reads input image row
    ``p * stride`` (or the resampled source row)."""
    reads, writes = [], []
    for p in range(h_out):
        src = resample_src(p, h_in, h_out) if resample else p * stride
        reads.append((src,))
        writes.append((p,))
    return RowSchedule(steps=h_out, in_rows=h_in, out_rows=h_out,
                       in_chunk=in_chunk, out_chunk=out_chunk,
                       reads=tuple(reads), writes=tuple(writes))


@_memo
def conv_dw_schedule(h_in: int, h_out: int, in_chunk: int, out_chunk: int,
                     *, rs: int, stride: int = 1,
                     padding: str = "same") -> RowSchedule:
    """Depthwise RSxRS conv: output row ``p`` reads the clamped halo rows
    ``p*stride - pad .. p*stride - pad + rs - 1``."""
    pad = conv_k2d_pad(rs, padding)
    reads, writes = [], []
    for p in range(h_out):
        win = sorted({min(max(p * stride - pad + r, 0), h_in - 1)
                      for r in range(rs)
                      if 0 <= p * stride - pad + r < h_in})
        reads.append(tuple(win))
        writes.append((p,))
    return RowSchedule(steps=h_out, in_rows=h_in, out_rows=h_out,
                       in_chunk=in_chunk, out_chunk=out_chunk,
                       reads=tuple(reads), writes=tuple(writes))


def conv_k2d_pad(k: int, padding: str) -> int:
    """Low-side ROW padding of a k x k conv (the one definition the
    planner, executors and codegen share).

    Besides ``same`` / ``valid``, the partial-execution slicer uses two
    vertical-split modes: ``same_top`` (a top slice of a 'same' conv —
    keeps the top pad) and ``same_mid`` (an interior/bottom slice — the
    halo rows above are real data, so no top pad)."""
    if padding in ("same", "same_top"):
        return (k - 1) // 2
    if padding in ("valid", "same_mid"):
        return 0
    raise ValueError(f"unknown padding {padding!r} "
                     "(same/valid/same_top/same_mid)")


def conv_k2d_pad_w(k: int, padding: str) -> int:
    """Low-side COLUMN padding of a k x k conv.  The slicer splits rows
    only, so every 'same'-family mode keeps the full horizontal pad."""
    return 0 if padding == "valid" else (k - 1) // 2


def conv_k2d_out(h_in: int, k: int, stride: int, padding: str) -> int:
    """Output extent of a k x k conv along one spatial axis."""
    if padding == "same":
        return -(-h_in // stride)
    if padding == "same_top":
        return (h_in + (k - 1) // 2 - k) // stride + 1
    if padding == "same_mid":
        return (h_in - k) // stride + 1
    if h_in < k:
        raise ValueError(f"valid conv needs h_in >= k ({h_in} < {k})")
    return (h_in - k) // stride + 1


@_memo
def conv_k2d_schedule(h_in: int, h_out: int, in_chunk: int, out_chunk: int,
                      *, k: int, stride: int = 1,
                      padding: str = "same") -> RowSchedule:
    """General k x k spatial conv: output row ``p`` reads the input halo
    rows ``p*stride - pad .. p*stride - pad + k - 1`` (rows outside the
    image are padding and never read) — the k-row read frontier that
    widens the Eq.-(1) safe offset vs the pointwise case."""
    pad = conv_k2d_pad(k, padding)
    reads, writes = [], []
    for p in range(h_out):
        win = sorted({p * stride - pad + r for r in range(k)
                      if 0 <= p * stride - pad + r < h_in})
        reads.append(tuple(win))
        writes.append((p,))
    return RowSchedule(steps=h_out, in_rows=h_in, out_rows=h_out,
                       in_chunk=in_chunk, out_chunk=out_chunk,
                       reads=tuple(reads), writes=tuple(writes))


@_memo
def ib_fused_schedule(h: int, in_chunk: int, out_chunk: int, *, rs: int,
                      residual: bool) -> RowSchedule:
    """The Fig.-6 fused kernel's row schedule (``ring_inverted_bottleneck``):
    step 0 primes the PW1 halo rows ``0..pad``; each later step ``p``
    expands exactly one new input row ``clip(p + pad)``; residual modules
    re-read input row ``p`` at step ``p``."""
    pad = (rs - 1) // 2
    reads, writes = [], []
    for p in range(h):
        if p == 0:
            rows = {min(r, h - 1) for r in range(pad + 1)}
        else:
            rows = {min(max(p + pad, 0), h - 1)}
        if residual:
            rows.add(p)
        reads.append(tuple(sorted(rows)))
        writes.append((p,))
    return RowSchedule(steps=h, in_rows=h, out_rows=h,
                       in_chunk=in_chunk, out_chunk=out_chunk,
                       reads=tuple(reads), writes=tuple(writes))


@_memo
def add_schedule(rows: int, chunk: int, *, aux_chunk: int | None = None
                 ) -> RowSchedule:
    """Residual add: step ``t`` reads row ``t`` of the chained operand AND
    row ``t`` of the held residual source, then writes row ``t``."""
    idx = tuple((t,) for t in range(rows))
    return RowSchedule(steps=rows, in_rows=rows, out_rows=rows,
                       in_chunk=chunk, out_chunk=chunk,
                       reads=idx, writes=idx, aux_reads=idx,
                       aux_rows=rows,
                       aux_chunk=chunk if aux_chunk is None else aux_chunk)


@_memo
def avgpool_schedule(h: int, in_chunk: int, out_chunk: int) -> RowSchedule:
    """Global average pool: reads one image row per step, emits the single
    output row at the last step (after its read)."""
    reads = tuple((t,) for t in range(h))
    writes = tuple(() for _ in range(h - 1)) + ((0,),)
    return RowSchedule(steps=h, in_rows=h, out_rows=1,
                       in_chunk=in_chunk, out_chunk=out_chunk,
                       reads=reads, writes=writes)


@_memo
def conv_stream_schedule(hop: int, h_out: int, in_chunk: int,
                         out_chunk: int) -> RowSchedule:
    """Streaming temporal conv: step 0 consumes the whole ``hop``-row
    frame (shift-append into the ring-resident window state, which is
    tracked as a separate lifetime class, not as chained input); steps
    ``1..h_out`` then write one output row each from the window.  The
    frame is dead before any output write, so delta solves to the
    non-overlap minimum."""
    reads = (tuple(range(hop)),) + ((),) * h_out
    writes = ((),) + tuple((p,) for p in range(h_out))
    return RowSchedule(steps=1 + h_out, in_rows=hop, out_rows=h_out,
                       in_chunk=in_chunk, out_chunk=out_chunk,
                       reads=reads, writes=writes)


@_memo
def gru_cell_schedule(in_chunk: int, out_chunk: int) -> RowSchedule:
    """GRU cell: step 0 reads the single input row (plus the pool-resident
    hidden state, tracked separately); step 1 writes the new hidden row
    to the chained output."""
    return RowSchedule(steps=2, in_rows=1, out_rows=1,
                       in_chunk=in_chunk, out_chunk=out_chunk,
                       reads=((0,), ()), writes=((), (0,)))


@_memo
def gemm_fine_schedule(m: int, k_segs: int, n_segs: int) -> RowSchedule:
    """The paper's Fig.-4 fine-grained FC schedule at row granularity:
    step ``t = r * n_segs + n`` re-reads input row ``r`` (all ``k_segs``
    segments) and writes output segment ``t``; row ``r`` dies at its last
    read ``n == n_segs - 1`` — exactly the order ``run_program_sim``
    replays, so the static verifier shares one source of truth with it."""
    steps = m * n_segs
    reads = tuple((t // n_segs,) for t in range(steps))
    writes = tuple((t,) for t in range(steps))
    return RowSchedule(steps=steps, in_rows=m, out_rows=steps,
                       in_chunk=k_segs, out_chunk=1,
                       reads=reads, writes=writes)


@_memo
def rowwise_schedule(rows: int, d_segs: int) -> RowSchedule:
    """In-place per-row ops (``fused_mlp`` / ``elementwise``): step ``t``
    reads row ``t``, frees it, then writes row ``t`` at delta == 0."""
    idx = tuple((t,) for t in range(rows))
    return RowSchedule(steps=rows, in_rows=rows, out_rows=rows,
                       in_chunk=d_segs, out_chunk=d_segs,
                       reads=idx, writes=idx)


def schedule_for_op(op, seg_width: int, m_rows: int | None = None
                    ) -> RowSchedule:
    """Rebuild the row schedule of a planned :class:`PoolOp` (sim replay).

    ``m_rows`` supplies the program row count for the kinds whose row
    extent defaults to it (``gemm`` / ``fused_mlp`` / ``elementwise``
    with ``rows_in == 0``)."""
    from .vpool import segments_for

    ci = segments_for(op.d_in, seg_width)
    co = segments_for(op.d_out, seg_width)
    if op.kind == "gemm":
        m = op.rows_in or m_rows
        if m is None:
            raise ValueError("gemm schedule needs m_rows")
        return gemm_fine_schedule(m, ci, co)
    if op.kind in ("fused_mlp", "elementwise"):
        m = op.rows_in or m_rows
        if m is None:
            raise ValueError(f"{op.kind} schedule needs m_rows")
        return rowwise_schedule(m, ci)
    if op.kind == "conv_pw":
        return conv_pw_schedule(op.h_in, op.h_out, op.w_in * ci,
                                op.w_out * co, stride=op.stride,
                                resample=op.resample)
    if op.kind == "conv_dw":
        return conv_dw_schedule(op.h_in, op.h_out, op.w_in * ci,
                                op.w_out * co, rs=op.rs, stride=op.stride,
                                padding=op.padding)
    if op.kind == "conv_k2d":
        return conv_k2d_schedule(op.h_in, op.h_out, op.w_in * ci,
                                 op.w_out * co, k=op.rs, stride=op.stride,
                                 padding=op.padding)
    if op.kind == "ib_fused":
        return ib_fused_schedule(op.h_in, op.w_in * ci, op.w_out * co,
                                 rs=op.rs, residual=op.residual)
    if op.kind == "add":
        return add_schedule(op.rows_in, ci)
    if op.kind == "pool_avg":
        return avgpool_schedule(op.h_in, op.w_in * ci, co)
    if op.kind == "conv_stream":
        return conv_stream_schedule(op.hop, op.h_out, op.w_in * ci,
                                    op.w_out * co)
    if op.kind == "gru_cell":
        return gru_cell_schedule(ci, co)
    raise ValueError(f"no row schedule for op kind {op.kind!r}")
