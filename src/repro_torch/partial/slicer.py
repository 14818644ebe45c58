"""Slice selection — the partial-execution cost model.

Counterpart of :mod:`repro.partial.slicer`.

A fusion group whose interior tensors pin the ring can trade latency
for memory Pex/MCUNetV2-style: split the group's OUTPUT spatially into
``n`` row bands and run the producing conv chain once per band.  Each
run reads a halo-extended window of the group input (held in place on
the ring), stages the interior tensors in small per-position scratch
bands, and lands its output band at its final ring offset — boundary
rows of the interior tensors are recomputed by adjacent slices, which
is exactly the extra-MACs-for-bytes trade this module prices.

The module is pure geometry/arithmetic: :func:`chain_steps` extracts a
group's conv-chain geometry, :func:`slice_layout` back-propagates
halo-aware row windows through the chain (the same ``core.rowsched``
k x k frontier conventions the executors run), and :func:`pareto`
enumerates the feasible slice counts as a latency/memory frontier.
The actual ``PoolOp`` surgery lives in :mod:`repro_torch.partial.lower`.
"""
from __future__ import annotations

import dataclasses

from ..core.program import PoolOp, PoolProgram
from ..core.rowsched import conv_k2d_pad
from ..core.vpool import segments_for

#: Conv kinds a slice chain may contain (linear, spatially local ops).
CHAIN_KINDS = ("conv_pw", "conv_dw", "conv_k2d")


@dataclasses.dataclass(frozen=True)
class ChainStep:
    """Vertical geometry of one chain position (one conv op)."""

    kind: str
    k: int                    # kernel extent (1 for pointwise)
    stride: int
    pad: int                  # top halo of the ORIGINAL padding mode
    padding: str              # the original mode ("same"/"valid"/...)
    h_in: int
    h_out: int
    w_in: int
    w_out: int
    d_in: int
    d_out: int

    def in_window(self, oa: int, ob: int) -> tuple[int, int]:
        """Input rows needed for output rows ``[oa, ob)`` (clamped)."""
        lo = max(0, oa * self.stride - self.pad)
        hi = min(self.h_in, (ob - 1) * self.stride - self.pad + self.k)
        return lo, hi

    def local_padding(self, oa: int) -> str | None:
        """Padding mode of a slice starting at output row ``oa``.

        ``None`` marks an infeasible boundary: an interior slice whose
        window would need a PARTIAL top halo (0 < oa*s < pad) — no
        padding mode expresses that, so the slice count is discarded.
        """
        if oa == 0:
            return self.padding
        if oa * self.stride < self.pad:
            return None
        return "valid" if self.padding == "valid" else "same_mid"

    def row_macs(self) -> int:
        """MACs per output row (the recompute-overhead unit)."""
        taps = self.k * self.k
        if self.kind == "conv_pw":
            return self.w_out * self.d_in * self.d_out
        if self.kind == "conv_dw":
            return self.w_out * taps * self.d_out
        return self.w_out * taps * self.d_in * self.d_out


@dataclasses.dataclass(frozen=True)
class SliceWindows:
    """Row windows of ONE slice at ONE chain position."""

    in_lo: int                # input window [in_lo, in_hi) — rows of the
    in_hi: int                # position's input tensor
    out_lo: int               # output band [out_lo, out_hi)
    out_hi: int
    padding: str              # local padding mode of the sliced op

    @property
    def h_in(self) -> int:
        return self.in_hi - self.in_lo

    @property
    def h_out(self) -> int:
        return self.out_hi - self.out_lo


@dataclasses.dataclass(frozen=True)
class SliceLayout:
    """A feasible slicing of one group chain into ``n_slices`` bands.

    ``windows[i][j]`` are slice ``i``'s row windows at chain position
    ``j``; ``band_rows[j]`` (``j >= 1``) is the scratch-band height for
    the interior tensor entering position ``j`` — the max over slices,
    since every slice reuses the same band.
    """

    steps: tuple[ChainStep, ...]
    n_slices: int
    windows: tuple[tuple[SliceWindows, ...], ...]
    band_rows: tuple[int, ...]       # len == len(steps); [0] unused (X)

    @property
    def extra_macs(self) -> int:
        """Recomputed MACs vs the unsliced chain (halo overlap cost)."""
        total = 0
        for j, st in enumerate(self.steps):
            rows = sum(w[j].h_out for w in self.windows)
            total += (rows - st.h_out) * st.row_macs()
        return total

    @property
    def chain_macs(self) -> int:
        return sum(st.h_out * st.row_macs() for st in self.steps)

    @property
    def extra_in_rows(self) -> tuple[int, ...]:
        """Per-position extra INPUT rows read (halo re-reads)."""
        return tuple(sum(w[j].h_in for w in self.windows) - st.h_in
                     for j, st in enumerate(self.steps))


def chain_steps(ops: tuple[PoolOp, ...]) -> tuple[ChainStep, ...]:
    """The vertical geometry of a conv chain (one group, add excluded)."""
    steps = []
    for op in ops:
        k = op.rs if op.kind in ("conv_dw", "conv_k2d") else 1
        pad = conv_k2d_pad(k, op.padding) if k > 1 else 0
        steps.append(ChainStep(
            kind=op.kind, k=k, stride=op.stride, pad=pad,
            padding=op.padding, h_in=op.h_in, h_out=op.h_out,
            w_in=op.w_in, w_out=op.w_out, d_in=op.d_in, d_out=op.d_out))
    return tuple(steps)


def even_bounds(h: int, n: int) -> tuple[int, ...]:
    """``n+1`` monotone band boundaries splitting ``h`` output rows."""
    return tuple(round(i * h / n) for i in range(n + 1))


def slice_layout(steps: tuple[ChainStep, ...],
                 n_slices: int) -> SliceLayout | None:
    """Back-propagate ``n_slices`` even output bands through the chain.

    Returns ``None`` when the split is infeasible: degenerate bands, or
    an interior boundary that would need a partial top halo at some
    position (``0 < oa*s < pad`` — no local padding mode covers it).
    """
    L = len(steps)
    h_last = steps[-1].h_out
    if not 2 <= n_slices <= h_last:
        return None
    bounds = even_bounds(h_last, n_slices)
    if any(bounds[i] >= bounds[i + 1] for i in range(n_slices)):
        return None
    slices = []
    for i in range(n_slices):
        oa, ob = bounds[i], bounds[i + 1]
        wins: list[SliceWindows] = []
        # walk the chain backward: position j's output band is position
        # j+1's input window
        for j in range(L - 1, -1, -1):
            st = steps[j]
            pad_mode = st.local_padding(oa)
            if pad_mode is None:
                return None
            ia, ib = st.in_window(oa, ob)
            wins.append(SliceWindows(ia, ib, oa, ob, pad_mode))
            oa, ob = ia, ib          # becomes position j-1's output band
        slices.append(tuple(reversed(wins)))
    band_rows = tuple(
        0 if j == 0 else max(w[j].h_in for w in slices)
        for j in range(L))
    return SliceLayout(steps=steps, n_slices=n_slices,
                       windows=tuple(slices), band_rows=band_rows)


# ---------------------------------------------------------------------------
# Sliceability + cost over a planned program.
# ---------------------------------------------------------------------------

def chain_range(program: PoolProgram, op_lo: int,
                op_hi: int) -> tuple[int, int] | str:
    """The sliceable conv chain ``[op_lo, hi)`` of group ``[op_lo,
    op_hi)``, or a reason string when the group cannot be sliced.

    A trailing residual ``add`` stays OUTSIDE the chain: it consumes
    the chain output plus the group input (which the slices then hold
    instead of freeing).  First/last groups are excluded — the program
    input is staged (not a ring record the slices could hold), and the
    network output is fetched whole.
    """
    ops = program.ops
    hi = op_hi
    if ops and ops[hi - 1].kind == "add" and hi - 1 > op_lo:
        hi -= 1
    if op_lo == 0:
        return "first group (program input is staged, not held)"
    if op_hi >= len(ops):
        return "last group (network output is fetched whole)"
    if hi - op_lo < 1:
        return "empty chain"
    for i in range(op_lo, hi):
        op = ops[i]
        if op.kind not in CHAIN_KINDS:
            return f"op {i} kind {op.kind!r} is not spatially local"
        if op.resample:
            return f"op {i} resamples (non-local row map)"
        if op.aux_op >= 0:
            return f"op {i} reads a residual source"
        if i > op_lo and (op.in_op >= 0 or op.hold_input):
            return f"op {i} branches off the linear chain"
    if ops[op_lo].in_op >= 0:
        return "group input is a held branch record"
    nxt = ops[hi]
    if nxt.in_op >= 0:
        return f"consumer op {hi} does not read the chain output"
    for i in range(hi, len(ops)):
        op = ops[i]
        for ref in (op.in_op, op.aux_op):
            if op_lo < ref < hi:
                return (f"op {i} holds interior tensor of op {ref} "
                        "across the group")
    return (op_lo, hi)


def chain_chunks(program: PoolProgram,
                 ops: tuple[PoolOp, ...]) -> tuple[tuple[int, int], ...]:
    """Per-position (in, out) row chunks in segments (one image row)."""
    sw = program.seg_width
    return tuple((op.w_in * segments_for(op.d_in, sw),
                  op.w_out * segments_for(op.d_out, sw)) for op in ops)


@dataclasses.dataclass(frozen=True)
class SliceCandidate:
    """One point of a group's latency/memory Pareto frontier."""

    op_lo: int
    op_hi: int                # chain end (residual add excluded)
    n_slices: int
    region_segments: int      # X + scratch bands + Y (tight estimate)
    extra_macs: int
    extra_read_segments: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def candidate(program: PoolProgram, op_lo: int, op_hi: int,
              n_slices: int) -> SliceCandidate | None:
    """Cost one (group, n_slices) point; ``None`` if infeasible.

    ``(op_lo, op_hi)`` may be the full GROUP range — the sliceable
    chain (trailing residual ``add`` excluded) is resolved here."""
    rng = chain_range(program, op_lo, op_hi)
    if isinstance(rng, str):
        return None
    op_lo, op_hi = rng
    ops = program.ops[op_lo:op_hi]
    steps = chain_steps(ops)
    layout = slice_layout(steps, n_slices)
    if layout is None:
        return None
    chunks = chain_chunks(program, ops)
    x_tot = steps[0].h_in * chunks[0][0]
    y_tot = steps[-1].h_out * chunks[-1][1]
    scratch = sum(layout.band_rows[j] * chunks[j][0]
                  for j in range(1, len(ops)))
    extra_reads = sum(r * chunks[j][0]
                      for j, r in enumerate(layout.extra_in_rows))
    return SliceCandidate(
        op_lo=op_lo, op_hi=op_hi, n_slices=n_slices,
        region_segments=x_tot + scratch + y_tot,
        extra_macs=layout.extra_macs,
        extra_read_segments=extra_reads)


def pareto(program: PoolProgram, op_lo: int, op_hi: int, *,
           max_slices: int | None = None) -> list[SliceCandidate]:
    """The group's feasible latency/memory frontier, by slice count.

    Dominated points (more slices AND no memory gain) are dropped —
    what remains is monotone: region shrinks as recompute grows.
    Accepts group or chain ranges (see :func:`candidate`).
    """
    rng = chain_range(program, op_lo, op_hi)
    if isinstance(rng, str):
        return []
    op_lo, op_hi = rng
    ops = program.ops[op_lo:op_hi]
    h_last = ops[-1].h_out
    cap = min(max_slices or h_last, h_last)
    frontier: list[SliceCandidate] = []
    best = None
    for n in range(2, cap + 1):
        c = candidate(program, op_lo, op_hi, n)
        if c is None:
            continue
        if best is None or c.region_segments < best:
            frontier.append(c)
            best = c.region_segments
    return frontier


def op_macs(op: PoolOp) -> int:
    """Whole-op MAC count (conv vocabulary; 0 for add/pool/plan-only)."""
    if op.kind in CHAIN_KINDS:
        k = op.rs if op.kind in ("conv_dw", "conv_k2d") else 1
        taps = k * k
        per_row = {"conv_pw": op.w_out * op.d_in * op.d_out,
                   "conv_dw": op.w_out * taps * op.d_out,
                   "conv_k2d": op.w_out * taps * op.d_in * op.d_out}
        return op.h_out * per_row[op.kind]
    if op.kind == "gemm":
        return (op.rows_in or 1) * op.d_in * op.d_out
    return 0


def program_macs(program: PoolProgram) -> int:
    return sum(op_macs(op) for op in program.ops)


def estimate_slices(program: PoolProgram, groups, sram_segments: int,
                    *, max_slices: int | None = None) -> int | None:
    """Cheapest total slice estimate that could bring every over-budget
    group region under ``sram_segments`` — the VMCU303 advisory number.

    ``groups`` is an iterable of ``(op_lo, op_hi)`` group ranges.
    Returns ``None`` when some pinning group cannot be sliced under the
    budget (partial execution cannot resolve the overflow).
    """
    total = 0
    for op_lo, op_hi in groups:
        span = max(op.span_segments
                   for op in program.ops[op_lo:op_hi])
        if span <= sram_segments:
            continue
        rng = chain_range(program, op_lo, op_hi)
        if isinstance(rng, str):
            return None
        lo, hi = rng
        fit = [c for c in pareto(program, lo, hi, max_slices=max_slices)
               if c.region_segments <= sram_segments]
        if not fit:
            return None
        total += min(fit, key=lambda c: c.n_slices).n_slices
    return total or None
