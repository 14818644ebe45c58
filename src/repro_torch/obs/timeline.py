"""Pool-occupancy timeline: memory-over-time from the solved plan.

Counterpart of :mod:`repro.obs.timeline`.

Replays the SAME live-record model the static verifier proves safety
with (one record per live tensor: the held network input, every op's
surviving output, residual sources until their consuming ``add``) and
derives, per op:

  * the output interval being streamed into the ring,
  * every record live while the op runs (its input included — frees
    happen as the op's read frontier passes, so the input is live at
    the op's start),
  * ``span_segs`` — the extent of the occupied window (output interval
    union live records, unwrapped pointers).

The timeline's watermark is ``max(span_segs)`` — for a solved plan this
equals ``program.pool_segments`` exactly (the ring is tight: some op's
occupied window spans the whole allocation), so ``watermark_bytes ==
program.pool_bytes`` is an invariant tests and the CLI smoke gate
assert.  Per-tensor residency intervals (born/died op indices) fall out
of the same replay.  Pure arithmetic on memoized schedules — deriving a
timeline costs nothing beyond the planning the program already paid.
"""
from __future__ import annotations

import dataclasses

from ..core.rowsched import schedule_for_op


@dataclasses.dataclass(frozen=True)
class Residency:
    """Lifetime of one pool-resident tensor.

    ``tensor`` 0 is the staged network input; tensor ``i`` is the output
    of op ``i - 1``.  ``born`` is the op index that produced it (-1 for
    the staged input); ``died`` is the op index whose execution freed it
    (``n_ops`` for tensors surviving the whole program)."""

    tensor: int
    ptr: int
    segments: int
    born: int
    died: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class OpOccupancy:
    """Ring occupancy while one op executes."""

    index: int
    out_lo: int                       # unwrapped output interval
    out_hi: int
    live: tuple                       # ((ptr, segments), ...) records
    live_segs: int                    # resident segments at op start
    span_segs: int                    # extent of the occupied window

    def to_dict(self) -> dict:
        return {"index": self.index, "out_lo": self.out_lo,
                "out_hi": self.out_hi,
                "live": [list(rec) for rec in self.live],
                "live_segs": self.live_segs,
                "span_segs": self.span_segs}


@dataclasses.dataclass(frozen=True)
class PoolTimeline:
    n_segments: int
    pool_segments: int
    seg_bytes: int
    ops: tuple
    residencies: tuple

    @property
    def watermark_segments(self) -> int:
        return max(o.span_segs for o in self.ops)

    @property
    def watermark_bytes(self) -> int:
        return self.watermark_segments * self.seg_bytes

    def live_curve(self) -> list[int]:
        """Resident segments at the start of each op (length n_ops)."""
        return [o.live_segs for o in self.ops]

    def to_dict(self) -> dict:
        return {"n_segments": self.n_segments,
                "pool_segments": self.pool_segments,
                "seg_bytes": self.seg_bytes,
                "watermark_segments": self.watermark_segments,
                "watermark_bytes": self.watermark_bytes,
                "ops": [o.to_dict() for o in self.ops],
                "residencies": [r.to_dict() for r in self.residencies]}


def pool_timeline(program) -> PoolTimeline:
    """Derive the occupancy timeline of a planned program (no execution).

    The record update rule mirrors the verifier's replay exactly: an
    op's input record (or, for branch ops, the held record of op
    ``in_op``) dies with the op unless ``hold_input``; the residual
    source dies at its consuming ``add``; the op's output becomes record
    ``i + 1``.
    """
    first = program.ops[0]
    seg_bytes = program.seg_width * program.elem_bytes

    records: dict[int, tuple[int, int, int]] = {
        0: (first.in_ptr, first.in_segments, -1)}   # (ptr, segs, born)
    occupancies: list[OpOccupancy] = []
    residencies: list[Residency] = []

    def _kill(tensor: int, died: int) -> None:
        ptr, segs, born = records.pop(tensor)
        residencies.append(Residency(tensor=tensor, ptr=ptr,
                                     segments=segs, born=born, died=died))

    for i, op in enumerate(program.ops):
        sched = schedule_for_op(op, program.seg_width,
                                m_rows=program.m_rows)
        out_tot = sum(len(rows) for rows in sched.writes) \
            * sched.out_chunk
        iown = op.in_op if op.in_op >= 0 else i
        live = tuple((ptr, segs) for ptr, segs, _ in records.values())
        lo = min([op.out_ptr] + [p for p, _ in live])
        hi = max([op.out_ptr + out_tot] + [p + s for p, s in live])
        occupancies.append(OpOccupancy(
            index=i, out_lo=op.out_ptr, out_hi=op.out_ptr + out_tot,
            live=live, live_segs=sum(s for _, s in live),
            span_segs=hi - lo))
        if not op.hold_input and iown in records:
            _kill(iown, i)
        if op.aux_op >= 0 and op.aux_op in records:
            _kill(op.aux_op, i)
        records[i + 1] = (op.out_ptr, out_tot, i)

    n_ops = len(program.ops)
    for tensor in sorted(records):
        _kill(tensor, n_ops)
    residencies.sort(key=lambda r: r.tensor)
    return PoolTimeline(n_segments=program.n_segments,
                        pool_segments=program.pool_segments,
                        seg_bytes=seg_bytes, ops=tuple(occupancies),
                        residencies=tuple(residencies))
