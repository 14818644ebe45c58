"""Static per-op traffic/compute counters — the metrics registry.

Counterpart of :mod:`repro.obs.counters`.

Every counter is derived from the SAME row schedules the planner solved
its offsets with and the verifier replays (``core.rowsched``), so the
schedule-level convention is shared with the safety certificate:

  * ``segs_read``    = read events x in_chunk + aux events x aux_chunk,
  * ``segs_written`` = write events x out_chunk,

and the program totals — with the input staging writes and the output
survival reads added (:func:`program_totals`) — equal the ``reads`` /
``writes`` fields of the static/sim certificate BIT-EXACTLY (asserted
in tests and in the ``python -m repro_torch.obs.cli --smoke`` gate).

MAC counts are nominal (zero-padding taps of spatial convs included,
matching the usual MACs-per-inference convention); requant counts are
requantize invocations at element granularity (``add`` rescales both
operands, so it counts twice its output elements) and are zero for
float programs.
"""
from __future__ import annotations

import dataclasses

from ..core.rowsched import schedule_for_op


@dataclasses.dataclass(frozen=True)
class OpCounters:
    """Schedule-derived traffic/compute counters of one PoolOp."""

    index: int
    kind: str
    steps: int
    segs_read: int
    segs_written: int
    bytes_loaded: int
    bytes_stored: int
    macs: int
    requants: int

    @property
    def bytes_moved(self) -> int:
        return self.bytes_loaded + self.bytes_stored

    @property
    def arithmetic_intensity(self) -> float:
        """MACs per byte moved through the ring (0 for pure-move ops)."""
        moved = self.bytes_moved
        return self.macs / moved if moved else 0.0

    def to_dict(self) -> dict:
        return {"index": self.index, "kind": self.kind,
                "steps": self.steps, "segs_read": self.segs_read,
                "segs_written": self.segs_written,
                "bytes_loaded": self.bytes_loaded,
                "bytes_stored": self.bytes_stored, "macs": self.macs,
                "requants": self.requants}


def op_macs(op, m_rows: int) -> int:
    """Nominal multiply-accumulates of one op (0 for move/reduce ops)."""
    rows = op.rows_in or m_rows
    if op.kind == "gemm":
        return rows * op.d_in * op.d_out
    if op.kind == "conv_pw":
        return op.h_out * op.w_out * op.d_in * op.d_out
    if op.kind == "conv_dw":
        return op.h_out * op.w_out * op.rs * op.rs * op.d_in
    if op.kind == "conv_k2d":
        return op.h_out * op.w_out * op.rs * op.rs * op.d_in * op.d_out
    if op.kind == "ib_fused":
        return op.h_in * op.w_in * (op.d_in * op.d_mid
                                    + op.rs * op.rs * op.d_mid
                                    + op.d_mid * op.d_out)
    if op.kind == "fused_mlp":
        return rows * op.d_in * op.d_ff * (3 if op.gated else 2)
    return 0   # add / pool_avg / elementwise: no MACs


def op_requants(op, m_rows: int, *, quantized: bool) -> int:
    """Requantize invocations (element granularity); 0 for float."""
    if not quantized:
        return 0
    rows_out = op.rows_out or m_rows
    if op.kind == "add":
        return 2 * (op.rows_in or m_rows) * op.d_in
    return rows_out * op.d_out


def op_counters(program) -> list[OpCounters]:
    """Per-op counters of a planned program (pure schedule arithmetic —
    nothing executes; memoized schedule builders make this O(ops))."""
    seg_bytes = program.seg_width * program.elem_bytes
    out = []
    for i, op in enumerate(program.ops):
        sched = schedule_for_op(op, program.seg_width,
                                m_rows=program.m_rows)
        n_read = sum(len(rows) for rows in sched.reads)
        n_aux = (sum(len(rows) for rows in sched.aux_reads)
                 if sched.aux_reads is not None else 0)
        segs_read = n_read * sched.in_chunk + n_aux * sched.aux_chunk
        segs_written = sum(len(rows) for rows in sched.writes) \
            * sched.out_chunk
        out.append(OpCounters(
            index=i, kind=op.kind, steps=sched.steps,
            segs_read=segs_read, segs_written=segs_written,
            bytes_loaded=segs_read * seg_bytes,
            bytes_stored=segs_written * seg_bytes,
            macs=op_macs(op, program.m_rows),
            requants=op_requants(op, program.m_rows,
                                 quantized=program.quantized)))
    return out


def stage_segments(program) -> int:
    """Segments written to stage the network input into the ring."""
    return program.ops[0].in_segments


def fetch_segments(program) -> int:
    """Segments read to fetch the surviving network output."""
    return program.ops[-1].out_segments


def program_totals(program, counters: list[OpCounters] | None = None
                   ) -> dict:
    """Whole-program totals in the certificate's counting convention:
    ``segs_read``/``segs_written`` (and their byte forms) include the
    input staging writes and the output survival reads, so they equal
    the verifier certificate's ``reads``/``writes`` bit-exactly."""
    if counters is None:
        counters = op_counters(program)
    seg_bytes = program.seg_width * program.elem_bytes
    stage, fetch = stage_segments(program), fetch_segments(program)
    segs_read = sum(c.segs_read for c in counters) + fetch
    segs_written = sum(c.segs_written for c in counters) + stage
    macs = sum(c.macs for c in counters)
    bytes_moved = (segs_read + segs_written) * seg_bytes
    return {
        "segs_read": segs_read,
        "segs_written": segs_written,
        "bytes_loaded": segs_read * seg_bytes,
        "bytes_stored": segs_written * seg_bytes,
        "macs": macs,
        "requants": sum(c.requants for c in counters),
        "arithmetic_intensity": macs / bytes_moved if bytes_moved else 0.0,
    }
