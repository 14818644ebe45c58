"""RingTracer — step-level measurement hooks for the executors.

Counterpart of :mod:`repro.obs.tracer`.  A :class:`RingTracer` is handed
to ``execute(..., tracer=...)`` (or ``CompiledNet.run(x, trace=True)``).
Executors call :meth:`record` with per-op wall seconds: on a CUDA pool
the time between two CUDA events recorded around the op's launch on the
current stream (read after one synchronize at the end of the program,
so it is device time, not dispatch time), on a CPU pool the host clock
around the op's plain version.  The ``sim`` backend additionally
snapshots the SegmentPool access counters around every op
(:meth:`record_sim`) — a *measured* read/write/free count that tests
assert equals the schedule-derived :mod:`counters` bit-exactly.

``tracer=None`` (the default) is the zero-cost path: no event is
recorded, nothing synchronizes, and the executors skip every tracer
call site.

:func:`build_trace` fuses the static counters/timeline with whatever a
tracer measured into one :class:`~repro_torch.obs.artifact.TraceArtifact`.
"""
from __future__ import annotations

import dataclasses

from .counters import (fetch_segments, op_counters, program_totals,
                       stage_segments)
from .timeline import pool_timeline


@dataclasses.dataclass
class RingTracer:
    """Mutable measurement sink for one traced execution."""

    backend: str | None = None
    wall_s: dict = dataclasses.field(default_factory=dict)
    sim_counts: dict = dataclasses.field(default_factory=dict)
    sim_summary: dict | None = None

    def record(self, op_index: int, seconds: float) -> None:
        self.wall_s[op_index] = seconds

    def record_sim(self, op_index: int, *, reads: int, writes: int,
                   frees: int, live: int) -> None:
        self.sim_counts[op_index] = {"reads": reads, "writes": writes,
                                     "frees": frees, "live": live}

    def finish_sim(self, sim) -> None:
        self.sim_summary = {"peak_live": sim.peak_live,
                            "reads": sim.reads, "writes": sim.writes,
                            "frees": sim.frees}


def build_trace(program, *, tracer: RingTracer | None = None,
                backend: str | None = None, net: str | None = None,
                target: str | None = None, spans: list | None = None):
    """Assemble a TraceArtifact for ``program``.

    Works with no tracer at all (a purely static trace: schedule-derived
    counters + occupancy timeline, no wall times) — that is what the
    plan-only surfaces (``python -m repro_torch.obs.cli`` on an artifact)
    use.
    """
    from .artifact import TRACE_SCHEMA, TraceArtifact

    counters = op_counters(program)
    timeline = pool_timeline(program)
    totals = program_totals(program, counters)
    totals["watermark_bytes"] = timeline.watermark_bytes

    seg_bytes = program.seg_width * program.elem_bytes
    events: list[dict] = [{
        "name": "stage_input", "kind": "stage", "index": -1,
        "segs_read": 0, "segs_written": stage_segments(program),
        "bytes_loaded": 0,
        "bytes_stored": stage_segments(program) * seg_bytes,
    }]
    for c in counters:
        ev = c.to_dict()
        ev["name"] = f"{c.kind}[{c.index}]"
        if tracer is not None and c.index in tracer.wall_s:
            ev["wall_us"] = tracer.wall_s[c.index] * 1e6
        if tracer is not None and c.index in tracer.sim_counts:
            ev["sim"] = dict(tracer.sim_counts[c.index])
        events.append(ev)
    events.append({
        "name": "fetch_output", "kind": "fetch",
        "index": len(program.ops),
        "segs_read": fetch_segments(program), "segs_written": 0,
        "bytes_loaded": fetch_segments(program) * seg_bytes,
        "bytes_stored": 0,
    })

    if tracer is not None and tracer.wall_s:
        totals["wall_us"] = sum(tracer.wall_s.values()) * 1e6
    if tracer is not None and tracer.sim_summary is not None:
        totals["sim"] = dict(tracer.sim_summary)

    from ..compile.artifact import program_sha256

    geometry = {
        "n_ops": len(program.ops),
        "m_rows": program.m_rows,
        "seg_width": program.seg_width,
        "block_rows": program.block_rows,
        "n_segments": program.n_segments,
        "pool_segments": program.pool_segments,
        "elem_bytes": program.elem_bytes,
        "dtype": program.dtype,
        "pool_bytes": program.pool_bytes,
        "physical_pool_bytes": program.physical_pool_bytes,
        "program_sha256": program_sha256(program),
    }
    backend = backend or (tracer.backend if tracer is not None else None)
    return TraceArtifact(schema=TRACE_SCHEMA, net=net, backend=backend,
                         target=target, geometry=geometry, events=events,
                         timeline=timeline.to_dict(), totals=totals,
                         spans=list(spans) if spans else [])
