"""Observability: ring telemetry, occupancy timelines, pipeline spans.

Counterpart of :mod:`repro.obs`.  Three layers:

  * :mod:`~repro_torch.obs.counters` / :mod:`~repro_torch.obs.timeline` —
    static per-op byte/MAC counters and the pool-occupancy timeline,
    derived from the same row schedules the planner and verifier share
    (trace totals equal the safety certificate's reads/writes
    bit-exactly),
  * :mod:`~repro_torch.obs.tracer` — :class:`RingTracer` measurement hooks
    in the executors (``execute(..., tracer=...)``: CUDA events on the
    card, the host clock on the CPU, pool counters in the sim oracle),
    zero-cost when absent,
  * :mod:`~repro_torch.obs.spans` — nested timed spans for the compile
    pipeline (and any other instrumented extent), no-ops without an
    installed collector.

``python -m repro_torch.obs.cli`` renders/exports the resulting
schema-versioned :class:`TraceArtifact`.
"""
from .artifact import TRACE_SCHEMA, TraceArtifact, diff_traces
from .counters import (OpCounters, op_counters, op_macs, op_requants,
                       program_totals)
from .spans import Span, SpanCollector, collect, set_attr, span
from .timeline import PoolTimeline, pool_timeline
from .tracer import RingTracer, build_trace

__all__ = [
    "TRACE_SCHEMA", "TraceArtifact", "diff_traces",
    "OpCounters", "op_counters", "op_macs", "op_requants",
    "program_totals",
    "Span", "SpanCollector", "collect", "set_attr", "span",
    "PoolTimeline", "pool_timeline",
    "RingTracer", "build_trace",
]
