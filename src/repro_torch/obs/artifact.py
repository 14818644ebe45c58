"""Serializable trace artifacts + their render/export surfaces.

Counterpart of :mod:`repro.obs.artifact`; the schema is the reference's,
so either package reads the other's traces.

A :class:`TraceArtifact` is the schema-versioned JSON form of one traced
execution (or of a purely static plan trace): geometry, per-(op) events
with byte/MAC/requant counters and optional measured wall times, the
pool-occupancy timeline, whole-program totals, and any compile-pipeline
spans that rode along.  Surfaces:

  * :meth:`save` / :meth:`load`     — JSON beside the plan artifact,
  * :meth:`to_chrome_trace`         — Chrome trace-event JSON (Perfetto:
    ring ops as complete events, pool occupancy as counter tracks,
    compile passes as a nested span track),
  * :meth:`ascii_timeline`          — terminal memory-map timeline,
  * :meth:`canonical`               — the trace with every wall-time
    field stripped (what determinism tests and golden files pin),
  * :func:`diff_traces`             — structural + wall comparison.
"""
from __future__ import annotations

import dataclasses
import json

TRACE_SCHEMA = "vmcu-trace/1"
_WALL_KEYS = ("wall_us",)


@dataclasses.dataclass
class TraceArtifact:
    schema: str
    net: str | None
    backend: str | None
    target: str | None
    geometry: dict
    events: list
    timeline: dict
    totals: dict
    spans: list = dataclasses.field(default_factory=list)

    # -- payload -----------------------------------------------------------
    def to_dict(self) -> dict:
        return {"schema": self.schema, "net": self.net,
                "backend": self.backend, "target": self.target,
                "geometry": dict(self.geometry),
                "events": [dict(e) for e in self.events],
                "timeline": self.timeline, "totals": dict(self.totals),
                "spans": list(self.spans)}

    def canonical(self) -> dict:
        """The payload with every wall-time field stripped — two traced
        runs of one plan are identical under this form, and it is what
        the golden file pins."""
        payload = self.to_dict()
        for key in _WALL_KEYS:
            payload["totals"].pop(key, None)
        payload["events"] = [
            {k: v for k, v in e.items() if k not in _WALL_KEYS}
            for e in payload["events"]]
        payload["spans"] = []      # pipeline spans are all wall time
        return payload

    @property
    def watermark_bytes(self) -> int:
        return self.timeline["watermark_bytes"]

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        return path

    @classmethod
    def load(cls, path: str) -> "TraceArtifact":
        with open(path) as f:
            payload = json.load(f)
        return cls.from_dict(payload, source=path)

    @classmethod
    def from_dict(cls, payload: dict, source: str = "<dict>"
                  ) -> "TraceArtifact":
        if payload.get("schema") != TRACE_SCHEMA:
            raise ValueError(
                f"{source}: trace schema {payload.get('schema')!r} != "
                f"supported {TRACE_SCHEMA!r}")
        return cls(schema=payload["schema"], net=payload.get("net"),
                   backend=payload.get("backend"),
                   target=payload.get("target"),
                   geometry=payload["geometry"],
                   events=payload["events"],
                   timeline=payload["timeline"],
                   totals=payload["totals"],
                   spans=payload.get("spans", []))

    # -- Chrome trace-event export ----------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON (open in Perfetto / chrome://tracing).

        Ring ops are ``ph:"X"`` complete events on pid 1; measured wall
        times set the timebase when present, otherwise schedule steps
        serve as pseudo-microseconds (the shape of the timeline is the
        schedule either way).  Pool occupancy (live segments, occupied
        span) rides as ``ph:"C"`` counter tracks; compile-pipeline spans
        (when the trace carries them) as a nested track on pid 2.
        """
        ev: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 1,
             "args": {"name": f"vmcu ring ({self.backend or 'static'})"}},
            {"ph": "M", "name": "process_name", "pid": 2, "tid": 1,
             "args": {"name": "vmcu compile pipeline"}},
        ]
        occ = {o["index"]: o for o in self.timeline["ops"]}
        ts = 0.0
        for e in self.events:
            dur = float(e.get("wall_us", max(e.get("steps", 1), 1)))
            args = {k: v for k, v in e.items() if k != "name"}
            ev.append({"ph": "X", "name": e["name"], "cat": "ring",
                       "pid": 1, "tid": 1, "ts": ts, "dur": dur,
                       "args": args})
            o = occ.get(e.get("index"))
            if o is not None:
                ev.append({"ph": "C", "name": "pool_live_segments",
                           "pid": 1, "tid": 1, "ts": ts,
                           "args": {"live": o["live_segs"]}})
                ev.append({"ph": "C", "name": "pool_span_segments",
                           "pid": 1, "tid": 1, "ts": ts,
                           "args": {"span": o["span_segs"]}})
            ts += dur

        def emit_span(s: dict, tid: int) -> None:
            ev.append({"ph": "X", "name": s["name"], "cat": "compile",
                       "pid": 2, "tid": tid,
                       "ts": s.get("start_s", 0.0) * 1e6,
                       "dur": s["seconds"] * 1e6,
                       "args": dict(s.get("attrs", {}))})
            for c in s.get("children", []):
                emit_span(c, tid)

        for s in self.spans:
            emit_span(s, 1)
        meta = {"net": self.net, "backend": self.backend,
                "target": self.target, "schema": self.schema}
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": meta}

    # -- ASCII memory-map timeline ----------------------------------------
    def ascii_timeline(self, width: int = 64) -> str:
        """Render the ring as one row per op: ``#`` the output interval
        being streamed, ``=`` live resident tensors, ``.`` free slots.
        Watermark line at the bottom (== the plan's pool_bytes)."""
        n = self.geometry["n_segments"]
        width = min(width, n)
        seg_bytes = self.timeline["seg_bytes"]
        names = {e.get("index"): e["name"] for e in self.events}
        lines = [f"ring memory map — {self.net or 'program'} "
                 f"({self.backend or 'static'}), {n} segments x "
                 f"{seg_bytes} B   # output  = live  . free"]
        for o in self.timeline["ops"]:
            slots = ["."] * n
            for ptr, segs in o["live"]:
                for s in range(ptr, ptr + segs):
                    slots[s % n] = "="
            for s in range(o["out_lo"], o["out_hi"]):
                slots[s % n] = "#"
            if n > width:                   # bucket; '#' > '=' > '.'
                chars = []
                for j in range(width):
                    lo, hi = j * n // width, max((j + 1) * n // width,
                                                 j * n // width + 1)
                    bucket = slots[lo:hi]
                    chars.append("#" if "#" in bucket
                                 else "=" if "=" in bucket else ".")
                row = "".join(chars)
            else:
                row = "".join(slots)
            name = names.get(o["index"], f"op[{o['index']}]")
            lines.append(f"op {o['index']:>3} {name:<14} |{row}| "
                         f"live {o['live_segs']:>6} "
                         f"span {o['span_segs']:>6}/{n}")
        wm = self.timeline["watermark_segments"]
        lines.append(f"watermark: {wm}/{self.geometry['pool_segments']} "
                     f"pool segments = {self.watermark_bytes} B "
                     f"(plan pool_bytes {self.geometry['pool_bytes']} B)")
        return "\n".join(lines)


def diff_traces(a: TraceArtifact, b: TraceArtifact) -> dict:
    """Compare two traces: ``structural`` lists every non-wall-time
    difference (geometry, counters, occupancy — empty iff the two runs
    executed the same plan the same way); ``wall`` lists per-op wall-time
    deltas where both sides measured one."""
    structural: list[str] = []

    def walk(pa, pb, path: str) -> None:
        if isinstance(pa, dict) and isinstance(pb, dict):
            for k in sorted(set(pa) | set(pb)):
                if k not in pa or k not in pb:
                    structural.append(f"{path}.{k}: only in "
                                      f"{'second' if k not in pa else 'first'}")
                else:
                    walk(pa[k], pb[k], f"{path}.{k}")
        elif isinstance(pa, list) and isinstance(pb, list):
            if len(pa) != len(pb):
                structural.append(f"{path}: length {len(pa)} != {len(pb)}")
            else:
                for i, (va, vb) in enumerate(zip(pa, pb)):
                    walk(va, vb, f"{path}[{i}]")
        elif pa != pb:
            structural.append(f"{path}: {pa!r} != {pb!r}")

    walk(a.canonical(), b.canonical(), "trace")

    wall: list[str] = []
    wa = {e.get("index"): e["wall_us"] for e in a.events if "wall_us" in e}
    wb = {e.get("index"): e["wall_us"] for e in b.events if "wall_us" in e}
    names = {e.get("index"): e["name"] for e in a.events}
    for i in sorted(set(wa) & set(wb)):
        d = wb[i] - wa[i]
        rel = d / wa[i] if wa[i] else 0.0
        wall.append(f"{names.get(i, i)}: {wa[i]:.1f}us -> {wb[i]:.1f}us "
                    f"({rel:+.0%})")
    return {"structural": structural, "wall": wall}
