"""Telemetry of the port: timed spans (``spans``).  The tracer, counters,
timeline and the rest of the reference's ``repro.obs`` are not ported."""
