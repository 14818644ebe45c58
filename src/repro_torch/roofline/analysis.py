"""MCU ring roofline — fed by measured TraceArtifacts, not cost models.

Counterpart of the ring half of :mod:`repro.roofline.analysis`
(``ring_traffic_summary`` and its machine balance).  The constants
describe the modelled Cortex-M4 the plans target, not the card the port
runs on.
"""
from __future__ import annotations

MCU_PEAK_MACS = 80e6      # Cortex-M4 @ 80 MHz, ~1 MAC/cycle sustained
MCU_SRAM_BW = 320e6       # bytes/s: one 32-bit SRAM access per cycle


def ring_traffic_summary(trace, *, peak_macs_per_s: float = MCU_PEAK_MACS,
                         sram_bw_bytes_per_s: float = MCU_SRAM_BW) -> dict:
    """Per-op-kind roofline terms from one ring trace's MEASURED traffic.

    ``trace`` is a :class:`repro_torch.obs.TraceArtifact` (or its payload
    dict) — the byte counters in it come from the executed/verified
    schedule, so this replaces the closed-form traffic models the
    energy-proxy figures previously trusted.  Each kind gets its summed
    ``bytes_moved`` / ``macs``, arithmetic intensity, the two roofline
    times at the given machine balance, and the binding term.
    """
    payload = trace if isinstance(trace, dict) else trace.to_dict()
    kinds: dict[str, dict] = {}
    for e in payload["events"]:
        k = e.get("kind")
        if k is None:
            continue
        rec = kinds.setdefault(k, {"n_ops": 0, "bytes_loaded": 0,
                                   "bytes_stored": 0, "macs": 0})
        rec["n_ops"] += 1
        rec["bytes_loaded"] += e.get("bytes_loaded", 0)
        rec["bytes_stored"] += e.get("bytes_stored", 0)
        rec["macs"] += e.get("macs", 0)
    for rec in kinds.values():
        moved = rec["bytes_loaded"] + rec["bytes_stored"]
        rec["bytes_moved"] = moved
        rec["arithmetic_intensity"] = rec["macs"] / moved if moved else 0.0
        rec["t_compute_s"] = rec["macs"] / peak_macs_per_s
        rec["t_memory_s"] = moved / sram_bw_bytes_per_s
        rec["bound"] = ("compute" if rec["t_compute_s"] >= rec["t_memory_s"]
                        else "memory")
    totals = payload["totals"]
    moved = totals["bytes_loaded"] + totals["bytes_stored"]
    ridge = peak_macs_per_s / sram_bw_bytes_per_s  # machine balance
    intensity = totals["macs"] / moved if moved else 0.0
    return {
        "net": payload.get("net"),
        "backend": payload.get("backend"),
        "kinds": kinds,
        "bytes_moved": moved,
        "macs": totals["macs"],
        "arithmetic_intensity": intensity,
        "ridge_intensity": ridge,
        "bound": "compute" if intensity >= ridge else "memory",
        "t_compute_s": totals["macs"] / peak_macs_per_s,
        "t_memory_s": moved / sram_bw_bytes_per_s,
        "watermark_bytes": totals.get("watermark_bytes"),
    }
