"""Roofline arithmetic of the ring (counterpart of :mod:`repro.roofline`).

Only the ring half is ported: :func:`~repro_torch.roofline.analysis.
ring_traffic_summary` reads a :class:`repro_torch.obs.TraceArtifact`.
"""
from .analysis import MCU_PEAK_MACS, MCU_SRAM_BW, ring_traffic_summary

__all__ = ["MCU_PEAK_MACS", "MCU_SRAM_BW", "ring_traffic_summary"]
