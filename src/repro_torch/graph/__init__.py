"""Whole-network execution on the ring — counterpart of ``repro.graph``."""
