"""Atomic, async checkpoints interchangeable with the reference's (the
port of ``repro.checkpoint``)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
