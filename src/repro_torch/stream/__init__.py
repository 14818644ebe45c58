"""Streaming inference: persistent temporal state on the segment ring —
counterpart of :mod:`repro.stream`.

  * :class:`StreamSession` — the reset/step driver
    (``repro_torch.load(artifact).stream()``).

The graph conversion (``to_streaming``/``to_full``) comes with the
compile pipeline, in a later slice.
"""
from .session import StreamSession

__all__ = ["StreamSession"]
