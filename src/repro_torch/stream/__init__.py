"""Streaming inference: persistent temporal state on the segment ring —
counterpart of :mod:`repro.stream`.

  * :func:`to_streaming` / :func:`to_full` — graph conversion,
  * :class:`StreamSession` — the reset/step driver
    (``repro_torch.compile(..., streaming=True).stream()`` or
    ``repro_torch.load(artifact).stream()``).
"""
from .convert import to_full, to_streaming
from .session import StreamSession

__all__ = ["StreamSession", "to_full", "to_streaming"]
