"""Nested timed spans (the port of ``repro.obs.spans``: ``span``,
``set_attr``, ``active`` and the collector they need).

A :class:`SpanCollector` is installed for a dynamic extent with
:func:`collect`; inside it, ``with span(name, **attrs):`` records a
nested span of wall seconds and ``set_attr(**attrs)`` annotates the
innermost open one.  With no collector installed, :func:`span` is a
no-op context manager and :func:`set_attr` returns at once, so spans can
stay in hot paths such as the serving engine's decode loop and the
scheduler's search.  PyTorch returns before the card finishes,
so a caller that times device work synchronises inside the span when
:func:`active` says a collector is listening (the serving engine calls
``torch.cuda.synchronize()`` where the reference calls
``jax.block_until_ready``).

The collector is a :mod:`contextvars` variable, so concurrent callers
(threads, async) each see their own span tree.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from typing import Any, Iterator

_ACTIVE: contextvars.ContextVar["SpanCollector | None"] = \
    contextvars.ContextVar("repro_torch_span_collector", default=None)


@dataclasses.dataclass
class Span:
    """One timed region: wall seconds, free-form attributes, children."""

    name: str
    seconds: float = 0.0
    start_s: float = 0.0       # offset from the collector's epoch
    attrs: dict = dataclasses.field(default_factory=dict)
    children: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {"name": self.name, "seconds": self.seconds,
                "start_s": self.start_s, "attrs": dict(self.attrs),
                "children": [c.to_dict() for c in self.children]}


class SpanCollector:
    """Accumulates a forest of spans for one instrumented extent."""

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self._stack: list[Span] = []
        self._epoch = time.perf_counter()

    def to_dicts(self) -> list[dict]:
        return [s.to_dict() for s in self.spans]


@contextlib.contextmanager
def collect(collector: SpanCollector | None = None
            ) -> Iterator[SpanCollector]:
    """Install a collector for the enclosed extent (a fresh one when not
    given)."""
    col = collector if collector is not None else SpanCollector()
    token = _ACTIVE.set(col)
    try:
        yield col
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[Span | None]:
    """Record a timed span when a collector is active; no-op otherwise."""
    col = _ACTIVE.get()
    if col is None:
        yield None
        return
    s = Span(name=name, attrs=dict(attrs))
    s.start_s = time.perf_counter() - col._epoch
    parent = col._stack[-1] if col._stack else None
    (parent.children if parent is not None else col.spans).append(s)
    col._stack.append(s)
    t0 = time.perf_counter()
    try:
        yield s
    finally:
        s.seconds = time.perf_counter() - t0
        col._stack.pop()


def active() -> bool:
    """True iff a collector is installed (for cheap guard checks)."""
    return _ACTIVE.get() is not None


def set_attr(**attrs: Any) -> None:
    """Annotate the innermost open span (no-op without a collector)."""
    col = _ACTIVE.get()
    if col is not None and col._stack:
        col._stack[-1].attrs.update(attrs)
