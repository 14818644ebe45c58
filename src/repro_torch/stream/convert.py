"""Feed-forward <-> streaming graph conversion.

A registered image/audio net consumes one whole ``h x w`` input window
per invocation.  :func:`to_streaming` rewrites it for per-frame
operation: the stem conv that consumes the graph input becomes a
``conv_stream`` node whose ``h_win``-row sliding window lives in the
segment ring as persistent state, and the graph input shrinks to the
``hop`` new rows arriving each step.  Everything downstream is
untouched — the stream step emits the SAME full-window stem output, so
once the window has filled (``h_win`` frames, zero-padded before that,
matching the reference conv's zero padding) every step reproduces the
one-shot net on the current window EXACTLY (bitwise for int8).

:func:`to_full` is the inverse, used by the equivalence tests to build
the one-shot twin of a streaming net over the same parameters.

The port's copy of :mod:`repro.stream.convert`, which is plain Python
and numpy.
"""
from __future__ import annotations

import dataclasses

from ..graph.ir import Graph, Tensor


def _single_stem(graph: Graph) -> tuple[str, str]:
    """The graph input id and its single conv consumer (the stem)."""
    in_id = graph.input_id()
    consumers = graph.consumers(in_id)
    if len(consumers) != 1:
        raise ValueError(
            f"streaming conversion needs exactly one consumer of the "
            f"graph input, {graph.name!r} has {len(consumers)}")
    return in_id, consumers[0]


def to_streaming(graph: Graph, *, hop: int = 1) -> Graph:
    """Convert a feed-forward net to per-frame streaming form.

    The stem must be a ``conv_k2d`` reading the graph input directly;
    its input height becomes the persistent window (``h_win``) and the
    new graph input is the ``hop`` rows appended per step."""
    in_id, stem_id = _single_stem(graph)
    stem = graph.nodes[stem_id]
    if stem.kind == "conv_stream":
        return graph          # already streaming
    if stem.kind != "conv_k2d":
        raise ValueError(
            f"streaming conversion needs a conv_k2d stem, "
            f"{stem_id!r} is {stem.kind!r}")
    tin = graph.nodes[in_id].out
    if not 0 < hop < tin.h:
        raise ValueError(f"hop must be in (0, {tin.h}), got {hop}")

    name = graph.name if graph.name.endswith("-stream") \
        else graph.name + "-stream"
    out = Graph(name, elem_bytes=graph.elem_bytes)
    out.modules = dict(graph.modules)
    frame = Tensor(rows=hop * tin.w, d=tin.d, h=hop, w=tin.w,
                   elem_bytes=tin.elem_bytes)
    for n in graph.nodes.values():
        if n.id == in_id:
            out.add(n.id, "input", [], frame)
        elif n.id == stem_id:
            out.nodes[n.id] = dataclasses.replace(
                n, kind="conv_stream", h_win=tin.h, hop=hop)
        else:
            out.nodes[n.id] = n
    out.validate()
    return out


def to_full(graph: Graph) -> Graph:
    """Convert a streaming net back to its one-shot feed-forward twin
    (the net :func:`to_streaming` started from, op list aligned 1:1)."""
    streams = [n for n in graph.nodes.values() if n.kind == "conv_stream"]
    if len(streams) != 1:
        raise ValueError(f"{graph.name!r} has {len(streams)} conv_stream "
                         "nodes; to_full needs exactly one")
    stem = streams[0]
    in_id = stem.inputs[0]
    tin = graph.nodes[in_id].out
    if graph.nodes[in_id].kind != "input":
        raise ValueError("conv_stream must read the graph input")

    name = graph.name[:-len("-stream")] \
        if graph.name.endswith("-stream") else graph.name + "-full"
    out = Graph(name, elem_bytes=graph.elem_bytes)
    out.modules = dict(graph.modules)
    window = Tensor(rows=stem.h_win * tin.w, d=tin.d, h=stem.h_win,
                    w=tin.w, elem_bytes=tin.elem_bytes)
    for n in graph.nodes.values():
        if n.id == in_id:
            out.add(n.id, "input", [], window)
        elif n.id == stem.id:
            out.nodes[n.id] = dataclasses.replace(
                n, kind="conv_k2d", h_win=0, hop=0)
        else:
            out.nodes[n.id] = n
    out.validate()
    return out
