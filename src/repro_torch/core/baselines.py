"""Tensor-level memory-management baselines the paper compares against.

* TinyEngine-style: in-place overlap ONLY when the whole tensors may legally
  alias (depthwise / elementwise); otherwise disjoint input+output buffers.
* HMCOS/Serenity-style: execution-order scheduling only, never in-place; for
  the linear-structure layers evaluated here scheduling buys nothing, so the
  footprint is always input + output (+ workspace).

Both are deliberately simple — the paper's point is precisely that these
policies leave partial overlap on the table for FC / non-depthwise conv.

The port's copy of :mod:`repro.core.baselines`, which is plain Python
and numpy.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """A single layer at byte granularity."""

    name: str
    in_bytes: int
    out_bytes: int
    inplace_legal: bool = False  # depthwise / elementwise
    workspace_bytes: int = 0     # e.g. im2col buffers


def tinyengine_bytes(layer: LayerShape) -> int:
    if layer.inplace_legal:
        return max(layer.in_bytes, layer.out_bytes) + layer.workspace_bytes
    return layer.in_bytes + layer.out_bytes + layer.workspace_bytes


def hmcos_bytes(layer: LayerShape) -> int:
    return layer.in_bytes + layer.out_bytes + layer.workspace_bytes


def pointwise_conv_layer(h: int, c: int, k: int, *, elem_bytes: int = 1,
                         im2col: bool = False) -> LayerShape:
    """Pointwise conv as evaluated in paper Fig. 7 (H/W, C, K named cases).
    TinyEngine runs im2col even for 1x1 convs (paper §7.2) — modeled as a
    one-row patch workspace when ``im2col`` is set."""
    ws = c * elem_bytes * h if im2col else 0
    return LayerShape(
        name=f"H/W{h},C{c},K{k}",
        in_bytes=h * h * c * elem_bytes,
        out_bytes=h * h * k * elem_bytes,
        inplace_legal=False,
        workspace_bytes=ws,
    )


# The nine single-layer cases of paper Fig. 7/8.
FIG7_CASES = [
    (80, 16, 16),
    (40, 32, 32),
    (20, 64, 64),
    (20, 64, 32),
    (20, 32, 64),
    (10, 128, 128),
    (10, 128, 64),
    (10, 64, 128),
    (5, 256, 256),
]
