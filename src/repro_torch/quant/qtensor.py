"""Symmetric int8 quantization parameters.

Counterpart of :mod:`repro.quant.qtensor`: activations per-tensor
symmetric (``zero_point == 0``), weights per-output-channel.  Quantize
and dequantize compute in float64 on the tensor's own device, exactly as
the reference does in numpy: ``rint(x / scale)`` clipped to
``[-127, 127]``, and ``q * scale`` rounded once to float32.  (A float32
division would differ in the last bit.)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

QMIN, QMAX = -127, 127   # symmetric: -128 is never produced by quantize()


@dataclasses.dataclass(frozen=True)
class QParams:
    """Symmetric quantization parameters of one tensor.

    ``scale`` is a float for per-tensor params or a ``[c]`` array for
    per-channel (``axis`` names the channel axis of the tensor).
    ``zero_point`` is always 0 in this scheme."""

    scale: object
    axis: int | None = None
    zero_point: int = 0

    def _bcast(self, ndim: int, device) -> torch.Tensor:
        s = torch.as_tensor(np.asarray(self.scale, np.float64),
                            device=device)
        if self.axis is None:
            return s
        shape = [1] * ndim
        shape[self.axis] = -1
        return s.reshape(shape)


def quantize(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    """Float -> int8 (round-to-nearest-even, clamped to [-127, 127]), on
    ``x``'s device."""
    x = x.to(torch.float64)
    q = torch.round(x / qp._bcast(x.ndim, x.device))
    return q.clamp(QMIN, QMAX).to(torch.int8)


def dequantize(q: torch.Tensor, qp: QParams) -> torch.Tensor:
    """Int8 -> float32, on ``q``'s device."""
    q = q.to(torch.float64)
    return (q * qp._bcast(q.ndim, q.device)).to(torch.float32)
