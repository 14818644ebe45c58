"""Symmetric int8 quantization parameters and calibration.

Counterpart of :mod:`repro.quant.qtensor`: activations per-tensor
symmetric (``zero_point == 0``), scale ``amax(|x|)/127``; weights
per-output-channel; biases int32 at the accumulator scale
``s_in * s_w[c]``.  Quantize and dequantize compute in float64 on the
tensor's own device, exactly as the reference does in numpy:
``rint(x / scale)`` clipped to ``[-127, 127]``, and ``q * scale``
rounded once to float32.  (A float32 division would differ in the last
bit.)  Calibration and the requant tables (:func:`calibrate`,
:func:`quantize_array`, :func:`quantize_bias`, :func:`requant_pair`,
:func:`requant_scalar`) are host-side float64 numpy, the reference's
own arithmetic, so given the same scales they give the same bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .requant import quantize_multiplier

QMIN, QMAX = -127, 127   # symmetric: -128 is never produced by quantize()
SCALE_FLOOR = 1e-8       # all-zero tensors/channels quantize at scale 1e-8


@dataclasses.dataclass(frozen=True)
class QParams:
    """Symmetric quantization parameters of one tensor.

    ``scale`` is a float for per-tensor params or a ``[c]`` array for
    per-channel (``axis`` names the channel axis of the tensor).
    ``zero_point`` is always 0 in this scheme."""

    scale: object
    axis: int | None = None
    zero_point: int = 0

    @property
    def per_channel(self) -> bool:
        return self.axis is not None

    def _bcast_np(self, ndim: int) -> np.ndarray:
        s = np.asarray(self.scale, np.float64)
        if self.axis is None:
            return s
        shape = [1] * ndim
        shape[self.axis] = -1
        return s.reshape(shape)

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


def _host(x) -> np.ndarray:
    """``x`` (a tensor on any device, an array or a scalar) as float64
    numpy on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def calibrate(x, axis: int | None = None) -> QParams:
    """Symmetric scale(s) from float data: ``amax(|x|) / 127``.

    ``axis=None`` gives one per-tensor scale; an integer gives one scale
    per slice of that axis (per-channel weights)."""
    x = _host(x)
    if axis is None:
        amax = float(np.abs(x).max()) if x.size else 0.0
        return QParams(scale=max(amax / QMAX, SCALE_FLOOR), axis=None)
    reduce_axes = tuple(i for i in range(x.ndim) if i != axis)
    amax = np.abs(x).max(axis=reduce_axes)
    return QParams(scale=np.maximum(amax / QMAX, SCALE_FLOOR), axis=axis)


def quantize_array(x, qp: QParams) -> np.ndarray:
    """The host twin of :func:`quantize`: float -> int8 numpy
    (round-to-nearest-even, clamped to [-127, 127]) — how weights are
    quantized."""
    x = _host(x)
    q = np.rint(x / qp._bcast_np(x.ndim))
    return np.clip(q, QMIN, QMAX).astype(np.int8)


def quantize_bias(b, in_scale: float, w_qp: QParams) -> np.ndarray:
    """Bias at the int32 accumulator scale ``s_in * s_w[c]``."""
    s = np.asarray(w_qp.scale, np.float64) * float(in_scale)
    bq = np.rint(_host(b) / s)
    return np.clip(bq, -(1 << 30), 1 << 30).astype(np.int32)


def requant_pair(in_scale: float, w_qp: QParams,
                 out_scale: float) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel ``(multiplier[c], shift[c])`` int32 arrays encoding
    ``s_in * s_w[c] / s_out``."""
    sw = np.atleast_1d(np.asarray(w_qp.scale, np.float64))
    mults, shifts = zip(*(quantize_multiplier(float(in_scale) * float(s)
                                              / float(out_scale))
                          for s in sw))
    return np.array(mults, np.int32), np.array(shifts, np.int32)


def requant_scalar(ratio: float) -> tuple[int, int]:
    """Scalar ``(multiplier, shift)`` for a plain scale ratio (residual
    add operands, average-pool normalization)."""
    return quantize_multiplier(float(ratio))
