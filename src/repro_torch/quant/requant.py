"""Fixed-point requantization (TFLite/CMSIS-NN multiplier + shift).

Counterpart of :mod:`repro.quant.requant`.  The reference emulates the
64-bit product with 32-bit operations because Pallas-TPU has no int64;
PyTorch and CUDA have one, so here the product ``acc * multiplier`` is
exact int64 arithmetic.  The rounding is the reference's: one
round-to-nearest, ties to even, over the exact product (not CMSIS's
round-half-up), then saturation to int32, a clip to ``±2**24`` and, for
:func:`requantize`, a clip to int8.  The CUDA kernels in
``kernels/csrc/ring_q.cu`` implement the same steps.
"""
from __future__ import annotations

import math

import torch

INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1

# Valid total right-shift range of the single-rounding requant:
# s = 31 - shift must lie in [1, 62].
SHIFT_MIN = -31
SHIFT_MAX = 30

# The working range requantize_i32 saturates to (well clear of int8).
I24 = 1 << 24


def quantize_multiplier(real: float) -> tuple[int, int]:
    """Encode ``real > 0`` as ``(multiplier, shift)`` with
    ``real ~= multiplier * 2**(shift - 31)`` and ``multiplier`` a Q31
    mantissa in ``[2**30, 2**31)`` (TFLite's QuantizeMultiplier).

    ``real == 0`` encodes as ``(0, 0)``; ``shift`` outside
    ``[SHIFT_MIN, SHIFT_MAX]`` (a scale ratio of ``2**30`` or beyond)
    raises — such ratios cannot be requantized with a single rounding.
    """
    if real == 0.0:
        return 0, 0
    if real < 0.0 or not math.isfinite(real):
        raise ValueError(f"requant multiplier must be finite and >= 0, "
                         f"got {real}")
    frac, exp = math.frexp(real)          # real = frac * 2**exp
    m = round(frac * (1 << 31))
    if m == (1 << 31):                    # frac rounded up to 1.0
        m >>= 1
        exp += 1
    if not SHIFT_MIN <= exp <= SHIFT_MAX:
        raise ValueError(f"scale ratio {real} needs shift {exp}, outside "
                         f"[{SHIFT_MIN}, {SHIFT_MAX}]")
    return m, exp


def _as_i64(v, device) -> torch.Tensor:
    return torch.as_tensor(v, device=device).to(torch.int64)


def requantize_i32(acc, multiplier, shift) -> torch.Tensor:
    """``RNE(acc * multiplier * 2**(shift-31))`` saturated to int32 and
    then to ``[-2**24, 2**24]``; returned as int64.

    ``acc`` is an integer tensor (any shape, values in the int32 range);
    ``multiplier``/``shift`` are ints or integer tensors broadcastable
    against it (per-channel requant broadcasts a trailing ``[c]`` axis).
    """
    acc = acc.to(torch.int64)
    mult = _as_i64(multiplier, acc.device)
    s = 31 - _as_i64(shift, acc.device)
    prod = acc * mult                     # exact: |prod| < 2**62
    one = torch.ones_like(s)
    half = one << (s - 1)
    q = (prod + half) >> s                # arithmetic shift: floor
    tie = (prod & ((one << s) - 1)) == half
    q = q - (tie & ((q & 1) == 1)).to(torch.int64)
    q = q.clamp(INT32_MIN, INT32_MAX)
    return q.clamp(-I24, I24)


def requantize(acc, multiplier, shift, *, zero_point: int = 0):
    """``clamp(RNE(acc * multiplier * 2**(shift-31)) + zero_point)`` to
    int8 — one rounding over the exact product, then saturation."""
    v = requantize_i32(acc, multiplier, shift) + zero_point
    return v.clamp(-128, 127).to(torch.int8)


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """Integer ``v`` taken mod 2**32 into the int32 range — the
    reference's int32 overflow — returned as int64."""
    return v.to(torch.int64).to(torch.int32).to(torch.int64)


def gru_update(gx, gh, h, d_h: int) -> torch.Tensor:
    """Fp32 hard-gate GRU update (gate order z, r, n) — the reference's
    ``gru_update``.

    ``gx = x @ w + b`` and ``gh = h @ u`` are ``[..., 3*d_h]`` gate
    pre-activations; ``hard_sigmoid(t) = clip(t/4 + 0.5, 0, 1)`` and
    ``hard_tanh(t) = clip(t, -1, 1)``.  The CUDA kernel in
    ``kernels/csrc/ring_f32.cu`` computes the same expression."""
    z = torch.clamp(0.25 * (gx[..., :d_h] + gh[..., :d_h]) + 0.5, 0.0, 1.0)
    r = torch.clamp(0.25 * (gx[..., d_h:2 * d_h] + gh[..., d_h:2 * d_h])
                    + 0.5, 0.0, 1.0)
    n = torch.clamp(gx[..., 2 * d_h:] + r * gh[..., 2 * d_h:], -1.0, 1.0)
    return (1.0 - z) * n + z * h


def gru_update_q12(gx, gh, h_q7, d_h: int) -> torch.Tensor:
    """Fixed-point hard-gate GRU update (gate order z, r, n) — the
    reference's ``gru_update_q12``, bit for bit.

    ``gx``/``gh`` are ``[..., 3*d_h]`` integer gate pre-activations in
    Q12 with values in the int32 range (the Q12 bias already folded
    into ``gx``); ``h_q7`` is the int8 hidden state at the fixed Q7
    scale.  Pre-activations saturate at ``±2**18``, hard-sigmoid lands
    in ``[0, 4096]``, hard-tanh in ``[-4096, 4096]``, and the blend
    ``(1-z)*n + z*h`` resolves at Q7 with one arithmetic ``>> 12``.
    Every intermediate fits int32, so int64 arithmetic gives the same
    bits.  Returns int8."""
    lim = 1 << 18
    gx = gx.to(torch.int64).clamp(-lim, lim)
    gh = gh.to(torch.int64).clamp(-lim, lim)
    h = h_q7.to(torch.int64)
    z = (((gx[..., :d_h] + gh[..., :d_h] + 2) >> 2) + 2048).clamp(0, 4096)
    r = (((gx[..., d_h:2 * d_h] + gh[..., d_h:2 * d_h] + 2) >> 2)
         + 2048).clamp(0, 4096)
    n = (gx[..., 2 * d_h:]
         + ((r * gh[..., 2 * d_h:] + 2048) >> 12)).clamp(-4096, 4096)
    n_q7 = ((n + 16) >> 5).clamp(-128, 127)
    hp = (z * h + (4096 - z) * n_q7 + 2048) >> 12
    return hp.clamp(-128, 127).to(torch.int8)


def act_i32(acc, activation):
    """Int32-domain activation between accumulate and requantize.

    With symmetric scales relu commutes with requantization, so
    clamping the accumulator at zero is exact; nothing beyond relu has
    a single-multiplier int8 form."""
    if activation in (None, "identity"):
        return acc
    if activation == "relu":
        return acc.clamp_min(0)
    raise NotImplementedError(
        f"activation {activation!r} has no int8 path (relu/None only)")
