"""Plain-torch oracles for every executable op kind (the port of
``repro.kernels.ref``).

Each oracle computes the mathematical result with no ring or pool:
tests stage inputs into a ring, run the op on a device, fetch the
outputs and compare against these.

  * fp32 oracles, held by tolerance; the conv oracles go through
    ``F.conv2d`` (``graph.run._conv_ref``), not the executors' tap and
    gather formulation, so a shared indexing fault cannot cancel out;
  * int8 oracles (``*_q_ref``), held bitwise: integer accumulation is
    exact in any order, so these plain formulations pin the ring kernels
    (they share only ``quant.requant``'s requantization with them).

Tensors come in the reference's layouts (images ``[h, w, c]``, conv
weights HWIO) on any device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.program import resolve_activation
from ..core.rowsched import conv_k2d_out, conv_k2d_pad
from ..graph.run import _conv_ref
from ..quant.requant import (act_i32, gru_update, gru_update_q12,
                             requantize, requantize_i32)
from .fused_mlp import fused_mlp_ref
from .inverted_bottleneck import inverted_bottleneck_ref
from .ring_decode import ring_decode_ref

F32 = torch.float32


def gemm_ref(x, w, b):
    return (x.to(F32) @ w.to(F32) + b.to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# fp32 whole-network op oracles.
# ---------------------------------------------------------------------------

def _act(y, activation):
    return resolve_activation(activation)(y)


def _conv2d(img, w, *, stride: int, pad_lo: int, h_out: int, w_out: int,
            groups: int = 1):
    """The conv with the repo's halo convention: the low padding fixed,
    the high padding whatever makes the output shape exact."""
    return _conv_ref(img.to(F32), w, stride=stride, pad_lo=pad_lo,
                     h_out=h_out, w_out=w_out, groups=groups)


def conv_pw_ref(img, w, b, *, stride: int = 1,
                activation: str | None = None):
    """Pointwise conv ``[h, w, c_in] -> [ceil(h/s), ceil(w/s), c_out]``."""
    h_out = -(-img.shape[0] // stride)
    w_out = -(-img.shape[1] // stride)
    c_in, c_out = w.shape
    y = _conv2d(img, w.reshape(1, 1, c_in, c_out), stride=stride,
                pad_lo=0, h_out=h_out, w_out=w_out)
    return _act(y + b.to(F32), activation).to(img.dtype)


def conv_dw_ref(img, w, b, *, stride: int = 1,
                activation: str | None = None):
    """Depthwise RS x RS conv, 'same' padding; ``w``: ``[rs, rs, c]``."""
    rs, _, c = w.shape
    h_out = -(-img.shape[0] // stride)
    w_out = -(-img.shape[1] // stride)
    y = _conv2d(img, w.reshape(rs, rs, 1, c), stride=stride,
                pad_lo=(rs - 1) // 2, h_out=h_out, w_out=w_out, groups=c)
    return _act(y + b.to(F32), activation).to(img.dtype)


def conv_k2d_ref(img, w, b, *, stride: int = 1, padding: str = "same",
                 activation: str | None = None):
    """General k x k conv; ``w``: ``[k, k, c_in, c_out]``."""
    k = w.shape[0]
    h_out = conv_k2d_out(img.shape[0], k, stride, padding)
    w_out = conv_k2d_out(img.shape[1], k, stride, padding)
    y = _conv2d(img, w, stride=stride, pad_lo=conv_k2d_pad(k, padding),
                h_out=h_out, w_out=w_out)
    return _act(y + b.to(F32), activation).to(img.dtype)


def conv_stream_ref(state, frame, w, b, *, stride: int = 1,
                    padding: str = "same", activation: str | None = None):
    """One conv_stream step: drop the oldest ``hop`` rows of the
    ``[h_win, w_in, c_in]`` window, append the ``[hop, w_in, c_in]``
    frame, run the k x k conv oracle over it.  Returns ``(y,
    new_state)``."""
    win = torch.cat([state[frame.shape[0]:], frame], dim=0)
    return conv_k2d_ref(win, w, b, stride=stride, padding=padding,
                        activation=activation), win


def gru_cell_ref(x, h, w, u, b):
    """Hard-gate GRU step: ``h' = gru_update(x@w + b, h@u, h)``."""
    xf, hf = x.to(F32), h.to(F32)
    gx = xf @ w.to(F32) + b.to(F32)
    gh = hf @ u.to(F32)
    return gru_update(gx, gh, hf, w.shape[1] // 3).to(x.dtype)


def add_ref(x, res, *, activation: str | None = None):
    return _act(x.to(F32) + res.to(F32), activation).to(x.dtype)


def avgpool_ref(img):
    """Global average pool ``[h, w, c] -> [1, c]``."""
    return img.to(F32).mean(dim=(0, 1))[None, :].to(img.dtype)


def elementwise_ref(x, fn: str):
    return _act(x.to(F32), fn).to(x.dtype)


def ib_fused_ref(a, w1, wd, w2, *, residual: bool = True):
    """Fused inverted bottleneck (Fig. 6) oracle, re-exported so every
    executable op kind has its oracle here."""
    return inverted_bottleneck_ref(a, w1, wd, w2, residual=residual)


# ---------------------------------------------------------------------------
# int8 op oracles: int8 operands -> exact integer accumulation -> the one
# shared requantization.  Bitwise contracts of the int8 kernels.
# ---------------------------------------------------------------------------

def _idot(a, b):
    """Exact integer product of two integer matrices as int64 (on a card,
    in fp64, which holds every int8 dot of the repo's widths exactly)."""
    if a.device.type == "cpu":
        return a.to(torch.int64) @ b.to(torch.int64)
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


def _q_act(acc, activation):
    return act_i32(acc, activation)


def gemm_q_ref(x_q, w_q, b_q, mult, shift, *, activation=None):
    acc = _q_act(_idot(x_q, w_q) + b_q.to(torch.int64), activation)
    return requantize(acc, mult[None, :], shift[None, :])


def conv_pw_q_ref(img_q, w_q, b_q, mult, shift, *, stride=1,
                  activation=None):
    sub = img_q[::stride, ::stride]
    h, w, c = sub.shape
    acc = _idot(sub.reshape(h * w, c), w_q).reshape(h, w, -1)
    return _requant_img(acc, b_q, mult, shift, activation)


def conv_dw_q_ref(img_q, w_q, b_q, mult, shift, *, stride=1,
                  activation=None):
    rs, _, c = w_q.shape
    acc = _tap_acc(img_q, w_q.reshape(rs, rs, 1, c), stride,
                   (rs - 1) // 2, "same", depthwise=True)
    return _requant_img(acc, b_q, mult, shift, activation)


def conv_k2d_q_ref(img_q, w_q, b_q, mult, shift, *, stride=1,
                   padding="same", activation=None):
    k = w_q.shape[0]
    acc = _tap_acc(img_q, w_q, stride, conv_k2d_pad(k, padding), padding)
    return _requant_img(acc, b_q, mult, shift, activation)


def _tap_acc(img_q, w_q, stride, pad_lo, padding, *, depthwise=False):
    """Integer tap-sum conv (exact: integer addition is associative)."""
    k = w_q.shape[0]
    h_in, w_in, _ = img_q.shape
    if padding == "same":
        h_out, w_out = -(-h_in // stride), -(-w_in // stride)
    else:
        h_out = (h_in - k) // stride + 1
        w_out = (w_in - k) // stride + 1
    pad_hi = pad_lo + stride if padding == "same" else 0
    padded = F.pad(img_q.to(torch.int64),
                   (0, 0, pad_lo, pad_hi, pad_lo, pad_hi))
    c_out = w_q.shape[2] if depthwise else w_q.shape[3]
    acc = torch.zeros((h_out, w_out, c_out), dtype=torch.int64,
                      device=img_q.device)
    for r in range(k):
        for c in range(k):
            tap = padded[r:r + stride * (h_out - 1) + 1:stride,
                         c:c + stride * (w_out - 1) + 1:stride]
            if depthwise:
                acc = acc + tap * w_q[r, c, 0].to(torch.int64)
            else:
                acc = acc + _idot(tap.reshape(h_out * w_out, -1),
                                  w_q[r, c]).reshape(h_out, w_out, -1)
    return acc


def _requant_img(acc, b_q, mult, shift, activation):
    acc = _q_act(acc + b_q.to(torch.int64), activation)
    return requantize(acc, mult[None, None, :], shift[None, None, :])


def add_q_ref(x_q, res_q, mult_in, shift_in, mult_aux, shift_aux, *,
              activation=None):
    ya = requantize_i32(x_q.to(torch.int64), mult_in, shift_in)
    yb = requantize_i32(res_q.to(torch.int64), mult_aux, shift_aux)
    return _q_act(ya + yb, activation).clamp(-128, 127).to(torch.int8)


def conv_stream_q_ref(state_q, frame_q, w_q, b_q, mult, shift, *,
                      stride=1, padding="same", activation=None):
    """Int8 conv_stream step: the shift and append are an exact int8
    copy, the conv is the bitwise k x k pipeline.  Returns ``(y_q,
    new_state_q)``."""
    win = torch.cat([state_q[frame_q.shape[0]:], frame_q], dim=0)
    return conv_k2d_q_ref(win, w_q, b_q, mult, shift, stride=stride,
                          padding=padding, activation=activation), win


def gru_cell_q_ref(x_q, h_q7, w_q, u_q, b_q12, mult_x, shift_x, mult_u,
                   shift_u):
    """Int8 GRU step: both accumulators requantized to Q12, then the
    shared fixed-point update."""
    gx = requantize_i32(_idot(x_q, w_q), mult_x, shift_x) \
        + b_q12.to(torch.int64)
    gh = requantize_i32(_idot(h_q7, u_q), mult_u, shift_u)
    return gru_update_q12(gx, gh, h_q7, w_q.shape[1] // 3)


def avgpool_q_ref(img_q, mult, shift):
    acc = img_q.to(torch.int64).sum(dim=(0, 1))[None, :]
    return requantize(acc, mult, shift)


__all__ = [
    "add_q_ref", "add_ref", "avgpool_q_ref", "avgpool_ref", "conv_dw_q_ref",
    "conv_dw_ref", "conv_k2d_q_ref", "conv_k2d_ref", "conv_pw_q_ref",
    "conv_pw_ref", "conv_stream_q_ref", "conv_stream_ref", "elementwise_ref",
    "fused_mlp_ref", "gemm_q_ref", "gemm_ref", "gru_cell_q_ref",
    "gru_cell_ref", "ib_fused_ref", "ring_decode_ref",
]
