"""Run a network end to end on the ring.

Counterpart of the execution half of :mod:`repro.graph.run`:
:func:`run_net` (an fp32 plan), :class:`QuantizedNet` (the data of a
calibrated int8 deployment), :func:`run_net_quantized` and, for
streaming programs, one step on a persistent pool (:func:`step_net`,
fp32, and :func:`step_net_quantized`); and :func:`reference_forward`,
the same network as a plain forward pass with no pool mechanics — the
float ground truth the ring paths are held to.  Calibration
(``_quantize_net``, which pins every GRU output at the fixed Q7 scale
1/128 in ``act_scales``) comes with the compile pipeline, in a later
slice.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core.executors import execute, run_program
from ..core.program import PoolProgram, resolve_activation
from ..core.rowsched import conv_k2d_pad, resample_src
from ..core.vpool import VirtualPool
from ..kernels.fused_mlp import fused_mlp_ref
from ..kernels.inverted_bottleneck import inverted_bottleneck_ref
from ..quant.qtensor import QParams, dequantize, quantize


def run_net(program: PoolProgram, x: torch.Tensor, params, *,
            kernel_block_rows: int = 8) -> torch.Tensor:
    """Stage ``x`` at the plan's input pointer, execute every op through
    the one fp32 ring, fetch the network output; everything on ``x``'s
    device (which must hold ``params``)."""
    y, _pool = run_program(program, x, params,
                           kernel_block_rows=kernel_block_rows)
    return y


def step_net(program: PoolProgram, pool: VirtualPool, frame: torch.Tensor,
             params, *, kernel_block_rows: int = 8) -> torch.Tensor:
    """One fp32 streaming step on the persistent ``pool`` (on
    ``frame``'s device, which must hold ``params``): stage the frame at
    the input pointer, execute, fetch the output — a copy, since the
    next step overwrites the pool."""
    pool.stage_rows(frame.to(torch.float32), program.input_ptr)
    execute(program, pool, params, kernel_block_rows=kernel_block_rows)
    return pool.fetch_rows(program.output_ptr, program.out_rows,
                           program.out_dim).clone()


def _conv_ref(img, w, *, stride: int, pad_lo: int, h_out: int, w_out: int,
              groups: int = 1) -> torch.Tensor:
    """Independent conv oracle through ``F.conv2d`` (not the executors'
    tap/gather formulation, so a shared indexing bug cannot cancel out).
    ``img`` is ``[h, w, c]`` and ``w`` HWIO, the reference's layouts;
    the high padding makes the output exactly ``[h_out, w_out]`` (it may
    be negative: a crop)."""
    h_in, w_in, _ = img.shape
    rs = w.shape[0]
    ph = (h_out - 1) * stride + rs - pad_lo - h_in
    pw = (w_out - 1) * stride + rs - pad_lo - w_in
    x = F.pad(img.permute(2, 0, 1)[None], (pad_lo, pw, pad_lo, ph))
    y = F.conv2d(x, w.to(torch.float32).permute(3, 2, 0, 1),
                 stride=stride, groups=groups)
    return y[0].permute(1, 2, 0)


def _wb(op, p):
    w, b = p
    if b is None:
        b = torch.zeros((op.d_out,), dtype=torch.float32, device=w.device)
    return w.to(torch.float32), b.to(torch.float32)


def reference_forward(program: PoolProgram, x: torch.Tensor,
                      params) -> torch.Tensor:
    """Plain forward pass of the planned network (no pool): the port of
    the reference's ``reference_forward`` for every executable kind but
    the streaming ones (whole-network, the fused inverted bottleneck,
    the fused MLP and the elementwise map).

    ``x`` is ``[rows, d]``, the flattened input image.  Residual ``add``
    ops read the saved input of their source op, and branch convs (the
    ResNet shortcut projections) the held input of op ``in_op``, exactly
    as the ring executors read the held interval."""
    saved: dict[int, torch.Tensor] = {}
    cur = x.to(torch.float32)
    for i, (op, p) in enumerate(zip(program.ops, params)):
        saved[i] = cur
        src = saved[op.in_op] if op.in_op >= 0 else cur
        act = resolve_activation(op.activation)
        if op.kind == "gemm":
            w, b = _wb(op, p)
            cur = act(src @ w + b)
        elif op.kind == "conv_pw":
            w, b = _wb(op, p)
            img = src.reshape(op.h_in, op.w_in, op.d_in)
            if op.resample:
                # the nearest-grid adapter is gather-by-definition
                ridx = [resample_src(r, op.h_in, op.h_out)
                        for r in range(op.h_out)]
                cidx = [resample_src(c, op.w_in, op.w_out)
                        for c in range(op.w_out)]
                y = torch.einsum("hwc,cd->hwd", img[ridx][:, cidx], w)
            else:
                y = _conv_ref(img, w.reshape(1, 1, op.d_in, op.d_out),
                              stride=op.stride, pad_lo=0, h_out=op.h_out,
                              w_out=op.w_out)
            cur = act(y + b).reshape(op.rows_out, op.d_out)
        elif op.kind == "conv_dw":
            w, b = _wb(op, p)
            img = src.reshape(op.h_in, op.w_in, op.d_in)
            y = _conv_ref(img, w.reshape(op.rs, op.rs, 1, op.d_in),
                          stride=op.stride, pad_lo=(op.rs - 1) // 2,
                          h_out=op.h_out, w_out=op.w_out, groups=op.d_in)
            cur = act(y + b).reshape(op.rows_out, op.d_out)
        elif op.kind == "conv_k2d":
            w, b = _wb(op, p)
            img = src.reshape(op.h_in, op.w_in, op.d_in)
            y = _conv_ref(img, w, stride=op.stride,
                          pad_lo=conv_k2d_pad(op.rs, op.padding),
                          h_out=op.h_out, w_out=op.w_out)
            cur = act(y + b).reshape(op.rows_out, op.d_out)
        elif op.kind == "ib_fused":
            w1, wd, w2 = p
            a = src.reshape(op.h_in, op.w_in, op.d_in)
            cur = inverted_bottleneck_ref(
                a, w1, wd, w2, residual=op.residual).reshape(op.rows_out,
                                                             op.d_out)
        elif op.kind == "fused_mlp":
            wg, wu, wd = p
            cur = fused_mlp_ref(cur, wg, wu, wd, gated=op.gated,
                                residual=op.residual,
                                activation=op.activation).to(torch.float32)
        elif op.kind == "add":
            cur = act(cur + saved[op.aux_op])
        elif op.kind == "pool_avg":
            img = cur.reshape(op.h_in, op.w_in, op.d_in)
            cur = torch.mean(img, dim=(0, 1))[None, :]
        elif op.kind == "elementwise":
            cur = act(cur)
        else:
            raise NotImplementedError(
                f"reference_forward has no {op.kind!r} op in the port yet")
    return cur


@dataclasses.dataclass
class QuantizedNet:
    """A calibrated int8 deployment of one planned network.

    ``program`` is the int8-typed plan; ``qparams`` are the per-op
    executor entries (int8 weights, int32 biases, requant multiplier and
    shift constants) on one device; ``act_scales[i]`` is the symmetric
    scale of tensor ``i`` (0 = network input, ``i`` = output of op
    ``i-1``).  ``plan`` and ``params`` (the float NetPlan and weights)
    are ``None`` for a net loaded from an artifact."""

    plan: object
    program: PoolProgram
    params: list | None
    qparams: list
    act_scales: tuple[float, ...]

    @property
    def in_scale(self) -> float:
        return self.act_scales[0]

    @property
    def out_scale(self) -> float:
        return self.act_scales[-1]


def run_net_quantized(qnet: QuantizedNet, x: torch.Tensor, *,
                      kernel_block_rows: int = 8) -> torch.Tensor:
    """Quantize ``x``, execute the int8 program on the ring, dequantize;
    everything on ``x``'s device (which must hold ``qnet.qparams``)."""
    x_q = quantize(x, QParams(scale=qnet.in_scale))
    y_q, _pool = run_program(qnet.program, x_q, qnet.qparams,
                             kernel_block_rows=kernel_block_rows)
    return dequantize(y_q, QParams(scale=qnet.out_scale))


def step_net_quantized(qnet: QuantizedNet, pool: VirtualPool,
                       frame: torch.Tensor, *,
                       kernel_block_rows: int = 8) -> torch.Tensor:
    """One streaming step on the persistent ``pool`` (on ``frame``'s
    device, which must hold ``qnet.qparams``): stage the frame at the
    input pointer, execute, fetch the output.

    A float frame is quantized at the input scale and the output
    dequantized at the output scale (a GRU output's is the fixed Q7
    scale); an int8 frame counts as quantized already and the raw int8
    output comes back.  The output is a copy: the next step overwrites
    the pool."""
    program = qnet.program
    quantized = frame.dtype == torch.int8
    if not quantized:
        frame = quantize(frame, QParams(scale=qnet.in_scale))
    pool.stage_rows(frame, program.input_ptr)
    execute(program, pool, qnet.qparams,
            kernel_block_rows=kernel_block_rows)
    y = pool.fetch_rows(program.output_ptr, program.out_rows,
                        program.out_dim).clone()
    return y if quantized else dequantize(y, QParams(scale=qnet.out_scale))
