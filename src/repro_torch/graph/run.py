"""Run a quantized network end to end on the ring.

Counterpart of the int8 execution half of :mod:`repro.graph.run`:
:class:`QuantizedNet` (the data of a calibrated int8 deployment),
:func:`run_net_quantized` and, for streaming programs, one step on a
persistent pool (:func:`step_net_quantized`).  Calibration
(``_quantize_net``, which pins every GRU output at the fixed Q7 scale
1/128 in ``act_scales``) and the float reference forward come with the
compile pipeline, in a later slice.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.executors import execute, run_program
from ..core.program import PoolProgram
from ..core.vpool import VirtualPool
from ..quant.qtensor import QParams, dequantize, quantize


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
