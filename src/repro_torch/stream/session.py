"""Streaming inference driver: persistent temporal state on the ring.

Counterpart of :mod:`repro.stream.session`.  A :class:`StreamSession`
owns ONE pool across invocations.  Each ``step(frame)`` stages only the
new frame, executes the program — whose ``conv_stream``/``gru_cell``
ops shift their ring-resident state and consume the frame — and fetches
the step output.  The state regions live wrap-free above the frame
program's linear extent, so frame traffic never aliases them.

A session runs an int8 plan (its calibrated qparams) or a float plan
(its fp32 params), each on the session's device: a CUDA pool runs the
hand-written kernels, a CPU pool (``device="cpu"``) their plain
versions, as :meth:`repro_torch.CompiledNet.run` does.  The reference's
``sim`` backend (the clobber oracle) and ``trace=True`` (per-step ring
telemetry) are not ported yet.
"""
from __future__ import annotations

import torch

from ..core.vpool import VirtualPool
from ..graph.run import step_net, step_net_quantized


class StreamSession:
    """Reset/step driver over one loaded streaming net.

    Built by :meth:`repro_torch.CompiledNet.stream`; holds the pool (the
    persistent state) between ``step`` calls.  ``device`` is the CUDA
    card unless it says otherwise."""

    def __init__(self, compiled, device=None, *, backend: str | None = None,
                 trace: bool = False):
        if backend == "sim":
            raise NotImplementedError(
                "the sim backend (the clobber oracle) is not ported yet: "
                "it comes with Slice D (the sim oracle and the row "
                "schedules)")
        if backend is not None:
            raise ValueError(f"unknown stream backend {backend!r}: the "
                             "port picks its kernels from the device")
        if trace:
            raise NotImplementedError(
                "trace=True is not ported yet: ring telemetry comes with "
                "Slice G (partial execution, streaming and telemetry)")
        from ..compile.driver import _device

        self.compiled = compiled
        self.device = _device(device)
        self.quantized = compiled.quantized
        if self.quantized:
            self.qnet = compiled._qnet_on(self.device)
            self.program = self.qnet.program
        else:
            self.params = compiled._params_on(self.device)
            self.program = compiled.program
        if not any(op.state_segments for op in self.program.ops):
            raise ValueError(
                f"{compiled.net_name!r} has no stream state — load a "
                "streaming artifact (conv_stream/gru_cell ops)")
        self.reset()

    # -- state lifecycle ---------------------------------------------------
    def reset(self) -> "StreamSession":
        """Zero every state region and restart the step counter.  A zero
        window is the reference conv's zero padding."""
        self.steps = 0
        self._pool = VirtualPool.alloc(self.program.spec(), self.device)
        return self

    # -- one frame ---------------------------------------------------------
    def step(self, frame) -> torch.Tensor:
        """Advance one frame.

        ``frame`` is ``[rows_in, d_in]`` (or anything reshapeable to it).
        Through an int8 plan a float frame is quantized on entry and the
        output dequantized, while an int8 frame counts as quantized and
        the raw int8 output comes back (the bitwise contract); a float
        plan takes the frame as fp32 and returns fp32."""
        first = self.program.ops[0]
        frame = torch.as_tensor(frame, device=self.device).reshape(
            first.rows_in, self.program.in_dim)
        kbr = self.compiled.target.kernel_block_rows
        if self.quantized:
            y = step_net_quantized(self.qnet, self._pool, frame,
                                   kernel_block_rows=kbr)
        else:
            y = step_net(self.program, self._pool, frame, self.params,
                         kernel_block_rows=kbr)
        self.steps += 1
        return y

    def run(self, frames) -> torch.Tensor | None:
        """Feed ``frames`` (an iterable of per-step inputs) and return the
        last step's output."""
        y = None
        for f in frames:
            y = self.step(f)
        return y

    @property
    def pool(self) -> VirtualPool:
        """The persistent pool (state included), as the last step left
        it."""
        return self._pool

    @property
    def state_segments(self) -> int:
        """Ring segments held by persistent state."""
        return sum(op.state_segments for op in self.program.ops)

    @property
    def state_bytes(self) -> int:
        return self.state_segments * self.program.seg_width \
            * self.program.elem_bytes
