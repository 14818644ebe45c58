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
versions, as :meth:`repro_torch.CompiledNet.run` does.

``backend="sim"`` is the reference's byte oracle: numerics-free, on the
host, every step replays the schedule through
:class:`~repro_torch.core.pool.SegmentPool` with the state records still
live under their ``("state", i, j)`` owners, so an N-step run is N
clobber proofs plus the carried state-survival invariant.

``trace=True`` threads a :class:`repro_torch.obs.RingTracer` through
every step (per-op wall times: CUDA events on the card, the host clock
on the CPU, the oracle's counters in the sim; byte traffic per frame);
the artifacts accumulate in :attr:`StreamSession.traces`.
"""
from __future__ import annotations

import torch

from ..core.executors import run_program_sim
from ..core.vpool import VirtualPool
from ..graph.run import step_net, step_net_quantized


class StreamSession:
    """Reset/step driver over one loaded streaming net.

    Built by :meth:`repro_torch.CompiledNet.stream`; holds the pool (the
    persistent state) between ``step`` calls.  ``device`` is the CUDA
    card unless it says otherwise; the ``sim`` backend runs on the host
    and takes no device."""

    def __init__(self, compiled, device=None, *, backend: str | None = None,
                 trace: bool = False):
        if backend not in (None, "sim"):
            raise ValueError(f"unknown stream backend {backend!r}: the "
                             "port picks its kernels from the device, "
                             "and 'sim' is the clobber oracle")
        from ..compile.driver import CompileError, _device

        self.compiled = compiled
        self.backend = backend
        self.trace = trace
        self.traces: list = []
        self.quantized = compiled.quantized
        if not self.quantized and compiled.program.quantized:
            raise CompileError(
                "planner-only int8 compile: no qparams to stream with — "
                "recompile with quantize=True")
        if backend == "sim":
            self.device = None
            self.program = (compiled.qnet.program if self.quantized
                            else compiled.program)
        elif self.quantized:
            self.device = _device(device)
            self.qnet = compiled._qnet_on(self.device)
            self.program = self.qnet.program
        else:
            self.device = _device(device)
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
        if self.backend == "sim":
            self._pool = None      # run_program_sim pre-writes the state
        else:
            self._pool = VirtualPool.alloc(self.program.spec(), self.device)
        return self

    # -- one frame ---------------------------------------------------------
    def step(self, frame=None):
        """Advance one frame.

        ``frame`` is ``[rows_in, d_in]`` (or anything reshapeable to it).
        Through an int8 plan a float frame is quantized on entry and the
        output dequantized, while an int8 frame counts as quantized and
        the raw int8 output comes back (the bitwise contract); a float
        plan takes the frame as fp32 and returns fp32.  The ``sim``
        backend ignores numerics (pass ``frame=None``) and returns the
        oracle's counters."""
        tracer = None
        if self.trace:
            from ..obs import RingTracer

            tracer = RingTracer()
        if self.backend == "sim":
            program = self.program
            sim = run_program_sim(program, pool=self._pool, tracer=tracer)
            # the session consumes the step output; its record must die
            # before the next frame is staged over it
            last = program.ops[-1]
            for j in range(last.out_segments):
                sim.free(last.out_ptr + j, owner=(len(program.ops), j))
            self._pool = sim
            self.steps += 1
            self._finish_trace(tracer)
            return {"reads": sim.reads, "writes": sim.writes,
                    "frees": sim.frees, "peak_live": sim.peak_live,
                    "live": sim.live, "steps": self.steps}
        if frame is None:
            raise ValueError("array backends need a frame per step")
        first = self.program.ops[0]
        frame = torch.as_tensor(frame, device=self.device).reshape(
            first.rows_in, self.program.in_dim)
        kbr = self.compiled.target.kernel_block_rows
        if self.quantized:
            y = step_net_quantized(self.qnet, self._pool, frame,
                                   kernel_block_rows=kbr, tracer=tracer)
        else:
            y = step_net(self.program, self._pool, frame, self.params,
                         kernel_block_rows=kbr, tracer=tracer)
        self.steps += 1
        self._finish_trace(tracer)
        return y

    def run(self, frames) -> torch.Tensor | None:
        """Feed ``frames`` (an iterable of per-step inputs) and return the
        last step's output."""
        y = None
        for f in frames:
            y = self.step(f)
        return y

    def _finish_trace(self, tracer) -> None:
        if tracer is None:
            return
        from ..obs import build_trace

        self.traces.append(build_trace(
            self.program, tracer=tracer, net=self.compiled.net_name,
            target=self.compiled.target.name))

    @property
    def pool(self):
        """The persistent pool (state included), as the last step left
        it: a :class:`VirtualPool`, or the sim backend's
        :class:`~repro_torch.core.pool.SegmentPool`."""
        return self._pool

    @property
    def state_segments(self) -> int:
        """Ring segments held by persistent state."""
        return sum(op.state_segments for op in self.program.ops)

    @property
    def state_bytes(self) -> int:
        return self.state_segments * self.program.seg_width \
            * self.program.elem_bytes
