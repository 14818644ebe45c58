"""Executors: run an int8 or fp32 PoolProgram on the ring, op by op.

Counterpart of :mod:`repro.core.executors` for the op kinds the port
has kernels for.  One dispatch (:func:`op_kernel_call`, a port of
``_run_pallas_q`` and of the fp32 loop of ``run_program_pallas``) maps
each op to a ring kernel and its arguments.  :func:`execute` runs a plan
on a named backend, as the reference's does (:func:`register_executor`,
:func:`executor_names`):

  * ``"cuda"`` runs the hand-written kernels
    (:data:`repro_torch.kernels.KERNELS`) on a CUDA pool,
  * ``"cpu"`` runs their plain PyTorch versions
    (:data:`repro_torch.kernels.PLAIN`) on a CPU pool — the port of
    ``_apply_op_q``/``_run_jnp_q`` and of ``_apply_op``/``_run_jnp``,
  * ``"sim"`` is :func:`run_program_sim`, the reference's clobber
    oracle: it replays every op's row schedule through a
    :class:`~repro_torch.core.pool.SegmentPool` on the host, with no
    tensor, and certifies a plan.

With no backend named, the pool's device picks ``"cuda"`` or ``"cpu"``;
a named array backend refuses a pool on the other device.

Each takes a ``tracer`` (:class:`repro_torch.obs.RingTracer`): per-op
wall seconds from CUDA events on a CUDA pool, from the host clock on a
CPU pool, and the oracle's measured segment traffic in the sim.
``tracer=None`` records nothing and synchronizes nothing.

Nothing on the CUDA path calls a plain version.  Every int8 op kind has
its kernel, and so does every executable fp32 kind (:data:`F32_KINDS`):
the whole-network ones, the fused inverted bottleneck, the streaming
ones, and the two delta-0 kinds, the fused MLP and the elementwise map.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from ..kernels import KERNELS, PLAIN
from .pool import SegmentPool
from .program import EXECUTABLE_KINDS, PoolProgram
from .vpool import VirtualPool, segments_for

#: Op kinds the port's int8 executors run.
Q_KINDS = ("gemm", "conv_pw", "conv_dw", "conv_k2d", "add", "pool_avg",
           "conv_stream", "gru_cell")
#: Op kinds the port's fp32 executors run.
F32_KINDS = ("gemm", "conv_pw", "conv_dw", "conv_k2d", "add", "pool_avg",
             "ib_fused", "conv_stream", "gru_cell", "fused_mlp",
             "elementwise")


def _normalize_qparams(program: PoolProgram, params):
    """Validate int8 param entries: ``(w_q, b_q, mult, shift)`` for
    gemm/conv (a missing bias becomes zeros), ``(mult_in, shift_in,
    mult_aux, shift_aux)`` for add, ``(mult, shift)`` for pool_avg."""
    if params is None:
        raise ValueError("quantized programs need explicit qparams")
    params = list(params)
    if len(params) != len(program.ops):
        raise ValueError(f"{len(params)} qparam entries for "
                         f"{len(program.ops)} ops")
    out = []
    for op, p in zip(program.ops, params):
        if op.kind in ("gemm", "conv_pw", "conv_dw", "conv_k2d",
                       "conv_stream"):
            w, b, mult, shift = p
            if b is None:
                b = torch.zeros((op.d_out,), dtype=torch.int32,
                                device=w.device)
            out.append((w, b, mult, shift))
        elif op.kind == "gru_cell":
            w, u, b, mx, sx, mu, su = p
            if b is None:
                b = torch.zeros((3 * op.d_out,), dtype=torch.int32,
                                device=w.device)
            out.append((w, u, b, mx, sx, mu, su))
        elif op.kind in ("add", "pool_avg"):
            out.append(tuple(p))
        else:
            raise NotImplementedError(
                f"op kind {op.kind!r} has no int8 execution path")
    return out


def _normalize_params(program: PoolProgram, params):
    """Validate param entries: int8 programs through
    :func:`_normalize_qparams`; fp32 ones take ``(w, b)`` for gemm, conv
    and conv_stream, ``(w, u, b)`` for gru_cell (a missing bias becomes
    zeros), ``(w1, wd, w2)`` for ib_fused, ``(w_gate, w_up, w_down)``
    for fused_mlp (an ungated op's ``None`` gate becomes ``w_up``, as in
    the reference; the kernel never reads it) and ``None`` for add,
    pool_avg and elementwise."""
    if program.quantized:
        return _normalize_qparams(program, params)
    if params is None:
        params = [None] * len(program.ops)
    params = list(params)
    if len(params) != len(program.ops):
        raise ValueError(f"{len(params)} param entries for "
                         f"{len(program.ops)} ops")
    out = []
    for op, p in zip(program.ops, params):
        if op.kind not in F32_KINDS:
            raise NotImplementedError(
                f"op kind {op.kind!r} has no fp32 execution path in the "
                f"port yet (it runs {F32_KINDS})")
        if op.kind in ("gemm", "conv_pw", "conv_dw", "conv_k2d",
                       "conv_stream"):
            w, b = p
            if b is None:
                b = torch.zeros((op.d_out,), dtype=w.dtype, device=w.device)
            out.append((w, b))
        elif op.kind == "gru_cell":
            w, u, b = p
            if b is None:
                b = torch.zeros((3 * op.d_out,), dtype=w.dtype,
                                device=w.device)
            out.append((w, u, b))
        elif op.kind == "ib_fused":
            w1, wd, w2 = p
            out.append((w1, wd, w2))
        elif op.kind == "fused_mlp":
            wg, wu, wd = p
            out.append((wu if wg is None else wg, wu, wd))
        else:
            if p is not None:
                raise ValueError(f"{op.kind} op takes no params")
            out.append(None)
    return out


def _image_ptr(op, seg_width: int) -> int:
    """Effective base pointer of the op's input image — the source base
    advanced past the rows above the slice window (``in_row0``; 0 for
    every unsliced op)."""
    if not op.in_row0:
        return op.in_ptr
    return op.in_ptr + op.in_row0 * op.w_in * segments_for(op.d_in,
                                                           seg_width)


def _pw_row_block(op, n_seg: int, in_ptr: int, seg_width: int,
                  limit: int) -> int:
    """Largest safe pointwise-conv row block ``<= limit``.

    Blocking needs the identity pixel map (stride 1, no resample) so a
    block's source rows are contiguous, plus the reference's no-wrap
    alignment: the pool length and both pointers must be multiples of
    the block's input and output chunk sizes.  Execution granularity
    only — the plan and its certificates are untouched.
    """
    if limit <= 1 or op.stride != 1 or op.resample:
        return 1
    ic = op.w_in * segments_for(op.d_in, seg_width)
    oc = op.w_out * segments_for(op.d_out, seg_width)
    for rb in range(min(limit, op.h_out), 1, -1):
        if op.h_out % rb:
            continue
        if n_seg % (rb * ic) or in_ptr % (rb * ic):
            continue
        if n_seg % (rb * oc) or op.out_ptr % (rb * oc):
            continue
        return rb
    return 1


def op_kernel_call(program: PoolProgram, op, p, *,
                   kernel_block_rows: int = 8):
    """``(kernel_name, params, kwargs)``: the ring kernel that runs
    ``op``, its weight operands and its keyword arguments."""
    if not program.quantized:
        return _f32_kernel_call(program, op, p,
                                kernel_block_rows=kernel_block_rows)
    sw, n = program.seg_width, program.n_segments
    if op.kind == "gemm":
        return "ring_gemm_q", tuple(p), dict(
            m_rows=op.rows_in or program.m_rows, d_in=op.d_in,
            d_out=op.d_out, in_ptr=op.in_ptr, out_ptr=op.out_ptr,
            block_rows=program.block_rows, activation=op.activation)
    if op.kind == "conv_pw":
        iptr = _image_ptr(op, sw)
        return "ring_conv_pw_q", tuple(p), dict(
            h_in=op.h_in, w_in=op.w_in, h_out=op.h_out, w_out=op.w_out,
            c_in=op.d_in, c_out=op.d_out, stride=op.stride,
            resample=op.resample, in_ptr=iptr, out_ptr=op.out_ptr,
            activation=op.activation,
            row_block=_pw_row_block(op, n, iptr, sw, kernel_block_rows))
    if op.kind == "conv_dw":
        return "ring_conv_dw_q", tuple(p), dict(
            h_in=op.h_in, w_in=op.w_in, h_out=op.h_out, w_out=op.w_out,
            c=op.d_in, rs=op.rs, stride=op.stride, padding=op.padding,
            in_ptr=_image_ptr(op, sw), out_ptr=op.out_ptr,
            activation=op.activation)
    if op.kind == "conv_k2d":
        return "ring_conv_k2d_q", tuple(p), dict(
            h_in=op.h_in, w_in=op.w_in, h_out=op.h_out, w_out=op.w_out,
            c_in=op.d_in, c_out=op.d_out, k=op.rs, stride=op.stride,
            padding=op.padding, in_ptr=_image_ptr(op, sw),
            out_ptr=op.out_ptr, activation=op.activation)
    if op.kind == "add":
        mi, si, ma, sa = p
        return "ring_add_q", (), dict(
            rows=op.rows_in or program.m_rows, d=op.d_in, in_ptr=op.in_ptr,
            aux_ptr=op.aux_ptr, out_ptr=op.out_ptr, mult_in=mi,
            shift_in=si, mult_aux=ma, shift_aux=sa,
            activation=op.activation)
    if op.kind == "pool_avg":
        mult, shift = p
        return "ring_avgpool_q", (), dict(
            h=op.h_in, w=op.w_in, c=op.d_in, in_ptr=op.in_ptr,
            out_ptr=op.out_ptr, mult=mult, shift=shift)
    if op.kind == "conv_stream":
        return "ring_conv_stream_q", tuple(p), dict(
            h_win=op.h_in, w_in=op.w_in, h_out=op.h_out, w_out=op.w_out,
            c_in=op.d_in, c_out=op.d_out, k=op.rs, stride=op.stride,
            padding=op.padding, hop=op.hop, in_ptr=op.in_ptr,
            out_ptr=op.out_ptr, state_ptr=op.state_ptr,
            activation=op.activation)
    if op.kind == "gru_cell":
        return "ring_gru_cell_q", tuple(p), dict(
            d_in=op.d_in, d_h=op.d_out, in_ptr=op.in_ptr,
            out_ptr=op.out_ptr, state_ptr=op.state_ptr)
    raise NotImplementedError(
        f"no int8 ring kernel for op kind {op.kind!r} (the port runs "
        f"{Q_KINDS})")


def _f32_kernel_call(program: PoolProgram, op, p, *,
                     kernel_block_rows: int):
    """The fp32 half of :func:`op_kernel_call` (the fp32 dispatch of the
    reference's ``run_program_pallas``)."""
    sw, n = program.seg_width, program.n_segments
    rows = op.rows_in or program.m_rows
    if op.kind == "gemm":
        return "ring_gemm", tuple(p), dict(
            m_rows=rows, d_in=op.d_in, d_out=op.d_out, in_ptr=op.in_ptr,
            out_ptr=op.out_ptr, block_rows=program.block_rows,
            activation=op.activation)
    if op.kind == "conv_pw":
        iptr = _image_ptr(op, sw)
        return "ring_conv_pw", tuple(p), dict(
            h_in=op.h_in, w_in=op.w_in, h_out=op.h_out, w_out=op.w_out,
            c_in=op.d_in, c_out=op.d_out, stride=op.stride,
            resample=op.resample, in_ptr=iptr, out_ptr=op.out_ptr,
            activation=op.activation,
            row_block=_pw_row_block(op, n, iptr, sw, kernel_block_rows))
    if op.kind == "conv_dw":
        return "ring_conv_dw", tuple(p), dict(
            h_in=op.h_in, w_in=op.w_in, h_out=op.h_out, w_out=op.w_out,
            c=op.d_in, rs=op.rs, stride=op.stride, padding=op.padding,
            in_ptr=_image_ptr(op, sw), out_ptr=op.out_ptr,
            activation=op.activation)
    if op.kind == "conv_k2d":
        return "ring_conv_k2d", tuple(p), dict(
            h_in=op.h_in, w_in=op.w_in, h_out=op.h_out, w_out=op.w_out,
            c_in=op.d_in, c_out=op.d_out, k=op.rs, stride=op.stride,
            padding=op.padding, in_ptr=_image_ptr(op, sw),
            out_ptr=op.out_ptr, activation=op.activation)
    if op.kind == "add":
        return "ring_add", (), dict(
            rows=rows, d=op.d_in, in_ptr=op.in_ptr, aux_ptr=op.aux_ptr,
            out_ptr=op.out_ptr, activation=op.activation)
    if op.kind == "pool_avg":
        return "ring_avgpool", (), dict(
            h=op.h_in, w=op.w_in, c=op.d_in, in_ptr=op.in_ptr,
            out_ptr=op.out_ptr)
    if op.kind == "ib_fused":
        return "ring_inverted_bottleneck", tuple(p), dict(
            H=op.h_in, W=op.w_in, C_in=op.d_in, C_mid=op.d_mid,
            C_out=op.d_out, RS=op.rs, in_ptr=op.in_ptr, out_ptr=op.out_ptr,
            residual=op.residual)
    if op.kind == "fused_mlp":
        return "ring_fused_mlp", tuple(p), dict(
            m_rows=rows, d_model=op.d_in, ptr=op.in_ptr,
            block_rows=program.block_rows, ff_tile=op.ff_tile,
            gated=op.gated, residual=op.residual, activation=op.activation)
    if op.kind == "elementwise":
        return "ring_elementwise", (), dict(
            m_rows=rows, d=op.d_in, ptr=op.in_ptr, fn=op.activation,
            block_rows=program.block_rows)
    if op.kind == "conv_stream":
        return "ring_conv_stream", tuple(p), dict(
            h_win=op.h_in, w_in=op.w_in, h_out=op.h_out, w_out=op.w_out,
            c_in=op.d_in, c_out=op.d_out, k=op.rs, stride=op.stride,
            padding=op.padding, hop=op.hop, in_ptr=op.in_ptr,
            out_ptr=op.out_ptr, state_ptr=op.state_ptr,
            activation=op.activation)
    if op.kind == "gru_cell":
        return "ring_gru_cell", tuple(p), dict(
            d_in=op.d_in, d_h=op.d_out, in_ptr=op.in_ptr,
            out_ptr=op.out_ptr, state_ptr=op.state_ptr)
    raise NotImplementedError(
        f"no fp32 ring kernel for op kind {op.kind!r} (the port runs "
        f"{F32_KINDS})")


class _OpClock:
    """Per-op wall seconds of a traced execution, into ``tracer``: a pair
    of CUDA events around each op's launch on the pool's current stream,
    read after one synchronize at the end, or the host clock around each
    op on the CPU."""

    def __init__(self, device: torch.device, tracer):
        self.device = device
        self.tracer = tracer
        self.events: dict[int, tuple] = {}
        tracer.backend = device.type

    def start(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def stop(self, i: int, t0) -> None:
        if self.device.type != "cuda":
            self.tracer.record(i, time.perf_counter() - t0)
            return
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        self.events[i] = (t0, event)

    def finish(self) -> None:
        if not self.events:
            return
        last = self.events[max(self.events)][1]
        last.synchronize()
        for i, (t0, t1) in self.events.items():
            self.tracer.record(i, t0.elapsed_time(t1) / 1e3)


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

_EXECUTORS: dict[str, Callable] = {}


def register_executor(name: str):
    """Register ``fn(program, pool, params, **kw)`` as backend ``name``."""
    def deco(fn):
        _EXECUTORS[name] = fn
        return fn
    return deco


def executor_names() -> tuple[str, ...]:
    return tuple(sorted(_EXECUTORS))


def execute(program: PoolProgram, pool=None, params=None, *,
            backend: str | None = None, **kwargs):
    """Run ``program`` on ``backend``: ``"cuda"`` (the CUDA kernels),
    ``"cpu"`` (their plain versions), ``"sim"`` (:func:`run_program_sim`,
    which ignores ``pool`` and ``params`` and returns the
    :class:`SegmentPool`) or any registered with
    :func:`register_executor`; ``None`` picks ``"cuda"`` or ``"cpu"`` by
    the pool's device.  ``pool`` is a :class:`VirtualPool` or raw
    ``[n_segments, seg_width]`` tensor of the program's dtype, int8 or
    float32, with the input staged at ``program.input_ptr``, and
    ``params`` lie on its device; the array backends run in place and
    return ``pool``.  ``kwargs``: ``kernel_block_rows`` (default 8) and
    ``tracer``, which gets each op's wall seconds (:class:`_OpClock`)
    and ``backend``."""
    if backend is None:
        arr = pool.array if isinstance(pool, VirtualPool) else pool
        backend = arr.device.type
        if backend not in ("cuda", "cpu"):
            raise ValueError(f"no ring executor for device {arr.device}")
    try:
        fn = _EXECUTORS[backend]
    except KeyError:
        raise ValueError(f"unknown backend {backend!r}; registered: "
                         f"{executor_names()}") from None
    if not program.executable:
        raise NotImplementedError(
            f"program contains plan-only ops; only kinds "
            f"{EXECUTABLE_KINDS} are executable")
    return fn(program, pool, params, **kwargs)


@register_executor("cuda")
def _run_cuda(program, pool, params, **kwargs):
    return _run_table(KERNELS, "cuda", program, pool, params, **kwargs)


@register_executor("cpu")
def _run_cpu(program, pool, params, **kwargs):
    return _run_table(PLAIN, "cpu", program, pool, params, **kwargs)


def _run_table(table, device: str, program: PoolProgram, pool, params, *,
               kernel_block_rows: int = 8, tracer=None):
    """Each op through ``table``'s wrapper of its kernel, on a pool that
    must lie on ``device``."""
    arr = pool.array if isinstance(pool, VirtualPool) else pool
    if arr.device.type != device:
        raise ValueError(f"the {device!r} backend runs a pool on its "
                         f"device, not on {arr.device}")
    clock = None if tracer is None else _OpClock(arr.device, tracer)
    for i, (op, p) in enumerate(zip(program.ops,
                                    _normalize_params(program, params))):
        name, args, kwargs = op_kernel_call(
            program, op, p, kernel_block_rows=kernel_block_rows)
        t0 = None if clock is None else clock.start()
        table[name](arr, *args, **kwargs)
        if clock is not None:
            clock.stop(i, t0)
    if clock is not None:
        clock.finish()
    return pool


def run_program(program: PoolProgram, x: torch.Tensor, params, *,
                kernel_block_rows: int = 8, tracer=None):
    """Allocate a zero pool on ``x``'s device, stage ``x`` at the input
    pointer, execute (traced into ``tracer`` when given), fetch the
    output.  Returns ``(y, pool)``."""
    pool = VirtualPool.alloc(program.spec(), x.device)
    pool.stage_rows(x, program.input_ptr)
    execute(program, pool, params, kernel_block_rows=kernel_block_rows,
            tracer=tracer)
    y = pool.fetch_rows(program.output_ptr, program.out_rows,
                        program.out_dim).clone()
    return y, pool


# ---------------------------------------------------------------------------
# sim backend — the clobber oracle.
# ---------------------------------------------------------------------------

def _sim_rowsched_op(sim: SegmentPool, program: PoolProgram, i: int) -> None:
    """Replay one conv-family op through the oracle from the SAME row
    schedule the planner solved its delta with (``core.rowsched``)."""
    from .rowsched import schedule_for_op

    op = program.ops[i]
    sched = schedule_for_op(op, program.seg_width)
    frees = sched.frees()
    ic, oc = sched.in_chunk, sched.out_chunk
    # branch ops (in_op >= 0) read the held INPUT of op in_op — segment
    # ownership tags carry that op's index, exactly like aux reads
    iown = op.in_op if op.in_op >= 0 else i
    # sliced ops (partial execution): reads window the source record at row
    # offset in_row0; writes land inside the SHARED output tensor owned
    # by op out_op at row offset out_row0
    r0 = op.in_row0
    oown = op.out_op if op.out_op >= 0 else i + 1
    w0 = op.out_row0
    for t in range(sched.steps):
        for r in sched.reads[t]:
            for s in range(ic):
                seg = (r0 + r) * ic + s
                sim.read(op.in_ptr + seg, owner=(iown, seg))
        if sched.aux_reads is not None:
            ac = sched.aux_chunk
            for r in sched.aux_reads[t]:
                for s in range(ac):
                    seg = r * ac + s
                    sim.read(op.aux_ptr + seg, owner=(op.aux_op, seg))
                    sim.free(op.aux_ptr + seg, owner=(op.aux_op, seg))
        if not op.hold_input:
            for r in frees[t]:
                for s in range(ic):
                    seg = (r0 + r) * ic + s
                    sim.free(op.in_ptr + seg, owner=(iown, seg))
        for r in sched.writes[t]:
            for s in range(oc):
                sim.write(op.out_ptr + r * oc + s,
                          owner=(oown, (w0 + r) * oc + s))
    if op.free_src:
        # last slice of a held source: release the WHOLE record (earlier
        # slices held it; re-freeing an already-free segment is benign)
        src_rows = op.h_src or sched.in_rows
        for seg in range(src_rows * ic):
            sim.free(op.in_ptr + seg, owner=(iown, seg))


def _sim_stream_op(sim: SegmentPool, program: PoolProgram, i: int) -> None:
    """conv_stream / gru_cell through the oracle: whole-state read then a
    same-owner whole-state rewrite (the executors fetch the full window /
    hidden vector, shift, and write it back — a FOREIGN write into the
    live state region is exactly the clobber this catches), followed by
    the frame traffic via the op's row schedule."""
    op = program.ops[i]
    for j in range(op.state_segments):
        sim.read(op.state_ptr + j, owner=("state", i, j))
    for j in range(op.state_segments):
        sim.write(op.state_ptr + j, owner=("state", i, j))
    _sim_rowsched_op(sim, program, i)


def run_program_sim(program: PoolProgram, pool=None, *,
                    tracer=None) -> SegmentPool:
    """Execute the program's schedule in the SegmentPool simulator.

    GEMM ops run the paper's fine-grained Fig.-4 schedule (input segment
    freed after its LAST read) — strictly harder than the block-granular
    schedule the ring kernels run, so a clobber-free sim run certifies
    them.
    Conv-family ops replay the row schedule their delta was solved with
    (``core.rowsched``); residual sources are freed by the consuming add.
    Returns the SegmentPool for access statistics (peak_live etc.).

    The port of the reference's ``sim`` executor, run on the host with no
    tensor at all (it needs no params).  A ``tracer``
    (:class:`repro_torch.obs.RingTracer`) snapshots the pool's
    read/write/free counters around every op — measured per-op traffic
    from the oracle itself, asserted bit-equal to the schedule-derived
    static counters.
    """
    sw = program.seg_width
    if isinstance(pool, SegmentPool):
        # persistent streaming session (repro_torch.stream): state records
        # from the previous step are still live under their ("state", i,
        # j) owners — the next step must prove it never clobbers them
        sim = pool
    else:
        sim = SegmentPool(program.n_segments,
                          segment_bytes=sw * program.elem_bytes)
        for i, op in enumerate(program.ops):
            for j in range(op.state_segments):
                sim.write(op.state_ptr + j, owner=("state", i, j))
    if tracer is not None:
        tracer.backend = "sim"
    first = program.ops[0]
    for j in range(first.in_segments):
        sim.write(first.in_ptr + j, owner=(0, j))
    for i, op in enumerate(program.ops):
        m = op.rows_in or program.m_rows
        if tracer is not None:
            pre = (sim.reads, sim.writes, sim.frees)
            t0 = time.perf_counter()
        if op.kind == "gemm":
            k_segs = segments_for(op.d_in, sw)
            n_segs = segments_for(op.d_out, sw)
            for r in range(m):
                for n in range(n_segs):
                    for k in range(k_segs):
                        seg = r * k_segs + k
                        sim.read(op.in_ptr + seg, owner=(i, seg))
                        if n == n_segs - 1 and not op.hold_input:
                            sim.free(op.in_ptr + seg, owner=(i, seg))
                    outseg = r * n_segs + n
                    sim.write(op.out_ptr + outseg, owner=(i + 1, outseg))
        elif op.kind in ("fused_mlp", "elementwise"):
            # per-row in-place at delta == 0
            d_segs = segments_for(op.d_in, sw)
            for r in range(m):
                for s in range(d_segs):
                    seg = r * d_segs + s
                    sim.read(op.in_ptr + seg, owner=(i, seg))
                    if not op.hold_input:
                        sim.free(op.in_ptr + seg, owner=(i, seg))
                for s in range(d_segs):
                    seg = r * d_segs + s
                    sim.write(op.out_ptr + seg, owner=(i + 1, seg))
        elif op.kind in ("conv_stream", "gru_cell"):
            _sim_stream_op(sim, program, i)
        else:
            _sim_rowsched_op(sim, program, i)
        if tracer is not None:
            tracer.record(i, time.perf_counter() - t0)
            tracer.record_sim(i, reads=sim.reads - pre[0],
                              writes=sim.writes - pre[1],
                              frees=sim.frees - pre[2], live=sim.live)
    last = program.ops[-1]
    for j in range(last.out_segments):  # outputs must survive the ring
        sim.read(last.out_ptr + j, owner=(len(program.ops), j))
    for i, op in enumerate(program.ops):  # ...and so must persistent state
        for j in range(op.state_segments):
            sim.read(op.state_ptr + j, owner=("state", i, j))
    if tracer is not None:
        tracer.finish_sim(sim)
    return sim


@register_executor("sim")
def _run_sim(program, pool, params, *, tracer=None, **_):
    return run_program_sim(program, pool, tracer=tracer)
