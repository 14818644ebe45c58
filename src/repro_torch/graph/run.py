"""Run, certify and calibrate a network on the ring.

Counterpart of :mod:`repro.graph.run`:

  * execution — :func:`run_net` (an fp32 plan), :class:`QuantizedNet`
    (a calibrated int8 deployment), :func:`run_net_quantized` and, for
    streaming programs, one step on a persistent pool (:func:`step_net`,
    fp32, and :func:`step_net_quantized`);
  * :func:`reference_forward` — the same network as a plain forward pass
    with no pool mechanics, the float ground truth the ring paths are
    held to and the taps int8 calibration reads;
  * the compile half — :func:`init_net_params`, :func:`certify_net` (the
    sim oracle), and int8 calibration in two plain steps,
    :func:`calibrate_scales` (activation scales from the reference
    forward, every GRU output pinned at the fixed Q7 scale 1/128) and
    :func:`quantize_ops` (int8 weights, int32 biases and requant pairs
    from given scales), which :func:`_quantize_net` chains.

Calibration's forward runs on the CPU in float32, as the reference's
does; its sums are torch's, not XLA's, so the activation scales agree
with the reference's to float32 rounding, not bit for bit.  Given the
same scales, :func:`quantize_ops` is the reference's arithmetic (float64
numpy) and gives the same bits.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

import numpy as np

from ..compile.artifact import to_device
from ..core.executors import execute, run_program, run_program_sim
from ..core.program import PoolProgram, resolve_activation
from ..core.rowsched import conv_k2d_pad, resample_src
from ..core.vpool import VirtualPool
from ..kernels.fused_mlp import fused_mlp_ref
from ..kernels.inverted_bottleneck import inverted_bottleneck_ref
from ..obs.spans import span
from ..quant.qtensor import (QParams, calibrate, dequantize, quantize,
                             quantize_array, quantize_bias, requant_pair,
                             requant_scalar)
from ..quant.requant import gru_update
from .netplan import NetPlan


def _prog(plan) -> PoolProgram:
    return plan.program if isinstance(plan, NetPlan) else plan


def _generator(key) -> torch.Generator:
    """``key`` as a CPU ``torch.Generator``: a generator passes through,
    an int seeds a fresh one, ``None`` seeds one with 0."""
    if isinstance(key, torch.Generator):
        return key
    g = torch.Generator()
    g.manual_seed(0 if key is None else int(key))
    return g


def init_net_params(plan, key=None) -> list:
    """Random, magnitude-controlled fp32 parameters for every op of the
    plan, as numpy arrays on the host (weights scaled ~1/sqrt(fan_in) so
    deep nets stay in float range; He gain before a ReLU).

    The shapes, scales and draw order are the reference's, but the
    draws come from a ``torch.Generator`` (``key``: a generator or a
    seed, 0 when ``None``), so the VALUES differ from the reference's
    JAX PRNG draws.  To hold the port against the reference, pass the
    reference's params to ``compile(..., params=...)``."""
    program = _prog(plan)
    g = _generator(key)

    def normal(*shape) -> np.ndarray:
        return torch.randn(shape, generator=g, dtype=torch.float32).numpy()

    gain = 2.0 ** 0.5  # He init: ReLU halves the variance
    params = []
    for op in program.ops:
        if op.kind in ("gemm", "conv_pw"):
            w = normal(op.d_in, op.d_out)
            params.append((w * gain / (op.d_in ** 0.5), None))
        elif op.kind == "conv_dw":
            w = normal(op.rs, op.rs, op.d_in)
            params.append((w / op.rs, None))
        elif op.kind in ("conv_k2d", "conv_stream"):
            w = normal(op.rs, op.rs, op.d_in, op.d_out)
            params.append((w * gain / ((op.rs * op.rs * op.d_in) ** 0.5),
                           None))
        elif op.kind == "gru_cell":
            w = normal(op.d_in, 3 * op.d_out) / (op.d_in ** 0.5)
            u = normal(op.d_out, 3 * op.d_out) / (op.d_out ** 0.5)
            params.append((w, u, None))
        elif op.kind == "ib_fused":
            w1 = normal(op.d_in, op.d_mid) / (op.d_in ** 0.5)
            wd = normal(op.rs, op.rs, op.d_mid) / op.rs
            w2 = normal(op.d_mid, op.d_out) / (op.d_mid ** 0.5)
            params.append((w1, wd, w2))
        elif op.kind == "fused_mlp":
            wg = normal(op.d_in, op.d_ff) / (op.d_in ** 0.5)
            wu = normal(op.d_in, op.d_ff) / (op.d_in ** 0.5)
            wd = normal(op.d_ff, op.d_in) / op.d_ff
            params.append((wg, wu, wd))
        else:
            params.append(None)
    return params


def run_net(program: PoolProgram, x: torch.Tensor, params, *,
            kernel_block_rows: int = 8, tracer=None) -> torch.Tensor:
    """Stage ``x`` at the plan's input pointer, execute every op through
    the one fp32 ring (traced into ``tracer`` when given), fetch the
    network output; everything on ``x``'s device (which must hold
    ``params``)."""
    y, _pool = run_program(program, x, params,
                           kernel_block_rows=kernel_block_rows,
                           tracer=tracer)
    return y


def step_net(program: PoolProgram, pool: VirtualPool, frame: torch.Tensor,
             params, *, kernel_block_rows: int = 8,
             tracer=None) -> torch.Tensor:
    """One fp32 streaming step on the persistent ``pool`` (on
    ``frame``'s device, which must hold ``params``): stage the frame at
    the input pointer, execute, fetch the output — a copy, since the
    next step overwrites the pool."""
    pool.stage_rows(frame.to(torch.float32), program.input_ptr)
    execute(program, pool, params, kernel_block_rows=kernel_block_rows,
            tracer=tracer)
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


def reference_forward(plan, x, params, *,
                      intermediates: list | None = None) -> torch.Tensor:
    """Plain forward pass of the planned network (no pool): the port of
    the reference's ``reference_forward`` for every executable kind.

    ``x`` is ``[rows, d]``, the flattened input image; ``params`` are
    tensors or numpy arrays (moved to ``x``'s device).  Residual ``add``
    ops read the saved input of their source op, and branch convs (the
    ResNet shortcut projections) the held input of op ``in_op``, exactly
    as the ring executors read the held interval.  A streaming op runs
    one step from reset: its window is the zero state with the frame
    appended, the GRU's hidden state zero.

    ``intermediates`` (if a list) collects the float input tensor of
    every op followed by the network output — the taps int8 calibration
    (:func:`calibrate_scales`) derives its activation scales from."""
    program = _prog(plan)
    if not isinstance(x, torch.Tensor):
        x = to_device(np.asarray(x), "cpu")
    params = to_device(params, x.device)
    saved: dict[int, torch.Tensor] = {}
    cur = x.to(torch.float32)
    for i, (op, p) in enumerate(zip(program.ops, params)):
        saved[i] = cur
        if intermediates is not None:
            intermediates.append(cur)
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
        elif op.kind == "conv_stream":
            w, b = _wb(op, p)
            frame = src.reshape(op.hop, op.w_in, op.d_in)
            state = torch.zeros((op.h_in - op.hop, op.w_in, op.d_in),
                                dtype=torch.float32, device=frame.device)
            win = torch.cat([state, frame], dim=0)
            y = _conv_ref(win, w, stride=op.stride,
                          pad_lo=conv_k2d_pad(op.rs, op.padding),
                          h_out=op.h_out, w_out=op.w_out)
            cur = act(y + b).reshape(op.rows_out, op.d_out)
        elif op.kind == "gru_cell":
            w, u, b = p
            if b is None:
                b = torch.zeros((3 * op.d_out,), dtype=torch.float32,
                                device=w.device)
            h = torch.zeros((1, op.d_out), dtype=torch.float32,
                            device=src.device)
            gx = src @ w.to(torch.float32) + b.to(torch.float32)
            gh = h @ u.to(torch.float32)
            cur = gru_update(gx, gh, h, op.d_out)
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
            raise NotImplementedError(op.kind)
    if intermediates is not None:
        intermediates.append(cur)
    return cur


def certify_net(plan):
    """Run the whole program through the SegmentPool clobber oracle.

    Returns the oracle (peak_live, reads/writes stats); raises
    :class:`repro_torch.core.pool.PoolClobberError` iff any op's write
    lands on a segment some later op still needs."""
    return run_program_sim(_prog(plan))


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

    @property
    def pool_bytes(self) -> int:
        """The executed int8 ring footprint."""
        return self.program.pool_bytes


_Q_KINDS = ("gemm", "conv_pw", "conv_dw", "conv_k2d", "add", "pool_avg",
            "conv_stream", "gru_cell")
_Q_ACTIVATIONS = (None, "identity", "relu")


def _check_quantizable(program: PoolProgram) -> None:
    for op in program.ops:
        if op.kind not in _Q_KINDS:
            raise ValueError(
                f"op kind {op.kind!r} has no int8 execution path — plan "
                "the net with plan_net(..., fused_exec=False) so modules "
                "lower to their unfused pw/dw/pw(/add) runs")
        if op.activation not in _Q_ACTIVATIONS:
            raise ValueError(f"activation {op.activation!r} has no int8 "
                             "form (relu/None only)")


def calibrate_scales(plan, params, calib) -> tuple[float, ...]:
    """Per-tensor symmetric activation scales, ``amax / 127`` over the
    taps of :func:`reference_forward` on every input of ``calib``
    (``[n, rows, d]``), run on the CPU in float32.  ``scales[i]`` is
    tensor ``i``'s (0 = network input, ``i`` = output of op ``i-1``);
    every GRU output is pinned at the fixed Q7 scale 1/128, the scale
    its hidden state keeps in the pool across invocations."""
    program = _prog(plan)
    n_ops = len(program.ops)
    cpu = torch.device("cpu")
    host = to_device(params, cpu)
    calib = to_device(calib if isinstance(calib, torch.Tensor)
                      else np.asarray(calib), cpu)
    amax = [0.0] * (n_ops + 1)
    with span("calibrate", batches=len(calib), taps=n_ops + 1):
        with torch.no_grad():
            for x in calib:
                taps: list = []
                reference_forward(program, x, host, intermediates=taps)
                for i, t in enumerate(taps):
                    amax[i] = max(amax[i], float(t.abs().max()))
    with span("act_scales"):
        # the amax of a float32 tensor, held as float32 (the reference's
        # ``jnp.array([a])``), then the float64 division
        act_scales = [float(calibrate(np.array([a], np.float32)).scale)
                      for a in amax]
    for i, op in enumerate(program.ops):
        if op.kind == "gru_cell":
            act_scales[i + 1] = 1.0 / 128.0
    return tuple(act_scales)


def quantize_ops(plan, params, act_scales) -> list:
    """Per-op int8 executor entries from float ``params`` and activation
    scales: per-output-channel int8 weights, int32 biases at the
    accumulator scale and CMSIS-NN ``(multiplier, shift)`` pairs relating
    ``s_in * s_w[c] / s_out``, as host numpy arrays (scalar pairs as
    ints for the add and the pool).  A GRU cell requantizes both of its
    accumulators into the Q12 gate domain (scale 1/4096), folds its bias
    there, and reads its hidden state at the fixed Q7 scale."""
    program = _prog(plan)
    _check_quantizable(program)
    qparams: list = []
    with span("quantize_ops", ops=len(program.ops)):
        for i, (op, p) in enumerate(zip(program.ops, params)):
            # branch convs read the held input of op ``in_op`` — their
            # input scale is that tensor's, not the chained tensor's
            s_in = act_scales[op.in_op if op.in_op >= 0 else i]
            s_out = act_scales[i + 1]
            if op.kind in ("gemm", "conv_pw", "conv_dw", "conv_k2d",
                           "conv_stream"):
                w, b = p
                axis = {"conv_dw": 2, "conv_k2d": 3,
                        "conv_stream": 3}.get(op.kind, 1)
                w_qp = calibrate(w, axis=axis)
                w_q = quantize_array(w, w_qp)
                b_q = (quantize_bias(b, s_in, w_qp) if b is not None
                       else np.zeros((op.d_out,), np.int32))
                mult, shift = requant_pair(s_in, w_qp, s_out)
                qparams.append((w_q, b_q, mult, shift))
            elif op.kind == "add":
                s_aux = act_scales[op.aux_op]   # the held source is op
                #                                 aux_op's INPUT tensor
                m_i, s_i = requant_scalar(s_in / s_out)
                m_a, s_a = requant_scalar(s_aux / s_out)
                qparams.append((m_i, s_i, m_a, s_a))
            elif op.kind == "pool_avg":
                m, s = requant_scalar(s_in / (op.h_in * op.w_in * s_out))
                qparams.append((m, s))
            elif op.kind == "gru_cell":
                w, u, b = p
                w_qp = calibrate(w, axis=1)
                u_qp = calibrate(u, axis=1)
                w_q, u_q = quantize_array(w, w_qp), quantize_array(u, u_qp)
                if b is not None:
                    if isinstance(b, torch.Tensor):
                        b = b.detach().cpu()
                    b32 = np.asarray(b, np.float32)
                    b_q12 = np.round(b32 * np.float32(4096.0)).astype(
                        np.int32)
                else:
                    b_q12 = np.zeros((3 * op.d_out,), np.int32)
                mx, sx = requant_pair(s_in, w_qp, 1.0 / 4096.0)
                mu, su = requant_pair(1.0 / 128.0, u_qp, 1.0 / 4096.0)
                qparams.append((w_q, u_q, b_q12, mx, sx, mu, su))
    return qparams


def _quantize_net(plan, params, *, calib=None, n_calib: int = 2,
                  key=None) -> QuantizedNet:
    """Calibrate an int8 deployment from the float reference forward:
    :func:`calibrate_scales` then :func:`quantize_ops`.

    ``plan`` must lower to the unfused op vocabulary (``plan_net(...,
    fused_exec=False)``); ``calib`` is ``[n, rows, d]`` float calibration
    inputs, drawn standard normal from ``key`` (a ``torch.Generator`` or
    a seed, 0 when ``None``) when omitted — values that differ from the
    reference's JAX draws."""
    program = _prog(plan)
    _check_quantizable(program)
    if calib is None:
        calib = torch.randn((n_calib, program.in_rows, program.in_dim),
                            generator=_generator(key), dtype=torch.float32)
    act_scales = calibrate_scales(program, params, calib)
    qparams = quantize_ops(program, params, act_scales)
    return QuantizedNet(plan=plan, program=program.with_dtype("int8"),
                        params=list(params), qparams=qparams,
                        act_scales=act_scales)


def quantize_net(plan, params, **kwargs) -> QuantizedNet:
    """Deprecated direct entry — use ``repro_torch.compile(net,
    target=..., dtype="int8")``, whose ``quantize`` pass runs this
    calibration."""
    import warnings

    warnings.warn(
        "direct quantize_net() entry is deprecated; use "
        "repro_torch.compile(net, target=..., dtype='int8') — the driver "
        "runs quantize_net as its 'quantize' pass",
        DeprecationWarning, stacklevel=2)
    return _quantize_net(plan, params, **kwargs)


def run_net_quantized(qnet: QuantizedNet, x: torch.Tensor, *,
                      kernel_block_rows: int = 8,
                      tracer=None) -> torch.Tensor:
    """Quantize ``x``, execute the int8 program on the ring (traced into
    ``tracer`` when given), dequantize; everything on ``x``'s device
    (which must hold ``qnet.qparams``)."""
    x_q = quantize(x, QParams(scale=qnet.in_scale))
    y_q, _pool = run_program(qnet.program, x_q, qnet.qparams,
                             kernel_block_rows=kernel_block_rows,
                             tracer=tracer)
    return dequantize(y_q, QParams(scale=qnet.out_scale))


def step_net_quantized(qnet: QuantizedNet, pool: VirtualPool,
                       frame: torch.Tensor, *,
                       kernel_block_rows: int = 8,
                       tracer=None) -> torch.Tensor:
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
            kernel_block_rows=kernel_block_rows, tracer=tracer)
    y = pool.fetch_rows(program.output_ptr, program.out_rows,
                        program.out_dim).clone()
    return y if quantized else dequantize(y, QParams(scale=qnet.out_scale))


def quantized_agreement(qnet: QuantizedNet, *, n: int = 8, key=None,
                        device=None) -> dict:
    """Top-line int8-vs-float agreement over random inputs (drawn from
    ``key``, a generator or a seed, 42 when ``None``): the float
    :func:`reference_forward` on the CPU against the int8 ring on
    ``device`` (the CUDA card when ``None``).

    Returns ``cosine`` (mean cosine similarity of the flattened
    outputs), ``argmax_agreement`` (fraction of inputs whose top-1
    output index matches) and ``n``."""
    from ..compile.driver import _device

    dev = _device(device)
    program = qnet.program
    xs = torch.randn((n, program.in_rows, program.in_dim),
                     generator=_generator(42 if key is None else key),
                     dtype=torch.float32)
    on_dev = dataclasses.replace(qnet, qparams=to_device(qnet.qparams, dev))
    cos, agree = [], []
    with torch.no_grad():
        for x in xs:
            ref = reference_forward(program, x, qnet.params).numpy()
            got = run_net_quantized(on_dev, x.to(dev)).cpu().numpy()
            a, b = ref.ravel(), got.ravel()
            denom = (np.linalg.norm(a) * np.linalg.norm(b)) or 1.0
            cos.append(float(a @ b / denom))
            agree.append(int(np.argmax(a) == np.argmax(b)))
    return {"cosine": float(np.mean(cos)),
            "argmax_agreement": float(np.mean(agree)), "n": n}
