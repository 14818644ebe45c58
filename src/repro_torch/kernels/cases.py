"""Parity cases for the ring kernels.

A :class:`Case` is one kernel call at one geometry: the kernel's name,
the pool length and its keyword arguments.  :func:`case_inputs` draws a
seeded pool (garbage everywhere, the input rows staged with zero channel
tails, as a ring holds them) and, unless the case carries real weights,
seeded weights and requant constants (int8 kernels, ``ring_*_q``) or
seeded fp32 weights and biases (fp32 kernels).  Everything is numpy, so
the same inputs can go to the reference's Pallas kernels, to the plain
versions and to the CUDA kernels.

:data:`EDGE_CASES` are the int8 geometries the DS-CNN plan does not
reach (wrapping runs, other strides, paddings and blockings, saturating
and wrapping int32 sums, streaming windows with ``hop`` 2);
:data:`F32_EDGE_CASES` are their fp32 twins for the six whole-network
kernels, with every activation of the fp32 epilogue;
:data:`F32_FUSED_STREAM_EDGE_CASES` those of the fused inverted
bottleneck and the fp32 streaming kernels;
:data:`F32_MLP_EDGE_CASES` those of the two delta-0 kernels, the fused
MLP and the elementwise map; :func:`program_cases` gives one case per
op of a real program, with its real weights.

:func:`mlp_tower_params` is the numpy recipe for the weights of an MLP
tower plan, whose fp32 weights are too large to commit (whisper-tiny's
four layers are 18.9 MB): the same seed gives the same weights on every
machine, to the reference and to the port; :func:`seeded_float_net`
serves such a plan from its params-less artifact.

An int8 kernel is held to its plain version bitwise.  An fp32 kernel is
held by :func:`compare_f32` at the one tolerance :data:`RTOL` and
:data:`ATOL_REL` (the reference's conformance-matrix rule): within it on
the live channels of the rows the call writes, and exactly everywhere
else (channel tails and segments the call does not write).

Every in/out overlap here is one a certified plan allows: no output row
lands on an input row (or residual row) a later step still reads, and
no output lands on a streaming state region.  Only such overlaps are a
test of anything: the reference kernels in interpret mode read an
unaliased copy of the pool, and the plain versions read every input
before they store, so an illegal overlap would set them apart from a
kernel that walks the ring in order.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from ..core.vpool import SEG_WIDTH, segments_for
from ..quant.requant import quantize_multiplier


#: The fp32 tolerance: ``|got - want| <= ATOL_REL * max|want| + RTOL *
#: |want|`` (``tests/test_conformance_matrix.py::_tol``).  Summation
#: order differs between the kernels, their plain versions and the
#: reference, so fp32 results agree to rounding, not bitwise.
RTOL = 3e-4
ATOL_REL = 3e-5


def is_f32(kernel: str) -> bool:
    """Whether ``kernel`` is an fp32 kernel (int8 ones end in ``_q``)."""
    return not kernel.endswith("_q")


def _base(kernel: str) -> str:
    return kernel.removesuffix("_q")


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    kernel: str           # wrapper name, e.g. "ring_conv_dw_q"
    n_seg: int
    kwargs: dict
    params: tuple | None = None   # real weights, or None to draw them
    d_ff: int = 0         # a fused MLP's hidden width, for drawn weights


def _k2d(h, w, ci, co, k, s, pad, hout, wout, i, o, act):
    return dict(h_in=h, w_in=w, h_out=hout, w_out=wout, c_in=ci, c_out=co,
                k=k, stride=s, padding=pad, in_ptr=i, out_ptr=o,
                activation=act)


def _dw(h, w, c, rs, s, pad, hout, wout, i, o, act):
    return dict(h_in=h, w_in=w, h_out=hout, w_out=wout, c=c, rs=rs,
                stride=s, padding=pad, in_ptr=i, out_ptr=o, activation=act)


def _pw(h, w, ci, co, s, rsmp, hout, wout, i, o, act, rb=1):
    return dict(h_in=h, w_in=w, h_out=hout, w_out=wout, c_in=ci, c_out=co,
                stride=s, resample=rsmp, in_ptr=i, out_ptr=o,
                activation=act, row_block=rb)


def _add(rows, d, i, aux, o, ratio_in, ratio_aux, act):
    mi, si = quantize_multiplier(ratio_in)
    ma, sa = quantize_multiplier(ratio_aux)
    return dict(rows=rows, d=d, in_ptr=i, aux_ptr=aux, out_ptr=o,
                mult_in=mi, shift_in=si, mult_aux=ma, shift_aux=sa,
                activation=act)


def _stream(h_win, w, ci, co, k, s, hop, hout, wout, i, o, st, act,
            pad="same"):
    return dict(h_win=h_win, w_in=w, h_out=hout, w_out=wout, c_in=ci,
                c_out=co, k=k, stride=s, padding=pad, hop=hop, in_ptr=i,
                out_ptr=o, state_ptr=st, activation=act)


def _ib(h, w, ci, cm, co, i, o, residual):
    return dict(H=h, W=w, C_in=ci, C_mid=cm, C_out=co, RS=3, in_ptr=i,
                out_ptr=o, residual=residual)


def _gru(d_in, d_h, i, o, st):
    return dict(d_in=d_in, d_h=d_h, in_ptr=i, out_ptr=o, state_ptr=st)


def _gru_params(d_in: int, d_h: int, seed: int, bias: int):
    """GRU weights and Q12 constants whose biases lie within ``bias`` of
    the int32 limits, so that ``gx + b`` wraps on some channels."""
    rng = np.random.default_rng(seed)
    g = 3 * d_h
    w = rng.integers(-127, 128, (d_in, g), dtype=np.int8)
    u = rng.integers(-127, 128, (d_h, g), dtype=np.int8)
    b = np.where(rng.integers(0, 2, g) == 1,
                 rng.integers((1 << 31) - bias, 1 << 31, g),
                 rng.integers(-(1 << 31), -(1 << 31) + bias, g)) \
        .astype(np.int32)
    mult = rng.integers(1 << 30, (1 << 31) - 1, (4, g), dtype=np.int32)
    shift = rng.integers(-3, 0, (4, g), dtype=np.int32)
    return w, u, b, mult[0], shift[0], mult[1], shift[1]


#: Multiplier and shift that saturate ``requantize_i32`` (int32, then
#: the ``2**24`` clip) for any nonzero int8 operand.
SATURATE = dict(mult_in=(1 << 31) - 1, shift_in=30, mult_aux=(1 << 31) - 1,
                shift_aux=30)

EDGE_CASES = (
    # k = 3 'same', input run wrapping the ring
    Case("k2d_k3_wrap", "ring_conv_k2d_q", 120,
         _k2d(8, 6, 3, 20, 3, 1, "same", 8, 6, 96, 30, "relu")),
    # 'valid' padding, stride 2, two input segments per pixel
    Case("k2d_valid_s2", "ring_conv_k2d_q", 210,
         _k2d(9, 7, 130, 5, 3, 2, "valid", 4, 3, 140, 75, None)),
    Case("dw_valid_s2", "ring_conv_dw_q", 144,
         _dw(9, 9, 70, 3, 2, "valid", 4, 4, 108, 60, "relu")),
    # the top slice of a partially executed 'same' conv
    Case("dw_same_top", "ring_conv_dw_q", 100,
         _dw(7, 5, 64, 3, 1, "same_top", 6, 5, 50, 0, "relu")),
    # DS-CNN's shift (out row p onto in row p - 1), across the wrap
    Case("dw_wrap_shifted", "ring_conv_dw_q", 40,
         _dw(6, 4, 32, 3, 1, "same", 6, 4, 28, 24, "relu")),
    Case("pw_stride2", "ring_conv_pw_q", 60,
         _pw(8, 6, 40, 72, 2, False, 4, 3, 30, 18, None)),
    Case("pw_resample", "ring_conv_pw_q", 80,
         _pw(7, 5, 20, 140, 1, True, 3, 4, 60, 24, "relu")),
    # the executor's _pw_row_block gives 4 here (kernel_block_rows 8)
    Case("pw_row_block", "ring_conv_pw_q", 48,
         _pw(8, 4, 64, 64, 1, False, 8, 4, 16, 16, "relu", rb=4)),
    Case("pw_inplace_wrap", "ring_conv_pw_q", 25,
         _pw(5, 5, 64, 64, 1, False, 5, 5, 15, 15, "relu")),
    Case("gemm_block_rows", "ring_gemm_q", 48,
         dict(m_rows=8, d_in=200, d_out=130, in_ptr=32, out_ptr=0,
              block_rows=4, activation="relu")),
    Case("gemm_wrap", "ring_gemm_q", 16,
         dict(m_rows=6, d_in=64, d_out=12, in_ptr=12, out_ptr=4,
              block_rows=2, activation=None)),
    # weights too large for shared memory: read from global memory
    Case("gemm_weights_global", "ring_gemm_q", 32,
         dict(m_rows=2, d_in=1000, d_out=240, in_ptr=16, out_ptr=0,
              block_rows=1, activation="relu")),
    # input run wrapping, and the store at a pointer past the ring's end
    Case("avgpool_wrap", "ring_avgpool_q", 40,
         dict(h=3, w=4, c=200, in_ptr=24, out_ptr=42,
              mult=quantize_multiplier(0.9 / 12)[0],
              shift=quantize_multiplier(0.9 / 12)[1])),
    # in place, the input run wrapping the ring, the residual elsewhere
    Case("add_inplace_wrap", "ring_add_q", 64,
         _add(24, 100, 52, 20, 52, 0.7, 1.3, "relu")),
    # out_ptr one chunk below in_ptr: row t lands on input row t - 1
    Case("add_shifted", "ring_add_q", 80,
         _add(12, 200, 40, 10, 38, 1.1, 0.45, None)),
    # both operands requantize to the 2**24 clip: the int32 sum is +-2**25
    Case("add_saturating", "ring_add_q", 32,
         dict(_add(8, 64, 0, 8, 16, 1.0, 1.0, None), **SATURATE)),
    # more rows than one shared-memory tile (908 one-segment rows), shifted
    Case("add_tiles_shifted", "ring_add_q", 2048,
         _add(1000, 16, 1048, 0, 1047, 0.9, 0.6, "relu")),
    # hop 2 (the test_stream.py chain geometry); the output lands on the
    # frame's rows, which the kernel has read
    Case("stream_hop2", "ring_conv_stream_q", 60,
         _stream(6, 5, 8, 16, 3, 1, 2, 6, 5, 20, 0, 30, "relu")),
    # stride 2, two output segments per pixel, the output run wrapping
    Case("stream_out_wraps", "ring_conv_stream_q", 120,
         _stream(6, 5, 20, 140, 3, 2, 1, 3, 3, 90, 114, 60, None)),
    # two input segments per pixel, out_ptr past the ring's end
    Case("gru_wide_input", "ring_gru_cell_q", 20, _gru(130, 40, 4, 25, 19)),
    # Q12 biases near the int32 limits: gx + b wraps
    Case("gru_bias_wraps", "ring_gru_cell_q", 8, _gru(64, 64, 2, 3, 6),
         _gru_params(64, 64, seed=5, bias=1 << 12)),
)


def _f32(case: Case, name: str, **kwargs) -> Case:
    """The fp32 twin of an int8 edge case, with ``kwargs`` changed."""
    kw = {k: v for k, v in case.kwargs.items()
          if not k.startswith(("mult", "shift"))}
    return Case(name, _base(case.kernel), case.n_seg, {**kw, **kwargs})


_EDGE = {c.name: c for c in EDGE_CASES}

F32_EDGE_CASES = (
    _f32(_EDGE["k2d_k3_wrap"], "f32_k2d_k3_wrap"),
    _f32(_EDGE["k2d_valid_s2"], "f32_k2d_valid_s2"),
    _f32(_EDGE["dw_valid_s2"], "f32_dw_valid_s2"),
    _f32(_EDGE["dw_same_top"], "f32_dw_same_top", activation="silu"),
    _f32(_EDGE["dw_wrap_shifted"], "f32_dw_wrap_shifted"),
    _f32(_EDGE["pw_stride2"], "f32_pw_stride2_gelu", activation="gelu"),
    _f32(_EDGE["pw_resample"], "f32_pw_resample_silu", activation="silu"),
    _f32(_EDGE["pw_row_block"], "f32_pw_row_block_square",
         activation="square"),
    _f32(_EDGE["pw_inplace_wrap"], "f32_pw_inplace_wrap"),
    _f32(_EDGE["gemm_block_rows"], "f32_gemm_block_rows_gelu",
         activation="gelu"),
    _f32(_EDGE["gemm_wrap"], "f32_gemm_wrap_silu", activation="silu"),
    _f32(_EDGE["gemm_wrap"], "f32_gemm_wrap_square", activation="square"),
    # 960,000 B of fp32 weights: read from global memory
    _f32(_EDGE["gemm_weights_global"], "f32_gemm_weights_global"),
    Case("f32_avgpool_wrap", "ring_avgpool", 40,
         dict(h=3, w=4, c=200, in_ptr=24, out_ptr=42)),
    _f32(_EDGE["add_inplace_wrap"], "f32_add_inplace_wrap"),
    _f32(_EDGE["add_shifted"], "f32_add_shifted_gelu", activation="gelu"),
    _f32(_EDGE["add_saturating"], "f32_add_square", activation="square"),
    _f32(_EDGE["add_saturating"], "f32_add_silu", activation="silu"),
    # three shared-memory tiles (223 two-segment rows each), shifted: row
    # t lands on input row t - 1; the residual rows lie below them all
    Case("f32_add_tiles_shifted", "ring_add", 2048,
         dict(rows=500, d=130, in_ptr=1010, aux_ptr=0, out_ptr=1008,
              activation="relu")),
)

#: Edge cases of the fp32 fused inverted bottleneck, streaming conv and
#: GRU cell.  Every image row of the bottleneck lies whole inside the ring
#: (the reference copies a row as one run that does not wrap).
F32_FUSED_STREAM_EDGE_CASES = (
    # no residual, C_in != C_out (as MCUNet-VWW's 24 -> 144 -> 16 op), in
    # place: row p's store narrows A row p after step p - 1 expanded it
    Case("f32_ib_narrowing_inplace", "ring_inverted_bottleneck", 40,
         _ib(6, 5, 24, 144, 16, 10, 10, False)),
    # out row p onto A row p - 1, both runs wrapping the ring
    Case("f32_ib_shifted_wrap", "ring_inverted_bottleneck", 50,
         _ib(7, 5, 32, 96, 32, 30, 25, True)),
    # a one-row image: the halo primes row 0 twice and masks the rest
    Case("f32_ib_one_row", "ring_inverted_bottleneck", 8,
         _ib(1, 4, 8, 40, 8, 4, 0, True)),
    # hop 2 and c_in 3; the output lands on the frame's rows
    Case("f32_stream_hop2_c3", "ring_conv_stream", 60,
         _stream(6, 5, 3, 16, 3, 1, 2, 6, 5, 20, 0, 30, "gelu")),
    _f32(_EDGE["stream_out_wraps"], "f32_stream_out_wraps"),
    # d_h not a multiple of 128, two input segments, out_ptr past the end
    _f32(_EDGE["gru_wide_input"], "f32_gru_wide_input"),
    Case("f32_gru_d_h_72", "ring_gru_cell", 12, _gru(64, 72, 2, 3, 6)),
)


def _mlp(m, d, ptr, ff_tile, gated, residual, act, block_rows=1):
    return dict(m_rows=m, d_model=d, ptr=ptr, block_rows=block_rows,
                ff_tile=ff_tile, gated=gated, residual=residual,
                activation=act)


def _ew(m, d, ptr, fn):
    return dict(m_rows=m, d=d, ptr=ptr, fn=fn, block_rows=1)


#: Edge cases of the fp32 fused MLP and elementwise map (both delta 0, in
#: place).  The fused MLP's kernel runs one block per 16 rows (8 at d_model
#: 1152), so every case with more than 16 rows runs several blocks at once.
F32_MLP_EDGE_CASES = (
    # the conformance-matrix cell (tests/test_conformance_matrix.py)
    Case("f32_mlp_conformance_cell", "ring_fused_mlp", 16,
         _mlp(8, 256, 0, 256, True, True, "gelu", block_rows=8), d_ff=512),
    # gated silu over three blocks of rows
    Case("f32_mlp_gated_silu", "ring_fused_mlp", 48,
         _mlp(40, 128, 4, 128, True, True, "silu"), d_ff=384),
    Case("f32_mlp_ungated_no_residual", "ring_fused_mlp", 40,
         _mlp(24, 96, 10, 128, False, False, "gelu"), d_ff=256),
    # two segments a row, 56 tail lanes each
    Case("f32_mlp_d200_tail", "ring_fused_mlp", 50,
         _mlp(20, 200, 6, 160, True, True, "gelu"), d_ff=320),
    # the run of rows wraps the ring inside the second block
    Case("f32_mlp_ring_wraps", "ring_fused_mlp", 64,
         _mlp(30, 160, 52, 256, True, True, "gelu"), d_ff=256),
    # one gemma3-1b geglu layer (d_model 1152, d_ff 6912, the planner's
    # ff_tile 432): 95.6 MB of weights; the wrapper shrinks its blocks to
    # 8 rows to fit shared memory
    Case("f32_mlp_gemma3_1b_geglu", "ring_fused_mlp", 160,
         _mlp(16, 1152, 16, 432, True, True, "gelu"), d_ff=6912),
    # every activation over a region that wraps the ring
    *(Case(f"f32_elementwise_{fn}_wrap", "ring_elementwise", 40,
           _ew(12, 200, 30, fn))
      for fn in ("gelu", "silu", "relu", "square", "identity")),
)


def mlp_tower_params(program, seed: int) -> list:
    """fp32 weights of an MLP tower plan (fused_mlp and elementwise ops),
    numpy, from one ``np.random.default_rng(seed)`` in op order: per
    fused_mlp op ``W_gate`` (gated ops only; ``None`` otherwise) and
    ``W_up`` ``[d, d_ff]`` from N(0, 1)/sqrt(d), then ``W_down`` ``[d_ff,
    d]`` from N(0, 1)/d_ff (the reference's init scale); ``None`` per
    elementwise op."""
    rng = np.random.default_rng(seed)
    params = []
    for op in program.ops:
        if op.kind == "elementwise":
            params.append(None)
            continue
        if op.kind != "fused_mlp":
            raise ValueError(f"an MLP tower has no {op.kind!r} op")
        d, f = op.d_in, op.d_ff
        wg = _normal(rng, (d, f), 1 / np.sqrt(d)) if op.gated else None
        wu = _normal(rng, (d, f), 1 / np.sqrt(d))
        params.append((wg, wu, _normal(rng, (f, d), 1 / f)))
    return params


def seeded_float_net(path, seed: int = 0):
    """A :class:`repro_torch.compile.driver.CompiledNet` from a float
    artifact saved without params, run with :func:`mlp_tower_params` of
    ``seed``."""
    from ..compile import artifact
    from ..compile.driver import CompiledNet
    from ..core.program import PoolProgram

    payload = artifact.load(path)
    program = PoolProgram.from_json_dict(payload["program"])
    return CompiledNet.from_payload(payload, where=path,
                                    params=mlp_tower_params(program, seed))


def program_cases(program, params, *, kernel_block_rows: int = 8,
                  prefix: str = "", kinds=None):
    """One case per op of ``program`` (of the op kinds ``kinds``, when
    given), with the op's real weights (``params``: an int8 program's
    qparams or an fp32 one's params, numpy; a missing bias becomes
    zeros); case names are ``<prefix>op<i>_<kind>``."""
    from ..core.executors import op_kernel_call

    cases = []
    for i, (op, p) in enumerate(zip(program.ops, params)):
        if kinds is not None and op.kind not in kinds:
            continue
        if op.kind == "fused_mlp" and p[0] is None:   # ungated: no gate
            p = (p[1], *p[1:])
        if p is not None and p[1] is None:     # a net without biases
            p = (p[0], np.zeros((op.d_out,), np.int32 if program.quantized
                                else np.float32), *p[2:])
        if op.kind == "gru_cell" and not program.quantized and p[2] is None:
            p = (*p[:2], np.zeros((3 * op.d_out,), np.float32))
        name, params, kwargs = op_kernel_call(
            program, op, p, kernel_block_rows=kernel_block_rows)
        cases.append(Case(f"{prefix}op{i:02d}_{op.kind}", name,
                          program.n_segments, kwargs, params))
    return tuple(cases)


def program_live_lanes(program, params, *,
                       kernel_block_rows: int = 8) -> np.ndarray:
    """:func:`live_lanes` of an fp32 program's final pool: the staged
    input, then every op's output in plan order."""
    regions = [(program.input_ptr, program.in_rows, program.in_dim)]
    for c in program_cases(program, params,
                           kernel_block_rows=kernel_block_rows):
        regions += output_regions(c.kernel, c.kwargs)
    return live_lanes(program.n_segments, regions)


def plain_pool(program, x, params, *, kernel_block_rows: int = 8):
    """The final pool of ``program`` run on input ``x`` through the
    plain versions on ``x``'s device (a CUDA one too): the whole-plan
    oracle the kernels' pool is held to.  ``x`` is one input, or a list
    of frames that a streaming program steps through on one persistent
    pool.  ``params`` are numpy arrays, as :func:`program_cases` takes
    them."""
    import torch

    from ..core.vpool import stage_rows
    from . import PLAIN

    frames = x if isinstance(x, (list, tuple)) else [x]
    device = frames[0].device
    spec = program.spec()
    pool = torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    calls = [(PLAIN[c.kernel], [torch.from_numpy(a).to(device)
                                for a in c.params], c.kwargs)
             for c in program_cases(program, params,
                                    kernel_block_rows=kernel_block_rows)]
    for frame in frames:
        stage_rows(pool, frame, program.input_ptr)
        for fn, weights, kwargs in calls:
            fn(pool, *weights, **kwargs)
    return pool


def input_regions(kernel: str, kw: dict) -> list[tuple[int, int, int]]:
    """``(ptr, rows, width)`` of each tensor the kernel reads."""
    kernel = _base(kernel)
    if kernel == "ring_gemm":
        return [(kw["in_ptr"], kw["m_rows"], kw["d_in"])]
    if kernel == "ring_avgpool":
        return [(kw["in_ptr"], kw["h"] * kw["w"], kw["c"])]
    if kernel == "ring_add":
        return [(kw["in_ptr"], kw["rows"], kw["d"]),
                (kw["aux_ptr"], kw["rows"], kw["d"])]
    if kernel == "ring_conv_stream":
        return [(kw["in_ptr"], kw["hop"] * kw["w_in"], kw["c_in"]),
                (kw["state_ptr"], kw["h_win"] * kw["w_in"], kw["c_in"])]
    if kernel == "ring_gru_cell":
        return [(kw["in_ptr"], 1, kw["d_in"]),
                (kw["state_ptr"], 1, kw["d_h"])]
    if kernel == "ring_inverted_bottleneck":
        return [(kw["in_ptr"], kw["H"] * kw["W"], kw["C_in"])]
    if kernel == "ring_fused_mlp":
        return [(kw["ptr"], kw["m_rows"], kw["d_model"])]
    if kernel == "ring_elementwise":
        return [(kw["ptr"], kw["m_rows"], kw["d"])]
    c = kw["c"] if kernel == "ring_conv_dw" else kw["c_in"]
    return [(kw["in_ptr"], kw["h_in"] * kw["w_in"], c)]


def output_regions(kernel: str, kw: dict) -> list[tuple[int, int, int]]:
    """``(ptr, rows, width)`` of each tensor an fp32 kernel computes (a
    streaming conv's window writeback is a copy and not among them; a
    GRU cell's new state is)."""
    kernel = _base(kernel)
    if kernel == "ring_gemm":
        return [(kw["out_ptr"], kw["m_rows"], kw["d_out"])]
    if kernel == "ring_avgpool":
        return [(kw["out_ptr"], 1, kw["c"])]
    if kernel == "ring_add":
        return [(kw["out_ptr"], kw["rows"], kw["d"])]
    if kernel == "ring_gru_cell":
        return [(kw["state_ptr"], 1, kw["d_h"]),
                (kw["out_ptr"], 1, kw["d_h"])]
    if kernel == "ring_inverted_bottleneck":
        return [(kw["out_ptr"], kw["H"] * kw["W"], kw["C_out"])]
    if kernel in ("ring_fused_mlp", "ring_elementwise"):
        return input_regions(kernel, kw)            # in place
    c = kw["c"] if kernel == "ring_conv_dw" else kw["c_out"]
    return [(kw["out_ptr"], kw["h_out"] * kw["w_out"], c)]


def live_lanes(n_seg: int, regions) -> np.ndarray:
    """``[n_seg, 128]`` mask of the lanes that hold live channels after
    the ``(ptr, rows, width)`` tensors ``regions`` are written into a
    ring in that order: each row's first ``width`` lanes, not its channel
    tails; a later tensor overrides an earlier one where they overlap."""
    mask = np.zeros((n_seg, SEG_WIDTH), bool)
    for ptr, rows, d in regions:
        segs = segments_for(d)
        lanes = np.zeros((rows, segs * SEG_WIDTH), bool)
        lanes[:, :d] = True
        mask[(ptr + np.arange(rows * segs)) % n_seg] = \
            lanes.reshape(rows * segs, SEG_WIDTH)
    return mask


def compare_f32(got, want, live) -> tuple[float, str | None]:
    """Hold an fp32 pool ``got`` to ``want``: within the tolerance on the
    ``live`` lanes, exactly everywhere else.  Returns the largest
    |difference| on the live lanes and ``None``, or a description of the
    first segment out of bounds."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got.astype(np.float64) - want)
    err = float(diff[live].max()) if live.any() else 0.0
    scale = float(np.abs(want[live]).max()) if live.any() else 0.0
    close = diff <= ATOL_REL * (scale or 1.0) + RTOL * np.abs(want)
    bad = np.where(live, ~close, got != want)
    if not bad.any():
        return err, None
    seg = int(bad.any(axis=1).nonzero()[0][0])
    what = "a live lane" if live[seg][bad[seg]].any() else \
        "a channel tail or an unwritten lane"
    return err, (f"first at segment {seg} ({what}; max |difference| on "
                 f"live lanes {err:.3g}, scale {scale:.3g})")


def _weight_shape(kernel: str, kw: dict) -> tuple[tuple[int, ...], int]:
    """Weight shape and reduction depth per output of a kernel."""
    kernel = _base(kernel)
    if kernel == "ring_gemm":
        return (kw["d_in"], kw["d_out"]), kw["d_in"]
    if kernel == "ring_conv_pw":
        return (kw["c_in"], kw["c_out"]), kw["c_in"]
    if kernel == "ring_conv_dw":
        return (kw["rs"], kw["rs"], kw["c"]), kw["rs"] ** 2
    k = kw["k"]
    return (k, k, kw["c_in"], kw["c_out"]), k * k * kw["c_in"]


def _gru_draw(rng, kw):
    """Seeded GRU weights and constants that put the Q12 gates around
    their linear regions (so the hard gates both clip and pass)."""
    d_in, d_h = kw["d_in"], kw["d_h"]
    g = 3 * d_h
    w = rng.integers(-127, 128, (d_in, g), dtype=np.int8)
    u = rng.integers(-127, 128, (d_h, g), dtype=np.int8)
    b = rng.integers(-(1 << 13), 1 << 13, (g,), dtype=np.int32)
    consts = []
    for depth in (d_in, d_h):
        s0 = -int(np.ceil(np.log2(np.sqrt(depth) * 4096 / 8192)))
        consts += [rng.integers(1 << 30, (1 << 31) - 1, (g,), dtype=np.int32),
                   rng.integers(s0 - 1, s0 + 2, (g,), dtype=np.int32)]
    return (w, u, b, *consts)


def _normal(rng, shape, scale):
    return (scale * rng.standard_normal(shape, np.float32)) \
        .astype(np.float32)


def _ib_draw(rng, kw):
    """Seeded fp32 bottleneck weights, He-scaled per reduction depth."""
    ci, cm, co, rs = kw["C_in"], kw["C_mid"], kw["C_out"], kw["RS"]
    return (_normal(rng, (ci, cm), np.sqrt(2 / ci)),
            _normal(rng, (rs, rs, cm), np.sqrt(2) / rs),
            _normal(rng, (cm, co), 1 / np.sqrt(cm)))


def _gru_f32_draw(rng, kw):
    """Seeded fp32 GRU weights whose gate pre-activations spread over
    about +-4, so the hard gates both clip and pass."""
    d_in, d_h = kw["d_in"], kw["d_h"]
    g = 3 * d_h
    return (_normal(rng, (d_in, g), 2 / np.sqrt(d_in)),
            _normal(rng, (d_h, g), 2 / np.sqrt(d_h)),
            _normal(rng, (g,), 0.5))


def _mlp_draw(rng, kw, d_ff: int):
    """Seeded fused-MLP weights.  ``W_down`` is N(0, 1)/sqrt(d_ff), not
    the reference's init scale 1/d_ff, so that the MLP's term is as large
    as the residual's and the tolerance does not hide an error in it.  An
    ungated op gets ``W_up`` in the gate's place, as the executor gives
    it."""
    d = kw["d_model"]
    wg = _normal(rng, (d, d_ff), 1 / np.sqrt(d)) if kw["gated"] else None
    wu = _normal(rng, (d, d_ff), 1 / np.sqrt(d))
    return (wu if wg is None else wg, wu,
            _normal(rng, (d_ff, d), 1 / np.sqrt(d_ff)))


def _f32_inputs(case: Case, rng):
    pool = rng.standard_normal((case.n_seg, SEG_WIDTH), np.float32)
    for ptr, rows, d in input_regions(case.kernel, case.kwargs):
        segs = segments_for(d)
        padded = np.zeros((rows, segs * SEG_WIDTH), np.float32)
        padded[:, :d] = rng.standard_normal((rows, d), np.float32)
        idx = (ptr + np.arange(rows * segs)) % case.n_seg
        pool[idx] = padded.reshape(rows * segs, SEG_WIDTH)
    if case.params is not None:
        return pool, tuple(case.params)
    if case.kernel in ("ring_avgpool", "ring_add", "ring_elementwise"):
        return pool, ()
    if case.kernel == "ring_fused_mlp":
        return pool, _mlp_draw(rng, case.kwargs, case.d_ff)
    if case.kernel == "ring_inverted_bottleneck":
        return pool, _ib_draw(rng, case.kwargs)
    if case.kernel == "ring_gru_cell":
        return pool, _gru_f32_draw(rng, case.kwargs)
    shape, depth = _weight_shape(case.kernel, case.kwargs)
    w = (rng.standard_normal(shape, np.float32) / np.sqrt(depth)) \
        .astype(np.float32)
    b = (0.1 * rng.standard_normal((shape[-1],), np.float32)) \
        .astype(np.float32)
    return pool, (w, b)


def case_inputs(case: Case, seed: int = 0):
    """``(pool, params)`` as numpy arrays: an int8 (fp32) ``[n_seg, 128]``
    pool for an int8 (fp32) kernel and the kernel's weight operands
    (``()`` for add and avgpool)."""
    rng = np.random.default_rng([seed, zlib.crc32(case.name.encode())])
    if is_f32(case.kernel):
        return _f32_inputs(case, rng)
    pool = rng.integers(-128, 128, (case.n_seg, SEG_WIDTH), dtype=np.int8)
    for ptr, rows, d in input_regions(case.kernel, case.kwargs):
        x = rng.integers(-128, 128, (rows, d), dtype=np.int8)
        segs = segments_for(d)
        padded = np.zeros((rows, segs * SEG_WIDTH), np.int8)
        padded[:, :d] = x
        idx = (ptr + np.arange(rows * segs)) % case.n_seg
        pool[idx] = padded.reshape(rows * segs, SEG_WIDTH)
    if case.params is not None:
        return pool, tuple(case.params)
    if case.kernel in ("ring_avgpool_q", "ring_add_q"):
        return pool, ()
    if case.kernel == "ring_gru_cell_q":
        return pool, _gru_draw(rng, case.kwargs)
    shape, depth = _weight_shape(case.kernel, case.kwargs)
    c_out = shape[-1]
    w = rng.integers(-127, 128, shape, dtype=np.int8)
    b = rng.integers(-(1 << 12), 1 << 12, (c_out,), dtype=np.int32)
    mult = rng.integers(1 << 30, (1 << 31) - 1, (c_out,), dtype=np.int32)
    # shifts that put the typical accumulator (sqrt(depth) * 64**2
    # in magnitude) around the int8 range, so outputs mix rounding and
    # saturation
    s0 = -int(np.ceil(np.log2(np.sqrt(depth) * 4096 / 64)))
    shift = rng.integers(s0 - 1, s0 + 2, (c_out,), dtype=np.int32)
    return pool, (w, b, mult, shift)
