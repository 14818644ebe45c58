"""Parity cases for the ring kernels.

A :class:`Case` is one kernel call at one geometry: the kernel's name,
the pool length and its keyword arguments.  :func:`case_inputs` draws a
seeded pool (garbage everywhere, the input rows staged with zero channel
tails, as a ring holds them) and, unless the case carries real weights,
seeded weights and requant constants.  Everything is numpy, so the same
inputs can go to the reference's Pallas kernels, to the plain versions
and to the CUDA kernels.

:data:`EDGE_CASES` are the geometries the DS-CNN plan does not reach
(wrapping runs, other strides, paddings and blockings);
:func:`program_cases` gives one case per op of a real program, with its
real weights.  Every in/out overlap here is one a certified plan allows:
no output row lands on an input row a later step still reads.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from ..core.vpool import SEG_WIDTH, segments_for
from ..quant.requant import quantize_multiplier


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    kernel: str           # wrapper name, e.g. "ring_conv_dw_q"
    n_seg: int
    kwargs: dict
    params: tuple | None = None   # real weights, or None to draw them


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
)


def program_cases(program, qparams, *, kernel_block_rows: int = 8):
    """One case per op of ``program``, with the op's real weights."""
    from ..core.executors import op_kernel_call

    cases = []
    for i, (op, p) in enumerate(zip(program.ops, qparams)):
        name, params, kwargs = op_kernel_call(
            program, op, p, kernel_block_rows=kernel_block_rows)
        cases.append(Case(f"op{i:02d}_{op.kind}", name, program.n_segments,
                          kwargs, params))
    return tuple(cases)


def input_region(kernel: str, kw: dict) -> tuple[int, int, int]:
    """``(ptr, rows, width)`` of the tensor the kernel reads."""
    if kernel == "ring_gemm_q":
        return kw["in_ptr"], kw["m_rows"], kw["d_in"]
    if kernel == "ring_avgpool_q":
        return kw["in_ptr"], kw["h"] * kw["w"], kw["c"]
    c = kw["c"] if kernel == "ring_conv_dw_q" else kw["c_in"]
    return kw["in_ptr"], kw["h_in"] * kw["w_in"], c


def _weight_shape(kernel: str, kw: dict) -> tuple[tuple[int, ...], int]:
    """Weight shape and reduction depth per output of a kernel."""
    if kernel == "ring_gemm_q":
        return (kw["d_in"], kw["d_out"]), kw["d_in"]
    if kernel == "ring_conv_pw_q":
        return (kw["c_in"], kw["c_out"]), kw["c_in"]
    if kernel == "ring_conv_dw_q":
        return (kw["rs"], kw["rs"], kw["c"]), kw["rs"] ** 2
    k = kw["k"]
    return (k, k, kw["c_in"], kw["c_out"]), k * k * kw["c_in"]


def case_inputs(case: Case, seed: int = 0):
    """``(pool, params)`` as numpy arrays: an int8 ``[n_seg, 128]`` pool
    and the kernel's weight operands (``()`` for avgpool)."""
    rng = np.random.default_rng([seed, zlib.crc32(case.name.encode())])
    pool = rng.integers(-128, 128, (case.n_seg, SEG_WIDTH), dtype=np.int8)
    ptr, rows, d = input_region(case.kernel, case.kwargs)
    x = rng.integers(-128, 128, (rows, d), dtype=np.int8)
    segs = segments_for(d)
    padded = np.zeros((rows, segs * SEG_WIDTH), np.int8)
    padded[:, :d] = x
    idx = (ptr + np.arange(rows * segs)) % case.n_seg
    pool[idx] = padded.reshape(rows * segs, SEG_WIDTH)
    if case.params is not None:
        return pool, tuple(case.params)
    if case.kernel == "ring_avgpool_q":
        return pool, ()
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
