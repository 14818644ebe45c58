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
and wrapping int32 sums, streaming windows with ``hop`` 2), and
:data:`CARD_EDGE_CASES` three too large to run through the reference
on the CPU;
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
serves such a plan from its params-less artifact.  :func:`lm_params` is
the same kind of recipe for a whole decoder LM's params tree (gemma3-1b's
is 5.2 GB in fp32).

:data:`DECODE_CASES` are the geometries of the decode attention over a
ring KV cache (:class:`DecodeCase`, inputs from :func:`decode_inputs`):
the reference's kernel-test grid in fp32, its softcap case, gemma3-1b's
bf16 local ring (also at batch 1) and a global cache whose length is no
multiple of the kernel's block, the serve path's 1,024-slot global cache
at batch 4 with whole splits past seq_len, and a batch of 4 in one
launch; :func:`compare_decode`
holds them (fp32 within 2e-5, bf16 within one bf16 ulp of the output's
scale).

An int8 kernel is held to its plain version bitwise.  An fp32 kernel is
held by :func:`compare_f32` at the one tolerance :data:`RTOL` and
:data:`ATOL_REL` (the reference's conformance-matrix rule): within it on
the live channels of the rows the call writes, and exactly everywhere
else (channel tails and segments the call does not write).

Every in/out overlap here but seven is one a certified plan allows: no
output row lands on an input row (or residual row) a later step still
reads, and no output lands on a streaming state region.  The reference
kernels in interpret mode read an unaliased copy of the pool, and the
plain versions read every input before they store, so an overlap no
plan has would set them apart from a kernel that walks the ring in
order.  The exceptions are the fp32 and int8 depthwise and k x k convs
in place (``f32_dw_inplace*``, ``f32_k2d_inplace``, ``dw_inplace_uneven``,
``k2d_inplace_uneven``) and the fp32 and int8 streams whose output
overlaps the window (``f32_stream_out_over_window``,
``stream_q_out_over_window``): those kernels read all of an
op's input before any CTA stores, so they too must match the plain
version there, where a kernel that walks the rows in order does not.  A
store before their grid barrier shows when it lands while another CTA
still reads: reliably in ``f32_dw_inplace_uneven``, whose short last
tile finishes first (``dw_inplace_uneven`` and ``k2d_inplace_uneven``
are built the same way).  The pointwise conv in place
(``f32_pw_inplace_uneven``, ``f32_pw_s2_inplace_uneven`` and their int8
twins ``pw_inplace_uneven``, ``pw_s2_inplace_uneven``: a plan's
overlap, each output row landing on an input row read earlier in the
walk but by another CTA) is such a case too
(``tests/test_torch_pw_mlp_tiles.py`` and
``tests/test_torch_q_conv_tiles.py`` model it).  The
fp32 add and stream cases ``f32_add_shifted_uneven``,
``f32_add_out_on_residual``, ``f32_stream_dscnn_out_on_frame`` and
``f32_stream_out_over_window`` store onto rows that another CTA of the
op reads (and the last, onto the window another CTA stores), so a
kernel without its grid barrier may differ there
(``tests/test_torch_add_stream_tiles.py`` models it); so do the int8
``add_shifted``, ``add_tiles_shifted``, ``add_shifted_uneven`` and
``add_out_on_residual``, and :data:`CARD_EDGE_CASES`' card-sized
``add_shifted_card``, the adds on which ``ring_add_q`` takes its
barrier (``tests/test_torch_q_dw_add_tiles.py`` models them).  So may
the fused bottleneck in place (a plan's overlap: every VWW bottleneck runs in
place) on ``f32_ib_inplace_uneven``, whose short last tile stores onto
the rows its neighbour's last sub-tile reads
(``tests/test_torch_ib_tiles.py`` models it), and the fp32 FC on
``f32_gemm_inplace_uneven`` and ``f32_gemm_widen`` (plans' overlaps:
every ToyADMOS layer but the last runs in place), whose CTAs store onto
input channels that other CTAs read (``tests/test_torch_gemm_tiles.py``
models it); so may their int8 twins ``gemm_q_inplace_uneven`` and
``gemm_q_widen``, and the int8 stream on ``stream_q_uneven``, whose short
last CTA copies a window row back onto the source of the row its
neighbour still reads (``tests/test_torch_q_stream_gemm_tiles.py`` models
them); so may the int8 GRU cell's channel tiles on ``gru_q_inplace`` (the
GRU chain's overlap: h' lands on x and on h, which every tile reads;
``tests/test_torch_q_pool_gru_tiles.py`` models it) and the fp32 cell's
on ``f32_gru_inplace`` and ``f32_gru_wide``
(``tests/test_torch_pool_gru_tiles.py`` models them).
"""
from __future__ import annotations

import dataclasses
import math
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


def _ib(h, w, ci, cm, co, i, o, residual, rs=3):
    return dict(H=h, W=w, C_in=ci, C_mid=cm, C_out=co, RS=rs, in_ptr=i,
                out_ptr=o, residual=residual)


def _avgpool(h, w, c, i, o):
    """A pool whose mult and shift fold in 0.9 / (h * w)."""
    mult, shift = quantize_multiplier(0.9 / (h * w))
    return dict(h=h, w=w, c=c, in_ptr=i, out_ptr=o, mult=mult, shift=shift)


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
    # in place (out_ptr == in_ptr), an overlap no certified plan has: at
    # 132 SMs 16 row blocks of 3 rows x 8 channel tiles (128 CTAs), the
    # last block rows 45-46, so its CTAs finish first; they store row 45
    # while the CTAs of rows 42-44 still read it; the input run wraps
    Case("k2d_inplace_uneven", "ring_conv_k2d_q", 400,
         _k2d(47, 8, 64, 64, 3, 1, "same", 47, 8, 200, 200, "relu")),
    # in place, two input segments a pixel onto one output segment: output
    # row p lands on input row p / 2.  At 132 SMs 16 row blocks of 3 rows x
    # 8 channel tiles, the last block rows 45-46, so its CTAs finish first;
    # they store onto input rows 22-23, which the CTAs of rows 21-23 read;
    # the input run wraps the ring
    Case("pw_inplace_uneven", "ring_conv_pw_q", 800,
         _pw(47, 8, 200, 64, 1, False, 47, 8, 400, 400, "relu")),
    # in place, stride 2, one segment a pixel (ResNet-8's and VWW's shortcut
    # widths): output row p lands on input row p / 2.  At 132 SMs 14 row
    # blocks of 5 rows x 8 channel tiles (112 CTAs), the last block rows
    # 65-66; they store onto input row 32, the source row of output row 16,
    # which the CTAs of rows 15-19 read
    Case("pw_s2_inplace_uneven", "ring_conv_pw_q", 600,
         _pw(134, 4, 16, 32, 2, False, 67, 2, 100, 100, None)),
    # in place, an overlap no certified plan has: at 132 SMs 24 row blocks
    # of 2 rows x 3 channel tiles (72 CTAs), the last block row 46 alone, so
    # its CTAs finish first; they store row 46 while the CTAs of rows 44-45
    # still read it.  The input run wraps the ring between whole rows
    Case("dw_inplace_uneven", "ring_conv_dw_q", 1152,
         _dw(47, 8, 384, 3, 1, "same", 47, 8, 48, 48, "relu")),
    # row t lands on input row t - 1 (a barrier is needed): at 132 SMs 131
    # CTAs of 2 rows and a last one of 1, which finishes first; it stores
    # row 262 onto input row 261, which the CTA of rows 260-261 reads.  Both
    # runs wrap the ring; 40 channels end inside a 16-byte vector
    Case("add_shifted_uneven", "ring_add_q", 600,
         _add(263, 40, 500, 200, 499, 0.8, 1.2, "relu")),
    # two segments a row, tiled as above: row t lands on residual row t - 1,
    # which the CTA of the rows before reads
    Case("add_out_on_residual", "ring_add_q", 1200,
         _add(263, 130, 0, 600, 598, 1.3, 0.7, None)),
    # ToyADMOS's 640-wide layer in place, 132 outputs a row (the int8 twin
    # of f32_gemm_inplace_uneven): at 132 SMs 2 row blocks x 9 column tiles
    # of 16, the last 4 columns wide, so its CTA finishes first; it stores
    # lanes 128 .. 255 of row 1's output (segment 13), channels 384 .. 511
    # of row 0's input, while the CTAs of row 0 still read them
    Case("gemm_q_inplace_uneven", "ring_gemm_q", 20,
         dict(m_rows=2, d_in=640, d_out=132, in_ptr=10, out_ptr=10,
              block_rows=1, activation="relu")),
    # ToyADMOS's last layer, 128 -> 640, onto a shifted pointer (the twin
    # of f32_gemm_widen): row 1's output wraps the ring onto segments 0 ..
    # 4, over both rows' inputs (80 CTAs of 1 row x 16 columns)
    Case("gemm_q_widen", "ring_gemm_q", 20,
         dict(m_rows=2, d_in=128, d_out=640, in_ptr=0, out_ptr=15,
              block_rows=1, activation=None)),
    # the reference's int8 ImageNet head (mcunet-320kb-imagenet on
    # cortex-m7: 96 -> 1000, in_ptr 594, out_ptr 584 on its 31,680-segment
    # ring) on a 600-segment ring; 96,000 B of weights over 63 CTAs
    Case("gemm_q_head_1000", "ring_gemm_q", 600,
         dict(m_rows=1, d_in=96, d_out=1000, in_ptr=594, out_ptr=584,
              block_rows=1, activation=None)),
    # 133 output rows at 132 SMs: 67 CTAs of 2 rows, the last one row
    # (row 132), so it finishes first; it also owns window row 132 (2 rows
    # a CTA) and stores it onto old state row 132, the source of window
    # row 131, which its neighbour (rows 130-131) still reads
    Case("stream_q_uneven", "ring_conv_stream_q", 600,
         _stream(133, 2, 4, 4, 3, 1, 1, 133, 2, 580, 0, 300, "relu")),
    # the output run overlaps the window region, an overlap no plan has:
    # the reference stores the window first, so the output wins there
    Case("stream_q_out_over_window", "ring_conv_stream_q", 80,
         _stream(6, 5, 8, 16, 3, 1, 2, 6, 5, 0, 40, 30, "relu")),
    # in place (out_ptr == in_ptr, as every plan's pool), the input run of
    # 125 one-segment pixels wrapping the ring, 100 channels (no multiple
    # of 16: the last vector of a pixel is part tail)
    Case("avgpool_q_inplace_wrap", "ring_avgpool_q", 150,
         _avgpool(25, 5, 100, 100, 100)),
    # 8 segments a pixel: 64 vectors, 4 pixel groups of 12-13 pixels a
    # thread; in place, the input run wrapping the ring
    Case("avgpool_q_wide", "ring_avgpool_q", 448,
         _avgpool(7, 7, 1000, 336, 336)),
    # the GRU chain's overlap: h' lands on x (out_ptr == in_ptr), the
    # state elsewhere
    Case("gru_q_inplace", "ring_gru_cell_q", 12, _gru(64, 64, 2, 2, 9)),
    # d_h 70 (the int8 twin of f32_gru_d_h_72): 3 d_h = 210 is no
    # multiple of 4, so W and U are staged byte by byte, and the last word
    # of h' is half channel tail
    Case("gru_q_d_h_70", "ring_gru_cell_q", 12, _gru(64, 70, 2, 3, 6)),
    # 98,304 B of W and U (four times the GRU chain's), in place
    Case("gru_q_wide", "ring_gru_cell_q", 8, _gru(128, 128, 2, 2, 5)),
)

#: Int8 edge cases too large for the reference's Pallas kernel in interpret
#: mode on the CPU: only ``chip_smoke.py`` and the ``gpu`` tests of
#: ``tests/test_torch_gpu.py`` hold them against the plain version, on the
#: card.
CARD_EDGE_CASES = (
    # 8,385 rows over 132 CTAs, 64 each but the last, which has one and
    # finishes first; row t lands on input row t - 1, which the CTA of the
    # rows before reads last; the input run wraps the ring (the geometry of
    # f32_add_shifted_uneven, which caught an fp32 add without its barrier
    # on the card where a few hundred rows did not)
    Case("add_shifted_card", "ring_add_q", 17000,
         _add(8385, 16, 9000, 400, 8999, 0.9, 1.1, "relu")),
    # 2,025 one-segment pixels (259,200 B): the pool's CTA stages them in
    # two chunks (1,808 and 217 pixels); in place, the input run wrapping
    # the ring
    Case("avgpool_q_chunks_card", "ring_avgpool_q", 2115,
         _avgpool(45, 45, 128, 90, 90)),
    # 9,000 channels (71 segments, 568 vectors a pixel, more than the CTA's
    # 512 threads): staged a vector a thread in turn, in chunks of 18
    # pixels; in place, the input run wrapping the ring
    Case("avgpool_q_wide_card", "ring_avgpool_q", 3976,
         _avgpool(7, 7, 9000, 2485, 2485)),
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
    # in place (out_ptr == in_ptr), an overlap no certified plan has: only
    # a kernel whose every read precedes every store matches the plain
    # version (6 and 40 CTAs)
    Case("f32_dw_inplace", "ring_conv_dw", 48,
         _dw(6, 4, 32, 3, 1, "same", 6, 4, 24, 24, "relu")),
    # in place with uneven tiles: 2 rows a tile over 3 channel tiles, the
    # last tile one row, so its CTA finishes first; it must not store row 46
    # while the CTA of rows 44-45 still reads it
    Case("f32_dw_inplace_uneven", "ring_conv_dw", 1152,
         _dw(47, 8, 384, 3, 1, "same", 47, 8, 24, 24, "relu")),
    Case("f32_k2d_inplace", "ring_conv_k2d", 144,
         _k2d(8, 6, 3, 20, 3, 1, "same", 8, 6, 96, 96, "relu")),
    # c_out 140, two output segments per pixel (the last channel tile
    # stores the 116-lane tail), stride 2, the input run wrapping the ring
    Case("f32_k2d_c140_s2_wrap", "ring_conv_k2d", 168,
         _k2d(9, 7, 20, 140, 3, 2, "same", 5, 4, 140, 40, "gelu")),
    # 45 rows x 3 channel tiles: 2 rows per tile (69 CTAs on 132 SMs), 1,024
    # outputs per CTA over 512 threads; the output run wraps the ring
    Case("f32_dw_row_blocks_wrap", "ring_conv_dw", 1200,
         _dw(45, 4, 260, 3, 1, "same", 45, 4, 300, 960, "relu")),
    # 8,385 rows over 132 CTAs, 64 each but the last, which has one and
    # finishes first; row t lands on input row t - 1, which the CTA of the
    # rows before reads last; the input run wraps the ring
    Case("f32_add_shifted_uneven", "ring_add", 17000,
         dict(rows=8385, d=16, in_ptr=9000, aux_ptr=400, out_ptr=8999,
              activation="silu")),
    # two segments a row, 32 rows a CTA but the last, which has one: row
    # t lands on residual row t - 1, which the CTA of the rows before reads
    # last
    Case("f32_add_out_on_residual", "ring_add", 16800,
         dict(rows=4193, d=130, in_ptr=0, aux_ptr=8400, out_ptr=8398,
              activation="gelu")),
    # in place, stride 1, two input segments a pixel onto one output
    # segment: output row p lands on input row p / 2, which the CTA of
    # those rows reads.  At 132 SMs 16 row blocks of 3 rows x 8 channel
    # tiles, the last block 2 rows, so its CTAs finish first; the input run
    # wraps the ring
    Case("f32_pw_inplace_uneven", "ring_conv_pw", 800,
         _pw(47, 8, 200, 64, 1, False, 47, 8, 400, 400, "relu")),
    # in place, stride 2, one segment a pixel (ResNet-8's and VWW's shortcut
    # widths): output row p lands on input row p / 2; at 132 SMs 14 row
    # blocks of 5 rows x 8 channel tiles, the last block 2 rows
    Case("f32_pw_s2_inplace_uneven", "ring_conv_pw", 600,
         _pw(134, 4, 16, 32, 2, False, 67, 2, 100, 100, "silu")),
    # 256 x 256 weights (262,144 B, more than a CTA's shared memory): each
    # CTA stages its channel tile's slice
    Case("f32_pw_wide_weights", "ring_conv_pw", 64,
         _pw(4, 4, 256, 256, 1, False, 4, 4, 0, 32, "relu")),
    # ToyADMOS's 640-wide layer in place, 132 outputs a row: at 132 SMs 2
    # row blocks x 17 column tiles of 8, the last 4 columns wide, so its
    # CTA finishes first; it stores lanes 128 .. 255 of row 1's output
    # (segment 13), channels 384 .. 511 of row 0's input, while the CTAs
    # of row 0 still read them
    Case("f32_gemm_inplace_uneven", "ring_gemm", 20,
         dict(m_rows=2, d_in=640, d_out=132, in_ptr=10, out_ptr=10,
              block_rows=1, activation="relu")),
    # ToyADMOS's last layer, 128 -> 640, onto a shifted pointer: row 1's
    # output wraps the ring onto segments 0 .. 4, over both rows' inputs
    # (80 CTAs of 2 rows x 8 columns)
    Case("f32_gemm_widen", "ring_gemm", 20,
         dict(m_rows=2, d_in=128, d_out=640, in_ptr=0, out_ptr=15,
              block_rows=1, activation=None)),
    # 49 pixels of 1,280 channels (250,880 B, more than a CTA's shared
    # memory): the pool's CTA stages them in two chunks (43 and 6 pixels);
    # in place, the input run wrapping the ring
    Case("f32_avgpool_chunks", "ring_avgpool", 630,
         dict(h=7, w=7, c=1280, in_ptr=420, out_ptr=420)),
    # MobileNet's head width (256 channels, two segments a pixel), in
    # place, the input run wrapping the ring
    Case("f32_avgpool_inplace_256", "ring_avgpool", 42,
         dict(h=3, w=3, c=256, in_ptr=36, out_ptr=36)),
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
    # DS-CNN's stream geometry (100 CTAs on 132 SMs); output rows 10 and
    # 11 land on the frame, which other CTAs read for the window's last row
    Case("f32_stream_dscnn_out_on_frame", "ring_conv_stream", 700,
         _stream(49, 10, 1, 64, 5, 2, 1, 25, 5, 100, 50, 200, "silu")),
    # the output run overlaps the window region, an overlap no plan has:
    # the reference stores the window first, so the output wins there
    Case("f32_stream_out_over_window", "ring_conv_stream", 80,
         _stream(6, 5, 8, 16, 3, 1, 2, 6, 5, 0, 40, 30, "relu")),
    # in place, RS 5, C_mid 1024 (the weights too large to stage): at 132
    # SMs, 108 CTAs of 6 x 3 pixels in three 2 x 3 sub-tiles each, the last
    # row block one row in one sub-tile, so its CTA finishes first; it must
    # not store row 48 while the CTA of rows 42-47 still reads it for its
    # last sub-tile.  The input run wraps the ring between whole rows.
    Case("f32_ib_inplace_uneven", "ring_inverted_bottleneck", 1800,
         _ib(49, 36, 16, 1024, 16, 360, 360, True, rs=5)),
    # RS 7 at C_mid 240 (an ImageNet 11 x 11 op's widths, 121 CTAs of one
    # pixel, 180 KB of shared memory each): out row p onto A row p - 1,
    # both runs wrapping the ring
    Case("f32_ib_rs7_shifted_wrap", "ring_inverted_bottleneck", 176,
         _ib(11, 11, 40, 240, 40, 110, 99, True, rs=7)),
    # the GRU chain's overlap: h' lands on x (out_ptr == in_ptr), the state
    # elsewhere; the channel tiles need their grid barrier here
    _f32(_EDGE["gru_q_inplace"], "f32_gru_inplace"),
    # d_h 70: 3 d_h = 210 is no multiple of 4, so W's and U's rows are
    # staged a float at a time
    _f32(_EDGE["gru_q_d_h_70"], "f32_gru_d_h_70"),
    # 393,216 B of fp32 W and U, more than one CTA's shared memory: channel
    # tiles under the grid barrier; in place
    _f32(_EDGE["gru_q_wide"], "f32_gru_wide"),
)


def _mlp(m, d, ptr, ff_tile, gated, residual, act, block_rows=1):
    return dict(m_rows=m, d_model=d, ptr=ptr, block_rows=block_rows,
                ff_tile=ff_tile, gated=gated, residual=residual,
                activation=act)


def _ew(m, d, ptr, fn):
    return dict(m_rows=m, d=d, ptr=ptr, fn=fn, block_rows=1)


#: Edge cases of the fp32 fused MLP and elementwise map (both delta 0, in
#: place).  The fused MLP's first kernel runs one CTA per (block of rows,
#: sub-tile of an ff tile) (``fused_mlp.mlp_tiling``: 16-row blocks for all
#: of these), so every case runs many CTAs at once.
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
    # d_model 4096 (32 segments a row): more than a block of the old
    # kernel's shared memory held for x and its sum; the rows wrap the ring
    Case("f32_mlp_d4096", "ring_fused_mlp", 300,
         _mlp(8, 4096, 100, 128, True, True, "silu"), d_ff=256),
    # 100 rows, not a multiple of a 16-row block, two segments a row with
    # 64 tail lanes; the run of rows wraps the ring
    Case("f32_mlp_uneven_rows", "ring_fused_mlp", 240,
         _mlp(100, 192, 150, 256, False, True, "gelu"), d_ff=512),
    # d_model 130 and ff_tile 150: weight rows and sub-tiles off 16-byte
    # alignment, so the kernel copies them 4 bytes at a time
    Case("f32_mlp_unaligned", "ring_fused_mlp", 60,
         _mlp(24, 130, 8, 150, True, False, "gelu"), d_ff=300),
    # every activation over a region that wraps the ring
    *(Case(f"f32_elementwise_{fn}_wrap", "ring_elementwise", 40,
           _ew(12, 200, 30, fn))
      for fn in ("gelu", "silu", "relu", "square", "identity")),
    # a region that ends exactly at the ring's end: one run, none from 0
    Case("f32_elementwise_ends_at_ring_end", "ring_elementwise", 40,
         _ew(10, 200, 20, "gelu")),
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


#: The MCU target of each committed int8 plan, by its label: the
#: reference's compile of the zoo net for that target, written by
#: ``tests/test_torch_assets.py`` and served by ``chip_smoke.py``.  A
#: label ending in ``SLICED_SUFFIX`` is the net compiled with
#: ``partial="auto"``.  Every fp32 twin is compiled for ``host-sim``.
INT8_TARGETS = {"ds-cnn": "cortex-m4", "resnet-8": "cortex-m4",
                "mcunet-5fps-vww": "cortex-m4", "ad-toyadmos": "cortex-m4",
                "mobilenetv1-0.25": "cortex-m4",
                "mcunet-320kb-imagenet": "cortex-m7",
                "mcunet-320kb-imagenet-sliced": "cortex-m4",
                "ds-cnn-stream": "cortex-m4", "kws-gru-chain": "cortex-m4"}
SLICED_SUFFIX = "-sliced"


def int8_stem(label: str) -> str:
    """The asset stem of an int8 plan: ``<net>.<target>.int8``, with
    ``.sliced`` after it for a sliced plan."""
    target = INT8_TARGETS[label]
    if label.endswith(SLICED_SUFFIX):
        return f"{label.removesuffix(SLICED_SUFFIX)}.{target}.int8.sliced"
    return f"{label}.{target}.int8"


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


# ---------------------------------------------------------------------------
# The decoder LM: a seeded params tree, and the decode attention's cases.
# ---------------------------------------------------------------------------

#: Version of :func:`lm_params`'s recipe; a golden made from it records it.
LM_PARAMS_VERSION = 1


def _lm_norm(rng, cfg, lead: tuple) -> dict:
    """Norm params drawn as 0.1 N(0, 1), not the reference's zeros, so a
    misplaced norm vector shows."""
    p = {"scale": _normal(rng, lead + (cfg.d_model,), 0.1)}
    if cfg.norm == "layernorm":
        p["bias"] = _normal(rng, lead + (cfg.d_model,), 0.1)
    return p


def _lm_attn(rng, cfg, lead: tuple) -> dict:
    """An attention sub-layer: ln, w_q, w_k, w_v, w_o, post_ln."""
    d, s_in = cfg.d_model, 1 / math.sqrt(cfg.d_model)
    attn = {"ln": _lm_norm(rng, cfg, lead),
            "w_q": _normal(rng, lead + (d, cfg.q_dim), s_in),
            "w_k": _normal(rng, lead + (d, cfg.kv_dim), s_in),
            "w_v": _normal(rng, lead + (d, cfg.kv_dim), s_in),
            "w_o": _normal(rng, lead + (cfg.q_dim, d), s_in)}
    if cfg.post_norms:
        attn["post_ln"] = _lm_norm(rng, cfg, lead)
    return attn


def _lm_mlp(rng, cfg, lead: tuple, d_ff: int | None = None) -> dict:
    """A dense FFN: ln, w_gate (gated MLPs), w_up, w_down, post_ln."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s_in, s_out = 1 / math.sqrt(d), 1 / math.sqrt(f)
    ffn = {"ln": _lm_norm(rng, cfg, lead)}
    if cfg.mlp in ("geglu", "swiglu"):
        ffn["w_gate"] = _normal(rng, lead + (d, f), s_in)
    ffn["w_up"] = _normal(rng, lead + (d, f), s_in)
    ffn["w_down"] = _normal(rng, lead + (f, d), s_out)
    if cfg.post_norms:
        ffn["post_ln"] = _lm_norm(rng, cfg, lead)
    return ffn


def _lm_moe(rng, cfg, lead: tuple) -> dict:
    """An MoE FFN (``models/moe.py:25``): ln, router, the experts' gate,
    up and down, then the shared experts' gate, up and down."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_out = 1 / math.sqrt(d), 1 / math.sqrt(f)
    p = {"ln": _lm_norm(rng, cfg, lead),
         "router": _normal(rng, lead + (d, E), s_in),
         "moe_gate": _normal(rng, lead + (E, d, f), s_in),
         "moe_up": _normal(rng, lead + (E, d, f), s_in),
         "moe_down": _normal(rng, lead + (E, f, d), s_out)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_gate"] = _normal(rng, lead + (d, fs), s_in)
        p["shared_up"] = _normal(rng, lead + (d, fs), s_in)
        p["shared_down"] = _normal(rng, lead + (fs, d), s_out)
    return p


def _lm_rec(rng, cfg, lead: tuple) -> dict:
    """An RG-LRU mixer (``models/rglru.py:31``), its init's
    distributions: lambda U[0.9, 0.999), gates and conv 0.1 N(0, 1)."""
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    s = 1 / math.sqrt(d)
    return {"ln": _lm_norm(rng, cfg, lead),
            "lru_w_y": _normal(rng, lead + (d, w), s),
            "lru_w_x": _normal(rng, lead + (d, w), s),
            "lru_conv": _normal(rng, lead + (cfg.ssm_conv, w), 0.1),
            "lru_lambda": rng.uniform(0.9, 0.999, lead + (w,))
            .astype(np.float32),
            "lru_gate_a": _normal(rng, lead + (w,), 0.1),
            "lru_gate_i": _normal(rng, lead + (w,), 0.1),
            "lru_out": _normal(rng, lead + (w, d), 1 / math.sqrt(w))}


def _lm_ssm(rng, cfg, lead: tuple) -> dict:
    """A Mamba-2 mixer (``models/mamba2.py:29``): the projections and
    conv drawn, ``A_log``, ``dt_bias`` and the gated norm's scale zeros
    and ``D`` ones, as the reference's init sets them."""
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    s = 1 / math.sqrt(d)
    return {"ln": _lm_norm(rng, cfg, lead),
            "ssm_w_z": _normal(rng, lead + (d, di), s),
            "ssm_w_x": _normal(rng, lead + (d, di), s),
            "ssm_w_b": _normal(rng, lead + (d, G * N), s),
            "ssm_w_c": _normal(rng, lead + (d, G * N), s),
            "ssm_w_dt": _normal(rng, lead + (d, H), s),
            "ssm_conv": _normal(rng, lead + (cfg.ssm_conv, di + 2 * G * N),
                                0.1),
            "ssm_a_log": np.zeros(lead + (H,), np.float32),
            "ssm_dt_bias": np.zeros(lead + (H,), np.float32),
            "ssm_d": np.ones(lead + (H,), np.float32),
            "ssm_norm": np.zeros(lead + (di,), np.float32),
            "ssm_out": _normal(rng, lead + (di, d), 1 / math.sqrt(di))}


def _lm_block(rng, cfg, lead: tuple, kind: str = "full",
              dense_ff: int | None = None) -> dict:
    """One block's params (``lead`` = ``(g,)`` stacks a scan group),
    drawn in this order: the mixer (an attention block's ln, w_q, w_k,
    w_v, w_o, post_ln; a cross block's self then cross attention; a
    rec or ssm mixer), then the FFN (a dense one's ln, w_gate for gated
    MLPs, w_up, w_down, post_ln; an MoE one; none where d_ff is 0)."""
    if kind in ("full", "local", "global"):
        p = {"attn": _lm_attn(rng, cfg, lead)}
    elif kind == "cross":
        p = {"attn": _lm_attn(rng, cfg, lead),
             "xattn": _lm_attn(rng, cfg, lead)}
    elif kind == "rec":
        p = {"rec": _lm_rec(rng, cfg, lead)}
    elif kind == "ssm":
        p = {"ssm": _lm_ssm(rng, cfg, lead)}
    else:
        raise ValueError(kind)
    if cfg.d_ff:
        p["ffn"] = _lm_moe(rng, cfg, lead) \
            if cfg.n_experts and dense_ff is None \
            else _lm_mlp(rng, cfg, lead, dense_ff)
    return p


def lm_params(cfg, seed: int) -> dict:
    """An LM's params tree as numpy fp32 arrays, laid out as the
    reference's ``Model.init`` builds it (``transformer.py:301-342``:
    ``embed``, ``final_ln``, ``unembed`` where untied, ``lead``,
    ``groups`` — one subtree per pattern position stacked ``[g, ...]`` —
    ``rem`` and ``encoder``), from one ``np.random.default_rng(seed)``,
    tensor by tensor in this order: embed (N(0, 1) x 0.02), final_ln,
    unembed (as embed), each lead block (a dense FFN of ``d_ff * (top_k
    + n_shared)``), each pattern position's stacked block, each
    remainder block, the encoder's stacked blocks and final_ln.  Matmul
    weights take the reference's init scales (``common.py:186-200,
    231-245``, ``moe.py:25-45``, ``rglru.py:31-47``, ``mamba2.py:29-50``:
    1/sqrt(d) into the model width's products, 1/sqrt of the inner width
    out of it); norm scales are 0.1 N(0, 1); the recurrent blocks'
    vectors follow their init's distributions.  A dense attention LM's
    tree is the same, draw for draw, as before the other kinds were
    added (``LM_PARAMS_VERSION`` 1).  The same seed gives the same tree
    to the reference and to the port on every machine."""
    rng = np.random.default_rng(seed)
    g, rem = cfg.n_groups()
    lead = cfg.first_dense_layers
    if lead:
        g = (cfg.n_layers - lead) // len(cfg.pattern)
        rem = (cfg.n_layers - lead) % len(cfg.pattern)
    tree = {"embed": _normal(rng, (cfg.vocab, cfg.d_model), 0.02),
            "final_ln": _lm_norm(rng, cfg, ())}
    if not cfg.tie_embeddings:
        tree["unembed"] = _normal(rng, (cfg.vocab, cfg.d_model), 0.02)
    if lead:
        dense_ff = cfg.d_ff * (cfg.top_k + cfg.n_shared_experts)
        tree["lead"] = tuple(_lm_block(rng, cfg, (), cfg.pattern[0],
                                       dense_ff) for _ in range(lead))
    tree["groups"] = tuple(_lm_block(rng, cfg, (g,), kind)
                           for kind in cfg.pattern)
    tree["rem"] = tuple(_lm_block(rng, cfg, (), cfg.pattern[i])
                        for i in range(rem))
    if cfg.encoder_layers:
        tree["encoder"] = {
            "blocks": _lm_block(rng, cfg, (cfg.encoder_layers,), "full"),
            "final_ln": _lm_norm(rng, cfg, ())}
    return tree


def lm_memory(cfg, seed: int, batch: int):
    """Seeded memory for a config's cross blocks, ``[batch,
    memory_len, d_model]`` fp32 from N(0, 1): encoder frames (audio) or
    image tokens (VLM); None for a config without cross blocks."""
    if not cfg.memory_len():
        return None
    rng = np.random.default_rng([seed, 3])
    return _normal(rng, (batch, cfg.memory_len(), cfg.d_model), 1.0)


@dataclasses.dataclass(frozen=True)
class DecodeCase:
    """One call of the decode attention: q ``[q_heads, head_dim]`` and a
    ring ``[window, kv_heads, head_dim]`` (``batch`` 0, the reference's
    layout), or ``batch`` of them; ``seq_len`` an int or one per row."""

    name: str
    q_heads: int
    kv_heads: int
    head_dim: int
    window: int
    block: int
    seq_len: int | tuple
    batch: int = 0
    dtype: str = "float32"
    softcap: float | None = None
    q_scale: float = 1.0

    @property
    def kwargs(self) -> dict:
        return dict(window=self.window, block=self.block,
                    softcap=self.softcap)


#: The reference's kernel-test grid (``tests/test_kernels.py:66-81``, a T
#: that is a multiple of the window above it moved one on), its softcap
#: case (``:83-92``), gemma3-1b's shapes in bf16 (a local ring of 512
#: slots part full and wrapped, also at batch 1; a global cache of 1,000
#: slots, 7 blocks of 128 and a ragged one of 104; the serve path's
#: 1,024-slot global cache at batch 4, part full), and a batch of 4 in one
#: launch.
DECODE_CASES = (
    *(DecodeCase(f"decode_q{qh}_kv{kvh}_d{dh}_w{w}_b{b}_T{t}", qh, kvh, dh,
                 w, b, t)
      for qh, kvh, dh, w, b in ((8, 2, 64, 256, 64), (4, 4, 128, 128, 128),
                                (16, 1, 64, 512, 128))
      for t in (t0 + (t0 > w and t0 % w == 0)
                for t0 in (7, 100, 256, 512, 5000))),
    DecodeCase("decode_softcap50", 4, 2, 64, 128, 64, 1000, softcap=50.0,
               q_scale=10.0),
    DecodeCase("decode_gemma3_local_bf16_T300", 4, 1, 256, 512, 128, 300,
               dtype="bfloat16"),
    DecodeCase("decode_gemma3_local_bf16_T1000", 4, 1, 256, 512, 128, 1000,
               dtype="bfloat16"),
    DecodeCase("decode_gemma3_global_1000_bf16", 4, 1, 256, 1000, 128, 700,
               batch=1, dtype="bfloat16"),
    DecodeCase("decode_gemma3_global_1000_f32", 4, 1, 256, 1000, 128, 999,
               batch=1),
    DecodeCase("decode_gemma3_batch4_bf16", 4, 1, 256, 512, 128, 600,
               batch=4, dtype="bfloat16"),
    DecodeCase("decode_batch4_per_row_seq", 8, 2, 64, 256, 64,
               (1, 100, 256, 700), batch=4),
    # the serve path's local ring at batch 1 (32 splits of 16 slots on
    # 132 SMs), part full: a split ends inside it, the splits past it are
    # skipped
    DecodeCase("decode_gemma3_local_batch1_bf16", 4, 1, 256, 512, 128, 450,
               batch=1, dtype="bfloat16"),
    # the global cache at batch 4 (32 splits of 32 slots), 600 tokens in:
    # 13 whole splits past seq_len skipped
    DecodeCase("decode_gemma3_global_1024_batch4_bf16", 4, 1, 256, 1024,
               128, 600, batch=4, dtype="bfloat16"),
)


#: The decode attention at the geometries of the other block kinds' LMs
#: served on the card (bf16, batch 4): recurrentgemma-2b's local ring (10
#: q heads on one KV head, head_dim 256, 2,048 slots) wrapped;
#: granite-moe-1b-a400m's full cache (2 q heads per KV head, head_dim 64,
#: 1,024 slots) part full; whisper-tiny's cross memory (6 heads of 64
#: over 1,500 frames, always full: 11 blocks of 128 and a ragged one of
#: 92).
LM_DECODE_CASES = (
    DecodeCase("decode_recurrentgemma_local_2048_wrapped_batch4_bf16", 10, 1,
               256, 2048, 128, 2116, batch=4, dtype="bfloat16"),
    DecodeCase("decode_granite_moe_full_1024_batch4_bf16", 16, 8, 64, 1024,
               128, 616, batch=4, dtype="bfloat16"),
    DecodeCase("decode_whisper_cross_1500_batch4_bf16", 6, 6, 64, 1500, 128,
               1500, batch=4, dtype="bfloat16"),
)


#: The decode attention over a rank's slice of a cache split on
#: ``kv_seq``, called with ``return_lse``, at the slice geometries that
#: the sequence-parallel paths run: gemma3-1b's 1,024-slot global cache
#: over 2 and 4 ranks (512 and 256 slots; 4 q heads on one KV head,
#: head_dim 256) at batch 4 (the decode cell) and at batch 1 (the
#: long-context cell, and the decode cell's timed batch-1 step: other
#: splits), and whisper-tiny's 512-slot self caches over 4 ranks (128
#: slots; 6 q and 6 KV heads, head_dim 64, a group of 1) at batch 1 and
#: 4; bf16.  Each slice part filled, full and empty (no valid slot yet:
#: ``out = 0``, ``lse = -inf``), and at batch 4 one of each in a batch.
SLICE_DECODE_CASES = tuple(
    DecodeCase(f"decode_{lm}_slice{n}_{what}_batch{b}_bf16", qh, kvh, d, n,
               128, seq, batch=b, dtype="bfloat16")
    for lm, qh, kvh, d, slices, batches in (
        ("gemma3", 4, 1, 256, (512, 256), (4, 1)),
        ("whisper", 6, 6, 64, (128,), (4, 1)))
    for b in batches
    for n in slices
    for what, seq in (("part", n * 3 // 5), ("full", n), ("empty", 0),
                      ("rows", (0, 1, n // 2, n)))
    if what != "rows" or b == 4)


def decode_inputs(case: DecodeCase, seed: int = 0):
    """``(q, k_ring, v_ring, seq_len)``: fp32 numpy arrays from N(0, 1)
    (q times ``q_scale``; a bf16 case rounds them to bf16 at the call)
    and ``seq_len`` as an int or an int32 array."""
    rng = np.random.default_rng([seed, zlib.crc32(case.name.encode())])
    lead = (case.batch,) if case.batch else ()
    q = _normal(rng, lead + (case.q_heads, case.head_dim), case.q_scale)
    kv = lead + (case.window, case.kv_heads, case.head_dim)
    k, v = _normal(rng, kv, 1.0), _normal(rng, kv, 1.0)
    seq = case.seq_len if isinstance(case.seq_len, int) \
        else np.asarray(case.seq_len, np.int32)
    return q, k, v, seq


#: The fp32 tolerance of the decode attention (``tests/test_kernels.py:80``).
DECODE_TOL = 2e-5


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x`` (8 significant
    bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 2.0 ** -133


def compare_lse(got: np.ndarray, want: np.ndarray) -> tuple[float,
                                                             str | None]:
    """``(max |got - want| over the finite entries, None)`` when the
    log-sum-exps are ``-inf`` at the same rows and the rest within rtol
    and atol 2e-5, else a description of the first miss."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    live = np.isfinite(want)
    if not np.array_equal(np.isneginf(got), ~live) or \
            not np.isfinite(got[live]).all():
        return float("inf"), (f"-inf rows {np.argwhere(np.isneginf(got))} "
                              f"against {np.argwhere(~live)}")
    err = np.abs(got[live] - want[live]) if live.any() else np.zeros(1)
    bad = err > DECODE_TOL + DECODE_TOL * np.abs(want[live])
    if not bad.any():
        return float(err.max()), None
    i = int(np.argwhere(bad)[0][0])
    return float(err.max()), f"{got[live][i]!r} against {want[live][i]!r}"


def compare_decode(got: np.ndarray, want: np.ndarray,
                   dtype: str) -> tuple[float, str | None]:
    """``(max |got - want|, None)`` when an fp32 output is within rtol and
    atol 2e-5 of ``want`` and a bf16 output within one bf16 ulp of
    ``max|want|``, else a description of the first miss."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    if dtype == "bfloat16":
        bad = err > bf16_ulp(float(np.abs(want).max()))
    else:
        bad = err > DECODE_TOL + DECODE_TOL * np.abs(want)
    if not bad.any():
        return float(err.max()), None
    at = tuple(int(i) for i in np.argwhere(bad)[0])
    return float(err.max()), (f"first at {at}: {got[at]!r} against "
                              f"{want[at]!r}")


# ---------------------------------------------------------------------------
# The LM golden: the reference's greedy steps on seeded prompts.
# ---------------------------------------------------------------------------

#: Prompt lengths, greedy steps and logits kept per step of an LM golden.
LM_GOLDEN_PROMPT_LENS = (8, 24)
LM_GOLDEN_STEPS = 8
LM_GOLDEN_TOP = 64
#: The cache length an LM golden is served with (prompt + steps fit).
LM_GOLDEN_CACHE_LEN = 32
#: bf16 logits: ``|got - want| <= LM_ATOL_REL * max|logits| + LM_RTOL *
#: |want|``.
LM_RTOL = LM_ATOL_REL = 2e-2


def lm_prompts(vocab: int, seed: int, lens=LM_GOLDEN_PROMPT_LENS):
    """Seeded prompts of token ids in ``[1, vocab)``."""
    rng = np.random.default_rng([seed, 1])
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in lens]


def logits_close(got, want, scale: float):
    """The elementwise bf16-logits test: ``|got - want| <= LM_ATOL_REL *
    scale + LM_RTOL * |want|``, with ``scale`` the max |logit| of the
    step; returns ``(max |difference|, all within)``."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    return float(err.max()), bool(np.all(
        err <= LM_ATOL_REL * scale + LM_RTOL * np.abs(want)))


def near_tie(top2, scale: float) -> bool:
    """Whether a step's top two logits ``(first, second)`` are close
    enough that two implementations within :func:`logits_close` may
    order them apart."""
    tol = LM_ATOL_REL * scale + LM_RTOL * abs(float(top2[0]))
    return float(top2[0]) - float(top2[1]) <= 2 * tol


def route_codes(routes) -> np.ndarray:
    """``[layers, B, S, k]``: the codes (``moe.Routing.codes``: kept
    experts as ids, dropped ones as ``-1 - id``, sorted) of one pass's
    MoE routings, in layer order; two runs sent a token alike at a layer
    where its codes there are equal."""
    return np.stack([r.codes().cpu().numpy() for r in routes])


def routed_apart(a, b) -> np.ndarray:
    """``[B, S]``: where two runs' :func:`route_codes` (or one run's and
    a golden's) differ at any layer: the positions where they really
    routed a token apart, to other experts or past the capacity."""
    return (np.asarray(a) != np.asarray(b)).any(axis=(0, 3))


def hold_lm_golden(model, params, golden, rules=None) -> dict:
    """Hold the port's model against an LM golden: for each prompt at
    batch 1 (with the config's :func:`lm_memory` of the golden's seed
    where it has cross blocks), teacher-forced on the golden's tokens,
    every step's logits at the golden's top ids within
    :func:`logits_close`, and its greedy token equal to the golden's
    unless the golden's top two are a :func:`near_tie`.  An MoE golden
    holds the reference's routing (``"routes"``, ``[prompts, layers,
    positions, k]`` :func:`route_codes`: the prompt's positions, then
    one a decode step); a prompt whose step misses is let pass, and not
    held further, only where the port's routing already went apart from
    the golden's at that step or an earlier one (two runs that round a
    bf16 router product apart can send a token to other experts).
    Returns ``{"max_err", "ok", "tokens", "flips", "routed_apart",
    "misses"}``: the port's greedy token at every step, the steps where a
    near tie flipped, the ``(prompt, step)`` of each let-pass miss, the
    step being the first whose routing went apart, and the ``(prompt,
    step, max |difference|)`` of each step that failed.  ``rules`` (a
    mesh's, whose batch is not split: the golden runs at batch 1) are
    the model's; over a ``model`` axis each rank holds the whole
    vocabulary's logits (``transformer.vocab_logits``)."""
    import torch

    from ..models.transformer import vocab_logits
    from ..parallel.sharding import NO_SHARDING

    device = params["embed"].device
    memory = lm_memory(model.cfg, int(golden["seed"]), 1)
    if memory is not None:
        memory = torch.from_numpy(memory).to(device)
    out = {"max_err": 0.0, "ok": True, "tokens": [], "flips": [],
           "routed_apart": [], "misses": []}
    steps = golden["tokens"].shape[1]
    for i, n in enumerate(golden["prompt_lens"]):
        routes = [] if "routes" in golden else None
        prompt = torch.as_tensor(golden["prompts"][i, :n][None],
                                 device=device).to(torch.int64)
        logits, caches, cur = model.prefill(
            params, prompt, cache_len=int(golden["cache_len"]),
            memory=memory, routes=routes, rules=rules)
        row, apart_at = [], None
        for t in range(steps):
            if t:
                tok = torch.as_tensor(golden["tokens"][i, t - 1:t],
                                      device=device).to(torch.int64)
                logits, caches, cur = model.decode_step(
                    params, caches, tok, cur, routes=routes, rules=rules)
            if routes is not None:
                at = slice(0, n) if t == 0 else slice(n + t - 1, n + t)
                want_routes = golden["routes"][i][:, None, at]
                if apart_at is None and routed_apart(
                        route_codes(routes), want_routes).any():
                    apart_at = t
                routes.clear()
            got = vocab_logits(logits, rules or NO_SHARDING)[0] \
                .float().cpu().numpy()
            ids, want = golden["top_ids"][i, t], golden["top_logits"][i, t]
            scale = float(golden["absmax"][i, t])
            err, ok = logits_close(got[ids], want, scale)
            row.append(int(got.argmax()))
            if row[-1] != int(golden["tokens"][i, t]):
                if near_tie(want[:2], scale):
                    out["flips"].append((i, t))
                else:
                    ok = False
            if not ok and apart_at is not None:
                out["routed_apart"].append((i, apart_at))
                row += [-1] * (steps - len(row))
                break
            out["max_err"] = max(out["max_err"], err)
            out["ok"] &= ok
            if not ok:
                out["misses"].append((i, t, round(err, 4)))
        out["tokens"].append(row)
    return out


# ---------------------------------------------------------------------------
# The train golden: the reference's first train steps from lm_params.
# ---------------------------------------------------------------------------

#: A train golden's batch, sequence, steps and optimizer
#: (``train.optimizer.AdamWConfig``'s other fields at their defaults):
#: step 0 in the warmup, steps 1 and 2 on the cosine.
TRAIN_GOLDEN_BATCH, TRAIN_GOLDEN_SEQ, TRAIN_GOLDEN_STEPS = 2, 128, 3
TRAIN_GOLDEN_OPT = dict(peak_lr=3e-4, warmup_steps=2, total_steps=10)
#: Each step's loss, grad_norm, lr and update (its norm, and its dot
#: with the new mu over mu's norm) and step 0's per-leaf gradient norms,
#: update dots and mu norms within this relative tolerance of the
#: golden's.
TRAIN_RTOL = 2e-2
#: A train golden's float records (besides ``loss``, ``grad_norm`` and
#: ``lr``, one a step): ``update_norm`` and ``update_dot`` one a step,
#: ``leaf_norms``, ``leaf_update_dots`` and ``leaf_mu_norms`` one a leaf.
TRAIN_GOLDEN_FLOATS = ("loss", "grad_norm", "lr", "update_norm",
                       "update_dot", "leaf_norms", "leaf_update_dots",
                       "leaf_mu_norms")


def update_records(d2, dots, mu2) -> dict:
    """A step's update records from each leaf's sum of squares of its
    update (new params - old), its update's dot with its new mu, and
    its new mu's sum of squares: the update's global norm, its global
    dot with mu over mu's norm (below 0 for a descent step, 0 for none,
    above 0 for a reversed one), and per leaf the dot over mu's norm
    and mu's norm ((1 - b1) times the step's own gradient's norm, where
    a misrouted gradient shows)."""
    d2, dots, mu2 = (np.asarray(a, np.float64) for a in (d2, dots, mu2))
    return {"update_norm": float(np.sqrt(d2.sum())),
            "update_dot": float(dots.sum() / np.sqrt(mu2.sum())),
            "leaf_update_dots": dots / np.sqrt(mu2),
            "leaf_mu_norms": np.sqrt(mu2)}


def hold_train_golden(cfg, tree, golden, device, rules=None) -> dict:
    """Train ``cfg`` from ``tree`` (a reference-layout params tree,
    numpy or torch; copied to fp32 on ``device``) as a train golden's
    recipe says, and hold it against the golden: the batches
    (``synthetic_batch`` of each step, bitwise), step 0's gradient norm
    of every leaf (the loss the step differentiates, by autograd, in the
    reference's leaf order), each step's loss, grad_norm and lr, and
    each step's update (:func:`update_records`; step 0's leaf by leaf)
    within :data:`TRAIN_RTOL`.  Returns ``{"ok", "metrics" (one dict a
    step), "updates" (its update records a step), "errs" (the worst
    relative error of each quantity), "same_data", "state" (after the
    last step), "opt"}``.
    Each step keeps a copy of the params it starts from, for the
    update.  With ``rules`` (a mesh's) the state is DTensors placed by
    ``rules.params_shardings``, each batch comes by ``sharded_batch``
    and the steps are the mesh's (``make_train_step(model, rules)``); the
    records are taken of the gathered tensors."""
    import torch

    from ..models import build_model
    from ..parallel.sharding import is_dtensor, no_sharding, place_tree
    from ..train import (AdamWConfig, init_state, make_train_step,
                         sharded_batch)
    from ..train.train_step import rank_loss_and_grads
    from ..train.tree import leaves, leaves_with_paths, unflatten_like

    rules = rules or no_sharding()

    def whole(t):
        return t.full_tensor() if is_dtensor(t) else t

    model = build_model(cfg)
    keys = ["|".join(p) for p, _ in leaves_with_paths(tree)]
    assert keys == [str(k) for k in golden["leaf_keys"]], "leaf order"
    params = unflatten_like(tree, [
        torch.as_tensor(np.asarray(a, np.float32) if not isinstance(
            a, torch.Tensor) else a).to(device=device, dtype=torch.float32,
                                        copy=True)
        for a in leaves(tree)])
    params = place_tree(params, rules.params_shardings(params))
    B, S = int(golden["batch"]), int(golden["seq"])
    rows = {"tokens": rules.sharding("batch", None),
            "labels": rules.sharding("batch", None)}
    batches = [sharded_batch(cfg, B, S, i, rows, device=device)
               for i in range(len(golden["loss"]))]
    same_data = all(
        np.array_equal(whole(b["tokens"]).cpu().numpy(), golden["tokens"][i])
        and np.array_equal(whole(b["labels"]).cpu().numpy(),
                           golden["labels"][i])
        for i, b in enumerate(batches))
    _, grads = rank_loss_and_grads(model, params, batches[0], rules)
    leaf_norms = torch.stack([torch.linalg.vector_norm(whole(g).float())
                              for g in leaves(grads)]).cpu().numpy()
    del grads
    opt = AdamWConfig(**{f.name: golden["opt_" + f.name].item()
                         for f in dataclasses.fields(AdamWConfig)})
    step = make_train_step(model, rules, opt=opt)
    state = init_state(params)
    metrics, updates = [], []
    for b in batches:
        old = [whole(p.detach()).clone() for p in leaves(state.params)]
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
        sums = [[], [], []]
        for p0, p, mu in zip(old, leaves(state.params), leaves(state.mu)):
            d = (whole(p.detach()) - p0).reshape(-1)
            mu = whole(mu).reshape(-1)
            for acc, (x, y) in zip(sums, ((d, d), (d, mu), (mu, mu))):
                acc.append(torch.sum(x * y, dtype=torch.float64))
        del old
        updates.append(update_records(
            *(torch.stack(a).cpu().numpy() for a in sums)))

    def rel(got, want):
        want = np.asarray(want, np.float64)
        return float(np.max(np.abs(np.asarray(got, np.float64) - want)
                            / np.abs(want)))
    errs = {k: rel([m[k] for m in metrics], golden[k])
            for k in ("loss", "grad_norm", "lr")}
    for k in ("update_norm", "update_dot"):
        errs[k] = rel([u[k] for u in updates], golden[k])
    errs["leaf_norms"] = rel(leaf_norms, golden["leaf_norms"])
    for k in ("leaf_update_dots", "leaf_mu_norms"):
        errs[k] = rel(updates[0][k], golden[k])
    return {"ok": same_data and max(errs.values()) <= TRAIN_RTOL,
            "same_data": same_data, "metrics": metrics,
            "updates": updates, "errs": errs,
            "state": state, "opt": opt}
