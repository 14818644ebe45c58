"""Streaming ring kernels, int8 and fp32: CUDA wrappers and their plain
versions.

Counterpart of :mod:`repro.kernels.stream`.  Both ops keep persistent
state in the ring, above the frame program's linear extent, so the
state region never wraps:

  * :func:`ring_conv_stream_q` / :func:`ring_conv_stream` shift the
    ``[h_win, w_in, c_in]`` window at ``state_ptr`` by ``hop`` image
    rows, append the frame at ``in_ptr``, write the window back and
    store the k x k conv over it at ``out_ptr``;
  * :func:`ring_gru_cell_q` / :func:`ring_gru_cell` read ``x`` at
    ``in_ptr`` and the hidden row at ``state_ptr`` (Q7 int8, or fp32)
    and store ``h'`` to both the state and ``out_ptr``; both cells read
    first over the tiles of :func:`gru_q_tiling` / :func:`gru_tiling`.

The wrappers follow :mod:`repro_torch.kernels.quantized` and
:mod:`repro_torch.kernels.conv2d`: the reference's geometry checks, then
device, dtype and shape checks, then one launch of the kernel in
``csrc/ring_q.cu`` (int8) or ``csrc/ring_f32.cu`` (fp32); they never
fall back.  Beside each sits its plain version (``<name>_plain``), which
copies the window as raw segments, exactly as the reference kernel's
DMA does.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.program import resolve_activation
from ..core.rowsched import conv_k2d_pad, conv_k2d_pad_w
from ..core.vpool import (SEG_WIDTH, fetch_rows, fetch_segments,
                          stage_rows, stage_segments)
from ..quant.requant import gru_update, gru_update_q12, requantize, \
    requantize_i32, wrap_i32
from . import conv2d
from ._launch import H100_SMS, MAX_SMEM
from .quantized import (_acc32, _check_cuda, _idot, _launch, _per_channel,
                        _relu, _segs, _store_image, _taps)
from .segment_matmul import F32, act_code


def _stream_geometry(n_seg, *, w_in, w_out, c_in, c_out, h_win, hop,
                     in_ptr, out_ptr, state_ptr) -> int:
    """The reference's checks (``stream.py::_stream_geometry``); returns
    the segments of one window row."""
    wc = w_in * _segs(c_in)
    if h_win % hop:
        raise ValueError("hop must divide h_win")
    if n_seg % wc or n_seg % (w_out * _segs(c_out)) or in_ptr % wc \
            or out_ptr % (w_out * _segs(c_out)) or state_ptr % wc:
        raise ValueError("pool/pointers not image-row aligned")
    if state_ptr + h_win * wc > n_seg or in_ptr + hop * wc > n_seg:
        raise ValueError("state/frame region wraps — streaming programs "
                         "must be planned wrap-free (core.program)")
    return wc


def _shift_window(pool, wc, *, h_win, w_in, c_in, hop, in_ptr, state_ptr):
    """The plain versions' window step (``_shift_window_p0``): drop the
    oldest ``hop`` image rows of the window at ``state_ptr``, append the
    frame at ``in_ptr``, write the window back as raw segments, and
    return its live channels ``[h_win, w_in, c_in]``."""
    keep = fetch_segments(pool, state_ptr + hop * wc, (h_win - hop) * wc)
    frame = fetch_segments(pool, in_ptr, hop * wc)
    win = torch.cat([keep, frame], dim=0)
    stage_segments(pool, win, state_ptr)
    return win.reshape(h_win, w_in, _segs(c_in) * SEG_WIDTH)[..., :c_in]

def _gru_geometry(n_seg, *, d_in, d_h, in_ptr, out_ptr, state_ptr) -> None:
    """The reference's checks (``stream.py::_gru_geometry``)."""
    ci, co = _segs(d_in), _segs(d_h)
    if n_seg % ci or n_seg % co or in_ptr % ci or out_ptr % co \
            or state_ptr % co:
        raise ValueError("pool/pointers not row aligned")
    if state_ptr + co > n_seg or in_ptr + ci > n_seg:
        raise ValueError("state/frame region wraps — streaming programs "
                         "must be planned wrap-free (core.program)")


# ---------------------------------------------------------------------------
# Streaming conv.
# ---------------------------------------------------------------------------

def ring_conv_stream_q(pool, w, b, mult, shift, *, h_win: int, w_in: int,
                       h_out: int, w_out: int, c_in: int, c_out: int,
                       k: int = 3, stride: int = 1, padding: str = "same",
                       hop: int = 1, in_ptr: int = 0, out_ptr: int = 0,
                       state_ptr: int = 0, activation: str | None = None):
    """Int8 streaming conv step: window shift and writeback (an exact
    int8 copy of the raw segments), then the k x k int32-accumulate conv
    with per-channel requantization over the window (replaces
    ``ring_conv_stream_q``, ``src/repro/kernels/stream.py:235``).  One
    cooperative launch over the CTAs of :func:`conv2d.conv_tiling` (kind
    ``ring_conv_stream_q``), each staging the window rows its taps reach
    and its share of the window's segments, every read before one grid
    barrier; where the output run overlaps the window region, the kernel
    is told to store the window first, as the reference does."""
    n_seg = pool.shape[0]
    wc = _stream_geometry(n_seg, w_in=w_in, w_out=w_out, c_in=c_in,
                          c_out=c_out, h_win=h_win, hop=hop, in_ptr=in_ptr,
                          out_ptr=out_ptr, state_ptr=state_ptr)
    _check_cuda(pool, _per_channel(w, b, mult, shift,
                                   (k, k, c_in, c_out), c_out))
    t = conv2d._tiling("ring_conv_stream_q", h_win, w_in, h_out, w_out,
                       c_in, c_out, k, stride, padding,
                       conv2d._sm_count(pool.device))
    over = _runs_overlap(n_seg, out_ptr % n_seg,
                         h_out * w_out * _segs(c_out), state_ptr, h_win * wc)
    _launch("ring_conv_stream_q", pool, t.smem, (w, b, mult, shift),
            (n_seg, h_win, w_in, h_out, w_out, c_in, c_out, k, stride, hop,
             conv_k2d_pad(k, padding), conv_k2d_pad_w(k, padding), in_ptr,
             out_ptr % n_seg, state_ptr, _relu(activation), t.rows, t.ctile,
             int(over)))
    ring_conv_stream_q.weights_staged = t.stage_w
    ring_conv_stream_q.launches += 1
    return pool


def ring_conv_stream_q_plain(pool, w, b, mult, shift, *, h_win: int,
                             w_in: int, h_out: int, w_out: int, c_in: int,
                             c_out: int, k: int = 3, stride: int = 1,
                             padding: str = "same", hop: int = 1,
                             in_ptr: int = 0, out_ptr: int = 0,
                             state_ptr: int = 0,
                             activation: str | None = None):
    """Plain version of :func:`ring_conv_stream_q` (``conv_stream_ring_q``
    with the kernel's raw-segment window copy)."""
    wc = _stream_geometry(pool.shape[0], w_in=w_in, w_out=w_out,
                          c_in=c_in, c_out=c_out, h_win=h_win, hop=hop,
                          in_ptr=in_ptr, out_ptr=out_ptr,
                          state_ptr=state_ptr)
    img = _shift_window(pool, wc, h_win=h_win, w_in=w_in, c_in=c_in,
                        hop=hop, in_ptr=in_ptr, state_ptr=state_ptr) \
        .to(torch.int64)
    acc = 0
    for r, s, tap in _taps(img, h_out, w_out, k, stride, padding):
        acc = acc + _idot(tap, w[r, s])
    acc = _acc32(acc, b, activation)
    return _store_image(pool, requantize(acc, mult, shift), out_ptr)


def _runs_overlap(n_seg, a, len_a, b, len_b) -> bool:
    """Whether two runs of segments of the ring (``len`` segments from
    ``a`` and from ``b``, modulo ``n_seg``) share a segment."""
    return len_a >= n_seg or len_b >= n_seg or (b - a) % n_seg < len_a \
        or (a - b) % n_seg < len_b


def ring_conv_stream(pool, w, b, *, h_win: int, w_in: int, h_out: int,
                     w_out: int, c_in: int, c_out: int, k: int = 3,
                     stride: int = 1, padding: str = "same", hop: int = 1,
                     in_ptr: int = 0, out_ptr: int = 0, state_ptr: int = 0,
                     activation: str | None = None):
    """Fp32 streaming conv step: window shift and writeback (an exact
    copy of the live channels, zero channel tails), then the k x k conv
    over the window, bias and activation (replaces ``ring_conv_stream``,
    ``src/repro/kernels/stream.py:142``).  One cooperative launch over
    the CTAs of :func:`conv2d.conv_tiling`; where the output run overlaps
    the window region, the kernel is told to store the window first, as
    the reference does."""
    n_seg = pool.shape[0]
    wc = _stream_geometry(n_seg, w_in=w_in, w_out=w_out, c_in=c_in,
                          c_out=c_out, h_win=h_win, hop=hop, in_ptr=in_ptr,
                          out_ptr=out_ptr, state_ptr=state_ptr)
    _check_cuda(pool, (("w", w, F32, (k, k, c_in, c_out)),
                       ("b", b, F32, (c_out,))), dtype=F32)
    t = conv2d._tiling("ring_conv_stream", h_win, w_in, h_out, w_out, c_in,
                       c_out, k, stride, padding,
                       conv2d._sm_count(pool.device))
    over = _runs_overlap(n_seg, out_ptr % n_seg,
                         h_out * w_out * _segs(c_out), state_ptr, h_win * wc)
    _launch(
        "ring_conv_stream", pool, t.smem, (w, b),
        (n_seg, h_win, w_in, h_out, w_out, c_in, c_out, k, stride, hop,
         conv_k2d_pad(k, padding), conv_k2d_pad_w(k, padding), in_ptr,
         out_ptr % n_seg, state_ptr, act_code(activation), t.rows, t.ctile,
         int(t.stage_w), int(over)))
    ring_conv_stream.weights_staged = t.stage_w
    ring_conv_stream.launches += 1
    return pool


def ring_conv_stream_plain(pool, w, b, *, h_win: int, w_in: int,
                           h_out: int, w_out: int, c_in: int, c_out: int,
                           k: int = 3, stride: int = 1,
                           padding: str = "same", hop: int = 1,
                           in_ptr: int = 0, out_ptr: int = 0,
                           state_ptr: int = 0,
                           activation: str | None = None):
    """Plain version of :func:`ring_conv_stream` (``conv_stream_ring``
    with the kernel's raw-segment window copy)."""
    wc = _stream_geometry(pool.shape[0], w_in=w_in, w_out=w_out,
                          c_in=c_in, c_out=c_out, h_win=h_win, hop=hop,
                          in_ptr=in_ptr, out_ptr=out_ptr,
                          state_ptr=state_ptr)
    img = _shift_window(pool, wc, h_win=h_win, w_in=w_in, c_in=c_in,
                        hop=hop, in_ptr=in_ptr, state_ptr=state_ptr).to(F32)
    acc = torch.zeros((h_out, w_out, c_out), dtype=F32, device=pool.device)
    for r, s, tap in _taps(img, h_out, w_out, k, stride, padding):
        acc = acc + torch.einsum("hwc,cd->hwd", tap, w[r, s].to(F32))
    y = resolve_activation(activation)(acc + b.to(F32))
    stage_rows(pool, y.reshape(h_out * w_out, c_out), out_ptr)
    return pool


# ---------------------------------------------------------------------------
# GRU cell.
# ---------------------------------------------------------------------------

def _gru_operands(w, u, b, mx, sx, mu, su, d_in, d_h):
    g = 3 * d_h
    return (("w", w, torch.int8, (d_in, g)), ("u", u, torch.int8, (d_h, g)),
            ("b", b, torch.int32, (g,)), ("mult_x", mx, torch.int32, (g,)),
            ("shift_x", sx, torch.int32, (g,)),
            ("mult_u", mu, torch.int32, (g,)),
            ("shift_u", su, torch.int32, (g,)))


#: Threads of a GRU CTA (``GRU_Q_THREADS`` in ``ring_q.cu``).
GRU_Q_THREADS = 256
#: Hidden-channel tiles a GRU CTA of the cooperative mode may take,
#: narrowest first (a smaller ``d_h`` is one tile): whole 32-bit words.
GRU_Q_CHANNEL_TILES = (4, 8, 16, 32, 64, 128, 256, 512, 1024)
#: The most weight bytes (``(d_in + d_h) * 3 * d_h``) of a cell that
#: :func:`gru_q_tiling` gives one CTA and an ordinary launch; a larger cell
#: is cut into channel tiles over many CTAs with a grid barrier.  Set from
#: ``chip_smoke.py::time_gru_modes`` on an H100 80GB HBM3 at 700 W
#: (PERF.md §6): one CTA is the faster mode by 0.99-1.44 µs at 20,400 B
#: (``gru_wide_input``) and 24,576 B (the GRU chain's cell), the channel
#: tiles by 0.27 µs at 98,304 B (``gru_q_wide``).
GRU_Q_ONE_CTA_BYTES = 24_576


def _r(n: int, m: int) -> int:
    return -(-n // m) * m


def _gru_q_smem(d_in: int, d_h: int, ctile: int) -> int:
    """A GRU CTA's shared memory in bytes (``ring_q.cu::gru_q_layout``):
    x and h in whole 16-byte chunks, the tile's columns of W and U as rows
    of ``round4(3 ctile)`` bytes (each region in whole 16-byte chunks),
    five int32 constants a column, 4 int32 partial sums a thread and two
    int32 gates a column."""
    row = _r(3 * ctile, 4)
    return (_r(d_in, 16) + _r(d_h, 16) + _r(_r(d_in, 4) * row, 16)
            + _r(_r(d_h, 4) * row, 16) + 4 * 15 * ctile
            + 16 * GRU_Q_THREADS + 4 * 6 * ctile)


@dataclasses.dataclass(frozen=True)
class GruQTiling:
    """How :func:`ring_gru_cell_q` cuts a cell of ``d_in`` inputs and
    ``d_h`` hidden channels: CTA ``i`` owns hidden channels ``i * ctile
    ..`` (fewer in the last tile) and their z, r and n columns of W and
    U.  ``barrier``: one cooperative launch whose CTAs meet a grid
    barrier between their reads and their stores (``h'`` lands on ``h``,
    and in place on ``x``, which every CTA reads); else one CTA in an
    ordinary launch, which reads all of the cell before it stores.
    ``smem`` is one CTA's shared memory in bytes."""

    d_in: int
    d_h: int
    ctile: int
    barrier: bool

    @property
    def ctas(self) -> int:
        return -(-self.d_h // self.ctile)

    @property
    def smem(self) -> int:
        return _gru_q_smem(self.d_in, self.d_h, self.ctile)

    def tile(self, i: int) -> tuple[int, int]:
        """CTA ``i``'s ``(i0, tn)``: hidden channels ``i0 .. i0 + tn -
        1``."""
        i0 = i * self.ctile
        return i0, min(self.ctile, self.d_h - i0)


def _cell_tiling(cls, kernel: str, small: bool, d_in: int, d_h: int,
                 n_sm: int, one_cta: bool | None):
    """The rule of :func:`gru_q_tiling` and :func:`gru_tiling`: one CTA
    of the whole cell where ``small`` (or ``one_cta``) and it fits
    ``MAX_SMEM``, else the narrowest channel tile of
    :data:`GRU_Q_CHANNEL_TILES` whose tiles fit ``n_sm`` and whose CTA
    fits ``MAX_SMEM``, under a grid barrier where that gives more than one
    CTA (or ``one_cta`` is False)."""
    one = cls(d_in, d_h, d_h, False)
    if one_cta is not False and one.smem <= MAX_SMEM and (one_cta or small):
        return one
    if one_cta is not True:
        for ctile in sorted({min(d_h, c) for c in GRU_Q_CHANNEL_TILES}):
            t = cls(d_in, d_h, ctile, True)
            if t.ctas <= n_sm and t.smem <= MAX_SMEM:
                return dataclasses.replace(
                    t, barrier=t.ctas > 1 or one_cta is False)
    raise ValueError(
        f"{kernel}: no tile of the cell d_in {d_in}, d_h {d_h} "
        f"(W [{d_in}, {3 * d_h}], U [{d_h}, {3 * d_h}]) fits {MAX_SMEM} B "
        "of shared memory"
        + (" in one CTA" if one_cta else f" over at most {n_sm} CTAs"))


@functools.lru_cache(maxsize=1024)
def gru_q_tiling(d_in: int, d_h: int, n_sm: int = H100_SMS,
                 one_cta: bool | None = None) -> GruQTiling:
    """The tiling of a ``ring_gru_cell_q`` call over at most ``n_sm``
    CTAs.

    One CTA of the whole cell, in an ordinary launch, where its weights
    are at most :data:`GRU_Q_ONE_CTA_BYTES`, ``d_h`` is a multiple of 4
    (else one CTA stages W and U byte by byte: 25.07 µs against 7.74 for
    the tiles on ``gru_q_d_h_70``) and it fits ``MAX_SMEM``; else the
    narrowest channel tile of :data:`GRU_Q_CHANNEL_TILES` whose
    tiles fit ``n_sm`` and whose CTA fits ``MAX_SMEM``, in one
    cooperative launch with a grid barrier (a barrier only where that
    gives more than one CTA).  ``one_cta`` forces either mode (the
    cooperative one with its barrier even over one CTA), as
    ``chip_smoke.py::time_gru_modes`` measures them.  Raises
    ``ValueError``, naming the cell's shape, when no tile fits."""
    small = d_h % 4 == 0 and (d_in + d_h) * 3 * d_h <= GRU_Q_ONE_CTA_BYTES
    return _cell_tiling(GruQTiling, "ring_gru_cell_q", small, d_in, d_h,
                        n_sm, one_cta)


def ring_gru_cell_q(pool, w, u, b, mult_x, shift_x, mult_u, shift_u, *,
                    d_in: int, d_h: int, in_ptr: int = 0, out_ptr: int = 0,
                    state_ptr: int = 0):
    """Int8 GRU step: ``x@W`` and ``h@U`` accumulate in int32, requantize
    to the Q12 gate domain (plus the Q12 bias, wrapping), and
    ``gru_update_q12`` gives the Q7 ``h'``, stored at ``state_ptr`` and
    ``out_ptr`` (replaces ``ring_gru_cell_q``,
    ``src/repro/kernels/stream.py:417``).  The kernel runs the tiles of
    :func:`gru_q_tiling`, each CTA staging x, h and its columns of W and
    U in shared memory and reading all of them before any store, in one
    CTA or over many with a grid barrier (``ring_gru_cell_q.barrier``
    records which)."""
    n_seg = pool.shape[0]
    _gru_geometry(n_seg, d_in=d_in, d_h=d_h, in_ptr=in_ptr, out_ptr=out_ptr,
                  state_ptr=state_ptr)
    ops = _gru_operands(w, u, b, mult_x, shift_x, mult_u, shift_u, d_in, d_h)
    _check_cuda(pool, ops)
    t = gru_q_tiling(d_in, d_h, conv2d._sm_count(pool.device))
    _launch("ring_gru_cell_q", pool, t.smem, tuple(a for _, a, _, _ in ops),
            (n_seg, d_in, d_h, in_ptr, out_ptr % n_seg, state_ptr, t.ctile,
             int(t.barrier)))
    ring_gru_cell_q.weights_staged = True      # W and U: shared memory
    ring_gru_cell_q.barrier = t.barrier
    ring_gru_cell_q.launches += 1
    return pool


def ring_gru_cell_q_plain(pool, w, u, b, mult_x, shift_x, mult_u, shift_u,
                          *, d_in: int, d_h: int, in_ptr: int = 0,
                          out_ptr: int = 0, state_ptr: int = 0):
    """Plain version of :func:`ring_gru_cell_q` (``gru_cell_ring_q``)."""
    _gru_geometry(pool.shape[0], d_in=d_in, d_h=d_h, in_ptr=in_ptr,
                  out_ptr=out_ptr, state_ptr=state_ptr)
    x = fetch_rows(pool, in_ptr, 1, d_in).to(torch.int64)
    h = fetch_rows(pool, state_ptr, 1, d_h)
    gx = requantize_i32(wrap_i32(_idot(x, w)), mult_x[None, :],
                        shift_x[None, :])
    gx = wrap_i32(gx + b.to(torch.int64))
    gh = requantize_i32(wrap_i32(_idot(h.to(torch.int64), u)),
                        mult_u[None, :], shift_u[None, :])
    hp = gru_update_q12(gx, gh, h, d_h)
    stage_rows(pool, hp, state_ptr)
    stage_rows(pool, hp, out_ptr)
    return pool


#: Threads of an fp32 GRU CTA (``GRU_THREADS`` in ``ring_f32.cu``).
GRU_THREADS = 256
#: The most fp32 weight bytes (``4 (d_in + d_h) 3 d_h``) of a cell that
#: :func:`gru_tiling` gives one CTA and an ordinary launch; a larger cell
#: is cut into channel tiles over many CTAs with a grid barrier.  Set from
#: ``chip_smoke.py::time_gru_modes`` on an H100 80GB HBM3 at 700 W, whose
#: times PERF.md §6 gives (the fp32 pool and GRU cell's section): one CTA
#: is the faster mode at 81,600 B (``f32_gru_wide_input``), 98,304 B (the
#: GRU chain's 64 -> 64 cell) and 117,504 B (``f32_gru_d_h_72``), the
#: largest size it was measured at.
GRU_ONE_CTA_BYTES = 117_504


def _gru_smem(d_in: int, d_h: int, ctile: int) -> int:
    """An fp32 GRU CTA's shared memory in bytes
    (``ring_f32.cu::gru_layout``): x and h in whole float4s, the tile's
    columns of W and U as rows of ``P = round4(3 ctile)`` floats, the
    biases (``P``), 4 partial sums a thread (or a quad of columns, where
    the ``P / 2`` quads of W and U outnumber the threads) and the two
    gates of each column."""
    row = _r(3 * ctile, 4)
    return 4 * (_r(d_in, 4) + _r(d_h, 4) + (d_in + d_h) * row + row
                + 4 * max(GRU_THREADS, row // 2) + 6 * ctile)


@dataclasses.dataclass(frozen=True)
class GruTiling(GruQTiling):
    """How :func:`ring_gru_cell` cuts an fp32 cell: as
    :class:`GruQTiling`, at 4 bytes an element (``smem``:
    :func:`_gru_smem`)."""

    @property
    def smem(self) -> int:
        return _gru_smem(self.d_in, self.d_h, self.ctile)

    @property
    def lanes(self) -> int:
        """The k split (``ring_f32.cu::gru_lanes``): the lanes over which
        a column's rows are summed, rows ``lane, lane + lanes, ...``; the
        most (a power of two) whose quads of columns fit
        :data:`GRU_THREADS`, with no more lanes than rows a lane."""
        quads, depth = 2 * _r(3 * self.ctile, 4) // 4, max(self.d_in,
                                                             self.d_h)
        ks = 1
        while 4 * ks * ks <= depth and 2 * ks * quads <= GRU_THREADS:
            ks *= 2
        return ks


@functools.lru_cache(maxsize=1024)
def gru_tiling(d_in: int, d_h: int, n_sm: int = H100_SMS,
               one_cta: bool | None = None) -> GruTiling:
    """The tiling of a ``ring_gru_cell`` call over at most ``n_sm`` CTAs.

    One CTA of the whole cell, in an ordinary launch, where its fp32
    weights are at most :data:`GRU_ONE_CTA_BYTES`, ``d_h`` is a multiple
    of 4 (else one CTA stages W and U a float at a time: 14.83 µs against
    5.86 for the tiles on ``f32_gru_d_h_70``) and it fits ``MAX_SMEM``;
    else the
    narrowest channel tile of
    :data:`GRU_Q_CHANNEL_TILES` whose tiles fit ``n_sm`` and whose CTA
    fits ``MAX_SMEM``, in one cooperative launch with a grid barrier (a
    barrier only where that gives more than one CTA).  ``one_cta`` forces
    either mode (the cooperative one with its barrier even over one CTA),
    as ``chip_smoke.py::time_gru_modes`` measures them.  Raises
    ``ValueError``, naming the cell's shape, when no tile fits."""
    small = d_h % 4 == 0 and 4 * (d_in + d_h) * 3 * d_h <= GRU_ONE_CTA_BYTES
    return _cell_tiling(GruTiling, "ring_gru_cell", small, d_in, d_h, n_sm,
                        one_cta)


def ring_gru_cell(pool, w, u, b, *, d_in: int, d_h: int, in_ptr: int = 0,
                  out_ptr: int = 0, state_ptr: int = 0):
    """Fp32 GRU step: ``h' = gru_update(x@W + b, h@U, h)``, stored at
    ``state_ptr`` and ``out_ptr`` (replaces ``ring_gru_cell``,
    ``src/repro/kernels/stream.py:350``).  The kernel runs the tiles of
    :func:`gru_tiling`, each CTA staging x, h and its columns of W and U
    in shared memory and reading all of them before any store, in one CTA
    or over many with a grid barrier (``ring_gru_cell.barrier`` records
    which)."""
    n_seg = pool.shape[0]
    _gru_geometry(n_seg, d_in=d_in, d_h=d_h, in_ptr=in_ptr, out_ptr=out_ptr,
                  state_ptr=state_ptr)
    g = 3 * d_h
    _check_cuda(pool, (("w", w, F32, (d_in, g)), ("u", u, F32, (d_h, g)),
                       ("b", b, F32, (g,))), dtype=F32)
    t = gru_tiling(d_in, d_h, conv2d._sm_count(pool.device))
    _launch("ring_gru_cell", pool, t.smem, (w, u, b),
            (n_seg, d_in, d_h, in_ptr, out_ptr % n_seg, state_ptr, t.ctile,
             int(t.barrier)))
    ring_gru_cell.weights_staged = True        # W and U: shared memory
    ring_gru_cell.barrier = t.barrier
    ring_gru_cell.launches += 1
    return pool


def ring_gru_cell_plain(pool, w, u, b, *, d_in: int, d_h: int,
                        in_ptr: int = 0, out_ptr: int = 0,
                        state_ptr: int = 0):
    """Plain version of :func:`ring_gru_cell` (``gru_cell_ring``)."""
    _gru_geometry(pool.shape[0], d_in=d_in, d_h=d_h, in_ptr=in_ptr,
                  out_ptr=out_ptr, state_ptr=state_ptr)
    x = fetch_rows(pool, in_ptr, 1, d_in).to(F32)
    h = fetch_rows(pool, state_ptr, 1, d_h).to(F32)
    hp = gru_update(x @ w.to(F32) + b.to(F32), h @ u.to(F32), h, d_h)
    stage_rows(pool, hp, state_ptr)
    stage_rows(pool, hp, out_ptr)
    return pool


#: The wrappers, by name, and their plain versions under the same names.
KERNELS = {f.__name__: f for f in (ring_conv_stream_q, ring_gru_cell_q,
                                   ring_conv_stream, ring_gru_cell)}
PLAIN = {name: globals()[f"{name}_plain"] for name in KERNELS}

for _f in KERNELS.values():
    _f.launches = 0
    _f.weights_staged = None
ring_gru_cell_q.barrier = None
ring_gru_cell.barrier = None
