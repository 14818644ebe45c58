"""Int8 ring kernels: CUDA wrappers and their plain PyTorch versions.

Counterpart of :mod:`repro.kernels.quantized`.  Each wrapper takes the
reference kernel's arguments, raises the reference's ``ValueError`` on a
misaligned pool or pointer, checks device, dtype, shape and contiguity,
and launches its hand-written kernel (``csrc/ring_q.cu``) on the current
CUDA stream without synchronising.  It updates the pool in place and
returns it.  A wrapper never falls back to its plain version: it raises
on anything but CUDA tensors.

Beside each wrapper sits its plain version (``<name>_plain``), a port of
the reference's jnp executor op: gather every input row, compute in
integer arithmetic, requantize, scatter.  It takes the same arguments,
works on any device, and is what the CPU path runs and what the kernels
are held against.  On a certified plan the gather-then-scatter order
leaves the same pool as the kernels' sequential walk.

Each wrapper counts its launches in ``<wrapper>.launches``, and a conv
or FC wrapper records in ``<wrapper>.weights_staged`` whether its last
launch staged the weights in shared memory (False: they were read from
global memory; None for a kernel without weights to stage; for the
pointwise, depthwise and k x k convs, whether each CTA staged its weight
slice, which it always does; so does the FC's).  The wrappers size
every kernel's shared memory; the kernels take the decision as an
argument.

The pointwise, depthwise and k x k convs run many CTAs that read all of
the op's input before any stores, one grid-wide barrier between, tiled
by :func:`repro_torch.kernels.conv2d.conv_tiling` (kinds
``ring_conv_pw_q``, ``ring_conv_dw_q``, ``ring_conv_k2d_q``: a block of
output image rows x a channel tile a CTA, at most one CTA per SM, shared
memory counted at int8 widths); a launch the card refuses (more CTAs
than fit at once) raises.  The residual add maps its rows over many CTAs
with no barrier where no output row lands on an operand row of another
index (:func:`add_needs_barrier`), and reads first over the row blocks
of ``conv2d.add_tiling`` elsewhere (``ring_add_q.barrier`` records
which).  The FC reads first too: one CTA in an ordinary launch where
:func:`gemm_q_tiling` gives one (every plan's head), else column tiles
under one grid barrier in a cooperative launch (``ring_gemm_q.barrier``
records which).  The average pool is one CTA in an ordinary launch
whose every thread stages pixels and sums a channel over a share of
them (:func:`pool_q_tiling`), and which stores after every read.  The streaming conv
(:mod:`repro_torch.kernels.stream`) reads first over the tiles of
``conv2d.conv_tiling``, and the GRU cell over those of
``stream.gru_q_tiling``.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..core.rowsched import conv_k2d_pad, conv_k2d_pad_w, resample_src
from ..core.vpool import SEG_WIDTH, fetch_rows, segments_for, stage_rows
from ..quant.requant import act_i32, requantize, requantize_i32, wrap_i32
from ._launch import H100_SMS, MAX_SMEM, _sm_count
from ._launch import check_cuda as _check_cuda
from ._launch import launch as _launch

def _segs(d: int) -> int:
    return segments_for(d, SEG_WIDTH)


def _relu(activation) -> int:
    if activation in (None, "identity"):
        return 0
    if activation == "relu":
        return 1
    raise NotImplementedError(
        f"activation {activation!r} has no int8 path (relu/None only)")


# ---------------------------------------------------------------------------
# Alignment checks (the reference kernels' own), shared by both versions.
# ---------------------------------------------------------------------------

def _check_gemm(n_seg, m_rows, d_in, d_out, in_ptr, out_ptr, block_rows):
    bk, bn = block_rows * _segs(d_in), block_rows * _segs(d_out)
    if m_rows % block_rows:
        raise ValueError("block_rows must divide m_rows")
    if n_seg % math.lcm(bk, bn) or in_ptr % bk or out_ptr % bn:
        raise ValueError("pool/pointers not block-aligned")


def _check_rows(n_seg, w_in, w_out, c_in, c_out, in_ptr, out_ptr):
    ic, oc = w_in * _segs(c_in), w_out * _segs(c_out)
    if n_seg % ic or n_seg % oc or in_ptr % ic or out_ptr % oc:
        raise ValueError("pool/pointers not image-row aligned")


def _check_pw(n_seg, h_out, w_in, w_out, c_in, c_out, stride, resample,
              in_ptr, out_ptr, row_block):
    _check_rows(n_seg, w_in, w_out, c_in, c_out, in_ptr, out_ptr)
    if row_block != 1 and (stride != 1 or resample or h_out % row_block):
        raise ValueError("row_block needs stride==1, no resample, and "
                         "row_block | h_out")


def _check_add(n_seg, d, in_ptr, aux_ptr, out_ptr):
    chunk = _segs(d)
    if n_seg % chunk or in_ptr % chunk or aux_ptr % chunk \
            or out_ptr % chunk:
        raise ValueError("pool/pointers not row aligned")


def _check_avgpool(n_seg, w, c, in_ptr, out_ptr):
    segs = _segs(c)
    if n_seg % (w * segs) or in_ptr % (w * segs) or out_ptr % segs:
        raise ValueError("pool/pointers not aligned")


# ---------------------------------------------------------------------------
# Launching.
# ---------------------------------------------------------------------------

def _per_channel(w, b, mult, shift, w_shape, c_out):
    return (("w", w, torch.int8, w_shape), ("b", b, torch.int32, (c_out,)),
            ("mult", mult, torch.int32, (c_out,)),
            ("shift", shift, torch.int32, (c_out,)))


# ---------------------------------------------------------------------------
# GEMM.
# ---------------------------------------------------------------------------

#: Threads of a gemm CTA (``GEMM_Q_THREADS`` in ``ring_q.cu``).
GEMM_Q_THREADS = 512
#: Output-column tiles a gemm CTA of the cooperative mode may take,
#: narrowest first (a smaller ``d_out`` is one tile): each a whole number
#: of 32-bit words and of 16-byte weight chunks.
GEMM_Q_COLUMN_TILES = (16, 32, 64, 128, 256, 512, 1024)
#: The most weight bytes (``d_in * d_out``) of an op that
#: :func:`gemm_q_tiling` gives one CTA and an ordinary launch; a larger op
#: is cut into column tiles over many CTAs with a grid barrier.  Set from
#: ``chip_smoke.py::time_gemm_modes`` on an H100 80GB HBM3 at 700 W
#: (PERF.md §6): one CTA is the faster mode up to 16,384 B (every head,
#: ToyADMOS's 128-wide layers), the column tiles at 26,000 B (an 8-row
#: edge case) and from 81,920 B on (ToyADMOS's 640-wide layers, the 96 ->
#: 1000 head).
GEMM_Q_ONE_CTA_BYTES = 16_384


@dataclasses.dataclass(frozen=True)
class GemmQTiling:
    """How :func:`ring_gemm_q` cuts an op of ``m_rows`` rows, ``d_in`` ->
    ``d_out``: CTA ``i`` owns ``rows`` rows (fewer in the last row block)
    x ``ctile`` output columns (fewer in the last column tile), column
    tiles fastest.  ``barrier``: one cooperative launch whose CTAs meet a
    grid barrier between their reads and their stores (at most one CTA an
    SM); else one CTA in an ordinary launch, which reads all of the op
    before it stores.  ``smem`` is one CTA's shared memory in bytes
    (``ring_q.cu::conv_q_layout_dense``: the tile is a 1x1 conv's over
    ``m_rows`` one-pixel rows), ``held`` the bytes of outputs it keeps
    across the barrier."""

    m_rows: int
    d_in: int
    d_out: int
    rows: int
    ctile: int
    barrier: bool

    @property
    def col_tiles(self) -> int:
        return -(-self.d_out // self.ctile)

    @property
    def ctas(self) -> int:
        return -(-self.m_rows // self.rows) * self.col_tiles

    @property
    def smem(self) -> int:
        from .conv2d import _conv_smem_q   # conv2d imports this module

        return _conv_smem_q(self.rows, self.ctile, w_in=1, w_out=1,
                            c_in=self.d_in, k=1, stride=1,
                            kind="ring_conv_pw_q")

    @property
    def held(self) -> int:
        return self.rows * self.ctile

    def tile(self, i: int) -> tuple[int, int, int, int]:
        """CTA ``i``'s ``(r0, nr, c0, cn)``: rows ``r0 .. r0 + nr - 1``,
        output columns ``c0 .. c0 + cn - 1`` (the kernel's own split)."""
        rb, cb = divmod(i, self.col_tiles)
        r0, c0 = rb * self.rows, cb * self.ctile
        return (r0, min(self.rows, self.m_rows - r0), c0,
                min(self.ctile, self.d_out - c0))


@functools.lru_cache(maxsize=4096)
def gemm_q_tiling(m_rows: int, d_in: int, d_out: int, n_sm: int = H100_SMS,
                  one_cta: bool | None = None) -> GemmQTiling:
    """The tiling of a ``ring_gemm_q`` call over at most ``n_sm`` CTAs.

    One CTA of the whole op, in an ordinary launch, where its weights are
    at most :data:`GEMM_Q_ONE_CTA_BYTES` and it fits ``MAX_SMEM``; else
    the narrowest column tile of :data:`GEMM_Q_COLUMN_TILES` whose tiles
    fit ``n_sm``, with the fewest rows per block that keep the CTAs within
    ``n_sm``, whose CTA fits ``MAX_SMEM``, in one cooperative launch with
    a grid barrier (a barrier only where that gives more than one CTA).
    ``one_cta`` forces either mode (the cooperative one with its barrier
    even over one CTA), as ``chip_smoke.py::time_gemm_modes`` measures
    them.  Raises ``ValueError``, naming the op's shape, when no tile
    fits."""
    one = GemmQTiling(m_rows, d_in, d_out, m_rows, d_out, False)
    if one_cta is not False and one.smem <= MAX_SMEM and (
            one_cta or d_in * d_out <= GEMM_Q_ONE_CTA_BYTES):
        return one
    if one_cta is not True:
        for ctile in sorted({min(d_out, c) for c in GEMM_Q_COLUMN_TILES}):
            col_tiles = -(-d_out // ctile)
            if col_tiles > n_sm:
                continue
            rows = -(-m_rows // (n_sm // col_tiles))
            t = GemmQTiling(m_rows, d_in, d_out, rows, ctile, True)
            if t.smem <= MAX_SMEM:
                return dataclasses.replace(
                    t, barrier=t.ctas > 1 or one_cta is False)
    raise ValueError(
        f"ring_gemm_q: no tile of the op [{m_rows}, {d_in}] -> [{m_rows}, "
        f"{d_out}] fits {MAX_SMEM} B of shared memory"
        + (" in one CTA" if one_cta else f" over at most {n_sm} CTAs"))


def ring_gemm_q(pool, w, b, mult, shift, *, m_rows: int, d_in: int,
                d_out: int, in_ptr: int, out_ptr: int, block_rows: int = 8,
                activation: str | None = None):
    """Int8 Fig.-4 FC kernel: int8 In @ int8 W -> int32 acc -> requantize
    per output channel on store (replaces ``ring_gemm_q``,
    ``src/repro/kernels/quantized.py:87``).  ``block_rows`` is checked as
    the reference does and shapes nothing: the kernel runs the tiles of
    :func:`gemm_q_tiling`, each CTA staging its rows and its weight slice
    and reading all of them before any store, in one CTA or over many
    with a grid barrier (``ring_gemm_q.barrier`` records which)."""
    n_seg = pool.shape[0]
    _check_gemm(n_seg, m_rows, d_in, d_out, in_ptr, out_ptr, block_rows)
    _check_cuda(pool, _per_channel(w, b, mult, shift, (d_in, d_out), d_out))
    t = gemm_q_tiling(m_rows, d_in, d_out, _sm_count(pool.device))
    _launch("ring_gemm_q", pool, t.smem, (w, b, mult, shift),
            (n_seg, m_rows, d_in, d_out, in_ptr % n_seg, out_ptr % n_seg,
             _relu(activation), t.rows, t.ctile, int(t.barrier)))
    ring_gemm_q.weights_staged = True
    ring_gemm_q.barrier = t.barrier
    ring_gemm_q.launches += 1
    return pool


def ring_gemm_q_plain(pool, w, b, mult, shift, *, m_rows: int, d_in: int,
                      d_out: int, in_ptr: int, out_ptr: int,
                      block_rows: int = 8, activation: str | None = None):
    """Plain version of :func:`ring_gemm_q` (``executors.py``'s
    ``gemm_ring_scan_q``)."""
    _check_gemm(pool.shape[0], m_rows, d_in, d_out, in_ptr, out_ptr,
                block_rows)
    x = fetch_rows(pool, in_ptr, m_rows, d_in).to(torch.int64)
    acc = _acc32(_idot(x, w), b, activation)
    stage_rows(pool, requantize(acc, mult[None, :], shift[None, :]),
               out_ptr)
    return pool


# ---------------------------------------------------------------------------
# Pointwise conv.
# ---------------------------------------------------------------------------

def ring_conv_pw_q(pool, w, b, mult, shift, *, h_in: int, w_in: int,
                   h_out: int, w_out: int, c_in: int, c_out: int,
                   stride: int = 1, resample: bool = False, in_ptr: int = 0,
                   out_ptr: int = 0, activation: str | None = None,
                   row_block: int = 1):
    """Int8 pointwise conv ``[h_in, w_in, c_in] -> [h_out, w_out, c_out]``
    in the ring (replaces ``ring_conv_pw_q``,
    ``src/repro/kernels/quantized.py:196``).  ``row_block`` is checked as
    the reference does (blocking requires the identity pixel map) and
    shapes nothing: one cooperative launch runs the tiles of
    ``conv2d.conv_tiling``, each CTA staging the source pixel of each of
    its outputs and its weight slice, every read before one grid
    barrier, then every store."""
    from .conv2d import _pw_tiling   # conv2d imports this module

    n_seg = pool.shape[0]
    _check_pw(n_seg, h_out, w_in, w_out, c_in, c_out, stride, resample,
              in_ptr, out_ptr, row_block)
    _check_cuda(pool, _per_channel(w, b, mult, shift, (c_in, c_out), c_out))
    t = _pw_tiling(h_in, w_in, h_out, w_out, c_in, c_out, stride, resample,
                   _sm_count(pool.device), "ring_conv_pw_q")
    _launch("ring_conv_pw_q", pool, t.smem, (w, b, mult, shift),
            (n_seg, h_in, w_in, h_out, w_out, c_in, c_out, stride,
             int(resample), in_ptr % n_seg, out_ptr % n_seg,
             _relu(activation), t.rows, t.ctile))
    ring_conv_pw_q.weights_staged = t.stage_w
    ring_conv_pw_q.launches += 1
    return pool


def ring_conv_pw_q_plain(pool, w, b, mult, shift, *, h_in: int, w_in: int,
                         h_out: int, w_out: int, c_in: int, c_out: int,
                         stride: int = 1, resample: bool = False,
                         in_ptr: int = 0, out_ptr: int = 0,
                         activation: str | None = None, row_block: int = 1):
    """Plain version of :func:`ring_conv_pw_q` (``conv_pw_ring_q``);
    ``row_block`` is execution granularity and changes nothing here."""
    _check_pw(pool.shape[0], h_out, w_in, w_out, c_in, c_out, stride,
              resample, in_ptr, out_ptr, row_block)
    img = _fetch_image(pool, in_ptr, h_in, w_in, c_in)
    if resample:
        ridx = [resample_src(p, h_in, h_out) for p in range(h_out)]
        cidx = [resample_src(q, w_in, w_out) for q in range(w_out)]
    else:
        ridx = [p * stride for p in range(h_out)]
        cidx = [q * stride for q in range(w_out)]
    sub = img[ridx][:, cidx]
    acc = _acc32(_idot(sub, w), b, activation)
    return _store_image(pool, requantize(acc, mult, shift), out_ptr)


# ---------------------------------------------------------------------------
# Depthwise and k x k conv.
# ---------------------------------------------------------------------------

def ring_conv_dw_q(pool, w, b, mult, shift, *, h_in: int, w_in: int,
                   h_out: int, w_out: int, c: int, rs: int = 3,
                   stride: int = 1, padding: str = "same", in_ptr: int = 0,
                   out_ptr: int = 0, activation: str | None = None):
    """Int8 depthwise RSxRS conv inside the ring (replaces
    ``ring_conv_dw_q``, ``src/repro/kernels/quantized.py:310``).  One
    cooperative launch runs the tiles of ``conv2d.conv_tiling`` (kind
    ``ring_conv_dw_q``: a block of output rows x a channel tile of one
    segment), each CTA staging its channel tile of the input rows its
    taps reach and its weight slice, every read before one grid barrier,
    then every store."""
    from .conv2d import _tiling   # conv2d imports this module

    n_seg = pool.shape[0]
    _check_rows(n_seg, w_in, w_out, c, c, in_ptr, out_ptr)
    _check_cuda(pool, _per_channel(w, b, mult, shift, (rs, rs, c), c))
    t = _tiling("ring_conv_dw_q", h_in, w_in, h_out, w_out, c, c, rs,
                stride, padding, _sm_count(pool.device))
    _launch("ring_conv_dw_q", pool, t.smem, (w, b, mult, shift),
            (n_seg, h_in, w_in, h_out, w_out, c, rs, stride,
             conv_k2d_pad(rs, padding), conv_k2d_pad_w(rs, padding),
             in_ptr % n_seg, out_ptr % n_seg, _relu(activation), t.rows,
             t.ctile))
    ring_conv_dw_q.weights_staged = t.stage_w
    ring_conv_dw_q.launches += 1
    return pool


def ring_conv_dw_q_plain(pool, w, b, mult, shift, *, h_in: int, w_in: int,
                         h_out: int, w_out: int, c: int, rs: int = 3,
                         stride: int = 1, padding: str = "same",
                         in_ptr: int = 0, out_ptr: int = 0,
                         activation: str | None = None):
    """Plain version of :func:`ring_conv_dw_q` (``conv_dw_ring_q``)."""
    _check_rows(pool.shape[0], w_in, w_out, c, c, in_ptr, out_ptr)
    img = _fetch_image(pool, in_ptr, h_in, w_in, c)
    acc = 0
    for r, s, tap in _taps(img, h_out, w_out, rs, stride, padding):
        acc = acc + tap * w[r, s].to(torch.int64)
    acc = _acc32(acc, b, activation)
    return _store_image(pool, requantize(acc, mult, shift), out_ptr)


def ring_conv_k2d_q(pool, w, b, mult, shift, *, h_in: int, w_in: int,
                    h_out: int, w_out: int, c_in: int, c_out: int,
                    k: int = 3, stride: int = 1, padding: str = "same",
                    in_ptr: int = 0, out_ptr: int = 0,
                    activation: str | None = None):
    """Int8 k x k conv inside the ring: int8 halo rows -> int32 dot per
    tap -> per-output-channel requantize on store (replaces
    ``ring_conv_k2d_q``, ``src/repro/kernels/quantized.py:419``).  One
    cooperative launch runs the tiles of ``conv2d.conv_tiling``, each CTA
    staging the input rows its taps reach and its weight slice, every
    read before one grid barrier, then every store."""
    from .conv2d import _tiling   # conv2d imports this module

    n_seg = pool.shape[0]
    _check_rows(n_seg, w_in, w_out, c_in, c_out, in_ptr, out_ptr)
    _check_cuda(pool, _per_channel(w, b, mult, shift, (k, k, c_in, c_out),
                                   c_out))
    t = _tiling("ring_conv_k2d_q", h_in, w_in, h_out, w_out, c_in, c_out, k,
                stride, padding, _sm_count(pool.device))
    _launch("ring_conv_k2d_q", pool, t.smem, (w, b, mult, shift),
            (n_seg, h_in, w_in, h_out, w_out, c_in, c_out, k, stride,
             conv_k2d_pad(k, padding), conv_k2d_pad_w(k, padding),
             in_ptr % n_seg, out_ptr % n_seg, _relu(activation), t.rows,
             t.ctile))
    ring_conv_k2d_q.weights_staged = t.stage_w
    ring_conv_k2d_q.launches += 1
    return pool


def ring_conv_k2d_q_plain(pool, w, b, mult, shift, *, h_in: int, w_in: int,
                          h_out: int, w_out: int, c_in: int, c_out: int,
                          k: int = 3, stride: int = 1, padding: str = "same",
                          in_ptr: int = 0, out_ptr: int = 0,
                          activation: str | None = None):
    """Plain version of :func:`ring_conv_k2d_q` (``conv_k2d_ring_q``)."""
    _check_rows(pool.shape[0], w_in, w_out, c_in, c_out, in_ptr, out_ptr)
    img = _fetch_image(pool, in_ptr, h_in, w_in, c_in)
    acc = 0
    for r, s, tap in _taps(img, h_out, w_out, k, stride, padding):
        acc = acc + _idot(tap, w[r, s])
    acc = _acc32(acc, b, activation)
    return _store_image(pool, requantize(acc, mult, shift), out_ptr)


# ---------------------------------------------------------------------------
# Residual add.
# ---------------------------------------------------------------------------

#: Threads of a residual-add CTA (``ADD_THREADS`` in ``ring_q.cu``), each
#: taking one 32-bit word (4 lanes) of a row at a time.
ADD_THREADS = 256


def add_needs_barrier(n_seg: int, rows: int, d: int, in_ptr: int,
                      aux_ptr: int, out_ptr: int) -> bool:
    """Whether some output row of an add (``rows`` rows of ``d``
    channels, ``segs(d)`` segments each, runs at ``in_ptr``, ``aux_ptr``
    and ``out_ptr`` on a ring of ``n_seg`` segments) lands on a segment
    of an operand row of another index.  False exactly when, for each
    operand run, ``out_ptr == ptr`` (mod ``n_seg``) or the output run and
    that run share no segment (runs that wrap the ring included), and the
    runs are no longer than the ring: then a thread that reads row t and
    stores row t needs no barrier, for no other row's store lands on what
    it reads."""
    n = rows * _segs(d)
    if n > n_seg:
        return True
    for ptr in (in_ptr, aux_ptr):
        gap = (out_ptr - ptr) % n_seg
        if gap and (gap < n or n_seg - gap < n):
            return True
    return False


def add_map_rows(d: int) -> int:
    """Rows a CTA of the barrier-free add takes: one 32-bit word of each
    row's ``segs(d)`` segments a thread (at least one row)."""
    return max(1, ADD_THREADS // (_segs(d) * SEG_WIDTH // 4))


def ring_add_q(pool, *, rows: int, d: int, in_ptr: int, aux_ptr: int,
               out_ptr: int, mult_in: int, shift_in: int, mult_aux: int,
               shift_aux: int, activation: str | None = None):
    """Int8 residual add: both operands requantized to the output scale,
    summed (int32, wrapping), optional relu, saturated to int8 and
    stored at ``out_ptr`` (replaces ``ring_add_q``,
    ``src/repro/kernels/quantized.py:515``).  Where no output row lands
    on an operand row of another index (:func:`add_needs_barrier`; every
    plan's add, in place), one plain launch maps the rows, each thread
    reading a 32-bit word of row t of both operands and storing that word
    of out row t; elsewhere one cooperative launch over the row
    blocks of ``conv2d.add_tiling`` reads every row before one grid
    barrier, then stores.  ``ring_add_q.barrier`` records which."""
    from .conv2d import add_tiling   # conv2d imports this module

    n_seg = pool.shape[0]
    _check_add(n_seg, d, in_ptr, aux_ptr, out_ptr)
    _check_cuda(pool)
    in_ptr, aux_ptr, out_ptr = in_ptr % n_seg, aux_ptr % n_seg, \
        out_ptr % n_seg
    barrier = add_needs_barrier(n_seg, rows, d, in_ptr, aux_ptr, out_ptr)
    if barrier:
        t = add_tiling(rows, d, _sm_count(pool.device), "ring_add_q")
        smem, tile_rows = t.smem, t.tile_rows
    else:
        smem, tile_rows = 0, add_map_rows(d)
    _launch("ring_add_q", pool, smem, (),
            (n_seg, rows, d, in_ptr, aux_ptr, out_ptr, int(mult_in),
             int(shift_in), int(mult_aux), int(shift_aux), _relu(activation),
             int(barrier), tile_rows))
    ring_add_q.barrier = barrier
    ring_add_q.launches += 1
    return pool


def ring_add_q_plain(pool, *, rows: int, d: int, in_ptr: int, aux_ptr: int,
                     out_ptr: int, mult_in: int, shift_in: int,
                     mult_aux: int, shift_aux: int,
                     activation: str | None = None):
    """Plain version of :func:`ring_add_q` (``add_ring_q``)."""
    _check_add(pool.shape[0], d, in_ptr, aux_ptr, out_ptr)
    x = fetch_rows(pool, in_ptr, rows, d)
    res = fetch_rows(pool, aux_ptr, rows, d)
    acc = wrap_i32(requantize_i32(x, int(mult_in), int(shift_in))
                   + requantize_i32(res, int(mult_aux), int(shift_aux)))
    acc = act_i32(acc, activation)
    stage_rows(pool, acc.clamp(-128, 127).to(torch.int8), out_ptr)
    return pool


# ---------------------------------------------------------------------------
# Global average pool.
# ---------------------------------------------------------------------------

#: Threads of the pool's one CTA up to 256 channels
#: (``POOL_Q_THREADS`` in ``ring_q.cu``), and above
#: (``POOL_Q_THREADS_WIDE``).
POOL_Q_THREADS = 256
POOL_Q_THREADS_WIDE = 512
#: Pixels a part of a channel's sum takes, at the least
#: (``POOL_PIX_PER_PART`` in ``ring_q.cu``).
POOL_PIX_PER_PART = 16


@dataclasses.dataclass(frozen=True)
class PoolQTiling:
    """How :func:`ring_avgpool_q`'s one CTA cuts a pool of ``npix`` pixels
    of ``c`` channels (``ring_q.cu::avgpool_q_kernel``): ``threads``
    threads stage ``chunk_pix`` pixels at a time (all of a plan's), and
    thread ``(j, ch)``, channels fastest over ``cw`` lanes (a power of two
    at least ``c`` and 32), adds channel ``ch`` of pixels ``j, j + parts,
    ...``; then a thread a channel adds its ``parts`` partials.  ``smem``
    is the CTA's shared memory in bytes: the int32 partials
    ``[parts, cw]``, then a chunk of pixels."""

    c: int
    npix: int
    threads: int
    cw: int
    parts: int
    chunk_pix: int

    @property
    def smem(self) -> int:
        return 4 * self.parts * self.cw + self.chunk_pix * _segs(self.c) \
            * SEG_WIDTH


def _pool_rule(cls, kernel: str, h: int, w: int, c: int,
               pixel_bytes: int):
    """The rule of :func:`pool_q_tiling` and ``conv2d.pool_tiling``:
    ``threads`` = :data:`POOL_Q_THREADS` up to that many channels, else
    :data:`POOL_Q_THREADS_WIDE`; ``parts`` = clamp(``h w //
    POOL_PIX_PER_PART``, 1, ``threads // cw``); and as many pixels of
    ``pixel_bytes`` a chunk as fit ``MAX_SMEM`` beside the partials, a
    multiple of ``parts`` where that is fewer than all.  Raises
    ``ValueError``, naming the pool's shape, when not one pixel fits."""
    npix = h * w
    threads = POOL_Q_THREADS if c <= POOL_Q_THREADS else POOL_Q_THREADS_WIDE
    cw = max(32, 1 << (c - 1).bit_length())
    parts = max(1, min(npix // POOL_PIX_PER_PART, threads // cw))
    fit = (MAX_SMEM - 4 * parts * cw) // pixel_bytes
    chunk = npix if fit >= npix else fit // parts * parts
    if chunk < 1:
        raise ValueError(f"{kernel}: no pixel of the pool [{h}, {w}, {c}] "
                         f"fits {MAX_SMEM} B of shared memory")
    return cls(c, npix, threads, cw, parts, chunk)


@functools.lru_cache(maxsize=1024)
def pool_q_tiling(h: int, w: int, c: int) -> PoolQTiling:
    """The tiling of a ``ring_avgpool_q`` call (:func:`_pool_rule`, a
    pixel staged as its whole segments)."""
    return _pool_rule(PoolQTiling, "ring_avgpool_q", h, w, c,
                      _segs(c) * SEG_WIDTH)


def ring_avgpool_q(pool, *, h: int, w: int, c: int, in_ptr: int,
                   out_ptr: int, mult: int, shift: int):
    """Int8 global average pool: int32 column sums, one requantized
    output row stored after every read (replaces ``ring_avgpool_q``,
    ``src/repro/kernels/quantized.py:603``).  One CTA in an ordinary
    launch (:func:`pool_q_tiling`): every thread stages 16-byte vectors
    of the pixels, then sums one channel over a share of them; after
    every read a thread a channel adds the shares, requantizes and
    stores."""
    n_seg = pool.shape[0]
    _check_avgpool(n_seg, w, c, in_ptr, out_ptr)
    _check_cuda(pool)
    t = pool_q_tiling(h, w, c)
    _launch("ring_avgpool_q", pool, t.smem, (),
            (n_seg, h, w, c, in_ptr % n_seg, out_ptr % n_seg, int(mult),
             int(shift), t.chunk_pix))
    ring_avgpool_q.launches += 1
    return pool


def ring_avgpool_q_plain(pool, *, h: int, w: int, c: int, in_ptr: int,
                         out_ptr: int, mult: int, shift: int):
    """Plain version of :func:`ring_avgpool_q` (``pool_avg_ring_q``)."""
    _check_avgpool(pool.shape[0], w, c, in_ptr, out_ptr)
    img = fetch_rows(pool, in_ptr, h * w, c).to(torch.int64)
    acc = img.sum(dim=0, keepdim=True).to(torch.int32)
    stage_rows(pool, requantize(acc, int(mult), int(shift)), out_ptr)
    return pool


# ---------------------------------------------------------------------------
# Plain-version helpers.
# ---------------------------------------------------------------------------

def _idot(x, w):
    """Exact integer ``x @ w`` over the last axis of ``x`` (int64;
    broadcast multiply and sum, which every device supports for
    integers)."""
    return (x.unsqueeze(-1) * w.to(torch.int64)).sum(dim=-2)


def _acc32(acc, b, activation):
    """The reference's int32 accumulator: the exact sum taken mod 2**32,
    plus the bias in int32 arithmetic, then the int32 activation."""
    acc = acc.to(torch.int32) + b.to(torch.int32)
    return act_i32(acc, activation)


def _fetch_image(pool, ptr, h, w, c):
    return fetch_rows(pool, ptr, h * w, c).reshape(h, w, c).to(torch.int64)


def _store_image(pool, q, out_ptr):
    stage_rows(pool, q.reshape(-1, q.shape[-1]), out_ptr)
    return pool


def _taps(img, h_out, w_out, k, stride, padding):
    """``(r, s, tap)`` for every tap of a k x k conv: ``tap`` is the
    ``[h_out, w_out, c]`` strided slice of the zero-padded image."""
    h_in, w_in, c = img.shape
    pad_t = conv_k2d_pad(k, padding)
    pad_l = conv_k2d_pad_w(k, padding)
    pad_b = max(0, stride * (h_out - 1) + k - pad_t - h_in)
    pad_r = max(0, stride * (w_out - 1) + k - pad_l - w_in)
    padded = img.new_zeros((pad_t + h_in + pad_b, pad_l + w_in + pad_r, c))
    padded[pad_t:pad_t + h_in, pad_l:pad_l + w_in] = img
    for r in range(k):
        for s in range(k):
            yield r, s, padded[r:r + stride * (h_out - 1) + 1:stride,
                               s:s + stride * (w_out - 1) + 1:stride]


#: The wrappers, by name (what the CUDA executor launches) ...
KERNELS = {f.__name__: f for f in (ring_gemm_q, ring_conv_pw_q,
                                   ring_conv_dw_q, ring_conv_k2d_q,
                                   ring_add_q, ring_avgpool_q)}
#: ... and their plain versions under the same names.
PLAIN = {name: globals()[f"{name}_plain"] for name in KERNELS}

for _f in KERNELS.values():
    _f.launches = 0
    _f.weights_staged = None
ring_add_q.barrier = None
ring_gemm_q.barrier = None
