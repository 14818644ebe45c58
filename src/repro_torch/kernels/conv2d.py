"""Fp32 ring conv, residual and pool kernels: CUDA wrappers and their
plain PyTorch versions.

Counterpart of :mod:`repro.kernels.conv2d`: the pointwise, depthwise and
k x k convs, the residual add and the global average pool of a whole
network on the fp32 ring.  Each wrapper takes the reference kernel's
arguments, raises its ``ValueError`` on a misaligned pool or pointer,
checks device, dtype, shape and contiguity, and launches its
hand-written kernel (``csrc/ring_f32.cu``) on the current CUDA stream
without synchronising; it updates the pool in place and returns it.  A
wrapper never falls back to its plain version: it raises on anything
but CUDA tensors.  It counts its launches in ``<wrapper>.launches``; a
conv wrapper records in ``<wrapper>.weights_staged`` whether its last
launch staged the weights (each CTA's weight slice) in shared memory
(None for the add and the pool, which have none).  The wrappers size
every kernel's shared memory at 4 bytes per element.

The pointwise, depthwise and k x k convs, the streaming conv
(:mod:`repro_torch.kernels.stream`) and the residual add run many CTAs
that read all of the op's input before any stores (one grid-wide barrier
between); :func:`conv_tiling` and :func:`add_tiling` are how they cut an
op into tiles, one per CTA.  The average pool is one CTA in an ordinary
launch whose threads each sum a share of a channel's pixels
(:func:`pool_tiling`).  The pointwise conv's ``row_block`` is the
reference's argument and is checked as the reference checks it; it
shapes nothing, here or in the plain version.

Beside each wrapper sits its plain version (``<name>_plain``), a port
of the reference's jnp executor op (``conv_pw_ring``, ``conv_dw_ring``,
``conv_k2d_ring``, ``add_ring``, ``pool_avg_ring``): gather every input
row, compute in fp32, scatter.  On a certified plan that leaves the
pool the kernels leave, up to the order of fp32 sums.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.program import resolve_activation
from ..core.rowsched import conv_k2d_pad, conv_k2d_pad_w, resample_src
from ..core.vpool import SEG_WIDTH, fetch_rows, stage_rows
from ._launch import H100_SMS, MAX_SMEM, _sm_count, check_cuda, launch
from .quantized import PoolQTiling, _check_add, _check_avgpool, _check_pw, \
    _check_rows, _pool_rule, _taps
from .segment_matmul import F32, act_code


def _weights(w, b, w_shape, c_out):
    return (("w", w, F32, w_shape), ("b", b, F32, (c_out,)))


def _fetch_image(pool, ptr, h, w, c):
    return fetch_rows(pool, ptr, h * w, c).reshape(h, w, c).to(F32)


def _store_image(pool, y, out_ptr):
    stage_rows(pool, y.reshape(-1, y.shape[-1]), out_ptr)
    return pool


# ---------------------------------------------------------------------------
# Pointwise conv.
# ---------------------------------------------------------------------------

def ring_conv_pw(pool, w, b, *, h_in: int, w_in: int, h_out: int,
                 w_out: int, c_in: int, c_out: int, stride: int = 1,
                 resample: bool = False, in_ptr: int = 0, out_ptr: int = 0,
                 activation: str | None = None, row_block: int = 1):
    """Fp32 pointwise conv ``[h_in, w_in, c_in] -> [h_out, w_out, c_out]``
    in the ring (replaces ``ring_conv_pw``,
    ``src/repro/kernels/conv2d.py:108``).  ``row_block`` is checked as the
    reference does (blocking requires the identity pixel map) and shapes
    nothing: the kernel runs the tiles of :func:`conv_tiling`."""
    n_seg = pool.shape[0]
    _check_pw(n_seg, h_out, w_in, w_out, c_in, c_out, stride, resample,
              in_ptr, out_ptr, row_block)
    check_cuda(pool, _weights(w, b, (c_in, c_out), c_out), dtype=F32)
    t = _pw_tiling(h_in, w_in, h_out, w_out, c_in, c_out, stride, resample,
                   _sm_count(pool.device))
    launch("ring_conv_pw", pool, t.smem, (w, b),
           (n_seg, h_in, w_in, h_out, w_out, c_in, c_out, stride,
            int(resample), in_ptr % n_seg, out_ptr % n_seg,
            act_code(activation), t.rows, t.ctile, int(t.stage_w)))
    ring_conv_pw.weights_staged = t.stage_w
    ring_conv_pw.launches += 1
    return pool


def ring_conv_pw_plain(pool, w, b, *, h_in: int, w_in: int, h_out: int,
                       w_out: int, c_in: int, c_out: int, stride: int = 1,
                       resample: bool = False, in_ptr: int = 0,
                       out_ptr: int = 0, activation: str | None = None,
                       row_block: int = 1):
    """Plain version of :func:`ring_conv_pw` (``conv_pw_ring``);
    ``row_block`` is execution granularity and changes nothing here."""
    _check_pw(pool.shape[0], h_out, w_in, w_out, c_in, c_out, stride,
              resample, in_ptr, out_ptr, row_block)
    act = resolve_activation(activation)
    img = _fetch_image(pool, in_ptr, h_in, w_in, c_in)
    ridx = pw_sources(h_in, h_out, stride, resample)
    cidx = pw_sources(w_in, w_out, stride, resample)
    sub = img[ridx][:, cidx]
    y = torch.einsum("hwc,cd->hwd", sub, w.to(F32))
    return _store_image(pool, act(y + b.to(F32)), out_ptr)


def pw_sources(n_in: int, n_out: int, stride: int,
               resample: bool) -> list[int]:
    """The source row (column) of each output row (column) of a pointwise
    conv: ``p * stride``, or the nearest-grid pick when resampling."""
    if resample:
        return [resample_src(p, n_in, n_out) for p in range(n_out)]
    return [p * stride for p in range(n_out)]


# ---------------------------------------------------------------------------
# Tiling of the convs that read first: pointwise, depthwise, k x k and
# streaming, fp32, and the int8 pointwise and k x k convs.
# ---------------------------------------------------------------------------

#: Output-channel tiles a k x k conv may take (a smaller ``c_out`` is one
#: tile); every one divides a segment.
K2D_CHANNEL_TILES = (4, 8, 16, 32)
#: The pointwise convs, fp32 and int8.
PW_KERNELS = ("ring_conv_pw", "ring_conv_pw_q")
#: The depthwise convs, fp32 and int8: channel tiles of one segment.
DW_KERNELS = ("ring_conv_dw", "ring_conv_dw_q")
#: The streaming convs, fp32 and int8: the k x k conv's tiles over the
#: window, each CTA also copying back a share of the window's rows.
STREAM_KERNELS = ("ring_conv_stream", "ring_conv_stream_q")


@dataclasses.dataclass(frozen=True)
class ConvTiling:
    """How :func:`ring_conv_pw` / :func:`ring_conv_dw` /
    :func:`ring_conv_k2d` / ``ring_conv_stream`` and the int8
    ``ring_conv_pw_q`` / ``ring_conv_dw_q`` / ``ring_conv_k2d_q`` /
    ``ring_conv_stream_q`` cut an op: CTA i owns
    tile i, ``rows`` output image rows (fewer in the last block) by
    ``ctile`` output channels, channel tiles fastest; ``ctas`` is at most
    the SM count, so all of them are resident at once.  A streaming conv's
    CTA i also copies back window rows ``i * win_rows ..``
    (:meth:`window`; ``h_in`` is the window's ``h_win``).  ``smem`` is one
    CTA's shared memory in bytes (a pointwise conv's staged source pixels,
    a k x k or streaming conv's staged input rows and its window rows, or
    a depthwise conv's input row segments, the held outputs, the bias, the
    weight slice when ``stage_w``, the output row segments; an int8
    conv's as :func:`_conv_smem_q` counts them), ``held`` the bytes of
    outputs and window rows it keeps across the grid barrier (an fp32
    stream's window row holds its ``w_in * c_in`` live floats, an int8
    one's its whole segments, ``win_row_len`` elements)."""

    kernel: str
    h_in: int
    h_out: int
    w_out: int
    c_out: int
    k: int
    stride: int
    pad_v: int
    rows: int
    ctile: int
    stage_w: bool
    smem: int
    win_rows: int = 0       # a streaming conv's window rows per CTA
    win_row_len: int = 0    # their elements a row: see above
    resample: bool = False  # a pointwise conv's nearest-grid pixel map

    @property
    def channel_tiles(self) -> int:
        return -(-self.c_out // self.ctile)

    @property
    def ctas(self) -> int:
        return -(-self.h_out // self.rows) * self.channel_tiles

    @property
    def halo(self) -> int:
        """Input rows a CTA's taps can reach."""
        return (self.rows - 1) * self.stride + self.k

    @property
    def elem(self) -> int:
        """Bytes of an element: 1 for an int8 conv, else 4."""
        return 1 if self.kernel.endswith("_q") else 4

    @property
    def held(self) -> int:
        return self.elem * (self.rows * self.w_out * self.ctile
                            + self.win_rows * self.win_row_len)

    def window(self, i: int) -> tuple[int, int]:
        """CTA ``i``'s window rows of a streaming conv's writeback, ``(r0,
        n)``: rows ``r0 .. r0 + n - 1`` (``n`` 0 past the window's end)."""
        r0 = i * self.win_rows
        return r0, max(0, min(self.win_rows, self.h_in - r0))

    def tile(self, i: int) -> tuple[int, int, int, int, int, int]:
        """CTA ``i``'s ``(p0, np, c0, cn, lo, nh)``: output rows ``p0 ..
        p0 + np - 1``, channels ``c0 .. c0 + cn - 1`` and the input rows
        ``lo .. lo + nh - 1`` inside the image that its taps reach (the
        kernel's ``conv_tile``; a pointwise conv's are the span of its
        source rows, :func:`pw_sources`, of which it stages only the
        picked pixels)."""
        rb, cb = divmod(i, self.channel_tiles)
        p0, c0 = rb * self.rows, cb * self.ctile
        np_ = min(self.rows, self.h_out - p0)
        if self.kernel in PW_KERNELS:
            src = pw_sources(self.h_in, self.h_out, self.stride,
                             self.resample)[p0:p0 + np_]
            lo, nh = src[0], src[-1] - src[0] + 1
        else:
            top = p0 * self.stride - self.pad_v
            lo = max(0, top)
            nh = max(0, min(self.h_in - 1, top + (np_ - 1) * self.stride
                            + self.k - 1) - lo + 1)
        return p0, np_, c0, min(self.ctile, self.c_out - c0), lo, nh


def _conv_smem(rows, ctile, stage_w, *, w_in, w_out, c_in, k, stride,
               kind, win_rows=0) -> int:
    """Bytes of a conv CTA's shared memory (``conv_smem_layout``): a
    pointwise conv keeps the source pixel of each output (``c_in | 1``
    floats a pixel), a depthwise conv its input rows' ring segments, a k x
    k conv the rows themselves, a streaming conv also its ``win_rows``
    window rows."""
    halo = (rows - 1) * stride + k
    if kind == "ring_conv_pw":
        rows_in = rows * w_out * (c_in | 1)
    elif kind == "ring_conv_dw":
        rows_in = halo
    else:
        rows_in = (halo + win_rows) * w_in * c_in
    w_len = k * k * ctile * (1 if kind == "ring_conv_dw" else c_in)
    return 4 * (rows_in + rows * w_out * ctile + ctile
                + (w_len if stage_w else 0) + rows)


def q_pixel_pitch(c_in: int) -> int:
    """Bytes an int8 conv CTA keeps of one staged pixel (and of one output
    channel's weights at one tap): its live channels in whole 16-byte
    chunks, an odd number of them, so that the 16-byte shared loads of
    neighbouring pixels and channels fall in different banks (the
    kernels' ``pitch``)."""
    return 16 * (-(-c_in // 16) | 1)


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def _conv_smem_q(rows, ctile, *, w_in, w_out, c_in, k, stride, kind,
                 win_rows=0) -> int:
    """Bytes of an int8 conv CTA's shared memory
    (``ring_q.cu::conv_q_layout``): the staged pixels (the pointwise
    conv's source pixel of each output, the k x k, streaming and
    depthwise conv's halo rows, then a streaming conv's ``win_rows``
    window rows as whole segments, ``conv_stream_q_layout``), the held
    int8 outputs, bias, mult and shift (4 bytes each a channel), the
    weight slice and the output rows' ring segments; each part from a
    16-byte boundary.  A pw / k x k / streaming pixel takes
    :func:`q_pixel_pitch` bytes and its weight slice ``[k * k, ctile,
    pitch]``; a depthwise pixel only its channel tile's bytes, ``ctile``
    in whole 16-byte chunks, and its weight slice ``[k * k, ctile]``,
    each tap's channels in whole 32-bit words."""
    if kind == "ring_conv_dw_q":
        pixel, w_len = _r16(ctile), _r16(k * k * -(-ctile // 4) * 4)
    else:
        pixel = q_pixel_pitch(c_in)
        w_len = k * k * ctile * pixel
    pixels = rows * w_out if kind in PW_KERNELS \
        else ((rows - 1) * stride + k) * w_in
    window = win_rows * _win_row_len(kind, w_in, c_in)
    return (pixels * pixel + window + _r16(rows * w_out * ctile)
            + _r16(12 * ctile) + w_len + 4 * rows)


def conv_tiling(kernel: str, kw: dict, n_sm: int = H100_SMS) -> ConvTiling:
    """The tiling of a ``ring_conv_pw`` / ``ring_conv_dw`` /
    ``ring_conv_k2d`` / ``ring_conv_stream`` / ``ring_conv_pw_q`` /
    ``ring_conv_dw_q`` / ``ring_conv_k2d_q`` / ``ring_conv_stream_q``
    call (its kwargs ``kw``) over at most ``n_sm`` CTAs.

    A depthwise conv (fp32 or int8) takes channel tiles of one segment (``min(c,
    128)``); a k x k or pointwise conv (k = 1, each output reading one
    source pixel) the ``K2D_CHANNEL_TILES`` entry (or ``c_out``) that
    gives the fewest outputs per CTA, ties to the wider tile, and a
    streaming conv the k x k conv's tiles over its window (``h_in =
    h_win``), its ``h_win`` window rows shared out in equal blocks.  Each
    takes the fewest output rows per tile that keep the tiles within
    ``n_sm``, and stages its weight slice when it fits beside the rest
    (an int8 conv's tile always stages it, at int8 widths).  Raises
    ``ValueError``, naming the op's geometry, when no tile fits
    ``MAX_SMEM``."""
    dw = kernel in DW_KERNELS
    if kernel in PW_KERNELS:
        return _pw_tiling(kw["h_in"], kw["w_in"], kw["h_out"], kw["w_out"],
                          kw["c_in"], kw["c_out"], kw.get("stride", 1),
                          bool(kw.get("resample")), n_sm, kernel)
    if kernel in STREAM_KERNELS:
        return _tiling(kernel, kw["h_win"], kw["w_in"], kw["h_out"],
                       kw["w_out"], kw["c_in"], kw["c_out"], kw["k"],
                       kw["stride"], kw["padding"], n_sm)
    return _tiling(kernel, kw["h_in"], kw["w_in"], kw["h_out"], kw["w_out"],
                   kw["c"] if dw else kw["c_in"],
                   kw["c"] if dw else kw["c_out"],
                   kw["rs"] if dw else kw["k"], kw["stride"], kw["padding"],
                   n_sm)


def _pw_tiling(h_in, w_in, h_out, w_out, c_in, c_out, stride, resample,
               n_sm, kernel="ring_conv_pw") -> ConvTiling:
    return _tiling(kernel, h_in, w_in, h_out, w_out, c_in, c_out, 1,
                   stride, "valid", n_sm, resample)


def _win_row_len(kernel, w_in, c_in) -> int:
    """Elements a streaming conv CTA holds of one window row: the fp32
    kernel's live channels, the int8 one's whole segments (a raw copy)."""
    if kernel == "ring_conv_stream":
        return w_in * c_in
    if kernel == "ring_conv_stream_q":
        return w_in * -(-c_in // SEG_WIDTH) * SEG_WIDTH
    return 0


@functools.lru_cache(maxsize=4096)
def _tiling(kernel, h_in, w_in, h_out, w_out, c_in, c_out, k, stride,
            padding, n_sm, resample=False) -> ConvTiling:
    """:func:`conv_tiling` by geometry, once per geometry (a wrapper
    calls it on every launch)."""
    dw = kernel in DW_KERNELS
    stream = kernel in STREAM_KERNELS
    tiles = [min(c_out, SEG_WIDTH)] if dw else \
        sorted({min(c_out, t) for t in K2D_CHANNEL_TILES})
    best = None
    for ctile in tiles:
        per_row = -(-c_out // ctile)
        if per_row > n_sm:
            continue
        rows = -(-h_out // (n_sm // per_row))
        win_rows = -(-h_in // (-(-h_out // rows) * per_row)) if stream else 0
        geom = dict(w_in=w_in, w_out=w_out, c_in=c_in, k=k, stride=stride,
                    kind=kernel)
        if kernel.endswith("_q"):
            smem, stage_w = _conv_smem_q(rows, ctile, win_rows=win_rows,
                                         **geom), True
            if smem > MAX_SMEM:
                continue
        else:
            smem = _conv_smem(rows, ctile, True, win_rows=win_rows, **geom)
            stage_w = smem <= MAX_SMEM
            if not stage_w:
                smem = _conv_smem(rows, ctile, False, win_rows=win_rows,
                                  **geom)
                if smem > MAX_SMEM:
                    continue
        key = (rows * ctile, -ctile)
        if best is None or key < best[0]:
            best = key, ConvTiling(
                kernel, h_in, h_out, w_out, c_out, k, stride,
                conv_k2d_pad(k, padding), rows, ctile, stage_w, smem,
                win_rows, _win_row_len(kernel, w_in, c_in), resample)
    if best is None:
        raise ValueError(
            f"{kernel}: no tile of the op [{h_in}, {w_in}, {c_in}] -> "
            f"[{h_out}, {w_out}, {c_out}], k {k}, stride {stride}, fits "
            f"{MAX_SMEM} B of shared memory over at most {n_sm} CTAs")
    return best[1]


def ring_conv_dw(pool, w, b, *, h_in: int, w_in: int, h_out: int,
                 w_out: int, c: int, rs: int = 3, stride: int = 1,
                 padding: str = "same", in_ptr: int = 0, out_ptr: int = 0,
                 activation: str | None = None):
    """Fp32 depthwise RSxRS conv inside the ring; ``w`` is ``[rs, rs, c]``
    (replaces ``ring_conv_dw``, ``src/repro/kernels/conv2d.py:225``)."""
    n_seg = pool.shape[0]
    _check_rows(n_seg, w_in, w_out, c, c, in_ptr, out_ptr)
    check_cuda(pool, _weights(w, b, (rs, rs, c), c), dtype=F32)
    t = _tiling("ring_conv_dw", h_in, w_in, h_out, w_out, c, c, rs, stride,
                padding, _sm_count(pool.device))
    launch("ring_conv_dw", pool, t.smem, (w, b),
           (n_seg, h_in, w_in, h_out, w_out, c, rs, stride,
            conv_k2d_pad(rs, padding), conv_k2d_pad_w(rs, padding),
            in_ptr % n_seg, out_ptr % n_seg, act_code(activation), t.rows,
            int(t.stage_w)))
    ring_conv_dw.weights_staged = t.stage_w
    ring_conv_dw.launches += 1
    return pool


def ring_conv_dw_plain(pool, w, b, *, h_in: int, w_in: int, h_out: int,
                       w_out: int, c: int, rs: int = 3, stride: int = 1,
                       padding: str = "same", in_ptr: int = 0,
                       out_ptr: int = 0, activation: str | None = None):
    """Plain version of :func:`ring_conv_dw` (``conv_dw_ring``)."""
    _check_rows(pool.shape[0], w_in, w_out, c, c, in_ptr, out_ptr)
    act = resolve_activation(activation)
    img = _fetch_image(pool, in_ptr, h_in, w_in, c)
    acc = torch.zeros((h_out, w_out, c), dtype=F32, device=pool.device)
    for r, s, tap in _taps(img, h_out, w_out, rs, stride, padding):
        acc = acc + tap * w[r, s].to(F32)
    return _store_image(pool, act(acc + b.to(F32)), out_ptr)


def ring_conv_k2d(pool, w, b, *, h_in: int, w_in: int, h_out: int,
                  w_out: int, c_in: int, c_out: int, k: int = 3,
                  stride: int = 1, padding: str = "same", in_ptr: int = 0,
                  out_ptr: int = 0, activation: str | None = None):
    """Fp32 k x k conv ``[h_in, w_in, c_in] -> [h_out, w_out, c_out]``
    inside the ring; ``w`` is ``[k, k, c_in, c_out]`` (replaces
    ``ring_conv_k2d``, ``src/repro/kernels/conv2d.py:336``)."""
    n_seg = pool.shape[0]
    _check_rows(n_seg, w_in, w_out, c_in, c_out, in_ptr, out_ptr)
    check_cuda(pool, _weights(w, b, (k, k, c_in, c_out), c_out), dtype=F32)
    t = _tiling("ring_conv_k2d", h_in, w_in, h_out, w_out, c_in, c_out, k,
                stride, padding, _sm_count(pool.device))
    launch("ring_conv_k2d", pool, t.smem, (w, b),
           (n_seg, h_in, w_in, h_out, w_out, c_in, c_out, k, stride,
            conv_k2d_pad(k, padding), conv_k2d_pad_w(k, padding),
            in_ptr % n_seg, out_ptr % n_seg, act_code(activation), t.rows,
            t.ctile, int(t.stage_w)))
    ring_conv_k2d.weights_staged = t.stage_w
    ring_conv_k2d.launches += 1
    return pool


def ring_conv_k2d_plain(pool, w, b, *, h_in: int, w_in: int, h_out: int,
                        w_out: int, c_in: int, c_out: int, k: int = 3,
                        stride: int = 1, padding: str = "same",
                        in_ptr: int = 0, out_ptr: int = 0,
                        activation: str | None = None):
    """Plain version of :func:`ring_conv_k2d` (``conv_k2d_ring``)."""
    _check_rows(pool.shape[0], w_in, w_out, c_in, c_out, in_ptr, out_ptr)
    act = resolve_activation(activation)
    img = _fetch_image(pool, in_ptr, h_in, w_in, c_in)
    acc = torch.zeros((h_out, w_out, c_out), dtype=F32, device=pool.device)
    for r, s, tap in _taps(img, h_out, w_out, k, stride, padding):
        acc = acc + torch.einsum("hwc,cd->hwd", tap, w[r, s].to(F32))
    return _store_image(pool, act(acc + b.to(F32)), out_ptr)


# ---------------------------------------------------------------------------
# Residual add.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AddTiling:
    """How :func:`ring_add` (and the int8 ``ring_add_q`` where its op
    needs a barrier) cuts an op of ``rows`` rows of ``d`` channels: CTA i
    owns rows ``i * tile_rows ..`` (fewer in the last block) and holds
    ``act(x + r)`` of their live channels across the grid barrier
    (``held`` bytes, at :attr:`elem` bytes an element, its whole shared
    memory ``smem``)."""

    rows: int
    d: int
    tile_rows: int
    kernel: str = "ring_add"

    @property
    def ctas(self) -> int:
        return -(-self.rows // self.tile_rows)

    @property
    def elem(self) -> int:
        """Bytes of an element: 1 for the int8 add, else 4."""
        return 1 if self.kernel.endswith("_q") else 4

    @property
    def smem(self) -> int:
        return self.elem * self.tile_rows * self.d

    held = smem

    def tile(self, i: int) -> tuple[int, int]:
        """CTA ``i``'s rows ``(r0, n)``: ``r0 .. r0 + n - 1``."""
        r0 = i * self.tile_rows
        return r0, min(self.tile_rows, self.rows - r0)


@functools.lru_cache(maxsize=4096)
def add_tiling(rows: int, d: int, n_sm: int = H100_SMS,
               kernel: str = "ring_add") -> AddTiling:
    """The tiling of a ``ring_add`` (or ``ring_add_q``, ``kernel``) call
    over at most ``n_sm`` CTAs: the fewest rows per CTA that keep the
    CTAs within ``n_sm``.  Raises ``ValueError``, naming the op's
    geometry, when a CTA's rows do not fit ``MAX_SMEM``."""
    t = AddTiling(rows, d, -(-rows // n_sm), kernel)
    if t.smem > MAX_SMEM:
        raise ValueError(
            f"{kernel}: {rows} rows of {d} channels over at most {n_sm} "
            f"CTAs hold {t.smem} B a CTA, above {MAX_SMEM} B of shared "
            "memory")
    return t


def ring_add(pool, *, rows: int, d: int, in_ptr: int, aux_ptr: int,
             out_ptr: int, activation: str | None = None):
    """``Out[t] = act(In[t] + Res[t])`` over ``rows`` pixel rows, the
    residual read from the held rows at ``aux_ptr`` (replaces
    ``ring_add``, ``src/repro/kernels/conv2d.py:432``)."""
    n_seg = pool.shape[0]
    _check_add(n_seg, d, in_ptr, aux_ptr, out_ptr)
    check_cuda(pool, dtype=F32)
    t = add_tiling(rows, d, _sm_count(pool.device))
    launch("ring_add", pool, t.smem, (),
           (n_seg, rows, d, in_ptr % n_seg, aux_ptr % n_seg,
            out_ptr % n_seg, act_code(activation), t.tile_rows))
    ring_add.launches += 1
    return pool


def ring_add_plain(pool, *, rows: int, d: int, in_ptr: int, aux_ptr: int,
                   out_ptr: int, activation: str | None = None):
    """Plain version of :func:`ring_add` (``add_ring``)."""
    _check_add(pool.shape[0], d, in_ptr, aux_ptr, out_ptr)
    act = resolve_activation(activation)
    x = fetch_rows(pool, in_ptr, rows, d).to(F32)
    res = fetch_rows(pool, aux_ptr, rows, d).to(F32)
    stage_rows(pool, act(x + res), out_ptr)
    return pool


# ---------------------------------------------------------------------------
# Global average pool.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PoolTiling(PoolQTiling):
    """How :func:`ring_avgpool`'s one CTA cuts a pool
    (``ring_f32.cu::avgpool_f32_kernel<threads>``): as
    :class:`~repro_torch.kernels.quantized.PoolQTiling`, but the threads
    stage only the live float4s of each pixel, and the partials are fp32.
    ``smem``: the partials ``[parts, cw]``, then a chunk of pixels of ``4
    ceil(c / 4)`` floats each."""

    @property
    def smem(self) -> int:
        return 4 * self.parts * self.cw + 16 * -(-self.c // 4) * self.chunk_pix


@functools.lru_cache(maxsize=1024)
def pool_tiling(h: int, w: int, c: int) -> PoolTiling:
    """The tiling of a ``ring_avgpool`` call: the int8 pool's rule
    (``quantized._pool_rule``: 256 threads up to 256 channels, else 512;
    parts of at least 16 pixels), a pixel staged as its live float4s.
    Raises ``ValueError``, naming the pool's shape, when not one pixel
    fits."""
    return _pool_rule(PoolTiling, "ring_avgpool", h, w, c, 16 * -(-c // 4))


def ring_avgpool(pool, *, h: int, w: int, c: int, in_ptr: int,
                 out_ptr: int):
    """Global average pool ``[h, w, c] -> [1, c]`` in the ring: fp32 sums,
    one division by ``h * w``, one output row stored after every read
    (replaces ``ring_avgpool``, ``src/repro/kernels/conv2d.py:514``).  One
    CTA in an ordinary launch (:func:`pool_tiling`): every thread stages
    16-byte vectors of the pixels, then sums one channel over a share of
    them; after every read a thread a channel adds the shares, divides and
    stores."""
    n_seg = pool.shape[0]
    _check_avgpool(n_seg, w, c, in_ptr, out_ptr)
    check_cuda(pool, dtype=F32)
    t = pool_tiling(h, w, c)
    launch("ring_avgpool", pool, t.smem, (),
           (n_seg, h, w, c, in_ptr % n_seg, out_ptr % n_seg, t.threads,
            t.parts, t.chunk_pix))
    ring_avgpool.launches += 1
    return pool


def ring_avgpool_plain(pool, *, h: int, w: int, c: int, in_ptr: int,
                       out_ptr: int):
    """Plain version of :func:`ring_avgpool` (``pool_avg_ring``)."""
    _check_avgpool(pool.shape[0], w, c, in_ptr, out_ptr)
    img = _fetch_image(pool, in_ptr, h, w, c)
    stage_rows(pool, torch.mean(img, dim=(0, 1))[None, :], out_ptr)
    return pool


#: The wrappers, by name (what the CUDA executor launches) ...
KERNELS = {f.__name__: f for f in (ring_conv_pw, ring_conv_dw,
                                   ring_conv_k2d, ring_add, ring_avgpool)}
#: ... and their plain versions under the same names.
PLAIN = {name: globals()[f"{name}_plain"] for name in KERNELS}

for _f in KERNELS.values():
    _f.launches = 0
    _f.weights_staged = None
