"""The fused inverted bottleneck (paper Fig. 6): CUDA wrapper and plain
version.

Counterpart of :mod:`repro.kernels.inverted_bottleneck`: PW-expand and
relu, DW RSxRS ('same' padding, stride 1) and relu, PW-project, plus the
residual, over an fp32 image ``A [H, W, C_in]`` held one segment per
pixel at ``in_ptr``; ``E [H, W, C_out]`` goes to ``out_ptr``, often in
place.

The kernel runs the op as one cooperative launch over the CTAs of
:func:`ib_tiling`: each CTA owns a tile of output pixels, computes them
from the A pixels its taps reach (their ``C_mid``-wide expansion lives
in shared memory and never reaches the ring) and holds them; after one
grid-wide barrier every CTA stores its pixels.  Every read thus sees the pool from before the op, as the
reference's sequential walk does on a certified plan, in place too.

:func:`ring_inverted_bottleneck` takes the reference kernel's arguments,
raises its ``ValueError`` on channel widths beyond the segment geometry,
checks device, dtype, shape and contiguity and launches the hand-written
kernel of ``csrc/ring_f32.cu`` on the current CUDA stream without
synchronising; it never falls back to its plain version.  It counts its
launches in ``ring_inverted_bottleneck.launches`` and records in
``.weights_staged`` whether its last launch staged w1, wd and w2 in
each CTA's shared memory.

:func:`ring_inverted_bottleneck_plain` is the port of the reference's
jnp executor op (``ib_fused_ring``): read the whole of A, compute
:func:`inverted_bottleneck_ref`, store E.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.vpool import SEG_WIDTH, fetch_rows, stage_rows
from ._launch import MAX_SMEM, check_cuda, launch
from .conv2d import H100_SMS, _sm_count
from .segment_matmul import F32

#: Threads of a bottleneck CTA (``THREADS`` of ``csrc/ring_f32.cu``).
IB_THREADS = 1024
#: What one more sub-tile costs a CTA beyond its FMA chains, in FMA
#: steps: its four ``__syncthreads`` and the wait for its staged pixels.
_SUBTILE_STEPS = 100


def _check_ib(C_in: int, C_mid: int, C_out: int, residual: bool) -> None:
    """The reference kernel's check, and the residual's shape."""
    if max(C_in, C_out) > SEG_WIDTH or C_mid > 8 * SEG_WIDTH:
        raise ValueError("channel widths exceed segment geometry")
    if residual and C_in != C_out:
        raise ValueError(f"a residual needs C_in == C_out, got {C_in} "
                         f"and {C_out}")


def inverted_bottleneck_ref(a, w1, wd, w2, *, residual: bool = True):
    """Oracle: ``A [H, W, C_in] -> E [H, W, C_out]``, stride 1, 'same'
    padding, relu after PW1 and DW (the reference's
    ``inverted_bottleneck_ref``)."""
    H, W, _ = a.shape
    rs = wd.shape[0]
    pad = (rs - 1) // 2
    a = a.to(F32)
    b = torch.relu(torch.einsum("hwc,cm->hwm", a, w1.to(F32)))
    bp = torch.nn.functional.pad(b, (0, 0, pad, pad, pad, pad))
    c = sum(bp[r:r + H, s:s + W] * wd[r, s].to(F32)
            for r in range(rs) for s in range(rs))
    e = torch.einsum("hwm,mo->hwo", torch.relu(c), w2.to(F32))
    return e + a if residual else e


@dataclasses.dataclass(frozen=True)
class IbTiling:
    """How :func:`ring_inverted_bottleneck` cuts an op: CTA i owns the
    output pixels of tile i, ``rows`` image rows by ``cols`` columns
    (fewer at the bottom and right edges), column tiles fastest; ``ctas``
    is at most the SM count, so all of them are resident at once.  A CTA
    computes its tile ``sub_rows`` x ``sub_cols`` pixels at a time, each
    sub-tile from the A pixels its taps reach (:meth:`subtiles`), and
    holds its outputs (``held`` bytes) across the grid barrier.  ``smem``
    is one CTA's shared memory in bytes (the kernel's ``ib_smem_layout``):
    the held outputs, a sub-tile's staged A pixels and their expansion,
    its depthwise outputs and, when ``stage_w``, w1, wd and w2."""

    H: int
    W: int
    C_in: int
    C_mid: int
    C_out: int
    RS: int
    rows: int
    cols: int
    sub_rows: int
    sub_cols: int
    stage_w: bool

    @property
    def pad(self) -> int:
        return (self.RS - 1) // 2

    @property
    def col_tiles(self) -> int:
        return -(-self.W // self.cols)

    @property
    def ctas(self) -> int:
        return -(-self.H // self.rows) * self.col_tiles

    @property
    def held(self) -> int:
        return 4 * self.rows * self.cols * self.C_out

    @property
    def smem(self) -> int:
        return _ib_smem(self.H, self.W, self.C_in, self.C_mid, self.C_out,
                        self.RS, self.rows, self.cols, self.sub_rows,
                        self.sub_cols, self.stage_w)

    def tile(self, i: int) -> tuple[int, int, int, int]:
        """CTA ``i``'s output pixels ``(p0, np, q0, nq)``: rows ``p0 ..
        p0 + np - 1`` by columns ``q0 .. q0 + nq - 1``."""
        rb, cb = divmod(i, self.col_tiles)
        p0, q0 = rb * self.rows, cb * self.cols
        return p0, min(self.rows, self.H - p0), q0, min(self.cols,
                                                        self.W - q0)

    def subtiles(self, i: int) -> list[tuple[int, ...]]:
        """CTA ``i``'s sub-tiles in the order it computes them, each
        ``(p0, np, q0, nq, lo, nh, lc, nc)``: its output pixels as in
        :meth:`tile`, and the A rows ``lo .. lo + nh - 1`` by columns
        ``lc .. lc + nc - 1`` inside the image that its taps reach."""
        t0, tn, u0, un = self.tile(i)
        out = []
        for p0 in range(t0, t0 + tn, self.sub_rows):
            for q0 in range(u0, u0 + un, self.sub_cols):
                np_ = min(self.sub_rows, t0 + tn - p0)
                nq = min(self.sub_cols, u0 + un - q0)
                lo, lc = max(0, p0 - self.pad), max(0, q0 - self.pad)
                hi = min(self.H, p0 + np_ + self.pad)
                rc = min(self.W, q0 + nq + self.pad)
                out.append((p0, np_, q0, nq, lo, hi - lo, lc, rc - lc))
        return out


def _ib_smem(H, W, C_in, C_mid, C_out, RS, rows, cols, sub_rows, sub_cols,
             stage_w) -> int:
    """Bytes of a bottleneck CTA's shared memory (``ib_smem_layout``)."""
    halo = min(H, sub_rows + RS - 1) * min(W, sub_cols + RS - 1)
    words = (rows * cols * C_out + halo * (C_in + C_mid)
             + sub_rows * sub_cols * C_mid)
    if stage_w:
        words += C_mid * (C_in + RS * RS + C_out)
    return 4 * words


def _ib_steps(t: IbTiling) -> int:
    """A CTA's critical path in dependent FMA steps, at a full tile and
    a full halo: per sub-tile, each phase's chain (C_in for the
    expansion, RS^2 for the depthwise conv, C_mid for the projection)
    times the passes its threads make over the phase's outputs."""
    def passes(n):
        return -(-n // IB_THREADS)
    halo = min(t.H, t.sub_rows + t.RS - 1) * min(t.W, t.sub_cols + t.RS - 1)
    px = t.sub_rows * t.sub_cols
    per = (t.C_in * passes(halo * t.C_mid) + t.RS ** 2 * passes(px * t.C_mid)
           + t.C_mid * passes(px * t.C_out) + _SUBTILE_STEPS)
    return -(-t.rows // t.sub_rows) * -(-t.cols // t.sub_cols) * per


def ib_tiling(kw: dict, n_sm: int = H100_SMS) -> IbTiling:
    """The tiling of a ``ring_inverted_bottleneck`` call (its kwargs
    ``kw``) over at most ``n_sm`` CTAs.

    Of the tiles that keep the CTAs within ``n_sm``, it takes the one
    whose CTA has the shortest critical path (:func:`_ib_steps`), then
    the fewest CTAs, then the widest.  A tile computes itself whole when
    its halo fits beside its held outputs, else in sub-tiles of fewer
    rows (then fewer columns); it stages the weights when they fit
    beside the rest.  Raises ``ValueError``, naming the op's shape, when
    no tile fits ``MAX_SMEM``."""
    return _ib_tiling(kw["H"], kw["W"], kw["C_in"], kw["C_mid"],
                      kw["C_out"], kw.get("RS", 3), n_sm)


@functools.lru_cache(maxsize=4096)
def _ib_tiling(H, W, C_in, C_mid, C_out, RS, n_sm) -> IbTiling:
    """:func:`ib_tiling` by geometry, once per geometry (the wrapper
    calls it on every launch)."""
    def fit(rows, cols):
        """The largest sub-tile of a ``rows`` x ``cols`` tile that fits,
        and whether the weights fit beside it."""
        subs = [(r, cols) for r in range(rows, 0, -1)] \
            + [(1, c) for c in range(cols - 1, 0, -1)]
        for sr, sc in subs:
            geom = (H, W, C_in, C_mid, C_out, RS, rows, cols, sr, sc)
            if _ib_smem(*geom, True) <= MAX_SMEM:
                return sr, sc, True
            if _ib_smem(*geom, False) <= MAX_SMEM:
                return sr, sc, False
        return None

    heights = sorted({-(-H // n) for n in range(1, H + 1)})
    widths = sorted({-(-W // n) for n in range(1, W + 1)})
    best = None
    for rows in heights:
        for cols in widths:
            if -(-H // rows) * -(-W // cols) > n_sm:
                continue
            sub = fit(rows, cols)
            if sub is None:
                continue
            t = IbTiling(H, W, C_in, C_mid, C_out, RS, rows, cols, *sub)
            key = (_ib_steps(t), t.ctas, -cols)
            if best is None or key < best[0]:
                best = key, t
    if best is None:
        raise ValueError(
            f"ring_inverted_bottleneck: no tile of the op [{H}, {W}, {C_in}]"
            f" -> {C_mid} -> {C_out}, RS {RS}, fits {MAX_SMEM} B of shared "
            f"memory over at most {n_sm} CTAs")
    return best[1]


def ring_inverted_bottleneck(pool, w1, wd, w2, *, H: int, W: int,
                             C_in: int, C_mid: int, C_out: int, RS: int = 3,
                             in_ptr: int = 0, out_ptr: int = 0,
                             residual: bool = True):
    """E pixel (p, q) = project(relu(DW(relu(expand(A pixels around
    (p, q)))))) (+ A pixel (p, q)), over the CTAs of :func:`ib_tiling`,
    every read before any store (replaces ``ring_inverted_bottleneck``,
    ``src/repro/kernels/inverted_bottleneck.py:107``)."""
    n_seg = pool.shape[0]
    _check_ib(C_in, C_mid, C_out, residual)
    check_cuda(pool, (("w1", w1, F32, (C_in, C_mid)),
                      ("wd", wd, F32, (RS, RS, C_mid)),
                      ("w2", w2, F32, (C_mid, C_out))), dtype=F32)
    t = _ib_tiling(H, W, C_in, C_mid, C_out, RS, _sm_count(pool.device))
    launch("ring_inverted_bottleneck", pool, t.smem, (w1, wd, w2),
           (n_seg, H, W, C_in, C_mid, C_out, RS, in_ptr % n_seg,
            out_ptr % n_seg, int(residual), t.rows, t.cols, t.sub_rows,
            t.sub_cols, int(t.stage_w)))
    ring_inverted_bottleneck.weights_staged = t.stage_w
    ring_inverted_bottleneck.launches += 1
    return pool


def ring_inverted_bottleneck_plain(pool, w1, wd, w2, *, H: int, W: int,
                                   C_in: int, C_mid: int, C_out: int,
                                   RS: int = 3, in_ptr: int = 0,
                                   out_ptr: int = 0, residual: bool = True):
    """Plain version of :func:`ring_inverted_bottleneck`
    (``ib_fused_ring``): every read, then every store."""
    _check_ib(C_in, C_mid, C_out, residual)
    a = fetch_rows(pool, in_ptr, H * W, C_in).reshape(H, W, C_in)
    e = inverted_bottleneck_ref(a, w1, wd, w2, residual=residual)
    stage_rows(pool, e.reshape(H * W, C_out), out_ptr)
    return pool


KERNELS = {"ring_inverted_bottleneck": ring_inverted_bottleneck}
PLAIN = {"ring_inverted_bottleneck": ring_inverted_bottleneck_plain}

ring_inverted_bottleneck.launches = 0
ring_inverted_bottleneck.weights_staged = None
