"""The fused inverted bottleneck (paper Fig. 6): CUDA wrapper and plain
version.

Counterpart of :mod:`repro.kernels.inverted_bottleneck`: PW-expand and
relu, DW RSxRS ('same' padding, stride 1) and relu, PW-project, plus the
residual, over an fp32 image ``A [H, W, C_in]`` held one segment per
pixel at ``in_ptr``; ``E [H, W, C_out]`` goes to ``out_ptr``, often in
place.  The ``C_mid``-wide expansion never reaches the ring: the kernel
keeps it as an RS-row halo in shared memory.

:func:`ring_inverted_bottleneck` takes the reference kernel's arguments,
raises its ``ValueError`` on channel widths beyond the segment geometry,
checks device, dtype, shape and contiguity and launches the hand-written
kernel of ``csrc/ring_f32.cu`` on the current CUDA stream without
synchronising; it never falls back to its plain version.  It counts its
launches in ``ring_inverted_bottleneck.launches`` and records in
``.weights_staged`` whether its last launch staged w1, wd and w2 in
shared memory.

:func:`ring_inverted_bottleneck_plain` is the port of the reference's
jnp executor op (``ib_fused_ring``): read the whole of A, compute
:func:`inverted_bottleneck_ref`, store E.
"""
from __future__ import annotations

import torch

from ..core.vpool import SEG_WIDTH, fetch_rows, stage_rows
from ._launch import check_cuda, launch
from .segment_matmul import F32


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


def ring_inverted_bottleneck(pool, w1, wd, w2, *, H: int, W: int,
                             C_in: int, C_mid: int, C_out: int, RS: int = 3,
                             in_ptr: int = 0, out_ptr: int = 0,
                             residual: bool = True):
    """E row p = project(relu(DW(relu(expand(A rows p-pad .. p+pad)))))
    (+ A row p), one output row per step in ring order (replaces
    ``ring_inverted_bottleneck``,
    ``src/repro/kernels/inverted_bottleneck.py:107``)."""
    n_seg = pool.shape[0]
    _check_ib(C_in, C_mid, C_out, residual)
    check_cuda(pool, (("w1", w1, F32, (C_in, C_mid)),
                      ("wd", wd, F32, (RS, RS, C_mid)),
                      ("w2", w2, F32, (C_mid, C_out))), dtype=F32)
    # the halo ring, the DW row, the A row being expanded and the
    # residual row
    smem = 4 * W * (RS * C_mid + C_mid + C_in + C_out)
    ring_inverted_bottleneck.weights_staged = launch(
        "ring_inverted_bottleneck", pool, smem, (w1, wd, w2),
        (n_seg, H, W, C_in, C_mid, C_out, RS, in_ptr % n_seg,
         out_ptr % n_seg, int(residual)),
        w_bytes=4 * C_mid * (C_in + RS * RS + C_out))
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
