"""Single-layer segment-offset solver — vMCU Eq. (1).

The optimization problem (paper §4):

    min  b_In − b_Out
    s.t. ∀ j ⪯ i (lexicographic):
         L_In·(A_In·i + V_In) + b_In  ≥  L_Out·(A_Out·j + V_Out) + b_Out

Both sides are linear in the iteration point, so with
``r(i) = L_In·(A_In·i+V_In)`` (read address) and ``w(j)`` (write address):

    b_In − b_Out  =  max_{i}  [ max_{j ⪯ i} w(j) ]  −  r(i)

which a single lexicographic scan computes *exactly* in O(|domain|): iterate
points in lex order, keep the running max of ``w``, subtract ``r``.  This is
the ILP of the paper solved in closed form for box domains (the only domains
its kernels use).  Closed-form fast paths for GEMM and conv are derived below
and property-tested against the scan.

The port's copy of :mod:`repro.core.planner`, which is plain Python
and numpy.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .affine import (AccessFn, IterDomain, gemm_domain, gemm_read_access,
                     gemm_write_access)

# Domains larger than this fall back to closed forms / chunked scans.
_SCAN_LIMIT = 50_000_000


def solve_offset_scan(domain: IterDomain, read: AccessFn,
                      write: AccessFn) -> int:
    """Exact minimal ``b_In − b_Out`` via vectorized lexicographic scan."""
    if domain.size > _SCAN_LIMIT:
        raise ValueError(
            f"domain size {domain.size} too large for the exact scan; "
            "use a closed form")
    pts = domain.points_lex()
    r = read.addresses(pts)
    w = write.addresses(pts)
    w_run = np.maximum.accumulate(w)
    return int(np.max(w_run - r))


def solve_offset_bruteforce(domain: IterDomain, read: AccessFn,
                            write: AccessFn) -> int:
    """O(n^2) reference used only in tests on tiny domains."""
    pts = domain.points_lex()
    r = read.addresses(pts)
    w = write.addresses(pts)
    best = -(1 << 62)
    for idx in range(len(pts)):
        best = max(best, int(np.max(w[: idx + 1]) - r[idx]))
    return best


def gemm_offset_closed_form(M: int, N: int, K: int) -> int:
    """delta = max over (m,n,k) of (N−K)·m + n − k  (writes are lex-monotone,
    so the running max is w(i) itself)."""
    m = M - 1 if N > K else 0
    return (N - K) * m + (N - 1)


def gemm_min_footprint_segments(M: int, N: int, K: int) -> int:
    """Paper closed form: ``max(MN, MK) + min(N, K) − 1``."""
    return max(M * N, M * K) + min(N, K) - 1


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Result of planning one kernel over the ring pool.

    ``delta``           minimal b_In − b_Out, in segments (Eq. 1 optimum).
    ``in_segments``     input tensor size in segments.
    ``out_segments``    output tensor size in segments.
    ``pool_segments``   minimal pool size: the span that In ∪ Out occupy.
    ``segment_bytes``   bytes per segment (kernel-specific, vMCU §5.3).
    """

    delta: int
    in_segments: int
    out_segments: int
    segment_bytes: int

    @property
    def pool_segments(self) -> int:
        # In occupies [delta, delta + in_segments); Out occupies
        # [0, out_segments).  Pool must cover the union span.
        lo = min(0, self.delta)
        hi = max(self.delta + self.in_segments, self.out_segments)
        return hi - lo

    @property
    def pool_bytes(self) -> int:
        return self.pool_segments * self.segment_bytes

    @property
    def naive_segments(self) -> int:
        """Tensor-level (TinyEngine-style, non-overlappable layer) footprint."""
        return self.in_segments + self.out_segments

    @property
    def saving_fraction(self) -> float:
        return 1.0 - self.pool_segments / self.naive_segments


def plan_gemm(M: int, N: int, K: int, *, segment_bytes: int,
              validate: bool = False) -> SegmentPlan:
    """Plan a fully-connected layer ``[M,K] @ [K,N]`` (weights in "Flash" —
    i.e. un-pooled read-only storage — exactly as the paper assumes)."""
    delta = gemm_offset_closed_form(M, N, K)
    if validate:
        scan = solve_offset_scan(gemm_domain(M, N, K),
                                 gemm_read_access(M, K),
                                 gemm_write_access(M, N))
        if scan != delta:
            raise AssertionError(
                f"GEMM closed form {delta} != exact scan {scan} "
                f"for M={M} N={N} K={K}")
    plan = SegmentPlan(delta=delta, in_segments=M * K, out_segments=M * N,
                       segment_bytes=segment_bytes)
    expected = gemm_min_footprint_segments(M, N, K)
    if plan.pool_segments != expected:
        raise AssertionError(
            f"pool size {plan.pool_segments} != paper closed form {expected}")
    return plan


def plan_affine(domain: IterDomain, read: AccessFn, write: AccessFn, *,
                segment_bytes: int) -> SegmentPlan:
    """Plan an arbitrary affine kernel via the exact scan."""
    delta = solve_offset_scan(domain, read, write)
    return SegmentPlan(delta=delta, in_segments=read.size,
                       out_segments=write.size, segment_bytes=segment_bytes)


def plan_pointwise_conv(H: int, W: int, C: int, K: int, *, stride: int = 1,
                        elem_bytes: int = 1) -> SegmentPlan:
    """Plan a 1x1 convolution ``[H,W,C] -> [P,Q,K]``.

    With segment = one channel vector (vMCU §5.3 picks segment size =
    min(C, K) elements; we keep one segment per pixel per tensor and fold the
    channel width into ``segment_bytes`` bookkeeping by planning at pixel
    granularity with the *byte* sizes handled by the caller).  At stride 1 a
    pointwise conv over pixels is exactly GEMM with M = H·W rows, K = 1 input
    segment per row, N = 1 output segment per row — but input and output
    segments differ in byte width (C vs K elements), so we plan in *bytes*
    via the generalized scan below.
    """
    P, Q = (H - 1) // stride + 1, (W - 1) // stride + 1
    seg = min(C, K) * elem_bytes  # vMCU §5.3 segment choice
    in_segs_per_pixel = -(-C * elem_bytes // seg)
    out_segs_per_pixel = -(-K * elem_bytes // seg)
    # Iteration: one step per output pixel (p, q); reads input pixel
    # (p*stride, q*stride) [the *last* tap it needs in row-major order is the
    # same pixel for 1x1 conv]; writes output pixel (p, q).
    domain = IterDomain((P, Q))
    read = AccessFn(A=((stride, 0), (0, stride)), V=(0, 0), shape=(H, W))
    write = AccessFn(A=((1, 0), (0, 1)), V=(0, 0), shape=(P, Q))
    pts = domain.points_lex()
    # Addresses in *bytes*: pixel-granular accesses scaled by per-pixel widths.
    r = read.addresses(pts) * (C * elem_bytes)
    w = write.addresses(pts) * (K * elem_bytes)
    # A read of pixel x means bytes [x*C, (x+1)*C) must still be intact; a
    # write of pixel y covers [y*K, (y+1)*K). Safety: write_end <= read_start
    # + (b_In - b_Out)  for all j <= i  =>  delta >= max(w_end - r_start).
    w_end = w + K * elem_bytes
    w_run = np.maximum.accumulate(w_end)
    delta_bytes = int(np.max(w_run - r))
    return SegmentPlan(delta=-(-delta_bytes // seg),
                       in_segments=H * W * in_segs_per_pixel,
                       out_segments=P * Q * out_segs_per_pixel,
                       segment_bytes=seg)


def motivational_example() -> tuple[int, int]:
    """Paper Fig. 1(c): FC layer with In = 2x3 segments, Out = 2x2 segments.
    Returns (segment_level_pool, tensor_level_pool) = (7, 10)."""
    plan = plan_gemm(2, 2, 3, segment_bytes=1, validate=True)
    return plan.pool_segments, plan.naive_segments
