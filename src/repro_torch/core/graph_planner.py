"""Multi-layer (fused) segment planning — vMCU Eq. (2).

For a producer/consumer chain executed as ONE streaming kernel, the pool
holds the chain *input* and the chain *output* (overlapped at a solved
offset) plus a small constant workspace for the intermediate tensors — the
paper's inverted-bottleneck kernel (Fig. 6, 11-segment workspace).

The generic solver below reduces Eq. (2) to the same scan as Eq. (1): walk
the fused iteration domain (output pixels in row-major order), track

  * ``w_end(t)``   — running max of output *byte* write-end addresses,
  * ``r_min(>=t)`` — min over current-and-future iterations of the lowest
                     input byte still needed (reverse minimum accumulate),

and the minimal input/output offset is ``delta = max_t [w_end(<=t) −
r_min(>t)]`` (writes at t happen after reads at t).  This generalizes the
single-layer scan to arbitrary read frontiers (conv halos, residual reads).

The port's copy of :mod:`repro.core.graph_planner`, which is plain Python
and numpy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np

WorkspacePolicy = Literal["paper_11seg", "row_cache"]


def solve_stream_offset(write_end: np.ndarray, read_start: np.ndarray) -> int:
    """Minimal byte offset ``b_In − b_Out`` for a streaming schedule.

    ``write_end[t]``  — one past the last output byte written at step t.
    ``read_start[t]`` — lowest input byte address step t still needs.
    Both relative to their tensor's base (b_Out / b_In).
    """
    if len(write_end) != len(read_start):
        raise ValueError("schedules must have equal length")
    w_run = np.maximum.accumulate(write_end)
    # lowest input byte needed at any step >= t
    r_future = np.minimum.accumulate(read_start[::-1])[::-1]
    # writes at step t land after reads at step t: compare against r_future
    # shifted by one (reads strictly after t). The final step has no future
    # readers — its write only needs to stay inside the pool.
    r_next = np.empty_like(r_future)
    r_next[:-1] = r_future[1:]
    r_next[-1] = np.iinfo(np.int64).max // 4
    return int(max(0, np.max(w_run - r_next)))


@dataclasses.dataclass(frozen=True)
class ModuleConfig:
    """An inverted-bottleneck module (paper Table 2 row)."""

    name: str
    hw: int          # input image height == width
    c_in: int
    c_mid: int
    c_out: int
    rs: int          # depthwise kernel size (R == S)
    strides: tuple[int, int, int]  # (pw1, dw, pw2)
    elem_bytes: int = 1  # int8 quantized

    @property
    def has_residual(self) -> bool:
        return (self.c_in == self.c_out
                and all(s == 1 for s in self.strides))

    def spatial(self) -> tuple[int, int, int]:
        """(input hw, post-pw1 hw, output hw) with 'same' padding for DW."""
        h0 = self.hw
        h1 = -(-h0 // self.strides[0])
        h2 = -(-h1 // self.strides[1])
        h3 = -(-h2 // self.strides[2])
        return h0, h1, h3

    @property
    def input_bytes(self) -> int:
        return self.hw * self.hw * self.c_in * self.elem_bytes

    @property
    def output_bytes(self) -> int:
        _, _, h_out = self.spatial()
        return h_out * h_out * self.c_out * self.elem_bytes


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    delta_bytes: int
    workspace_bytes: int
    input_bytes: int
    output_bytes: int

    @property
    def pool_bytes(self) -> int:
        return (max(self.input_bytes + self.delta_bytes, self.output_bytes)
                + self.workspace_bytes)


def plan_inverted_bottleneck(cfg: ModuleConfig,
                             workspace: WorkspacePolicy = "paper_11seg",
                             ) -> FusedPlan:
    """Plan the fused PW→DW→PW(→add) kernel of paper Fig. 6.

    Iterates output pixels of E in row-major order; per pixel the kernel
    needs a DW halo of B pixels, which pull an A halo through PW1's stride.
    """
    h0, h1, h2 = cfg.spatial()
    s1, s2, s3 = cfg.strides
    pad = (cfg.rs - 1) // 2
    eb = cfg.elem_bytes

    p = np.arange(h2 * h2, dtype=np.int64)
    ep, eq = p // h2, p % h2
    # E pixel (ep, eq) <- D (stride s3) <- C pixel (s3*ep, s3*eq)
    cp, cq = ep * s3, eq * s3
    # C pixel <- DW window over B rows s2*cp - pad .. s2*cp - pad + rs - 1
    bp_lo = np.maximum(cp * s2 - pad, 0)
    bq_lo = np.maximum(cq * s2 - pad, 0)
    # B pixel <- PW1 (stride s1) <- A pixel (s1*bp, s1*bq)
    ap_lo, aq_lo = bp_lo * s1, bq_lo * s1
    read_start = (ap_lo * cfg.hw + aq_lo) * cfg.c_in * eb
    if cfg.has_residual:  # residual reads A[ep, eq] — never below the halo
        res_start = (ep * cfg.hw + eq) * cfg.c_in * eb
        read_start = np.minimum(read_start, res_start)
    write_end = (p + 1) * cfg.c_out * eb

    delta = solve_stream_offset(write_end, read_start)

    if workspace == "paper_11seg":
        # RS x RS segments of B + 1 of C + 1 of D (Fig. 6): segment = one
        # channel vector of the respective tensor.
        ws = (cfg.rs * cfg.rs * cfg.c_mid + cfg.c_mid + cfg.c_out) * eb
    else:  # row_cache: RS rows of B cached to avoid PW1 recompute
        ws = (cfg.rs * h1 * cfg.c_mid + cfg.c_mid + cfg.c_out) * eb

    return FusedPlan(delta_bytes=delta, workspace_bytes=ws,
                     input_bytes=cfg.input_bytes,
                     output_bytes=cfg.output_bytes)


def plan_fc_chain(M: int, dims: list[int], *, elem_bytes: int = 2,
                  rows_per_step: int = 1) -> FusedPlan:
    """Plan a fused chain of fully-connected layers
    ``X[M,d0] -> H1[M,d1] -> ... -> Y[M,dL]`` streamed ``rows_per_step`` rows
    at a time (the transformer-MLP analogue of the inverted bottleneck: the
    intermediates live in a workspace of one row-block each and are never
    materialized).
    """
    if len(dims) < 2:
        raise ValueError("need at least input and output dims")
    d_in, d_out = dims[0], dims[-1]
    steps = -(-M // rows_per_step)
    t = np.arange(steps, dtype=np.int64)
    rows_done = np.minimum((t + 1) * rows_per_step, M)
    read_start = t * rows_per_step * d_in * elem_bytes
    write_end = rows_done * d_out * elem_bytes
    delta = solve_stream_offset(write_end, read_start)
    ws = sum(dims[1:-1]) * rows_per_step * elem_bytes
    return FusedPlan(delta_bytes=delta, workspace_bytes=ws,
                     input_bytes=M * d_in * elem_bytes,
                     output_bytes=M * d_out * elem_bytes)


def plan_module_fallback(cfg: ModuleConfig) -> int:
    """Per-layer (unfused) vMCU plan: single-layer segment overlap applied
    to each conv, residual source held live.  The paper itself falls back
    to this when fusion is unsuitable (e.g. its B18: 7x7 kernel on a 6x6
    image); with tiny spatial extents the R·S workspace of the fused kernel
    can exceed the fusion win."""
    from .planner import plan_pointwise_conv
    h0, h1, h2 = cfg.spatial()
    eb = cfg.elem_bytes
    sa = h0 * h0 * cfg.c_in * eb
    sb = h1 * h1 * cfg.c_mid * eb
    h_dw = -(-h1 // cfg.strides[1])
    sc = h_dw * h_dw * cfg.c_mid * eb
    sd = h2 * h2 * cfg.c_out * eb
    res = sa if cfg.has_residual else 0
    # PW1: input A must stay live when it feeds the residual — no overlap.
    if cfg.has_residual:
        pw1 = sa + sb
    else:
        pw1 = plan_pointwise_conv(h0, h0, cfg.c_in, cfg.c_mid,
                                  stride=cfg.strides[0],
                                  elem_bytes=eb).pool_bytes
    dw = res + sb                        # depthwise in-place (+ held A)
    pw2 = res + plan_pointwise_conv(h_dw, h_dw, cfg.c_mid, cfg.c_out,
                                    stride=cfg.strides[2],
                                    elem_bytes=eb).pool_bytes
    add = res + sd                       # in-place add
    return max(pw1, dw, pw2, add)


def vmcu_module_bytes(cfg: ModuleConfig,
                      workspace: WorkspacePolicy = "paper_11seg") -> int:
    """vMCU's choice per module: fused streaming kernel where it wins,
    per-layer segment planning otherwise (paper §7.3 exclusion rule)."""
    return min(plan_inverted_bottleneck(cfg, workspace).pool_bytes,
               plan_module_fallback(cfg))


# ---------------------------------------------------------------------------
# Tensor-level baselines (paper §7 comparisons) at module granularity.
# ---------------------------------------------------------------------------

def tinyengine_module_bytes(cfg: ModuleConfig) -> int:
    """TinyEngine-style: per-layer buffers, in-place DW, residual add fused
    into PW2's epilogue (A stays live through the module when residual)."""
    h0, h1, h2 = cfg.spatial()
    eb = cfg.elem_bytes
    sa = h0 * h0 * cfg.c_in * eb
    sb = h1 * h1 * cfg.c_mid * eb
    h_dw = -(-h1 // cfg.strides[1])
    sc = h_dw * h_dw * cfg.c_mid * eb
    sd = h2 * h2 * cfg.c_out * eb
    res = sa if cfg.has_residual else 0
    phases = [
        sa + sb,            # PW1: A, B live
        sb + res,           # DW in-place inside B's buffer
        sc + sd + res,      # PW2: C, D live (+A held for residual)
    ]
    if cfg.has_residual:
        phases.append(sd + sa)  # add: D += A (in-place into D)
    return max(phases)


def hmcos_module_bytes(cfg: ModuleConfig) -> int:
    """HMCOS-style: scheduling only, no in-place — every layer's input and
    output coexist (linear chains give scheduling nothing to reorder)."""
    h0, h1, h2 = cfg.spatial()
    eb = cfg.elem_bytes
    sa = h0 * h0 * cfg.c_in * eb
    sb = h1 * h1 * cfg.c_mid * eb
    h_dw = -(-h1 // cfg.strides[1])
    sc = h_dw * h_dw * cfg.c_mid * eb
    sd = h2 * h2 * cfg.c_out * eb
    res = sa if cfg.has_residual else 0
    phases = [sa + sb, sb + sc + res, sc + sd + res]
    if cfg.has_residual:
        phases.append(sd + sa + cfg.output_bytes)  # add out-of-place
    return max(phases)


# Paper Table 2 module configs ------------------------------------------------

MCUNET_5FPS_VWW = [
    ModuleConfig("S1", 20, 16, 48, 16, 3, (1, 1, 1)),
    ModuleConfig("S2", 20, 16, 48, 16, 3, (1, 1, 1)),
    ModuleConfig("S3", 10, 24, 144, 16, 3, (1, 1, 1)),
    ModuleConfig("S4", 10, 24, 120, 24, 3, (1, 1, 1)),
    ModuleConfig("S5", 5, 40, 240, 40, 3, (1, 1, 1)),
    ModuleConfig("S6", 5, 48, 192, 48, 3, (1, 1, 1)),
    ModuleConfig("S7", 3, 96, 480, 96, 3, (1, 1, 1)),
    ModuleConfig("S8", 3, 96, 384, 96, 3, (1, 1, 1)),
]

MCUNET_320KB_IMAGENET = [
    ModuleConfig("B1", 176, 3, 16, 8, 3, (2, 1, 1)),
    ModuleConfig("B2", 88, 8, 24, 16, 7, (1, 2, 1)),
    ModuleConfig("B3", 44, 16, 80, 16, 3, (1, 1, 1)),
    ModuleConfig("B4", 44, 16, 80, 16, 7, (1, 1, 1)),
    ModuleConfig("B5", 44, 16, 64, 24, 5, (1, 1, 1)),
    ModuleConfig("B6", 44, 16, 80, 24, 5, (1, 2, 1)),
    ModuleConfig("B7", 22, 24, 120, 24, 5, (1, 1, 1)),
    ModuleConfig("B8", 22, 24, 120, 24, 5, (1, 1, 1)),
    ModuleConfig("B9", 22, 24, 120, 40, 3, (1, 2, 1)),
    ModuleConfig("B10", 11, 40, 240, 40, 7, (1, 1, 1)),
    ModuleConfig("B11", 11, 40, 160, 40, 5, (1, 1, 1)),
    ModuleConfig("B12", 11, 40, 200, 48, 7, (1, 2, 1)),
    ModuleConfig("B13", 11, 48, 240, 48, 7, (1, 1, 1)),
    ModuleConfig("B14", 11, 48, 240, 48, 3, (1, 1, 1)),
    ModuleConfig("B15", 11, 48, 288, 96, 3, (1, 2, 1)),
    ModuleConfig("B16", 6, 96, 480, 96, 7, (1, 1, 1)),
    ModuleConfig("B17", 6, 96, 384, 96, 3, (1, 1, 1)),
]
