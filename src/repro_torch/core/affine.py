"""Affine formulation of segment-level memory planning (vMCU §4).

The paper models a kernel as:

  * an iteration domain  ``{S[i] : H·i + B < 0}`` — here restricted to the box
    domains every vMCU kernel actually uses (GEMM / conv / fused chains),
  * per-tensor *access functions* ``S[i] -> T[u], u = A_u·i + V_u``,
  * a row-major *mapping vector* ``L`` flattening segment indices ``u`` to a
    linear pool address ``addr = L·u + b_off``.

All quantities are in units of SEGMENTS, not bytes; byte accounting happens in
:mod:`repro_torch.core.planner` / :mod:`repro_torch.core.pool`.

The port's copy of :mod:`repro.core.affine`, which is plain Python
and numpy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class IterDomain:
    """A box iteration domain ``0 <= i_d < extents[d]``, iterated in
    lexicographic (row-major) order — the order vMCU kernels execute in."""

    extents: tuple[int, ...]

    def __post_init__(self):
        if any(e <= 0 for e in self.extents):
            raise ValueError(f"empty iteration domain {self.extents}")

    @property
    def size(self) -> int:
        return math.prod(self.extents)

    def points_lex(self) -> np.ndarray:
        """All iteration points as an ``(size, ndim)`` int64 array, in
        lexicographic order (last axis fastest)."""
        grids = np.indices(self.extents).reshape(len(self.extents), -1)
        return grids.T.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class AccessFn:
    """Affine segment access ``u = A·i + V`` followed by row-major flattening
    with mapping vector ``L`` (strides of the accessed tensor, in segments)."""

    A: tuple[tuple[int, ...], ...]  # (tensor_rank, iter_rank)
    V: tuple[int, ...]              # (tensor_rank,)
    shape: tuple[int, ...]          # tensor shape in segments (defines L)

    def __post_init__(self):
        rank = len(self.shape)
        if len(self.A) != rank or len(self.V) != rank:
            raise ValueError("A/V rank must match tensor shape rank")

    @property
    def L(self) -> tuple[int, ...]:
        """Row-major strides of the tensor in segments."""
        strides = []
        acc = 1
        for extent in reversed(self.shape):
            strides.append(acc)
            acc *= extent
        return tuple(reversed(strides))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def linear_coeffs(self) -> tuple[np.ndarray, int]:
        """Collapse ``L·(A·i + V)`` into ``(c, c0)`` with addr = c·i + c0."""
        A = np.asarray(self.A, dtype=np.int64)
        V = np.asarray(self.V, dtype=np.int64)
        L = np.asarray(self.L, dtype=np.int64)
        return L @ A, int(L @ V)

    def addresses(self, points: np.ndarray) -> np.ndarray:
        c, c0 = self.linear_coeffs()
        return points @ c + c0


def gemm_domain(M: int, N: int, K: int) -> IterDomain:
    """Iteration domain of the vMCU fully-connected kernel (Fig. 4), one
    point per (row, out-col-segment, in-col-segment)."""
    return IterDomain((M, N, K))


def gemm_read_access(M: int, K: int) -> AccessFn:
    """Reads ``In[m, k]`` at iteration (m, n, k)."""
    return AccessFn(A=((1, 0, 0), (0, 0, 1)), V=(0, 0), shape=(M, K))


def gemm_write_access(M: int, N: int) -> AccessFn:
    """Writes ``Out[m, n]`` at iteration (m, n, k) (stored when k completes;
    using the per-k address is conservative and matches the paper's Eq. 1)."""
    return AccessFn(A=((1, 0, 0), (0, 1, 0)), V=(0, 0), shape=(M, N))


def conv2d_pointwise_domain(P: int, Q: int, K: int, C: int) -> IterDomain:
    """1x1 conv == GEMM over (P*Q, K, C); kept spatial for clarity."""
    return IterDomain((P, Q, K, C))


def conv2d_read_access(H: int, W: int, C: int, *, stride: int = 1,
                       r: int = 0, s: int = 0) -> AccessFn:
    """Reads ``In[p*stride + r, q*stride + s, c]`` at iteration (p, q, k, c)
    for a fixed filter tap (r, s). Tap offsets enter through ``V``."""
    return AccessFn(
        A=((stride, 0, 0, 0), (0, stride, 0, 0), (0, 0, 0, 1)),
        V=(r, s, 0),
        shape=(H, W, C),
    )


def conv2d_write_access(P: int, Q: int, K: int) -> AccessFn:
    """Writes ``Out[p, q, k]`` at iteration (p, q, k, c)."""
    return AccessFn(
        A=((1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0)),
        V=(0, 0, 0),
        shape=(P, Q, K),
    )
