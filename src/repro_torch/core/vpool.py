"""VirtualPool — the one segment ring every kernel partitions.

Counterpart of :mod:`repro.core.vpool`.  The ring is one tensor
``[n_segments, seg_width]``; a tensor of ``d``-wide rows occupies
``segments_for(d)`` consecutive segments per row, and every address is
taken modulo ``n_segments`` (the paper's ``addr % (MemCap/Seg)``).

Unlike the JAX package, whose arrays are immutable, the port updates the
pool tensor in place: :func:`stage_segments` and :func:`stage_rows` write
into the tensor they are given and return it.
"""
from __future__ import annotations

import dataclasses

import torch

# The canonical segment width: one pool segment holds SEG_WIDTH elements.
SEG_WIDTH = 128


def ceil_div(a: int, b: int) -> int:
    """Ceiling division for non-negative ``a`` and positive ``b``."""
    return -(-a // b)


def segments_for(dim: int, seg_width: int = SEG_WIDTH) -> int:
    """Number of ``seg_width``-wide segments covering a ``dim``-wide row."""
    return ceil_div(dim, seg_width)


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """Geometry of a virtual pool: ``n_segments`` rows of ``seg_width``
    elements of ``dtype``."""

    n_segments: int
    seg_width: int = SEG_WIDTH
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.n_segments <= 0 or self.seg_width <= 0:
            raise ValueError(f"bad pool geometry {self!r}")

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_segments, self.seg_width)

    @property
    def segment_bytes(self) -> int:
        return self.seg_width * self.dtype.itemsize

    @property
    def nbytes(self) -> int:
        return self.n_segments * self.segment_bytes


def fetch_segments(pool: torch.Tensor, ptr: int, count: int,
                   n_segments: int | None = None) -> torch.Tensor:
    """Read ``count`` consecutive ring segments starting at ``ptr``.

    A run inside the pool is one slice (a view of ``pool``); a wrapping
    run is two, concatenated into a new tensor.  The selected segments
    are those of ``pool[(ptr + arange(count)) % n]``.
    """
    n = pool.shape[0] if n_segments is None else n_segments
    start = int(ptr) % n
    if start + count <= n:
        return pool[start:start + count]
    head = n - start
    return torch.cat([pool[start:n], pool[:count - head]], dim=0)


def stage_segments(pool: torch.Tensor, segs: torch.Tensor, ptr: int,
                   n_segments: int | None = None) -> torch.Tensor:
    """Write ``segs [count, seg_width]`` at ring segment ``ptr``, in
    place (one slice, or two on a wrap); returns ``pool``."""
    n = pool.shape[0] if n_segments is None else n_segments
    start = int(ptr) % n
    count = segs.shape[0]
    segs = segs.to(pool.dtype)
    if start + count <= n:
        pool[start:start + count] = segs
        return pool
    head = n - start
    pool[start:n] = segs[:head]
    pool[:count - head] = segs[head:]
    return pool


def stage_rows(pool: torch.Tensor, rows: torch.Tensor, ptr: int,
               n_segments: int | None = None) -> torch.Tensor:
    """Place ``rows [M, d]`` into the ring starting at segment ``ptr``,
    each row zero-padded to whole segments; in place, returns ``pool``."""
    m, d = rows.shape
    seg_w = pool.shape[1]
    segs = segments_for(d, seg_w)
    padded = torch.zeros((m, segs * seg_w), dtype=pool.dtype,
                         device=pool.device)
    padded[:, :d] = rows
    return stage_segments(pool, padded.reshape(m * segs, seg_w), ptr,
                          n_segments)


def fetch_rows(pool: torch.Tensor, ptr: int, m: int, d: int,
               n_segments: int | None = None) -> torch.Tensor:
    """Gather ``[m, d]`` rows resident at segment ``ptr`` out of the ring."""
    seg_w = pool.shape[1]
    segs = segments_for(d, seg_w)
    return fetch_segments(pool, ptr, m * segs,
                          n_segments).reshape(m, segs * seg_w)[:, :d]


@dataclasses.dataclass(frozen=True)
class VirtualPool:
    """Handle on the one pool tensor all kernels partition.  The tensor
    lives on the device it was allocated on and is updated in place."""

    array: torch.Tensor

    @classmethod
    def alloc(cls, spec: PoolSpec, device) -> "VirtualPool":
        return cls(torch.zeros(spec.shape, dtype=spec.dtype, device=device))

    def stage_rows(self, rows: torch.Tensor, ptr: int) -> "VirtualPool":
        stage_rows(self.array, rows, ptr)
        return self

    def fetch_rows(self, ptr: int, m: int, d: int) -> torch.Tensor:
        return fetch_rows(self.array, ptr, m, d)
