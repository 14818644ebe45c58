"""Circular segment-pool simulator — the correctness oracle for plans.

Simulates vMCU's ``Pool[MemCap/Seg]`` byte-for-byte: every address is taken
modulo the pool length, a write to a still-live segment that does not belong
to the writing tensor raises (this is the "silent error" the paper warns
about when too few empty segments are allocated).  Tests drive kernel
schedules through this simulator with the planner's delta (must succeed) and
with delta − 1 (must clobber), proving the plans are tight.

The port's copy of :mod:`repro.core.pool`, which is plain Python
and numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Hashable

import numpy as np


class PoolClobberError(RuntimeError):
    """A write overwrote a live segment of another tensor."""


@dataclasses.dataclass
class _Segment:
    owner: Hashable
    payload: object = None


class SegmentPool:
    """A circular buffer of ``n_segments`` slots with liveness tracking."""

    def __init__(self, n_segments: int, segment_bytes: int = 1):
        if n_segments <= 0:
            raise ValueError("pool must have at least one segment")
        self.n = n_segments
        self.segment_bytes = segment_bytes
        self._slots: dict[int, _Segment] = {}
        self.peak_live = 0
        self.reads = 0
        self.writes = 0
        self.frees = 0

    # -- addressing ---------------------------------------------------------
    def _wrap(self, addr: int) -> int:
        return addr % self.n  # the paper's modulo bounds check

    # -- operations ---------------------------------------------------------
    def write(self, addr: int, owner: Hashable, payload: object = None) -> None:
        slot = self._wrap(addr)
        prev = self._slots.get(slot)
        if prev is not None and prev.owner != owner:
            raise PoolClobberError(
                f"write by {owner!r} at pool[{slot}] clobbers live segment "
                f"of {prev.owner!r}")
        self._slots[slot] = _Segment(owner, payload)
        self.writes += 1
        self.peak_live = max(self.peak_live, len(self._slots))

    def read(self, addr: int, owner: Hashable) -> object:
        slot = self._wrap(addr)
        seg = self._slots.get(slot)
        if seg is None:
            raise PoolClobberError(f"read of dead segment pool[{slot}] by {owner!r}")
        if seg.owner != owner:
            raise PoolClobberError(
                f"read by {owner!r} at pool[{slot}] sees segment of "
                f"{seg.owner!r} — input was overwritten too early")
        self.reads += 1
        return seg.payload

    def free(self, addr: int, owner: Hashable) -> None:
        slot = self._wrap(addr)
        seg = self._slots.get(slot)
        if seg is None:
            return  # double-free is benign in the paper's kernels
        if seg.owner != owner:
            raise PoolClobberError(
                f"free by {owner!r} at pool[{slot}] of segment owned by "
                f"{seg.owner!r}")
        del self._slots[slot]
        self.frees += 1

    @property
    def live(self) -> int:
        return len(self._slots)

    @property
    def peak_bytes(self) -> int:
        return self.peak_live * self.segment_bytes


def run_gemm_schedule(pool: SegmentPool, M: int, N: int, K: int,
                      b_out: int, b_in: int,
                      in_payload: np.ndarray | None = None) -> dict[int, object]:
    """Execute the paper's FC kernel schedule (Fig. 4) against the pool.

    Input segments In[m,k] start resident at ``b_in + m*K + k``; output
    segments are stored to ``b_out + m*N + n``.  Eq. (1)'s ``∀ j ⪯ i``
    semantics means an input segment is *dead after its last read* — the
    explicit RAMFree loop in Fig. 4 is bookkeeping that trails the real
    lifetime — so the simulator frees each input segment immediately after
    the final ``n`` iteration reads it.  Returns {linear_out_idx: payload}
    so callers can check numerics survived the ring.
    """
    for m in range(M):
        for k in range(K):
            payload = None if in_payload is None else in_payload[m, k]
            pool.write(b_in + m * K + k, owner=("in", m, k), payload=payload)
    out: dict[int, object] = {}
    for m in range(M):
        for n in range(N):
            acc = []
            for k in range(K):
                acc.append(pool.read(b_in + m * K + k, owner=("in", m, k)))
                if n == N - 1:  # last read of In[m, k] — segment is dead
                    pool.free(b_in + m * K + k, owner=("in", m, k))
            pool.write(b_out + m * N + n, owner="out",
                       payload=(m, n, tuple(acc)))
            out[m * N + n] = (m, n)
    # outputs must all be intact at the end
    for m in range(M):
        for n in range(N):
            pool.read(b_out + m * N + n, owner="out")
    return out
