"""Modular byte/segment-interval arithmetic for the ring verifier.

The abstract domain of :mod:`repro_torch.analysis.verifier` is the *live
record*: a contiguous run of pool segments ``(base + s) % n`` for
``s in [lo, hi)``.  Everything the clobber oracle can detect reduces to
two questions about such runs:

  * do two modular runs share a slot (``overlap``), and
  * which is the FIRST write of a streaming sweep that lands on a live
    run (``first_static_clash`` / ``first_stream_clash``)?

Both are answered exactly.  A write stream covers absolute output
segments ``w in [0, out_tot)`` at slot ``(out_base + w) % n``; a live
segment ``r`` of a record based ``delta = (rec_base - out_base) % n``
above the output occupies slot ``(out_base + delta + r) % n``.  The two
collide iff ``w ≡ delta + r (mod n)``, i.e. ``w - r = delta + j*n`` for
some integer ``j`` — enumerating the (at most a handful of) feasible
``j`` turns every modular clash query into a linear one.

The port's copy of :mod:`repro.analysis.intervals`, which is plain
Python and numpy.
"""
from __future__ import annotations

import numpy as np


def overlap(a0: int, la: int, b0: int, lb: int, n: int) -> bool:
    """Do ``[a0, a0+la)`` and ``[b0, b0+lb)`` intersect modulo ``n``?"""
    if la <= 0 or lb <= 0:
        return False
    if la >= n or lb >= n:
        return True
    return ((b0 - a0) % n) < la or ((a0 - b0) % n) < lb


def _j_range(delta: int, hi: int, out_tot: int, n: int) -> range:
    """Integers ``j`` with ``delta + j*n`` in ``[-(hi-1), out_tot-1]``."""
    if hi <= 0 or out_tot <= 0:
        return range(0)
    j_min = -((hi - 1 + delta) // n)
    j_max = (out_tot - 1 - delta) // n
    return range(j_min, j_max + 1)


def first_static_clash(out_tot: int, victim_len: int, delta: int,
                       n: int) -> tuple[int, int] | None:
    """First write of a ``[0, out_tot)`` sweep that lands on a live run
    of ``victim_len`` segments based ``delta`` slots above the sweep.

    Returns ``(w, r)`` — the clashing write segment and victim segment —
    or ``None``.  The victim is live for the whole sweep (a held input,
    a residual source, any tensor the op does not consume)."""
    best: tuple[int, int] | None = None
    for j in _j_range(delta, victim_len, out_tot, n):
        d = delta + j * n
        w = max(0, d)
        if w < out_tot and w - d < victim_len:
            if best is None or w < best[0]:
                best = (w, w - d)
    return best


def first_stream_clash(we: np.ndarray, lo: np.ndarray, hi: int,
                       delta: int, n: int
                       ) -> tuple[int, int, int] | None:
    """First write that lands on the *shrinking* live suffix of the
    record the op is streaming over.

    ``we[t]`` is the cumulative output-segment high-water mark after
    step ``t``'s writes; ``lo[t]`` the first still-live victim segment
    at step ``t``'s writes (Eq.-(2) frees have already run); ``hi`` the
    victim's live top.  Returns ``(t, w, r)`` — step, write segment,
    victim segment — of the earliest clash, or ``None``."""
    steps = len(we)
    if steps == 0 or hi <= 0:
        return None
    we_prev = np.empty_like(we)
    we_prev[0] = 0
    we_prev[1:] = we[:-1]
    out_tot = int(we[-1])
    best: tuple[int, int, int] | None = None
    for j in _j_range(delta, hi, out_tot, n):
        d = delta + j * n
        # a clash at step t needs a write w in [we_prev[t], we[t]) and a
        # live victim segment r in [lo[t], hi) with w = d + r
        mask = (we > we_prev) & (lo < hi) & (we_prev < d + hi) \
            & (we > d + lo)
        if not mask.any():
            continue
        t = int(np.argmax(mask))
        w = int(max(we_prev[t], d + lo[t]))
        cand = (t, w, w - d)
        if best is None or (cand[0], cand[1]) < (best[0], best[1]):
            best = cand
    return best
