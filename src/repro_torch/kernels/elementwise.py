"""The in-place ring elementwise map: CUDA wrapper and plain version.

Counterpart of :mod:`repro.kernels.elementwise`: one activation of
:data:`repro_torch.core.program.ACTIVATIONS` applied in place to the
``m_rows`` rows of ``d`` fp32 channels resident at ``ptr`` — to the
whole padded ``[m_rows * segs(d), 128]`` region, as the reference
applies it to the padded tile; every activation maps 0 to 0, so channel
tails stay zero.

:func:`ring_elementwise` takes the reference kernel's arguments and
raises ``ValueError`` on an unknown activation and on a region longer
than the ring (``m_rows * segs(d) > n_seg``); its kernel maps each
float on its own, so it does not demand the reference's ``block_rows``
alignment.  It checks the pool and launches the hand-written kernel of
``csrc/ring_f32.cu`` on the current CUDA stream without synchronising:
the region as the two linear runs of :func:`ring_runs`, over the grid of
:func:`ew_blocks`.  It never falls back to its plain version.  It counts
its launches in ``ring_elementwise.launches``.

:func:`ring_elementwise_plain` is the port of the reference's jnp
executor op (``elementwise_ring_scan``).
"""
from __future__ import annotations

from ..core.program import resolve_activation
from ..core.vpool import SEG_WIDTH, fetch_segments, segments_for, \
    stage_segments
from ._launch import H100_SMS, _sm_count, check_cuda, launch
from .segment_matmul import F32, act_code

#: Threads of a block (``EW_THREADS`` in ``ring_f32.cu``), each mapping
#: one float4 at a time, and the most blocks an SM holds at once (256 x 8
#: threads fill an SM).
EW_THREADS, EW_BLOCKS_PER_SM = 256, 8


def ring_runs(n_seg: int, ptr: int, n: int) -> tuple[tuple[int, int], ...]:
    """The ``n`` segments from ``ptr`` modulo ``n_seg`` (``0 <= ptr <
    n_seg``, ``n <= n_seg``) as linear runs ``(start, length)``: up to
    the ring's end, then from segment 0 (length 0 when the region ends at
    or before the ring's end)."""
    first = min(n, n_seg - ptr)
    return (ptr, first), (0, n - first)


def ew_blocks(n: int, n_sm: int = H100_SMS) -> int:
    """Blocks of the elementwise kernel over ``n`` segments: one float4 a
    thread, at most ``EW_BLOCKS_PER_SM`` blocks per SM, all resident at
    once (the kernel strides over the rest)."""
    vecs = n * SEG_WIDTH // 4
    return max(1, min(-(-vecs // EW_THREADS), EW_BLOCKS_PER_SM * n_sm))


def _region(n_seg: int, m_rows: int, d: int, fn: str) -> int:
    """The region's length in segments, after the wrapper's checks."""
    resolve_activation(fn)
    n = m_rows * segments_for(d)
    if m_rows < 1 or d < 1:
        raise ValueError("an elementwise op needs m_rows >= 1 and d >= 1")
    if n > n_seg:
        raise ValueError(f"{n} segments do not fit a ring of {n_seg}")
    return n


def ring_elementwise(pool, *, m_rows: int, d: int, ptr: int,
                     fn: str = "gelu", block_rows: int = 1):
    """``fn`` in place over the rows at ``ptr`` (replaces
    ``ring_elementwise``, ``src/repro/kernels/elementwise.py:61``);
    ``block_rows`` is the plan's and goes unused."""
    n_seg = pool.shape[0]
    n = _region(n_seg, m_rows, d, fn)
    check_cuda(pool, dtype=F32)
    (start, first), _ = ring_runs(n_seg, ptr % n_seg, n)
    launch("ring_elementwise", pool, 0, (),
           (n, start, first, act_code(fn),
            ew_blocks(n, _sm_count(pool.device))))
    ring_elementwise.launches += 1
    return pool


def ring_elementwise_plain(pool, *, m_rows: int, d: int, ptr: int,
                           fn: str = "gelu", block_rows: int = 1):
    """Plain version of :func:`ring_elementwise`
    (``elementwise_ring_scan``)."""
    n = _region(pool.shape[0], m_rows, d, fn)
    x = fetch_segments(pool, ptr, n).to(F32)
    stage_segments(pool, resolve_activation(fn)(x), ptr)
    return pool


KERNELS = {"ring_elementwise": ring_elementwise}
PLAIN = {"ring_elementwise": ring_elementwise_plain}

ring_elementwise.launches = 0
ring_elementwise.weights_staged = None
