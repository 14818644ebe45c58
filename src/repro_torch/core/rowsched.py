"""Row maps and conv padding shared by the executors and the kernels.

Counterpart of the JAX-free helpers of :mod:`repro.core.rowsched`.  The
per-step row schedules (and the sim oracle that replays them) are not
ported yet; this module holds only the maps that the ring kernels and
their plain versions need to agree on.
"""
from __future__ import annotations


def resample_src(p: int, n_in: int, n_out: int) -> int:
    """Nearest-grid row map for resampling adapters: monotone, exact
    ``p * s`` when ``n_in == s * n_out``."""
    return (p * n_in) // n_out


def conv_k2d_pad(k: int, padding: str) -> int:
    """Low-side ROW padding of a k x k conv.

    Besides ``same`` / ``valid``, the partial-execution slicer uses two
    vertical-split modes: ``same_top`` (a top slice of a 'same' conv —
    keeps the top pad) and ``same_mid`` (an interior/bottom slice — the
    halo rows above are real data, so no top pad)."""
    if padding in ("same", "same_top"):
        return (k - 1) // 2
    if padding in ("valid", "same_mid"):
        return 0
    raise ValueError(f"unknown padding {padding!r} "
                     "(same/valid/same_top/same_mid)")


def conv_k2d_pad_w(k: int, padding: str) -> int:
    """Low-side COLUMN padding of a k x k conv.  The slicer splits rows
    only, so every 'same'-family mode keeps the full horizontal pad."""
    return 0 if padding == "valid" else (k - 1) // 2


def conv_k2d_out(h_in: int, k: int, stride: int, padding: str) -> int:
    """Output extent of a k x k conv along one spatial axis."""
    if padding == "same":
        return -(-h_in // stride)
    if padding == "same_top":
        return (h_in + (k - 1) // 2 - k) // stride + 1
    if padding == "same_mid":
        return (h_in - k) // stride + 1
    if h_in < k:
        raise ValueError(f"valid conv needs h_in >= k ({h_in} < {k})")
    return (h_in - k) // stride + 1
