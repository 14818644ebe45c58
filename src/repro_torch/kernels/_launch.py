"""Checks and the ctypes launch shared by every ring-kernel wrapper.

A wrapper validates the pool and its operands (:func:`check_cuda`)
before their pointers go to a kernel, then :func:`launch` calls the
kernel's C entry point on the pool's device and current stream, without
synchronising, and raises if the launch was refused.  The wrappers size
every kernel's shared memory against :data:`MAX_SMEM`.
"""
from __future__ import annotations

import functools

import torch

from ..core.vpool import SEG_WIDTH

#: Shared memory one thread block may use on Hopper (bytes).
MAX_SMEM = 232_448
#: SMs of an H100 SXM, the tilings' CTA limit where no card is asked.
H100_SMS = 132


@functools.cache
def _sm_count(device: torch.device) -> int:
    """The SMs of ``device``: the most CTAs a cooperative launch takes."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_cuda(pool, tensors=(), dtype: torch.dtype = torch.int8) -> None:
    """Validate the ``dtype`` pool and ``(name, tensor, dtype, shape)``
    operands before their pointers go to the kernel."""
    if not isinstance(pool, torch.Tensor) or pool.device.type != "cuda":
        raise ValueError("the ring kernels run on CUDA tensors only; got a "
                         f"pool on {getattr(pool, 'device', type(pool))} "
                         "(the CPU path uses the *_plain versions)")
    if pool.dtype != dtype or pool.ndim != 2 \
            or pool.shape[1] != SEG_WIDTH or not pool.is_contiguous():
        raise ValueError(f"pool must be a contiguous {dtype} "
                         f"[n_segments, {SEG_WIDTH}] tensor, got "
                         f"{pool.dtype} {tuple(pool.shape)}")
    if pool.data_ptr() % 16:
        raise ValueError("pool must be 16-byte aligned")
    for name, t, t_dtype, shape in tensors:
        if not isinstance(t, torch.Tensor) or t.device != pool.device:
            raise ValueError(f"{name} must be a tensor on {pool.device}")
        if t.dtype != t_dtype or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {t_dtype} "
                             f"{tuple(shape)} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")


def launch(name: str, pool: torch.Tensor, smem: int, tensors, ints,
           w_bytes: int | None = None) -> bool | None:
    """Launch C entry point ``name`` on ``pool``'s device and current
    stream (a ``None`` in ``tensors`` goes as a null pointer).  ``smem``
    is the shared memory a step needs without the
    weights.  Given ``w_bytes``, the weights are staged too when they
    fit beside it: the kernel gets that choice as its last int, and it
    is returned."""
    if smem > MAX_SMEM:
        raise ValueError(f"{name} needs {smem} B of shared memory per "
                         f"block, above the card's {MAX_SMEM} B")
    staged = None
    if w_bytes is not None:
        staged = smem + w_bytes <= MAX_SMEM
        ints = (*ints, int(staged))
    from ._build import library, source_of

    stem = source_of(name)
    lib, _ = library(stem)
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(pool.data_ptr(),
                                 *(None if t is None else t.data_ptr()
                                   for t in tensors),
                                 *ints, stream)
    if err:
        text = getattr(lib, f"{stem}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({text})")
    return staged
