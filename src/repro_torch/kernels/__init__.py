"""The port's hand-written CUDA ring kernels (``csrc/``), their build
(``_build``), their Python wrappers and plain versions (int8:
``quantized``; fp32: ``segment_matmul``, ``conv2d``,
``inverted_bottleneck``, ``fused_mlp``, ``elementwise``; both:
``stream``; the decode attention over a ring KV cache, fp32 and bf16:
``ring_decode``, with its public entry in ``ops``) and the parity cases
they are held to (``cases``).

:data:`KERNELS` and :data:`PLAIN` are every wrapper and every plain
version by kernel name; each wrapper counts its launches in
``<wrapper>.launches`` (:func:`launch_counts`).  Importing this package
builds nothing."""
from . import (conv2d, elementwise, fused_mlp, inverted_bottleneck, quantized,
               ring_decode, segment_matmul, stream)

_MODULES = (quantized, stream, segment_matmul, conv2d, inverted_bottleneck,
            fused_mlp, elementwise, ring_decode)
KERNELS = {name: f for m in _MODULES for name, f in m.KERNELS.items()}
PLAIN = {name: f for m in _MODULES for name, f in m.PLAIN.items()}


def reset_launch_counts() -> None:
    for f in KERNELS.values():
        f.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: f.launches for name, f in KERNELS.items()}
