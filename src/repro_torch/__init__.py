"""PyTorch/CUDA port of the vMCU reproduction (the JAX package ``repro``
is the reference it is held against).

The deployment front door serves a plan artifact that the reference
compiler wrote::

    import repro_torch
    cn = repro_torch.load("ds-cnn.cortex-m4.int8.json")
    y = cn.run(x)                 # on the CUDA card, through the ring kernels
    y = cn.run(x, device="cpu")   # plain PyTorch versions of the kernels

A streaming plan steps frame by frame on a persistent pool::

    s = repro_torch.load("ds-cnn-stream.cortex-m4.int8.json").stream()
    y = s.step(frame)             # stream(device="cpu") on the CPU

The compile pipeline (``repro.compile``) is not ported yet.
"""
from .compile.driver import CompiledNet, load

__version__ = "0.1.0"

__all__ = ["CompiledNet", "load", "__version__"]
