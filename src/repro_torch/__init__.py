"""PyTorch/CUDA port of the vMCU reproduction (the JAX package ``repro``
is the reference it is held against).

The deployment front door is one call, which plans, budgets, calibrates,
lints and certifies a net on the host, with no JAX::

    import repro_torch
    cn = repro_torch.compile("ds-cnn", "cortex-m4")
    y = cn.run(x)                 # on the CUDA card, through the ring kernels
    y = cn.run(x, device="cpu")   # plain PyTorch versions of the kernels
    cn.save("ds-cnn.cortex-m4.int8.json")

A saved plan artifact (the port's or the reference's) loads without
re-planning::

    cn = repro_torch.load("ds-cnn.cortex-m4.int8.json")

A streaming plan steps frame by frame on a persistent pool::

    s = repro_torch.load("ds-cnn-stream.cortex-m4.int8.json").stream()
    y = s.step(frame)             # stream(device="cpu") on the CPU

Note: ``repro_torch.compile`` is the *function*; the package it lives
in is reachable as ``repro_torch.compile.targets`` etc. through ``from``
imports.
"""
from .compile import (CompiledNet, CompileError, PASS_NAMES, PassRecord,
                      REQUANT_IDIOMS, SRAMBudgetError, Target,
                      available_nets, compile, get_target, list_targets,
                      load, register_target)

__version__ = "0.1.0"

__all__ = [
    "CompiledNet", "CompileError", "PASS_NAMES", "PassRecord",
    "REQUANT_IDIOMS", "SRAMBudgetError", "Target", "available_nets",
    "compile", "get_target", "list_targets", "load", "register_target",
    "__version__",
]
