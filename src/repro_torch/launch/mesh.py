"""Meshes (the port of ``repro.launch.mesh``): ``DeviceMesh``es of cards
over the ranks of the default process group.

Functions, not module constants: importing this module touches no
device and starts no process group.
"""
from __future__ import annotations

import math
import os
import tempfile

import torch
import torch.distributed as dist


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The production mesh's shape and axis names: 16 x 16 = 256 ranks a
    pod; ``multi_pod`` stacks 2 pods (512)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh("cuda", ranks, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over the default group's first ranks: axes
    ``data`` (DP/FSDP), ``model`` (TP/experts/vocab) and, with
    ``multi_pod``, ``pod`` (pure DP across pods).  Raises ``ValueError``
    where the group has fewer ranks (as ``jax.make_mesh`` does with
    fewer devices)."""
    shape, names = production_mesh_shape(multi_pod=multi_pod)
    n = dist.get_world_size() if dist.is_initialized() else 0
    if n < math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the default process "
                         f"group has {n}")
    return _mesh(shape, names)


def make_host_mesh(data: int = 1, model: int = 1):
    """A small ``("data", "model")`` mesh over the ranks that exist:
    ``data`` and ``model`` are clamped to them as the reference clamps
    to ``len(jax.devices())``.  Where no process group is open, a
    one-rank NCCL group of this process's card is started over a
    ``FileStore`` in a new temporary directory (no port, no environment
    variables)."""
    if not dist.is_initialized():
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh needs a CUDA card")
        store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
        dist.init_process_group(
            "nccl", store=store, rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // data))
    return _mesh((data, model), ("data", "model"))
