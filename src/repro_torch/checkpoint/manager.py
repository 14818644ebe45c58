"""Fault-tolerant checkpointing (the port of ``repro.checkpoint.manager``).

* **Atomic**: a checkpoint is written to ``step_N.tmp/`` and renamed to
  ``step_N/``; a crash mid-write never corrupts the latest good one, and
  ``latest_step`` scans the committed directories (those with a
  ``MANIFEST.json``).
* **Logical**: arrays are saved under their tree paths with their full
  shapes; ``restore`` lays them onto whatever tree and device the
  restarted job builds, and with ``shardings=`` onto whatever mesh:
  each rank places only its own piece of each leaf (elastic
  rescaling).
* **Distributed**: a tree with DTensor leaves is saved by every rank of
  its mesh together: each leaf is gathered whole, rank 0 of the default
  group alone writes, and the files are those one process writes of the
  same values; the ranks meet at a barrier once they are committed.
* **Async**: ``save_async`` copies every leaf to the host before it
  returns (a CPU leaf too: the next in-place optimizer step would
  otherwise rewrite the snapshot), then writes on a background thread.
* **Retention**: the ``keep`` newest checkpoints stay, older ones go.

The files are the reference's, so a checkpoint written by either package
restores in the other: one ``shard_00000.npz`` (rank 0: one process)
whose keys are the reference's ``_flatten`` of the tree (path parts
joined by ``|``: ``step``, ``params|embed``, ``mu|groups|0|attn|w_k``,
...), each array in its own dtype.  A bf16 leaf is stored as the
reference's numpy stores one, its 2-byte payload as the void dtype
``|V2`` (``ml_dtypes``' bfloat16 has no numpy type code), and read back
from those bytes; numpy needs no bf16 support for either.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.sharding import is_dtensor
from ..train.tree import leaves_with_paths, map_with_path

_SEP = "|"
_BF16_FILE_DTYPE = np.dtype("V2")


def _key(path: tuple) -> str:
    return _SEP.join(path)


def _to_numpy(leaf, copy: bool) -> np.ndarray:
    """A leaf as the numpy array the file holds (``copy``: never sharing
    the leaf's memory; a DTensor gathered whole, which every rank of its
    mesh must do together)."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_FILE_DTYPE)
        return t.numpy()
    return np.array(leaf, copy=copy)


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    if arr.dtype == _BF16_FILE_DTYPE:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree: Any, copy: bool = False) -> dict[str, np.ndarray]:
    return {_key(path): _to_numpy(leaf, copy)
            for path, leaf in leaves_with_paths(tree)}


def _distributed(tree: Any) -> bool:
    """Whether the tree has DTensor leaves: every rank saves it, rank 0
    writes."""
    return any(is_dtensor(x) for _, x in leaves_with_paths(tree))


def _writes(distributed: bool) -> bool:
    """Whether this process writes a save: any process its own tree, rank
    0 alone a distributed one."""
    return not distributed or dist.get_rank() == 0


def _structure(tree) -> str:
    """A readable record of the tree's structure for the manifest."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return f"{type(tree).__name__}(" + ", ".join(
            f"{f}={_structure(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_structure(v) for v in tree) + ")"
    return "*"


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = str(directory)
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._barrier = False   # a distributed save is pending

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "MANIFEST.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: dict | None = None) -> str:
        """Write ``tree`` as step ``step`` and return its directory; a tree
        with DTensor leaves is saved by every rank together (rank 0
        writes; all return once the checkpoint is committed)."""
        flat, distributed = _flatten(tree), _distributed(tree)
        final = self._step_dir(step)
        if _writes(distributed):
            final = self._write(step, flat, _structure(tree), metadata)
        if distributed:
            dist.barrier()
        return final

    def _write(self, step: int, flat: dict, structure: str,
               metadata: dict | None) -> str:
        tmp = self._step_dir(step) + ".tmp"
        final = self._step_dir(step)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "shard_00000.npz"), **flat)
        manifest = {"step": step, "time": time.time(),
                    "n_arrays": len(flat), "keys": sorted(flat),
                    "treedef": structure, "metadata": metadata or {}}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)   # commit point: atomic on POSIX
        self._gc()
        return final

    def save_async(self, step: int, tree: Any,
                   metadata: dict | None = None) -> None:
        """Copy every leaf to the host now, write on a thread (rank 0's,
        for a tree with DTensor leaves; every rank's :meth:`wait` meets
        the others once it is written)."""
        flat = _flatten(tree, copy=True)   # the snapshot, before return
        structure = _structure(tree)
        self.wait()
        self._barrier = _distributed(tree)
        if _writes(self._barrier):
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, structure, metadata),
                daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _gc(self) -> None:
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def restore(self, like: Any, step: int | None = None,
                shardings: Any = None, device=None) -> Any:
        """The checkpoint of ``step`` (default: the latest) in the
        structure of ``like``, each leaf in its ``like`` leaf's dtype on
        ``device``, or else on that leaf's device (a ``meta`` leaf: the
        CPU).  Tensors of ``like`` give its leaves; anything else with a
        ``dtype`` (a numpy array) is restored as a numpy array.  A leaf
        that ``shardings`` (a tree of ``parallel.sharding.Sharding`` in
        ``like``'s structure, None where a leaf is not placed; e.g.
        ``rules.params_shardings``) places is placed shard by shard onto
        its mesh, whatever mesh wrote it: a DTensor of which this rank
        holds only its own piece."""
        placed = {} if shardings is None else dict(
            leaves_with_paths(shardings))
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self._step_dir(step)
        data: dict[str, np.ndarray] = {}
        for name in sorted(os.listdir(d)):
            if name.endswith(".npz"):
                with np.load(os.path.join(d, name)) as z:
                    data.update({k: z[k] for k in z.files})

        def place(path, leaf):
            arr = data[_key(path)]
            if path in placed:
                return placed[path].place(
                    _from_numpy(arr).to(dtype=leaf.dtype))
            if not isinstance(leaf, torch.Tensor):
                return arr.astype(leaf.dtype) if hasattr(leaf, "dtype") \
                    else arr
            dev = device or ("cpu" if leaf.device.type == "meta"
                             else leaf.device)
            return _from_numpy(arr).to(device=dev, dtype=leaf.dtype)
        return map_with_path(place, like)
