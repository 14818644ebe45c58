"""Serializable plan artifacts: the JSON codec the reference writes.

Counterpart of :mod:`repro.compile.artifact`.  An artifact holds the
solved :class:`PoolProgram` (pure ints) and the parameter payloads:
arrays as ``{"__array__": <base64 raw bytes>, dtype, shape}``, tuples as
``{"__tuple__": [...]}``, scalars as JSON scalars.

:func:`decode` is the function that carries the reference's weights
across: it turns the arrays of an artifact written by the JAX package
into numpy arrays, and :func:`to_device` puts them on a torch device.
:func:`encode` and :func:`dump` write what the port compiles in the same
form, so the reference reads it back.
"""
from __future__ import annotations

import base64
import hashlib
import json

import numpy as np
import torch

SCHEMA = 1
KIND = "vmcu-compiled-net"


def program_sha256(program) -> str:
    """Canonical content hash of a :class:`PoolProgram`: the sha256 of
    the sorted-key compact JSON of its dict form — the hash the
    reference's certificates embed."""
    blob = json.dumps(program.to_json_dict(), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def encode(obj):
    """Recursively encode params/qparams into JSON-safe structures:
    numpy arrays and tensors (copied to the host) as base64 envelopes,
    tuples tagged, numpy scalars as JSON scalars."""
    if obj is None or isinstance(obj, (bool, str)):
        return obj
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return float(obj)
    if isinstance(obj, tuple):
        return {"__tuple__": [encode(v) for v in obj]}
    if isinstance(obj, list):
        return [encode(v) for v in obj]
    if isinstance(obj, dict):
        return {k: encode(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    arr = np.asarray(obj)
    return {"__array__": base64.b64encode(arr.tobytes()).decode("ascii"),
            "dtype": arr.dtype.name, "shape": list(arr.shape)}


def decode(obj):
    """Decode an artifact payload: arrays come back as writable numpy
    arrays, tuples as tuples, everything else as it is."""
    if isinstance(obj, dict):
        if "__tuple__" in obj:
            return tuple(decode(v) for v in obj["__tuple__"])
        if "__array__" in obj:
            raw = np.frombuffer(base64.b64decode(obj["__array__"]),
                                dtype=np.dtype(obj["dtype"]))
            return raw.copy().reshape(obj["shape"])
        return {k: decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode(v) for v in obj]
    return obj


def to_device(obj, device):
    """The same structure with every numpy array and tensor as a torch
    tensor on ``device`` (scalars, None and strings pass through)."""
    if isinstance(obj, np.ndarray):
        if not obj.flags.writeable:     # torch wants a buffer it may own
            obj = obj.copy()
        return torch.from_numpy(obj).to(device)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        return tuple(to_device(v, device) for v in obj)
    if isinstance(obj, list):
        return [to_device(v, device) for v in obj]
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj


def dump(payload: dict, path) -> None:
    with open(path, "w") as f:
        json.dump(payload, f)


def load(path) -> dict:
    """Read an artifact file and check its kind and schema."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("kind") != KIND:
        raise ValueError(f"{path} is not a {KIND} artifact")
    if payload.get("schema") != SCHEMA:
        raise ValueError(f"artifact schema {payload.get('schema')} != "
                         f"supported {SCHEMA}")
    return payload


def write_compile_inputs(path, params, calib) -> None:
    """Save what a compile takes besides the net — the float ``params``
    (one entry per op: ``None`` or a tuple of arrays and ``None``) and
    the calibration inputs ``calib`` — as one ``.npz``: ``calib``, each
    array of entry ``i`` as ``p{i}_{j}``, and ``layout[i]``, the length
    of entry ``i``'s tuple (-1 for a ``None`` entry)."""
    arrays = {"calib": np.asarray(calib, np.float32)}
    layout = []
    for i, entry in enumerate(params):
        if entry is None:
            layout.append(-1)
            continue
        layout.append(len(entry))
        for j, a in enumerate(entry):
            if a is not None:
                arrays[f"p{i}_{j}"] = np.asarray(a)
    np.savez(path, layout=np.asarray(layout, np.int64), **arrays)


def read_compile_inputs(path) -> tuple[list, np.ndarray]:
    """``(params, calib)`` as :func:`write_compile_inputs` saved them,
    as numpy arrays."""
    with np.load(path) as f:
        params = []
        for i, n in enumerate(f["layout"].tolist()):
            params.append(None if n < 0 else tuple(
                f[f"p{i}_{j}"].copy() if f"p{i}_{j}" in f.files else None
                for j in range(n)))
        return params, f["calib"].copy()
