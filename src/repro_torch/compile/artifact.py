"""Serializable plan artifacts: the JSON codec the reference writes.

Counterpart of :mod:`repro.compile.artifact`.  An artifact holds the
solved :class:`PoolProgram` (pure ints) and the parameter payloads:
arrays as ``{"__array__": <base64 raw bytes>, dtype, shape}``, tuples as
``{"__tuple__": [...]}``, scalars as JSON scalars.

:func:`decode` is the function that carries the reference's weights
across: it turns the arrays of an artifact written by the JAX package
into numpy arrays, and :func:`to_device` puts them on a torch device.
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
    """The same structure with every numpy array as a torch tensor on
    ``device`` (scalars, None and strings pass through)."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj).to(device)
    if isinstance(obj, tuple):
        return tuple(to_device(v, device) for v in obj)
    if isinstance(obj, list):
        return [to_device(v, device) for v in obj]
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj


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
