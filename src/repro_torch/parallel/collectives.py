"""Distributed-optimization collectives (the port of
``repro.parallel.collectives``), over ``torch.distributed``.

* ``compressed_psum`` — int8-quantized all-reduce: the participants agree
  on one scale (an all-reduce of ``max|x|``), each quantizes to int8,
  the int32 sum is all-reduced and dequantized.
* ``bucketed_psum``   — a tree all-reduced in fixed-byte flat fp32
  buckets, one after another, then split back into the tree with each
  leaf's dtype.
* ``quantize_int8 / dequantize_int8`` — the codec.
* ``mesh_sum / mesh_max / mesh_gather`` — tensor parallelism's sums and
  MoE routing's exchanges along mesh dims, over a ``DeviceMesh``'s
  process groups or a one-process ``standin.StandInMesh`` (what
  ``AxisRules.psum``, ``pmax`` and ``pgather`` call).

The arithmetic is written once, over rows of a leading participant
axis, with the reduction over participants injected: the process-group
form holds one row (this rank's) and reduces with ``all_reduce``; the
one-process form (``*_stacked``, a list of per-rank tensors) holds every
participant's row and reduces over the axis, the counterpart of the
reference under ``jax.vmap(f, axis_name=...)``.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..train.tree import leaves, unflatten_like

F32 = torch.float32
#: ``reduce(rows, op)``: the reduction (``"sum"`` or ``"max"``) of
#: ``rows`` over every participant, broadcast back to ``rows``' shape.
Reduce = Callable[[torch.Tensor, str], torch.Tensor]


def _scale(m: torch.Tensor) -> torch.Tensor:
    """``max|x| / 127 + 1e-12`` as the reference computes it compiled:
    XLA's simplifier turns the division by the constant 127 into a
    product with fp32 ``1/127`` (read the jitted HLO: ``multiply(...,
    0.00787401572)``), one ulp off the quotient for some maxima; the
    product here is that one (an fp32 tensor operand, so the card
    computes it in fp32 too)."""
    inv = torch.tensor(1 / 127, dtype=F32, device=m.device)
    return m * inv + 1e-12


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale fp32)``: ``scale = max|x| / 127 + 1e-12`` and
    ``q = clip(round(x / scale), -127, 127)``, round half to even."""
    xf = x.to(F32)
    scale = _scale(xf.abs().max())
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def _compressed_rows(rows: torch.Tensor, reduce: Reduce) -> torch.Tensor:
    """``compressed_psum`` of each participant's row of ``rows``
    ``[P, ...]``."""
    xf = rows.to(F32)
    m = xf.abs().reshape(len(xf), -1).amax(dim=1)
    scale = _scale(reduce(m, "max"))
    scale = scale.reshape((-1,) + (1,) * (xf.dim() - 1))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    total = reduce(q.to(torch.int32), "sum")
    return total.to(F32) * scale


def _bucketed_rows(rows: list[torch.Tensor], reduce: Reduce,
                   bucket_bytes: int, compressed: bool) -> torch.Tensor:
    """``bucketed_psum`` of each participant's flat leaves (``rows``: one
    ``[P, n_i]`` block a leaf) -> the summed ``[P, n]``."""
    flat = torch.cat([r.to(F32) for r in rows], dim=1)
    P, n = flat.shape
    per = max(1, bucket_bytes // 4)
    pad = (-n) % per
    flat = torch.nn.functional.pad(flat, (0, pad)).reshape(P, -1, per)
    # sequential buckets: each could overlap the compute still running
    out = [(_compressed_rows(flat[:, b], reduce) if compressed
            else reduce(flat[:, b], "sum")) for b in range(flat.shape[1])]
    return torch.stack(out, dim=1).reshape(P, -1)[:, :n]


def _split(flat: torch.Tensor, like) -> object:
    """``flat`` cut back into ``like``'s leaves, shapes and dtypes."""
    out, off = [], 0
    for x in leaves(like):
        n = x.numel()
        out.append(flat[off:off + n].reshape(x.shape).to(x.dtype))
        off += n
    return unflatten_like(like, out)


# -- over a process group ----------------------------------------------------

def _group_reduce(group) -> Reduce:
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

    def reduce(rows, op):
        out = rows.clone()
        dist.all_reduce(out, op=ops[op], group=group)
        return out
    return reduce


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8 all-reduce of ``x`` over ``group`` (the default group if
    None): each rank sends one byte an element and agrees on one fp32
    scale first, so the int32 sum dequantizes alike on every rank."""
    return _compressed_rows(x[None], _group_reduce(group))[0]


def bucketed_psum(tree, group=None, bucket_bytes: int = 4 << 20,
                  compressed: bool = False):
    """All-reduce a tree over ``group`` in fixed-size flat buckets."""
    rows = [x.reshape(1, -1) for x in leaves(tree)]
    flat = _bucketed_rows(rows, _group_reduce(group), bucket_bytes,
                          compressed)
    return _split(flat[0], tree)


# -- in one process, over a list of per-rank values ---------------------------

def _stacked_reduce(rows, op):
    r = rows.sum(dim=0) if op == "sum" else rows.amax(dim=0)
    return r.expand_as(rows)


def compressed_psum_stacked(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """:func:`compressed_psum` as each of ``len(xs)`` participants would
    receive it, ``xs[r]`` being rank r's ``x``."""
    return list(_compressed_rows(torch.stack(xs), _stacked_reduce))


def bucketed_psum_stacked(trees: list, bucket_bytes: int = 4 << 20,
                          compressed: bool = False) -> list:
    """:func:`bucketed_psum` as each participant would receive it,
    ``trees[r]`` being rank r's tree."""
    per_leaf = zip(*(leaves(t) for t in trees))
    rows = [torch.stack([x.reshape(-1) for x in xs]) for xs in per_leaf]
    flat = _bucketed_rows(rows, _stacked_reduce, bucket_bytes, compressed)
    return [_split(f, trees[0]) for f in flat]


# -- the model and batch axes of a mesh --------------------------------------
#
# Tensor parallelism's sums, and MoE routing's exchanges over the batch,
# along mesh dims: over a ``DeviceMesh``'s process groups, or over a
# ``StandInMesh`` (one thread a rank).  A sum's gradient is the sum of
# the ranks' gradients: a rank holds a partial gradient of every value
# that all ranks hold alike (its own share of the loss), and the sum over
# the ranks of the partial gradients is the whole.

def _groups(mesh, dims) -> list:
    """The process groups of a ``DeviceMesh`` along ``dims``."""
    return [mesh.get_group(mesh.mesh_dim_names[d]) for d in dims]


def _reduced(x: torch.Tensor, groups, op: str) -> torch.Tensor:
    out = x.contiguous().clone()
    for g in groups:
        dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op], group=g)
    return out


class _GroupSum(torch.autograd.Function):
    """The sum over process groups; its backward sums the gradient over
    them too."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _reduced(x, groups, "sum")

    @staticmethod
    def backward(ctx, grad):
        return _reduced(grad, ctx.groups, "sum"), None


def _standin(mesh) -> bool:
    from .standin import StandInMesh
    return isinstance(mesh, StandInMesh)


def mesh_sum(mesh, dims, x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x`` along the mesh ``dims``, on every one
    of them (autograd-aware; the stand-in adds the ranks' tensors in rank
    order)."""
    if _standin(mesh):
        parts = mesh.exchange(dims, x)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out
    return _GroupSum.apply(x, _groups(mesh, dims))


def mesh_max(mesh, dims, x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of every rank's ``x`` along ``dims`` (no
    gradient)."""
    x = x.detach()
    if _standin(mesh):
        return torch.stack(mesh.exchange(dims, x)).amax(dim=0)
    return _reduced(x, _groups(mesh, dims), "max")


def mesh_gather(mesh, dims, x: torch.Tensor) -> torch.Tensor:
    """``[ranks, *x.shape]``: every rank's ``x`` along ``dims`` stacked in
    their order on ``dims`` (the first dim outermost; no gradient)."""
    x = x.detach()
    if _standin(mesh):
        return torch.stack(mesh.exchange(dims, x))
    out = x.contiguous()[None]
    for g in reversed(_groups(mesh, dims)):   # the innermost dim first
        parts = [torch.empty_like(out) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, out, group=g)
        out = torch.cat(parts)
    return out
