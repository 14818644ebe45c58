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
  ``AxisRules.psum`` and ``pmax`` call).
* ``mesh_cat / mesh_scatter_sum`` — the ranks' runs of a dim joined
  whole, its backward a reduce-scatter; and the reduce-scatter itself
  (the sum of the ranks' whole dims, each rank keeping its run), its
  backward the join (what ``AxisRules.seq_gather``, ``pgather`` and
  ``scatter_sum`` call).

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


#: ``reduce_scatter_single``; older torch (2.11) has it only as
#: ``reduce_scatter_tensor`` (the same arguments), which newer torch warns
#: of
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _padded(x: torch.Tensor, dim: int, chunk: int) -> torch.Tensor:
    """``x`` zero-padded at the end of ``dim`` to ``chunk`` rows."""
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, chunk - x.shape[dim]]
    return torch.nn.functional.pad(x, pad)


def _joined_runs(x, mesh, dims, dim, lengths) -> torch.Tensor:
    """Every rank's run ``x`` of ``dim`` (rank ``i`` holding
    ``lengths[i]`` rows) joined in rank order: an all-gather of the runs
    padded to the longest, the padding cut away."""
    stacked = mesh_gather(mesh, dims, _padded(x, dim, max(lengths)))
    return torch.cat([stacked[i].narrow(dim, 0, n)
                      for i, n in enumerate(lengths)], dim=dim)


def _scattered_runs(whole, mesh, dims, dim, lengths,
                    index) -> torch.Tensor:
    """Rank ``index``'s run of ``dim`` of the sum of every rank's
    ``whole`` (the runs ``lengths`` long, joined in rank order): a
    reduce-scatter of the runs padded to the longest, one a mesh dim,
    outermost first, each rank sending and receiving ``1 / R`` of the
    whole but for the padding."""
    chunk, lo = max(lengths), 0
    runs = []
    for n in lengths:
        runs.append(_padded(whole.narrow(dim, lo, n), dim, chunk))
        lo += n
    rows = torch.stack(runs).contiguous()           # [R, ...chunk...]
    for g in _groups(mesh, dims):
        size = dist.get_world_size(g)
        out = rows.new_empty((rows.shape[0] // size,) + rows.shape[1:])
        _reduce_scatter(out, rows, group=g)
        rows = out
    return rows[0].narrow(dim, 0, lengths[index])


class _GroupCat(torch.autograd.Function):
    """The ranks' runs of ``dim`` joined in rank order over process
    groups; the backward reduce-scatters the gradient of the whole, each
    rank receiving the sum over them of its own run's."""

    @staticmethod
    def forward(ctx, x, mesh, dims, dim, lengths, index):
        ctx.args = mesh, dims, dim, lengths, index
        return _joined_runs(x, mesh, dims, dim, lengths)

    @staticmethod
    def backward(ctx, grad):
        return (_scattered_runs(grad, *ctx.args),) + (None,) * 5


class _GroupScatterSum(torch.autograd.Function):
    """The sum over process groups of the ranks' whole ``dim``, each rank
    keeping its run (a reduce-scatter); the backward joins the ranks'
    gradients of their runs."""

    @staticmethod
    def forward(ctx, x, mesh, dims, dim, lengths, index):
        ctx.args = mesh, dims, dim, lengths
        return _scattered_runs(x, mesh, dims, dim, lengths, index)

    @staticmethod
    def backward(ctx, grad):
        return (_joined_runs(grad, *ctx.args),) + (None,) * 5


def mesh_cat(mesh, dims, x: torch.Tensor, dim: int, lengths,
             index: int) -> torch.Tensor:
    """Every rank's ``x`` along the mesh ``dims`` joined on ``dim`` in
    their order (rank ``i`` holding ``lengths[i]`` rows of it; this rank
    is ``index``): autograd-aware, each rank's gradient of the whole
    reduce-scattered back to the ranks' runs (the stand-in keeps the
    ranks' autograd edges, so the caller's one backward does that)."""
    if _standin(mesh):
        return torch.cat(mesh.exchange(dims, x), dim=dim)
    return _GroupCat.apply(x, mesh, tuple(dims), dim, tuple(lengths), index)


def mesh_scatter_sum(mesh, dims, x: torch.Tensor, dim: int, lengths,
                     index: int) -> torch.Tensor:
    """This rank's run (``lengths[index]`` rows at the rank's offset, the
    runs in rank order) of dim ``dim`` of the sum of every rank's ``x``
    along the mesh ``dims``: a reduce-scatter over process groups, its
    backward the join of the ranks' gradients (the stand-in adds the
    ranks' tensors in rank order and cuts the run, keeping their autograd
    edges)."""
    if _standin(mesh):
        lo = sum(lengths[:index])
        return mesh_sum(mesh, dims, x).narrow(dim, lo, lengths[index])
    return _GroupScatterSum.apply(x, mesh, tuple(dims), dim,
                                  tuple(lengths), index)
