"""Logical-axis sharding rules for both mesh modes (the port of
``repro.parallel.sharding``), over ``torch.distributed`` DTensors.

Two modes, as the reference's:

* ``tp``      — Megatron TP on the ``model`` axis (heads / d_ff / experts /
                vocab) + ZeRO-3 FSDP on ``data`` + DP batch on (pod, data).
* ``fsdp_sp`` — params replicated on ``model`` (FSDP on ``data``),
                activations sequence-sharded on ``model``; vocab still TP.

Models never name physical axes: they call ``rules.act(x, "batch", "seq",
None)``, and the rules give each parameter path its spec
(``param_spec``).  A spec is the reference's ``PartitionSpec`` as a tuple,
one entry a tensor dim: ``None``, a mesh axis name, or a tuple of names
(one tensor dim over several mesh dims, the first named outermost).
``placements`` turns a spec into DTensor placements, one per mesh dim.
Without a mesh every call is a no-op, so the same code runs on one
device.

The mesh path keeps DTensors at its edges: the train state and a batch
(placed by these rules), a checkpoint's restore, and each block's weight
gather (:meth:`AxisRules.gather`), which hands the block plain tensors:
whole over the batch/FSDP dims, and on the ``model`` axis the rank's own
shard of every leaf that ``tp`` shards there (heads, ``d_ff``, experts,
vocabulary, SSD heads).  Every op of the model and every hand-written
kernel sees plain tensors, the rank's own batch rows, and the model
code itself makes the reductions that GSPMD inserts from the
reference's specs (a sum after a row-parallel product, the vocabulary's max
and sum, the MoE routing's exchange over the batch: :meth:`AxisRules.
psum` and the methods beside it, over the mesh's process groups or a
one-process ``standin.StandInMesh``).  A rank holds a partial gradient
of every value the ranks hold alike, so the sum's backward sums the
gradient over the ranks, and a leaf replicated on ``model`` gathers a
partial gradient on each rank (``Partial``, as on the batch dims).

Sequence parallelism is the model code's too.  Where ``seq`` or
``res_seq`` lies on a mesh dim above 1 (``fsdp_sp`` over ``model``, and
``sp_residual``'s residual under ``tp``) a rank holds a contiguous run
of positions, cut as a DTensor ``Shard`` cuts them
(:meth:`AxisRules.seq_slice`: ceil-sized runs, the last shorter); the
tokens come whole, the embedding keeps the rank's run
(:meth:`AxisRules.scatter_sum`), attention gathers K and V
(:meth:`AxisRules.seq_gather`, its backward a reduce-scatter), a
recurrence passes its carry across the ranks, and the hidden sequence
is gathered before the vocabulary-split unembedding.  Where ``kv_seq``
does (a decode cache whose KV heads do not divide, ``long_context``
over a data axis) a rank keeps its run of each full-length cache and
the ranks' partial attentions are combined by their log-sum-exp.
"""
from __future__ import annotations

import dataclasses
import math
import re
import sys
from typing import Any, ClassVar

import torch

from ..train.tree import leaves_with_paths, map_with_path, tree_map
from . import collectives

#: Where the execution that :func:`check_executable` refuses is queued.
MODEL_AXIS_ITEM = "ROADMAP Queue 1 item 9.6"


def _dt():
    """``torch.distributed.tensor``, imported at first use on a mesh (it
    takes over a second to import; the path without a mesh never needs
    it)."""
    import torch.distributed.tensor as dt
    return dt


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (none can be before the module is
    imported, so this imports nothing)."""
    dt = sys.modules.get("torch.distributed.tensor")
    return dt is not None and isinstance(x, dt.DTensor)


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a mesh (a ``DeviceMesh``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(entry) -> tuple[str, ...]:
    """The mesh axes a spec entry names."""
    return () if entry is None else \
        (entry,) if isinstance(entry, str) else tuple(entry)


def check_executable(cfg, rules) -> None:
    """Raise where the mesh path of ``rules`` would not compute the
    reference's numbers.  ``NotImplementedError`` (naming
    :data:`MODEL_AXIS_ITEM`) for what no config reaches: an ``lru_``
    block under ``tp`` with a ``model`` axis above 1 (its widths on
    ``model``), and an MoE or SSM block over a split ``seq`` (routing and
    the chunked SSD's state over the ranks' runs).  ``ValueError`` where
    the ``model`` axis does not divide a width it shards, where a rank's
    query heads would read KV heads in runs of unequal length, or where
    the residual's sequence is split over other ranks than the
    vocabulary (the embedding's sum keeps the rank's run)."""
    sizes = axis_sizes(rules.mesh)
    R = sizes.get("model", 1)
    # a config with no attention keeps no KV cache for kv_seq to shard
    cached = {"full", "local", "global", "cross"} & set(cfg.pattern)
    res = rules.mesh_dims("res_seq")
    if res and res != rules.mesh_dims("vocab"):
        raise ValueError(f"{cfg.name}: the residual's sequence on mesh dims "
                         f"{res}, the vocabulary on "
                         f"{rules.mesh_dims('vocab')}")
    if rules.mesh_dims("seq") and ({"ssm"} & set(cfg.pattern)
                                   or cfg.n_experts):
        raise NotImplementedError(
            f"{cfg.name}: MoE routing and the SSD's state over a sequence "
            f"split on {sizes} are not ported: {MODEL_AXIS_ITEM}")
    if R == 1:
        return
    widths = {"vocab": cfg.vocab}
    if rules.mode == "tp":
        if "rec" in cfg.pattern:
            raise NotImplementedError(
                f"{cfg.name}'s rec blocks under a 'model' axis of {R} "
                f"ranks (lru_ widths on 'model') are not ported: "
                f"{MODEL_AXIS_ITEM}")
        widths.update({"d_ff": cfg.d_ff, "n_experts": cfg.n_experts})
        if cached:
            widths["n_heads"] = cfg.n_heads
        if cfg.first_dense_layers:
            widths["lead d_ff"] = cfg.d_ff * (cfg.top_k
                                              + cfg.n_shared_experts)
        if cfg.ssm_state:
            widths["ssm_heads"] = cfg.ssm_heads
            if cfg.ssm_groups != 1:
                raise ValueError(f"{cfg.name}: SSD heads over a 'model' "
                                 f"axis read one B/C group; it has "
                                 f"{cfg.ssm_groups}")
    bad = {k: n for k, n in widths.items() if n % R}
    if bad:
        raise ValueError(f"{cfg.name}: a 'model' axis of {R} ranks does not "
                         f"divide {bad}")
    if rules.mode == "tp" and cached and not rules.kv_shardable:
        group = cfg.n_heads // cfg.n_kv_heads
        if group % (cfg.n_heads // R):
            raise ValueError(
                f"{cfg.name}: each of {R} ranks holds {cfg.n_heads // R} "
                f"query heads, which straddle groups of {group} on "
                f"{cfg.n_kv_heads} KV heads")


def run_of(n: int, counts, index) -> tuple[int, int]:
    """``(offset, length)`` of the run of a dim of ``n`` that the rank at
    ``index`` (one coordinate a mesh dim that splits it, outermost first)
    holds when ``counts`` ranks split it on those dims in turn: each dim
    cuts the rank's current run into ``ceil(size / count)`` pieces, the
    last shorter (a rank past the end holds none), as
    :func:`local_slices` and a DTensor ``Shard`` cut it."""
    lo, size = 0, n
    for count, c in zip(counts, index):
        chunk = -(-size // count)
        off = min(c * chunk, size)
        lo += off
        size = min(chunk, size - off)
    return lo, size


def local_slices(shape, mesh_shape, placements, coord) -> tuple[slice, ...]:
    """The slices of a tensor of ``shape`` that the rank at mesh
    coordinate ``coord`` holds under ``placements``: mesh dims in order,
    each ``Shard(d)`` cutting the rank's current piece of dim ``d`` into
    ``torch.chunk`` pieces (the first ``ceil(size / n)`` long; a rank
    past the end holds none), as DTensor cuts it."""
    start, size = [0] * len(shape), list(shape)
    for n, p, c in zip(mesh_shape, placements, coord):
        if isinstance(p, _dt().Shard):
            d = p.dim
            chunk = -(-size[d] // n)
            lo = min(c * chunk, size[d])
            start[d] += lo
            size[d] = min(chunk, size[d] - lo)
    return tuple(slice(s, s + n) for s, n in zip(start, size))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lies on a mesh: the rule's ``spec`` and the DTensor
    ``placements`` it gives, one per mesh dim (the port's
    ``NamedSharding``)."""

    mesh: Any
    spec: tuple
    placements: tuple

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole tensor ``full`` (a view)."""
        return full[local_slices(full.shape, self.mesh.shape,
                                 self.placements,
                                 self.mesh.get_coordinate())]

    def place(self, full, device=None):
        """A DTensor of the whole tensor ``full`` (a tensor or numpy
        array, on any device): this rank keeps only its piece, moved to
        ``device`` (the mesh's device by default), and nothing is sent."""
        full = torch.as_tensor(full)
        if device is None:
            device = mesh_device(self.mesh)
        local = self.local(full).to(device).contiguous()
        return _dt().DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=full.shape,
                                  stride=_contiguous_stride(full.shape))


def mesh_device(mesh) -> torch.device:
    """The device a mesh's tensors lie on in this process."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _on_rank(x, keep_model: bool) -> torch.Tensor:
    """A DTensor as the plain tensor this rank computes on: whole over
    every mesh dim but ``model``, where ``keep_model`` keeps the rank's
    shard (a leaf replicated there is whole anyway).  The gradient
    arrives as this rank's partial sum over every dim it is whole on
    (the ranks' own rows; on ``model``, the rank's share of the loss)
    and its own shard where it keeps one, and goes back into the
    DTensor's placements (a reduce-scatter over the dims it is sharded
    on, an all-reduce over the others)."""
    dt, mesh = _dt(), x.device_mesh
    keep = [keep_model and name == "model" and isinstance(p, dt.Shard)
            for name, p in zip(mesh.mesh_dim_names, x.placements)]
    target = [p if k else dt.Replicate() for p, k in zip(x.placements, keep)]
    return x.redistribute(mesh, target).to_local(
        grad_placements=[p if k else dt.Partial()
                         for p, k in zip(target, keep)])


@dataclasses.dataclass(frozen=True)
class AxisRules:
    mesh: Any                  # a DeviceMesh, or None
    mode: str = "tp"           # "tp" | "fsdp_sp"
    multi_pod: bool = False
    decode: bool = False       # decode steps: S==1, never shard "seq"
    long_context: bool = False  # long_500k: batch==1, shard cache seq
    kv_shardable: bool = True  # n_kv_heads % model_size == 0
    sp_residual: bool = False  # tp mode: Megatron-SP — shard the residual
                               # stream (and saved activations) on "model"

    # -- logical -> physical ---------------------------------------------------
    def _phys(self, logical: str | None):
        if logical is None:
            return None
        if logical == "batch":
            if self.long_context:
                return None    # batch == 1
            return ("pod", "data") if self.multi_pod else "data"
        if logical == "fsdp":
            return "data"
        if logical == "seq":
            if self.decode:
                return None    # decode: query length 1
            return "model" if self.mode == "fsdp_sp" else None
        if logical == "res_seq":   # residual stream between blocks
            if self.decode:
                return None
            if self.mode == "fsdp_sp" or self.sp_residual:
                return "model"
            return None
        if logical == "kv_seq":      # KV-cache sequence dim
            if self.long_context:
                # batch==1: spread the cache over everything available
                return "data" if self.kv_shardable else ("data", "model")
            if self.decode and not self.kv_shardable:
                return "model"  # heads can't shard — shard cache seq instead
            return None
        if logical == "kv_heads":
            return ("model" if self.mode == "tp" and self.kv_shardable
                    else None)
        if logical in ("heads", "ff", "experts", "tp"):
            return "model" if self.mode == "tp" else None
        if logical == "vocab":
            return "model"
        raise ValueError(f"unknown logical axis {logical!r}")

    def spec(self, *logical: str | None) -> tuple:
        return tuple(self._phys(ax) for ax in logical)

    def placements(self, spec: tuple) -> tuple:
        """DTensor placements of ``spec`` on the mesh: ``Shard(d)`` on
        every mesh dim that entry ``d`` names, ``Replicate()`` on the
        others.  A tuple entry names its mesh dims outermost first, in
        the mesh's order (the data-major layout of JAX's)."""
        dt, names = _dt(), tuple(self.mesh.mesh_dim_names)
        out: list = [dt.Replicate()] * len(names)
        for d, entry in enumerate(spec):
            axes = _axes(entry)
            for a in axes:
                if a not in names:
                    raise ValueError(f"spec {spec} names {a!r}, not an axis "
                                     f"of the mesh {names}")
            dims = [names.index(a) for a in axes]
            if dims != sorted(set(dims)):
                raise ValueError(f"spec entry {entry!r} must name distinct "
                                 f"mesh axes in the mesh's order {names}")
            for m in dims:
                if not isinstance(out[m], dt.Replicate):
                    raise ValueError(f"spec {spec} names mesh axis "
                                     f"{names[m]!r} twice")
                out[m] = dt.Shard(d)
        return tuple(out)

    def act(self, x, *logical: str | None):
        """Constrain an activation: a DTensor is redistributed to the
        rule's placements; a plain tensor (the rank's own rows, as the
        mesh path hands every op) and anything without a mesh is
        returned as it is."""
        if self.mesh is None or not is_dtensor(x):
            return x
        return x.redistribute(self.mesh, self.placements(self.spec(*logical)))

    def sharding(self, *logical: str | None) -> Sharding | None:
        if self.mesh is None:
            return None
        spec = self.spec(*logical)
        return Sharding(self.mesh, spec, self.placements(spec))

    # -- parameter placement ---------------------------------------------------
    # Path-pattern rules, first match wins. Trailing dims are matched right-
    # aligned so stacked [n_groups, ...] params get None on the lead axis.
    _PARAM_RULES: ClassVar[tuple[tuple[str, tuple[str | None, ...]], ...]] = (
        (r"embed|unembed", ("vocab", "fsdp")),
        (r"\bw_(q|k|v)\b", ("fsdp", "heads")),
        (r"\bw_o\b", ("heads", "fsdp")),
        (r"\bw_(gate|up)\b$", ("fsdp", "ff")),
        (r"\bw_down\b", ("ff", "fsdp")),
        (r"moe_(gate|up)", ("experts", "fsdp", None)),
        (r"moe_down", ("experts", None, "fsdp")),
        (r"shared_(gate|up)", ("fsdp", "ff")),
        (r"shared_down", ("ff", "fsdp")),
        (r"router", ("fsdp", None)),
        (r"ssm_w_(z|x)|ssm_conv_x", ("fsdp", "heads")),  # d_inner cols
        (r"ssm_w_(b|c|dt)", ("fsdp", None)),
        (r"ssm_out", ("heads", "fsdp")),
        (r"ssm_(a_log|d|dt_bias|norm)", (None,)),
        (r"lru_w_(x|y)", ("fsdp", "tp")),
        (r"lru_out", ("tp", "fsdp")),
        (r"lru_", (None,)),
        (r"conv", (None, None)),
        (r"ln|norm|scale|bias", (None,)),
    )

    def param_spec(self, path: str, ndim: int) -> tuple:
        for pat, dims in self._PARAM_RULES:
            if re.search(pat, path):
                if len(dims) > ndim:
                    dims = dims[-ndim:]
                lead = (None,) * (ndim - len(dims))
                return tuple(self._phys(d) for d in (lead + dims))
        return (None,) * ndim

    def params_shardings(self, params) -> Any:
        """A param tree's :class:`Sharding` of every leaf, by its path
        (keys joined by ``/``; no mesh: a tree of None)."""
        if self.mesh is None:
            return tree_map(lambda _: None, params)

        def leaf(path, x):
            spec = self.param_spec("/".join(path), x.ndim)
            return Sharding(self.mesh, spec, self.placements(spec))
        return map_with_path(leaf, params)

    def constrain_tree(self, params):
        """Pin every DTensor param to its rule placements (a no-op where
        it already lies so); plain tensors and a tree without a mesh are
        returned as they are."""
        if self.mesh is None:
            return params

        def leaf(path, x):
            if not is_dtensor(x):
                return x
            spec = self.param_spec("/".join(path), x.ndim)
            return x.redistribute(self.mesh, self.placements(spec))
        return map_with_path(leaf, params)

    # -- the mesh path ---------------------------------------------------------
    def batch_shards(self) -> int:
        """How many ranks split the batch (1 without a mesh)."""
        return self.shards("batch")

    def check(self, cfg) -> None:
        """:func:`check_executable` of this mesh (no mesh: nothing)."""
        if self.mesh is not None:
            check_executable(cfg, self)

    def whole_on_model(self, path) -> bool:
        """Whether a leaf at ``path`` (its keys) is computed on whole
        where the rules shard it on ``model``: the KV projections when
        the KV heads do not divide (``kv_heads`` replicated: each rank
        reads the KV heads its query heads need)."""
        return not self.kv_shardable and bool(path) \
            and path[-1] in ("w_k", "w_v")

    def gather(self, tree):
        """Every DTensor leaf of ``tree`` as the plain tensor this rank
        computes on (a block's weights just before it runs): whole over
        the batch/FSDP dims, the rank's shard on a ``model`` axis above 1
        (:meth:`whole_on_model` aside); autograd sends each gradient
        back into its leaf's placements."""
        if self.mesh is None:
            return tree
        keep = self.model_ranks() > 1
        return map_with_path(
            lambda path, x: _on_rank(x, keep and not self.whole_on_model(
                path)) if is_dtensor(x) else x, tree)

    def rank_tree(self, tree, coord=None):
        """This rank's plain tree of a whole one (any layout whose leaf
        paths the param rules read: the reference's tree or the serve
        path's params): each leaf as :meth:`gather` hands it to the
        rank at ``coord`` (this rank's by default), a view."""
        if self.mesh is None or self.model_ranks() == 1:
            return tree
        names = tuple(self.mesh.mesh_dim_names)
        m = list(coord if coord is not None
                 else self.mesh.get_coordinate())[names.index("model")]
        R = self.model_ranks()

        def leaf(path, x):
            d = self.model_dim(path, x.ndim)
            if d is None:
                return x
            n = x.shape[d] // R
            return x.narrow(d, m * n, n)
        return map_with_path(leaf, tree)

    def model_dim(self, path, ndim: int) -> int | None:
        """The dim of a leaf at ``path`` whose ``model`` shard a rank
        computes on (None: it computes on the leaf whole)."""
        if self.whole_on_model(path):
            return None
        spec = self.param_spec("/".join(path), ndim)
        return next((d for d, entry in enumerate(spec)
                     if "model" in _axes(entry)), None)

    # -- collectives over the mesh dims of a logical axis ---------------------
    def mesh_dims(self, logical: str) -> list[int]:
        """The mesh dims above 1 that ``logical`` is sharded over."""
        if self.mesh is None:
            return []
        names = tuple(self.mesh.mesh_dim_names)
        return [names.index(a) for a in _axes(self._phys(logical))
                if a in names and self.mesh.shape[names.index(a)] > 1]

    def shards(self, logical: str) -> int:
        """How many ranks split ``logical`` (1 where none does)."""
        return math.prod(self.mesh.shape[d] for d in self.mesh_dims(logical))

    def model_ranks(self) -> int:
        """The ranks of the ``model`` axis (1 without a mesh)."""
        return 1 if self.mesh is None else \
            axis_sizes(self.mesh).get("model", 1)

    def shard_index(self, logical: str) -> int:
        """This rank's index among the ranks that split ``logical``
        (row-major over their mesh dims; 0 where nothing splits it)."""
        dims = self.mesh_dims(logical)
        if not dims:
            return 0
        coord, i = self.mesh.get_coordinate(), 0
        for d in dims:
            i = i * self.mesh.shape[d] + coord[d]
        return i

    def psum(self, x: torch.Tensor, logical: str) -> torch.Tensor:
        """The sum of the ranks' ``x`` over the mesh dims that split
        ``logical`` (``x`` itself where none does): the reduction GSPMD
        inserts after a product contracted over that axis.  Its backward
        sums the ranks' gradients."""
        dims = self.mesh_dims(logical)
        return collectives.mesh_sum(self.mesh, dims, x) if dims else x

    def pmax(self, x: torch.Tensor, logical: str) -> torch.Tensor:
        """The elementwise max of the ranks' ``x`` over the mesh dims that
        split ``logical`` (no gradient)."""
        dims = self.mesh_dims(logical)
        return collectives.mesh_max(self.mesh, dims, x) if dims \
            else x.detach()

    def seq_slices(self, logical: str, n: int) -> list[tuple[int, int]]:
        """``(offset, length)`` of every rank's run of a dim of ``n``
        split on ``logical``, in :meth:`shard_index` order (one run, the
        whole, where nothing splits it)."""
        counts = [self.mesh.shape[d] for d in self.mesh_dims(logical)] \
            if self.mesh is not None else []
        out = []
        for i in range(math.prod(counts)):
            index = []
            for c in reversed(counts):
                index.append(i % c)
                i //= c
            out.append(run_of(n, counts, index[::-1]))
        return out

    def seq_slice(self, logical: str, n: int) -> tuple[int, int]:
        """This rank's ``(offset, length)`` of a dim of ``n`` split on
        ``logical``: its run of positions (``(0, n)`` where nothing
        splits it)."""
        dims = self.mesh_dims(logical)
        if not dims:
            return 0, n
        coord = self.mesh.get_coordinate()
        return run_of(n, [self.mesh.shape[d] for d in dims],
                      [coord[d] for d in dims])

    def seq_gather(self, x: torch.Tensor, logical: str, n: int,
                   dim: int = 1) -> torch.Tensor:
        """The whole dim ``dim`` (``n`` long) from the ranks' runs of it
        split on ``logical`` (``x`` is this rank's): autograd-aware, the
        gradient of each rank's run reduce-scattered back to it."""
        dims = self.mesh_dims(logical)
        if not dims:
            return x
        return collectives.mesh_cat(
            self.mesh, dims, x, dim,
            [m for _, m in self.seq_slices(logical, n)],
            self.shard_index(logical))

    def scatter_sum(self, x: torch.Tensor, logical: str,
                    dim: int = 1) -> torch.Tensor:
        """This rank's run (split on ``logical``) of dim ``dim`` of the sum
        of the ranks' ``x`` over ``logical``'s mesh dims: a reduce-scatter
        (its backward gathers the ranks' gradients of their runs)."""
        dims = self.mesh_dims(logical)
        if not dims:
            return x
        return collectives.mesh_scatter_sum(
            self.mesh, dims, x, dim,
            [m for _, m in self.seq_slices(logical, x.shape[dim])],
            self.shard_index(logical))

    def seq_last(self, x: torch.Tensor, logical: str,
                 n: int) -> torch.Tensor:
        """The last row of dim 1 (``n`` long, split on ``logical``; ``x``
        is this rank's run), on every rank: each rank's last row (zeros
        from a rank past the end) gathered, the last holder's kept."""
        dims = self.mesh_dims(logical)
        if not dims:
            return x[:, -1:]
        owner = max(i for i, (_, m) in
                    enumerate(self.seq_slices(logical, n)) if m)
        row = x[:, -1:] if x.shape[1] else \
            x.new_zeros(x.shape[:1] + (1,) + x.shape[2:])
        return self.pgather(row, logical)[owner]

    def scatters_residual(self) -> bool:
        """Whether the residual's sequence is split where the blocks'
        is not (``sp_residual``, Megatron-SP): a block gathers it at its
        entry and scatters its row-parallel sums."""
        res = self.mesh_dims("res_seq")
        return bool(res) and res != self.mesh_dims("seq")

    def block_input(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """A sub-layer's input from this rank's run of the residual ``x``
        (``n`` positions in all): the whole sequence where the residual is
        split and the blocks are not (:meth:`scatters_residual`), else
        ``x``."""
        return self.seq_gather(x, "res_seq", n) if self.scatters_residual() \
            else x

    def one_token(self) -> "AxisRules":
        """The rules of a one-token decode step under these: a sequence
        of one is not split (``sp_residual`` off; ``fsdp_sp``'s blocks and
        residual are split alike, so nothing moves), the caches stay
        where prefill put them."""
        return dataclasses.replace(self, sp_residual=False) \
            if self.sp_residual else self

    def pgather(self, x: torch.Tensor, logical: str) -> torch.Tensor:
        """``[n, *x.shape]``: the ``n`` ranks' ``x`` that split
        ``logical``, in :meth:`shard_index` order; autograd-aware (a scan
        carry or a conv halo that crosses the ranks' runs), each rank's
        gradient of the whole summed back to the rank of each row."""
        dims = self.mesh_dims(logical)
        if not dims:
            return x[None]
        return collectives.mesh_cat(self.mesh, dims, x[None], 0,
                                    [1] * self.shards(logical),
                                    self.shard_index(logical))

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of a rank's plain ``x`` over the ranks that split the
        batch (``x`` itself without a mesh)."""
        return self.psum(x, "batch")

    def _sum_over(self, x: torch.Tensor, dims) -> torch.Tensor:
        """The sum of a rank's plain ``x`` over the ranks along mesh
        ``dims`` (one all-reduce a dim; none where ``dims`` is empty)."""
        dt = _dt()
        part = [dt.Partial() if d in dims else dt.Replicate()
                for d in range(self.mesh.ndim)]
        return dt.DTensor.from_local(x, self.mesh, part).full_tensor()

    def global_norm(self, tree) -> torch.Tensor:
        """The global norm of a tree of DTensors (and plain tensors), in
        fp32: each leaf's sum of squares over its local shards, counted
        once however many ranks hold a replica, summed over every rank
        in one all-reduce, then over the leaves in their order."""
        if self.mesh is None:
            raise ValueError("global_norm needs a mesh")
        dt, coord = _dt(), self.mesh.get_coordinate()
        sums = []
        for _, x in leaves_with_paths(tree):
            if isinstance(x, dt.DTensor):
                owner = all(c == 0 for c, p in zip(coord, x.placements)
                            if not isinstance(p, dt.Shard))
                x = x.to_local()
            else:
                owner = all(c == 0 for c in coord)
            sq = x.detach().to(torch.float32).square().sum()
            sums.append(sq if owner else torch.zeros_like(sq))
        total = self._sum_over(torch.stack(sums), [
            d for d, n in enumerate(self.mesh.shape) if n > 1])
        acc = total[0]
        for s in total[1:]:
            acc = acc + s
        return torch.sqrt(acc)


def local_tree(tree):
    """Every DTensor leaf of ``tree`` as this rank's local tensor."""
    return tree_map(lambda x: x.to_local() if is_dtensor(x) else x, tree)


def place_tree(tree, shardings):
    """``tree`` with each leaf that ``shardings`` (the same structure,
    e.g. :meth:`AxisRules.params_shardings`) gives a :class:`Sharding`
    placed by it (:meth:`Sharding.place`); the others as they are."""
    by_path = {p: s for p, s in leaves_with_paths(shardings)}

    def leaf(path, x):
        s = by_path.get(path)
        return x if s is None else s.place(x)
    return map_with_path(leaf, tree)


#: The rules without a mesh (immutable, so one instance serves every
#: caller): every call a no-op.
NO_SHARDING = AxisRules(mesh=None)


def no_sharding() -> AxisRules:
    return NO_SHARDING
