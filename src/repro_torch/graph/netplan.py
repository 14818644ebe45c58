"""The global network planner: all groups in ONE VirtualPool ring.

``plan_net`` turns a :class:`graph.ir.Graph` into a :class:`NetPlan`:

  1. schedule the DAG (``graph.schedule.reorder``),
  2. select fusion groups by the paper's exclusion rule,
  3. lower every group to ``plan_program()`` layer specs and solve the
     WHOLE net as one :class:`PoolProgram` — the Eq.-(1)/(2) offsets
     chain *across* group boundaries, so group ``i+1`` overwrites group
     ``i``'s consumed input instead of resetting the pool,
  4. chain the byte-granular (int8, MCU) footprints of the groups the
     same way and report the whole-network bottleneck against the
     TinyEngine / HMCOS tensor-level baselines.

Two footprints, two granularities, by design: ``program.pool_bytes`` is
the *executed* segment-granular ring (fp32 on the card's kernels, certified
by the ``sim`` oracle), ``mcu_bottleneck_bytes`` is the paper's byte-
granular int8 number (the Fig. 9/10 metric the 61.5% reduction is
measured on).  The byte formulas of ``core.graph_planner`` cross-check
the per-group values.

The port's copy of :mod:`repro.graph.netplan`, which is plain Python
and numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from ..core.graph_planner import ModuleConfig
from ..core.program import (AvgPoolSpec, ConvDWSpec, ConvK2DSpec,
                            ConvPWSpec, ConvStreamSpec, GemmSpec,
                            FusedMLPSpec, GRUCellSpec, IBModuleSpec,
                            LayerSpec, PoolProgram, ResidualAddSpec,
                            plan_program)
from ..core.vpool import SEG_WIDTH, ceil_div
from .ir import Graph
from .schedule import FusionGroup, reorder, select_groups


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """One fusion group's slot in the NetPlan."""

    group: FusionGroup
    op_lo: int                # slice of NetPlan.program.ops
    op_hi: int
    mcu_in_off: int           # byte-chain offsets (Eq. 2 across groups)
    mcu_out_off: int

    @property
    def name(self) -> str:
        return self.group.name


@dataclasses.dataclass
class NetPlan:
    """A fully planned network over one ring."""

    name: str
    graph: Graph
    order: tuple[str, ...]
    groups: tuple[GroupPlan, ...]
    program: PoolProgram
    mcu_pool_bytes: int       # byte-granular whole-net ring (max span)

    # -- whole-network MCU numbers (paper Fig. 9/10 metric) ---------------
    @property
    def mcu_bottleneck_bytes(self) -> int:
        return max(g.group.mcu_bytes for g in self.groups)

    @property
    def tinyengine_bottleneck_bytes(self) -> int:
        return max(g.group.te_bytes for g in self.groups)

    @property
    def hmcos_bottleneck_bytes(self) -> int:
        return max(g.group.hmcos_bytes for g in self.groups)

    @property
    def reduction_vs_tinyengine(self) -> float:
        return 1.0 - (self.mcu_bottleneck_bytes
                      / self.tinyengine_bottleneck_bytes)

    @property
    def reduction_vs_hmcos(self) -> float:
        return 1.0 - (self.mcu_bottleneck_bytes
                      / self.hmcos_bottleneck_bytes)

    # -- executed (segment-granular) footprint ----------------------------
    @property
    def pool_bytes(self) -> int:
        return self.program.pool_bytes

    @property
    def physical_pool_bytes(self) -> int:
        return self.program.physical_pool_bytes

    def bottleneck_group(self) -> GroupPlan:
        return max(self.groups, key=lambda g: g.group.mcu_bytes)

    def deployable(self, ram_bytes: int) -> bool:
        return self.mcu_bottleneck_bytes <= ram_bytes


# ---------------------------------------------------------------------------
# Group -> layer-spec lowering.
# ---------------------------------------------------------------------------

def _module_specs(graph: Graph, group: FusionGroup,
                  cfg: ModuleConfig) -> list[LayerSpec]:
    if group.fused_exec:
        return [IBModuleSpec(cfg)]
    s1, s2, s3 = cfg.strides
    h0 = cfg.hw
    h1 = ceil_div(h0, s1)
    h2 = ceil_div(h1, s2)
    specs: list[LayerSpec] = [
        ConvPWSpec(h0, h0, cfg.c_in, cfg.c_mid, stride=s1,
                   activation="relu"),
        ConvDWSpec(h1, h1, cfg.c_mid, rs=cfg.rs, stride=s2,
                   activation="relu"),
        ConvPWSpec(h2, h2, cfg.c_mid, cfg.c_out, stride=s3),
    ]
    if cfg.has_residual:
        specs.append(ResidualAddSpec(3))
    return specs


def _node_spec(graph: Graph, nid: str,
               input_from: int = 0) -> list[LayerSpec]:
    n = graph.nodes[nid]
    tin = graph.in_tensor(nid)
    if input_from and n.kind not in ("conv_pw", "conv_k2d"):
        raise ValueError(f"{nid}: only conv_pw/conv_k2d nodes can read a "
                         "held branch tensor")
    if n.kind == "conv_pw":
        return [ConvPWSpec(tin.h, tin.w, tin.d, n.out.d, stride=n.stride,
                           resample_to=((n.out.h, n.out.w) if n.resample
                                        else None),
                           activation=n.activation,
                           input_from=input_from)]
    if n.kind == "conv_dw":
        return [ConvDWSpec(tin.h, tin.w, tin.d, rs=n.rs, stride=n.stride,
                           activation=n.activation)]
    if n.kind == "conv_k2d":
        return [ConvK2DSpec(tin.h, tin.w, tin.d, n.out.d, k=n.rs,
                            stride=n.stride, padding=n.padding,
                            activation=n.activation,
                            input_from=input_from)]
    if n.kind == "conv_stream":
        return [ConvStreamSpec(n.h_win, tin.w, tin.d, n.out.d, k=n.rs,
                               stride=n.stride, padding=n.padding,
                               hop=n.hop, activation=n.activation)]
    if n.kind == "gru_cell":
        return [GRUCellSpec(n.out.d)]
    if n.kind == "avgpool":
        return [AvgPoolSpec(tin.h, tin.w, tin.d)]
    if n.kind == "fc":
        return [GemmSpec(n.out.d, activation=n.activation)]
    if n.kind == "mlp":
        from .ir import _ff_tile
        return [FusedMLPSpec(n.d_ff, gated=n.gated, residual=True,
                             activation=n.activation or "gelu",
                             ff_tile=_ff_tile(n.d_ff))]
    if n.kind == "elementwise":
        from ..core.program import ElementwiseSpec
        return [ElementwiseSpec(n.activation or "gelu")]
    raise ValueError(f"cannot lower node kind {n.kind!r}")


def resblock_specs(graph: Graph, ids: Sequence[str]) -> list[LayerSpec]:
    """Lower a ``block``-tagged residual run (in scheduled order) to
    plan_program specs.

    The run is a linear chain plus at most one branch per node: a node
    whose graph input is not the chained tensor becomes a branch conv
    (``input_from`` — it reads the *held* input of the op whose chained
    tensor it needs, e.g. the ResNet shortcut projection reading the
    block input), and the closing ``add``'s residual operand resolves to
    whichever op's chained input produced it (``ResidualAddSpec.src``).
    """
    nodes = [graph.nodes[i] for i in ids]
    if len(nodes) < 2 or nodes[-1].kind != "add":
        raise ValueError(f"res block {ids}: must end in an add node")
    # chained tensor entering op j: the previous node's output (op 0
    # chains from the block input)
    chain_in = [nodes[0].inputs[0]] + [n.id for n in nodes[:-1]]
    specs: list[LayerSpec] = []
    for j, n in enumerate(nodes[:-1]):
        src_id = n.inputs[0]
        input_from = 0
        if src_id != chain_in[j]:
            k = chain_in.index(src_id)
            if k >= j:
                raise ValueError(f"{n.id}: branch source {src_id!r} not "
                                 "available earlier in the block")
            input_from = j - k
        specs.extend(_node_spec(graph, n.id, input_from=input_from))
    add = nodes[-1]
    main, aux = add.inputs
    if main != nodes[-2].id:
        main, aux = aux, main
    if main != nodes[-2].id:
        raise ValueError(f"{add.id}: neither add operand chains from the "
                         f"preceding node {nodes[-2].id!r}")
    if aux not in chain_in:
        raise ValueError(f"{add.id}: residual operand {aux!r} is not a "
                         "tensor the block holds")
    src = (len(nodes) - 1) - chain_in.index(aux)
    specs.append(ResidualAddSpec(src, activation=add.activation))
    return specs


def group_specs(graph: Graph, group: FusionGroup) -> list[LayerSpec]:
    """Lower one fusion group to ``plan_program`` layer specs."""
    if group.kind == "module":
        return _module_specs(graph, group, graph.modules[group.name])
    if group.kind == "resblock":
        return resblock_specs(graph, group.node_ids)
    specs: list[LayerSpec] = []
    for nid in group.node_ids:
        specs.extend(_node_spec(graph, nid))
    return specs


# ---------------------------------------------------------------------------
# plan_net.
# ---------------------------------------------------------------------------

def _plan_net(graph: Graph, *, seg_width: int = SEG_WIDTH,
              block_rows: int | None = 1, elem_bytes: int | None = None,
              dtype: str = "float32", delta_slack: int = 0,
              fused_exec: bool = True,
              order: Sequence[str] | None = None) -> NetPlan:
    """Plan a whole network into one ring.

    ``block_rows=1`` (default) produces the DMA-aligned geometry all
    ring kernels execute; ``block_rows=None`` the tight Eq.-(1)/(2)
    geometry (certified by the ``sim`` oracle).

    ``dtype`` sets the executed pool element type (``"int8"`` makes
    ``program.pool_bytes`` byte-comparable to ``mcu_bottleneck_bytes``).
    ``fused_exec=False`` forces every module to lower to its unfused
    pw → dw → pw (→ add) op run — the form the int8 executor requantizes
    between ops (the byte-granular *reported* footprints still follow
    the paper's exclusion rule either way).
    """
    graph.validate()
    if order is None:
        order, _ = reorder(graph)
    order = list(order)
    groups = select_groups(graph, order, seg_width=seg_width)
    if not fused_exec:
        groups = [dataclasses.replace(g, fused_exec=False) for g in groups]

    specs: list[LayerSpec] = []
    ranges: list[tuple[int, int]] = []
    for g in groups:
        lo = len(specs)
        specs.extend(group_specs(graph, g))
        ranges.append((lo, len(specs)))

    tin = graph.nodes[graph.input_id()].out
    program = plan_program(tin.rows, tin.d, specs, seg_width=seg_width,
                           block_rows=block_rows, elem_bytes=elem_bytes,
                           dtype=dtype, delta_slack=delta_slack)

    # Chain the byte-granular group plans across boundaries (Eq. 2): the
    # next group's input IS this group's output, delta_bytes below it.
    gplans: list[GroupPlan] = []
    off = 0
    for g, (lo, hi) in zip(groups, ranges):
        out_off = off - g.delta_bytes
        gplans.append(GroupPlan(group=g, op_lo=lo, op_hi=hi,
                                mcu_in_off=off, mcu_out_off=out_off))
        off = out_off
    mcu_pool = max(g.mcu_bytes for g in groups)

    return NetPlan(name=graph.name, graph=graph, order=tuple(order),
                   groups=tuple(gplans), program=program,
                   mcu_pool_bytes=mcu_pool)


def plan_net(graph: Graph, **kwargs) -> NetPlan:
    """Deprecated direct entry — use :func:`repro_torch.compile`.

    ``plan_net`` is now the ``plan`` pass of the compile driver
    (``repro_torch.compile(net, target=...)``), which sources seg-width /
    alignment / dtype knobs from the :class:`repro_torch.compile.targets.
    Target` registry instead of per-call-site wiring.  The shim keeps
    the exact legacy behavior (same defaults, same NetPlan)."""
    import warnings

    warnings.warn(
        "direct plan_net() entry is deprecated; use "
        "repro_torch.compile(net, target=...) — the driver runs plan_net as "
        "its 'plan' pass with knobs from the Target registry",
        DeprecationWarning, stacklevel=2)
    return _plan_net(graph, **kwargs)
