"""Whole-network DAG IR + builders.

A :class:`Graph` is an ordered DAG of :class:`Node` ops over quantized
:class:`Tensor` values (per-tensor byte sizes drive the lifetime
analysis in ``graph.schedule``).  Node kinds:

  ``input`` ``conv_pw`` ``conv_dw`` ``conv_k2d`` ``add`` ``avgpool``
  ``flatten`` ``fc`` ``mlp`` ``elementwise``

Builders lower the paper's MCUNet module tables
(:data:`repro_torch.core.graph_planner.MCUNET_5FPS_VWW` /
:data:`MCUNET_320KB_IMAGENET`) and every registered ``configs/`` model
into the IR.  Modules expand to their *unfused* pw → dw → pw (→ add)
node sequence tagged with the module name — fusing them back into one
Fig.-6 kernel is the scheduler's decision (``graph.schedule``), made by
the paper's own exclusion rule, not the builder's.

Where consecutive table modules do not chain (channel or resolution
mismatch — the tables list benchmark modules, not a closed network), the
builder inserts a pointwise *adapter* conv: strided when the resolution
divides down exactly, nearest-grid resampling otherwise.

The MLPerf-Tiny-class model zoo (``build_ds_cnn`` / ``build_resnet8`` /
``build_mobilenet_v1``) builds on the general ``conv_k2d`` node: real
k x k spatial convs with halo frontiers, incl. ResNet residual blocks
whose shortcut projection reads the *held* block input (``block``-tagged
node runs — lowered by ``graph.schedule.select_groups`` as one planning
unit).

The port's copy of :mod:`repro.graph.ir`, which is plain Python
and numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from ..core.graph_planner import ModuleConfig
from ..core.rowsched import conv_k2d_out
from ..core.vpool import ceil_div


@dataclasses.dataclass(frozen=True)
class Tensor:
    """A value in the graph: ``rows`` x ``d`` elements (``h``/``w`` carry
    the image geometry for conv tensors; ``rows == h * w`` then)."""

    rows: int
    d: int
    h: int = 0
    w: int = 0
    elem_bytes: int = 1

    @property
    def nbytes(self) -> int:
        return self.rows * self.d * self.elem_bytes


@dataclasses.dataclass(frozen=True)
class Node:
    """One IR op.  ``inputs`` are producer node ids (the second input of
    ``add`` is the residual source); ``out`` is the produced tensor."""

    id: str
    kind: str
    inputs: tuple[str, ...]
    out: Tensor
    stride: int = 1
    rs: int = 0
    padding: str = "same"     # conv_k2d halo convention (same/valid)
    resample: bool = False
    activation: str | None = None
    d_ff: int = 0
    gated: bool = False
    module: str = ""          # module tag for fusion-group selection
    block: str = ""           # residual-block tag (ResNet-style groups)
    h_win: int = 0            # conv_stream: sliding-window height
    hop: int = 0              # conv_stream: frame rows appended per step


class Graph:
    """An ordered DAG; insertion order is a valid topological order."""

    def __init__(self, name: str, elem_bytes: int = 1):
        self.name = name
        self.elem_bytes = elem_bytes
        self.nodes: dict[str, Node] = {}
        self.modules: dict[str, ModuleConfig] = {}

    # -- construction ------------------------------------------------------
    def add(self, id: str, kind: str, inputs: Sequence[str], out: Tensor,
            **attrs) -> str:
        if id in self.nodes:
            raise ValueError(f"duplicate node id {id!r}")
        for src in inputs:
            if src not in self.nodes:
                raise ValueError(f"node {id!r} references unknown input "
                                 f"{src!r}")
        self.nodes[id] = Node(id=id, kind=kind, inputs=tuple(inputs),
                              out=out, **attrs)
        return id

    # -- structure ---------------------------------------------------------
    def node(self, id: str) -> Node:
        return self.nodes[id]

    def in_tensor(self, id: str) -> Tensor:
        """The (first) input tensor of a node."""
        n = self.nodes[id]
        if not n.inputs:
            raise ValueError(f"node {id!r} has no inputs")
        return self.nodes[n.inputs[0]].out

    def consumers(self, id: str) -> list[str]:
        return [n.id for n in self.nodes.values() if id in n.inputs]

    def input_id(self) -> str:
        for n in self.nodes.values():
            if n.kind == "input":
                return n.id
        raise ValueError("graph has no input node")

    def output_id(self) -> str:
        sinks = [n.id for n in self.nodes.values()
                 if not self.consumers(n.id)]
        if len(sinks) != 1:
            raise ValueError(f"graph has {len(sinks)} sinks: {sinks}")
        return sinks[0]

    def topo_order(self) -> list[str]:
        """Kahn topological order (ties broken by insertion order)."""
        indeg = {i: len(n.inputs) for i, n in self.nodes.items()}
        ready = [i for i, d in indeg.items() if d == 0]
        order: list[str] = []
        while ready:
            i = ready.pop(0)
            order.append(i)
            for c in self.consumers(i):
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(order) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return order

    def validate(self) -> None:
        self.topo_order()
        for n in self.nodes.values():
            if n.kind == "input":
                if n.inputs:
                    raise ValueError("input node cannot have inputs")
                continue
            t = self.in_tensor(n.id)
            if n.kind in ("conv_pw", "conv_dw", "conv_k2d", "conv_stream") \
                    and t.h * t.w != t.rows:
                raise ValueError(f"{n.id}: conv over non-image tensor")
            if n.kind == "conv_stream" and (t.h, t.w) != (n.hop, t.w):
                raise ValueError(f"{n.id}: conv_stream frame height "
                                 f"{t.h} != hop {n.hop}")
            if n.kind == "add":
                if len(n.inputs) != 2:
                    raise ValueError(f"{n.id}: add needs two inputs")
                a, b = (self.nodes[s].out for s in n.inputs)
                if (a.rows, a.d) != (b.rows, b.d):
                    raise ValueError(f"{n.id}: add shape mismatch")
            if n.kind == "flatten" and t.rows != 1:
                raise ValueError(
                    f"{n.id}: only 1x1 tensors flatten losslessly in "
                    "row-major pool layout (use avgpool first)")


# ---------------------------------------------------------------------------
# Builders.
# ---------------------------------------------------------------------------

def _adapter(g: Graph, src: str, cur: Tensor, h: int, c: int,
             elem_bytes: int, idx: int) -> tuple[str, Tensor]:
    """Insert a pointwise adapter conv from ``cur`` to an ``h x h x c``
    tensor: strided when the resolution divides down, resampling
    otherwise."""
    stride, resample = 1, False
    if cur.h != h:
        s = max(1, round(cur.h / h))
        if ceil_div(cur.h, s) == h:
            stride = s
        else:
            resample = True
    out = Tensor(rows=h * h, d=c, h=h, w=h, elem_bytes=elem_bytes)
    nid = g.add(f"T{idx}", "conv_pw", [src], out, stride=stride,
                resample=resample, activation=None)
    return nid, out


def build_mcunet(modules: Iterable[ModuleConfig], name: str, *,
                 num_classes: int = 2, elem_bytes: int = 1,
                 include_head: bool = True) -> Graph:
    """Lower a MCUNet module table into the IR.

    Each table row becomes its unfused pw1 -> dw -> pw2 (-> residual add)
    node run tagged ``module=<row name>``; adapters connect rows whose
    shapes do not chain; an avgpool/flatten/fc head closes the net.
    """
    modules = list(modules)
    g = Graph(name, elem_bytes=elem_bytes)
    cfg0 = modules[0]
    cur = Tensor(rows=cfg0.hw * cfg0.hw, d=cfg0.c_in, h=cfg0.hw, w=cfg0.hw,
                 elem_bytes=elem_bytes)
    src = g.add("in", "input", [], cur)
    for t, cfg in enumerate(modules):
        if (cur.h, cur.d) != (cfg.hw, cfg.c_in):
            src, cur = _adapter(g, src, cur, cfg.hw, cfg.c_in, elem_bytes,
                                t)
        g.modules[cfg.name] = cfg
        s1, s2, s3 = cfg.strides
        h0 = cfg.hw
        h1 = ceil_div(h0, s1)
        h2 = ceil_div(h1, s2)
        h3 = ceil_div(h2, s3)
        mod_in = src
        b = Tensor(h1 * h1, cfg.c_mid, h1, h1, elem_bytes)
        src = g.add(f"{cfg.name}.pw1", "conv_pw", [src], b, stride=s1,
                    activation="relu", module=cfg.name)
        c = Tensor(h2 * h2, cfg.c_mid, h2, h2, elem_bytes)
        src = g.add(f"{cfg.name}.dw", "conv_dw", [src], c, stride=s2,
                    rs=cfg.rs, activation="relu", module=cfg.name)
        d = Tensor(h3 * h3, cfg.c_out, h3, h3, elem_bytes)
        src = g.add(f"{cfg.name}.pw2", "conv_pw", [src], d, stride=s3,
                    module=cfg.name)
        if cfg.has_residual:
            src = g.add(f"{cfg.name}.add", "add", [src, mod_in], d,
                        module=cfg.name)
        cur = d
    if include_head:
        pooled = Tensor(1, cur.d, 1, 1, elem_bytes)
        src = g.add("head.pool", "avgpool", [src], pooled)
        src = g.add("head.flatten", "flatten", [src], pooled)
        logits = Tensor(1, num_classes, 1, 1, elem_bytes)
        src = g.add("head.fc", "fc", [src], logits)
    g.validate()
    return g


# ---------------------------------------------------------------------------
# MLPerf-Tiny-class model zoo (conv_k2d workloads).
# ---------------------------------------------------------------------------

def _k2d(g: Graph, id: str, src: str, cur: Tensor, c_out: int, *, k: int,
         stride: int = 1, padding: str = "same",
         activation: str | None = "relu", block: str = "",
         elem_bytes: int = 1) -> tuple[str, Tensor]:
    h = conv_k2d_out(cur.h, k, stride, padding)
    w = conv_k2d_out(cur.w, k, stride, padding)
    out = Tensor(rows=h * w, d=c_out, h=h, w=w, elem_bytes=elem_bytes)
    nid = g.add(id, "conv_k2d", [src], out, stride=stride, rs=k,
                padding=padding, activation=activation, block=block)
    return nid, out


def _head(g: Graph, src: str, cur: Tensor, num_classes: int,
          elem_bytes: int) -> None:
    pooled = Tensor(1, cur.d, 1, 1, elem_bytes)
    src = g.add("head.pool", "avgpool", [src], pooled)
    src = g.add("head.flatten", "flatten", [src], pooled)
    logits = Tensor(1, num_classes, 1, 1, elem_bytes)
    g.add("head.fc", "fc", [src], logits)


def build_ds_cnn(*, num_classes: int = 12, c: int = 64,
                 elem_bytes: int = 1) -> Graph:
    """DS-CNN keyword spotting (MLPerf Tiny): 49x10x1 MFCC input, a
    strided k x k stem conv, four depthwise-separable blocks, avgpool +
    fc head.

    The reference stem is a (10, 4)-shaped stride-2 filter; the segment
    ring's conv vocabulary is square k in {3, 5}, so the stem is the
    closest square member: 5x5 stride 2 (same channel count and output
    grid)."""
    g = Graph("ds-cnn", elem_bytes=elem_bytes)
    cur = Tensor(rows=49 * 10, d=1, h=49, w=10, elem_bytes=elem_bytes)
    src = g.add("in", "input", [], cur)
    src, cur = _k2d(g, "stem", src, cur, c, k=5, stride=2,
                    elem_bytes=elem_bytes)
    for i in range(4):
        out = Tensor(cur.rows, c, cur.h, cur.w, elem_bytes)
        src = g.add(f"B{i}.dw", "conv_dw", [src], out, rs=3,
                    activation="relu")
        src = g.add(f"B{i}.pw", "conv_pw", [src], out, activation="relu")
        cur = out
    _head(g, src, cur, num_classes, elem_bytes)
    g.validate()
    return g


def build_resnet8(*, num_classes: int = 10, elem_bytes: int = 1) -> Graph:
    """ResNet-8 (MLPerf Tiny image classification): 32x32x3 input, a
    3x3 stem and three residual stacks (16/32/64 channels; stacks 2 and
    3 downsample with stride 2 and a 1x1 stride-2 shortcut projection),
    avgpool + fc head.

    Each stack is a ``block``-tagged node run so the scheduler lowers it
    as one planning unit: the main-path convs run while the planner
    holds the block input, the shortcut projection reads that held
    tensor (``input_from``), and the post-add relu rides on the ``add``
    op."""
    g = Graph("resnet-8", elem_bytes=elem_bytes)
    cur = Tensor(rows=32 * 32, d=3, h=32, w=32, elem_bytes=elem_bytes)
    src = g.add("in", "input", [], cur)
    src, cur = _k2d(g, "stem", src, cur, 16, k=3, elem_bytes=elem_bytes)
    for i, (c, stride) in enumerate(((16, 1), (32, 2), (64, 2))):
        tag = f"R{i}"
        block_in, tin = src, cur
        src, cur = _k2d(g, f"{tag}.c1", src, cur, c, k=3, stride=stride,
                        block=tag, elem_bytes=elem_bytes)
        src, cur = _k2d(g, f"{tag}.c2", src, cur, c, k=3, stride=1,
                        activation=None, block=tag,
                        elem_bytes=elem_bytes)
        res = block_in
        if stride != 1 or tin.d != c:
            res = g.add(f"{tag}.sc", "conv_pw", [block_in], cur,
                        stride=stride, activation=None, block=tag)
        src = g.add(f"{tag}.add", "add", [src, res], cur,
                    activation="relu", block=tag)
    _head(g, src, cur, num_classes, elem_bytes)
    g.validate()
    return g


def build_mobilenet_v1(*, hw: int = 96, num_classes: int = 2,
                       width_mult: float = 0.25,
                       elem_bytes: int = 1) -> Graph:
    """MobileNetV1 (width multiplier 0.25, 96x96 input by default — the
    MLPerf Tiny visual-wake-words configuration): a real 3x3 stride-2
    stem conv (the op MCUNet-style tables never exercise) followed by
    13 depthwise-separable blocks and the avgpool/fc head."""
    def ch(c: int) -> int:
        return max(8, int(c * width_mult + 0.5) // 8 * 8)

    g = Graph(f"mobilenetv1-{width_mult}", elem_bytes=elem_bytes)
    cur = Tensor(rows=hw * hw, d=3, h=hw, w=hw, elem_bytes=elem_bytes)
    src = g.add("in", "input", [], cur)
    src, cur = _k2d(g, "stem", src, cur, ch(32), k=3, stride=2,
                    elem_bytes=elem_bytes)
    blocks = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
              (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
              (1024, 2), (1024, 1))
    for i, (c, stride) in enumerate(blocks):
        h = ceil_div(cur.h, stride)
        w = ceil_div(cur.w, stride)
        dwt = Tensor(h * w, cur.d, h, w, elem_bytes)
        src = g.add(f"B{i}.dw", "conv_dw", [src], dwt, rs=3,
                    stride=stride, activation="relu")
        out = Tensor(h * w, ch(c), h, w, elem_bytes)
        src = g.add(f"B{i}.pw", "conv_pw", [src], out, activation="relu")
        cur = out
    _head(g, src, cur, num_classes, elem_bytes)
    g.validate()
    return g


def build_ad_autoencoder(*, d_in: int = 640, d_hidden: int = 128,
                         d_latent: int = 8, elem_bytes: int = 1) -> Graph:
    """MLPerf-Tiny anomaly detection (ToyADMOS): a fully-connected
    autoencoder over 640-dim (5-frame stacked) log-mel windows — four
    128-wide encoder layers, an 8-dim bottleneck, four 128-wide decoder
    layers and the 640-dim reconstruction head (the anomaly score is
    the reconstruction error, computed outside the net)."""
    g = Graph("ad-toyadmos", elem_bytes=elem_bytes)
    cur = Tensor(rows=1, d=d_in, elem_bytes=elem_bytes)
    src = g.add("in", "input", [], cur)
    dims = (d_hidden,) * 4 + (d_latent,) + (d_hidden,) * 4 + (d_in,)
    for i, d in enumerate(dims):
        out = Tensor(rows=1, d=d, elem_bytes=elem_bytes)
        act = "relu" if i < len(dims) - 1 else None
        src = g.add(f"fc{i}", "fc", [src], out, activation=act)
    g.validate()
    return g


def _ff_tile(d_ff: int, cap: int = 512) -> int:
    """Largest divisor of d_ff not exceeding ``cap``."""
    for t in range(min(cap, d_ff), 0, -1):
        if d_ff % t == 0:
            return t
    return d_ff


def build_mlp_tower(cfg, *, m_rows: int = 8, n_layers: int | None = None,
                    elem_bytes: int = 2) -> Graph:
    """Lower a ``configs/`` :class:`ModelConfig`'s FFN stack into the IR
    (the pool-resident part of an LM block; attention state does not
    stream through the ring — DESIGN.md §Arch-applicability)."""
    n_layers = cfg.n_layers if n_layers is None else n_layers
    gated = cfg.mlp in ("geglu", "swiglu")
    act = "silu" if cfg.mlp == "swiglu" else "gelu"
    d_ff = cfg.d_ff
    if d_ff == 0:           # pure-SSM configs: the in-projection
        d_ff = cfg.d_inner  # expansion is the never-materialized tensor
        gated, act = True, "silu"
    g = Graph(f"{cfg.name}-mlp-tower", elem_bytes=elem_bytes)
    cur = Tensor(rows=m_rows, d=cfg.d_model, elem_bytes=elem_bytes)
    src = g.add("in", "input", [], cur)
    for i in range(n_layers):
        src = g.add(f"L{i}.mlp", "mlp", [src], cur, d_ff=d_ff,
                    gated=gated, activation=act)
    g.validate()
    return g
