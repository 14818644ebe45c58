"""Scheduling: lifetime analysis, operator reordering, fusion selection.

Reordering follows Liberis & Lane (PAPERS.md): among all topological
orders of the DAG, pick one minimising the peak of the tensor-lifetime
memory profile.  Exact search over orders is exponential, but with
memoisation on the *scheduled set* (the profile's future depends only on
which nodes ran, not in what order) MCUNet-class graphs — chains with
residual skips — collapse to a handful of states; a cap falls back to
the greedy order (smallest resulting live set first).

Fusion selection applies the paper's §7.3 exclusion rule: an
inverted-bottleneck module is fused iff the fused Eq.-(2) plan beats the
per-layer fallback (``vmcu_module_bytes``'s min); FC chains fuse iff the
streaming Eq.-(2) chain plan beats per-layer Eq.-(1) chaining.  Fused
*execution* additionally requires the Fig.-6 kernel's applicability
envelope (stride 1, one segment per pixel) — a byte-fused but strided
module still *reports* the fused footprint while *executing* unfused.

The port's copy of :mod:`repro.graph.schedule`, which is plain Python
and numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from ..core.graph_planner import (ModuleConfig, plan_fc_chain,
                                  plan_inverted_bottleneck,
                                  plan_module_fallback)
from ..core.planner import plan_gemm
from ..core.vpool import SEG_WIDTH, segments_for
from .ir import Graph

# ---------------------------------------------------------------------------
# Lifetime analysis.
# ---------------------------------------------------------------------------


def tensor_lifetimes(graph: Graph, order: Sequence[str]
                     ) -> dict[str, tuple[int, int]]:
    """``{node_id: (birth_step, death_step)}`` of each node's OUTPUT
    tensor under ``order`` (death = last consumer's step; the graph
    output dies at the end)."""
    pos = {i: t for t, i in enumerate(order)}
    lifetimes = {}
    for i in order:
        cons = graph.consumers(i)
        death = max((pos[c] for c in cons), default=len(order) - 1)
        lifetimes[i] = (pos[i], death)
    return lifetimes


def peak_live_bytes(graph: Graph, order: Sequence[str]) -> int:
    """Peak of the tensor-level memory profile: at each step the node's
    inputs and output coexist, plus every tensor whose lifetime spans the
    step."""
    lt = tensor_lifetimes(graph, order)
    peak = 0
    for t, i in enumerate(order):
        live = 0
        for j, (b, d) in lt.items():
            alive = b <= t <= d
            # a node's output is also live while it is being produced
            if j == i:
                alive = True
            if alive:
                live += graph.nodes[j].out.nbytes
        # inputs being read at step t are live even if t is their death
        peak = max(peak, live)
    return peak


# ---------------------------------------------------------------------------
# Operator reordering.
# ---------------------------------------------------------------------------

def reorder(graph: Graph, *, max_states: int = 100_000
            ) -> tuple[list[str], int]:
    """Pick the topological order minimising peak live bytes.

    Exact memoised search over scheduled-sets (branch-and-bound on the
    running peak); falls back to the greedy order when the state budget
    is exhausted.  Returns ``(order, peak_live_bytes)``.
    """
    ids = list(graph.nodes)
    n = len(ids)
    idx = {i: k for k, i in enumerate(ids)}
    preds = {i: set(graph.nodes[i].inputs) for i in ids}
    succs = {i: graph.consumers(i) for i in ids}
    size = {i: graph.nodes[i].out.nbytes for i in ids}

    def live_after(scheduled: frozenset, extra: str) -> int:
        """Live bytes DURING the step that runs ``extra``: its inputs and
        output coexist with every tensor still awaiting a consumer —
        exactly :func:`peak_live_bytes`'s per-step accounting."""
        done = scheduled | {extra}
        total = 0
        for j in done:
            if (j == extra or j in preds[extra]
                    or any(c not in done for c in succs[j])
                    or not succs[j]):
                total += size[j]
        return total

    def ready(scheduled: frozenset) -> list[str]:
        return [i for i in ids
                if i not in scheduled and preds[i] <= scheduled]

    # greedy baseline (also the fallback)
    sched: frozenset = frozenset()
    greedy: list[str] = []
    while len(greedy) < n:
        cand = ready(sched)
        best = min(cand, key=lambda i: (live_after(sched, i), idx[i]))
        greedy.append(best)
        sched = sched | {best}
    bound = peak_live_bytes(graph, greedy)

    states = 0
    memo: dict[frozenset, int] = {}
    best_order: list[str] = greedy

    def dfs(scheduled: frozenset, order: list[str], peak: int) -> None:
        nonlocal states, bound, best_order
        if states > max_states:
            return
        if len(order) == n:
            if peak < bound:
                bound, best_order = peak, list(order)
            return
        seen = memo.get(scheduled)
        if seen is not None and seen <= peak:
            return
        memo[scheduled] = peak
        states += 1
        for i in sorted(ready(scheduled),
                        key=lambda i: (live_after(scheduled, i), idx[i])):
            step_peak = max(peak, live_after(scheduled, i))
            if step_peak >= bound:
                continue
            dfs(scheduled | {i}, order + [i], step_peak)

    dfs(frozenset(), [], 0)
    from ..obs.spans import set_attr
    set_attr(states_expanded=states, n_nodes=n,
             exhausted=states > max_states)
    return best_order, peak_live_bytes(graph, best_order)


# ---------------------------------------------------------------------------
# Fusion-group selection (paper §7.3 exclusion rule).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusionGroup:
    """A run of scheduled nodes lowered as one planning unit.

    ``mcu_bytes`` is the byte-granular vMCU footprint by the paper's
    rule; ``fused_bytes_win`` records the rule's outcome and
    ``fused_exec`` whether execution uses the fused Fig.-6 kernel (rule
    win AND kernel applicability)."""

    name: str
    kind: str                 # module | resblock | mlp_chain | fc_chain
    #                           | single
    node_ids: tuple[str, ...]
    fused_bytes_win: bool = False
    fused_exec: bool = False
    mcu_bytes: int = 0
    te_bytes: int = 0
    hmcos_bytes: int = 0
    delta_bytes: int = 0      # byte-granular b_In - b_Out of the group


def _module_group(graph: Graph, ids: tuple[str, ...], cfg: ModuleConfig,
                  seg_width: int) -> FusionGroup:
    from ..core.graph_planner import (hmcos_module_bytes,
                                      tinyengine_module_bytes)

    fp = plan_inverted_bottleneck(cfg)
    fallback = plan_module_fallback(cfg)
    fused_win = fp.pool_bytes <= fallback
    fused_exec = (fused_win
                  and all(s == 1 for s in cfg.strides)
                  and segments_for(cfg.c_in, seg_width) == 1
                  and segments_for(cfg.c_out, seg_width) == 1)
    mcu = min(fp.pool_bytes, fallback)
    delta = fp.delta_bytes if fused_win else cfg.output_bytes
    return FusionGroup(name=cfg.name, kind="module", node_ids=ids,
                       fused_bytes_win=fused_win, fused_exec=fused_exec,
                       mcu_bytes=mcu, te_bytes=tinyengine_module_bytes(cfg),
                       hmcos_bytes=hmcos_module_bytes(cfg),
                       delta_bytes=delta)


def _resblock_group(graph: Graph, ids: tuple[str, ...]) -> FusionGroup:
    """Byte-granular plan of a ``block``-tagged residual run (ResNet
    basic block): the SAME spec lowering the executable planner uses
    (``netplan.resblock_specs`` — main-path convs with the block input
    held, optional shortcut projection reading the held tensor, post-add
    relu), solved at one byte per segment through ``plan_program``."""
    from ..core.program import plan_program
    from .netplan import resblock_specs

    specs = resblock_specs(graph, ids)
    tin = graph.in_tensor(ids[0])
    prog = plan_program(tin.rows, tin.d, specs, seg_width=1,
                        block_rows=None, elem_bytes=graph.elem_bytes)
    naive = prog.naive_bytes
    return FusionGroup(name=f"res[{ids[0]}..{ids[-1]}]", kind="resblock",
                       node_ids=tuple(ids), fused_bytes_win=True,
                       mcu_bytes=prog.pool_bytes, te_bytes=naive,
                       hmcos_bytes=naive,
                       delta_bytes=prog.input_ptr - prog.output_ptr)


def _single_group(graph: Graph, nid: str) -> FusionGroup:
    """Byte plan of a standalone node (adapter/spatial conv / pool / fc)."""
    import numpy as np

    from ..core.graph_planner import solve_stream_offset
    from ..core.rowsched import conv_k2d_pad

    n = graph.nodes[nid]
    if n.kind == "add":
        raise ValueError(
            f"{nid}: standalone residual adds are not plannable — tag the "
            "pw/dw/pw/add run with a module (or a ResNet run with a "
            "block) so the planner can hold the source tensor "
            "(ResidualAddSpec); free-form skip connections outside "
            "module/block groups are future work")
    tin = graph.in_tensor(nid)
    tout = n.out
    eb = graph.elem_bytes
    if n.kind == "conv_pw":
        p = np.arange(tout.rows, dtype=np.int64)
        op, oq = p // tout.w, p % tout.w
        if n.resample:
            sp, sq = (op * tin.h) // tout.h, (oq * tin.w) // tout.w
        else:
            sp, sq = op * n.stride, oq * n.stride
        read_start = (sp * tin.w + sq) * tin.d * eb
        write_end = (p + 1) * tout.d * eb
        delta = solve_stream_offset(write_end, read_start)
    elif n.kind in ("conv_dw", "conv_k2d"):
        # k-row/col halo window: output pixel (op, oq) still needs the
        # input from its window's low corner on — the Eq.-(2) frontier
        # the conv_k2d schedule widens vs the pointwise case
        pad = (conv_k2d_pad(n.rs, n.padding) if n.kind == "conv_k2d"
               else (n.rs - 1) // 2)
        p = np.arange(tout.rows, dtype=np.int64)
        op, oq = p // tout.w, p % tout.w
        sp = np.clip(op * n.stride - pad, 0, tin.h - 1)
        sq = np.clip(oq * n.stride - pad, 0, tin.w - 1)
        read_start = (sp * tin.w + sq) * tin.d * eb
        write_end = (p + 1) * tout.d * eb
        delta = solve_stream_offset(write_end, read_start)
    elif n.kind in ("conv_stream", "gru_cell"):
        # the frame/input row dies before any output write (delta 0);
        # the persistent state tensor coexists with both — the fourth
        # lifetime class, counted on top of the frame traffic
        state = (n.h_win * tin.w * tin.d * eb if n.kind == "conv_stream"
                 else tout.d * eb)
        mcu = max(tin.nbytes, tout.nbytes) + state
        naive = tin.nbytes + tout.nbytes + state
        return FusionGroup(name=nid, kind="single", node_ids=(nid,),
                           mcu_bytes=mcu, te_bytes=naive,
                           hmcos_bytes=naive, delta_bytes=0)
    elif n.kind == "avgpool":
        # output row written once, at the very end, over freed input
        delta = 0
    elif n.kind == "fc":
        delta = plan_gemm(tin.rows, tout.d * eb, tin.d * eb,
                          segment_bytes=1).delta
    else:   # flatten and friends: no bytes move
        return FusionGroup(name=nid, kind="single", node_ids=(nid,),
                           mcu_bytes=tin.nbytes, te_bytes=tin.nbytes,
                           hmcos_bytes=tin.nbytes, delta_bytes=0)
    mcu = max(tin.nbytes + delta, tout.nbytes)
    naive = tin.nbytes + tout.nbytes
    return FusionGroup(name=nid, kind="single", node_ids=(nid,),
                       mcu_bytes=mcu, te_bytes=naive, hmcos_bytes=naive,
                       delta_bytes=delta)


def _fc_chain_group(graph: Graph, ids: tuple[str, ...]) -> FusionGroup:
    eb = graph.elem_bytes
    tin = graph.in_tensor(ids[0])
    dims = [tin.d] + [graph.nodes[i].out.d for i in ids]
    m = tin.rows
    fused = plan_fc_chain(m, dims, elem_bytes=eb)
    unfused = max(plan_gemm(m, b * eb, a * eb, segment_bytes=1).pool_bytes
                  for a, b in zip(dims[:-1], dims[1:]))
    naive = max((a + b) * m * eb for a, b in zip(dims[:-1], dims[1:]))
    win = fused.pool_bytes <= unfused
    return FusionGroup(name=f"fc[{ids[0]}..{ids[-1]}]", kind="fc_chain",
                       node_ids=ids, fused_bytes_win=win,
                       mcu_bytes=min(fused.pool_bytes, unfused),
                       te_bytes=naive, hmcos_bytes=naive,
                       delta_bytes=fused.delta_bytes if win
                       else dims[-1] * m * eb)


def _mlp_chain_group(graph: Graph, ids: tuple[str, ...]) -> FusionGroup:
    tin = graph.in_tensor(ids[0])
    eb = graph.elem_bytes
    mcu = tin.nbytes            # in-place residual MLPs: x never moves
    naive = tin.nbytes * 2
    return FusionGroup(name=f"mlp[{ids[0]}..{ids[-1]}]", kind="mlp_chain",
                       node_ids=ids, fused_bytes_win=True, fused_exec=True,
                       mcu_bytes=mcu, te_bytes=naive, hmcos_bytes=naive,
                       delta_bytes=0)


def select_groups(graph: Graph, order: Sequence[str], *,
                  seg_width: int = SEG_WIDTH) -> list[FusionGroup]:
    """Partition a scheduled order into fusion groups.

    Module-tagged runs become ``module`` groups (fused by the exclusion
    rule); maximal runs of ``mlp`` / ``fc`` nodes become chain groups;
    everything else is a single-node group.  ``input``/``flatten`` nodes
    lower to nothing.
    """
    groups: list[FusionGroup] = []
    i = 0
    order = [o for o in order
             if graph.nodes[o].kind not in ("input", "flatten")]
    while i < len(order):
        nid = order[i]
        node = graph.nodes[nid]
        if node.module:
            tag = node.module
            j = i
            while j < len(order) and graph.nodes[order[j]].module == tag:
                j += 1
            ids = tuple(order[i:j])
            groups.append(_module_group(graph, ids, graph.modules[tag],
                                        seg_width))
            i = j
        elif node.block:
            tag = node.block
            j = i
            while j < len(order) and graph.nodes[order[j]].block == tag:
                j += 1
            ids = tuple(order[i:j])
            groups.append(_resblock_group(graph, ids))
            i = j
        elif node.kind in ("mlp", "fc"):
            kind = node.kind
            j = i
            while j < len(order) and graph.nodes[order[j]].kind == kind \
                    and not graph.nodes[order[j]].module:
                j += 1
            ids = tuple(order[i:j])
            if kind == "mlp":
                groups.append(_mlp_chain_group(graph, ids))
            elif len(ids) > 1:
                groups.append(_fc_chain_group(graph, ids))
            else:
                groups.append(_single_group(graph, ids[0]))
            i = j
        else:
            groups.append(_single_group(graph, nid))
            i += 1
    return groups
