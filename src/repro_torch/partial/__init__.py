"""Partial execution on the segment ring.

Counterpart of :mod:`repro.partial`, in plain Python on the host.

When a fusion group's footprint overflows the target SRAM, this
subsystem turns the hard :class:`repro_torch.SRAMBudgetError` into a
scheduled latency/memory trade: split the group's output spatially and
re-run the producing conv chain once per slice, recomputing the halo
rows adjacent slices share (Pex / MCUNetV2 patch-based inference).

  * :mod:`repro_torch.partial.slicer` — halo-aware window propagation and
    the recompute-MACs-vs-bytes-saved cost model (Pareto frontier),
  * :mod:`repro_torch.partial.lower` — the ``PoolOp`` surgery producing ONE
    merged, verifier-coverable program,
  * :func:`plan_partial` — the driver-facing policy: greedily slice
    whichever group pins the ring, walking each group's frontier until
    the whole net fits (``partial="auto"``) or a fixed slice count is
    forced on the pinning group (``partial=N``).
"""
from __future__ import annotations

import dataclasses

from ..core.program import PoolProgram
from .lower import (PartialLowerError, apply_partial, finalize,
                    live_spans, recompute_spans, slice_group_ops)
from .slicer import (SliceCandidate, candidate, chain_range, chain_steps,
                     estimate_slices, op_macs, pareto, program_macs,
                     slice_layout)


class PartialPlanError(PartialLowerError):
    """No slicing of the sliceable groups brings the net under budget."""


@dataclasses.dataclass(frozen=True)
class PartialPlan:
    """A chosen slicing: the sliced program + its cost accounting."""

    program: PoolProgram              # sliced + finalized
    parents: tuple[int, ...]          # sliced op -> unsliced op index
    choices: dict                     # {(op_lo, op_hi): n_slices}
    groups: tuple[dict, ...]          # per-group cost rows
    ring_bytes_before: int
    ring_bytes_after: int
    net_macs: int

    @property
    def extra_macs(self) -> int:
        return sum(g["extra_macs"] for g in self.groups)

    @property
    def extra_read_segments(self) -> int:
        return sum(g["extra_read_segments"] for g in self.groups)

    @property
    def mac_overhead(self) -> float:
        return self.extra_macs / self.net_macs if self.net_macs else 0.0

    def summary(self) -> dict:
        """JSON-safe accounting for reports/artifacts/benchmarks."""
        return {
            "n_sliced_groups": len(self.groups),
            "total_slices": sum(g["n_slices"] for g in self.groups),
            "ring_bytes_before": self.ring_bytes_before,
            "ring_bytes_after": self.ring_bytes_after,
            "extra_macs": self.extra_macs,
            "mac_overhead": self.mac_overhead,
            "extra_read_segments": self.extra_read_segments,
            "groups": list(self.groups),
        }


def _pinning_range(spans, parents, ranges):
    """The group range containing the op that pins the current ring."""
    i = max(range(len(spans)), key=spans.__getitem__)
    parent = parents[i]
    for lo, hi in ranges:
        if lo <= parent < hi:
            return (lo, hi)
    return None


def plan_partial(program: PoolProgram, group_ranges, sram_bytes: int, *,
                 force: int | None = None,
                 max_slices: int | None = None) -> PartialPlan | None:
    """Choose and lower a slicing that fits ``program`` in ``sram_bytes``.

    ``group_ranges`` are ``(op_lo, op_hi)`` fusion-group spans of the
    unsliced program (``NetPlan.groups``).  Auto mode (``force=None``):
    repeatedly find the op pinning the ring, walk its group one step
    further along the slice-count Pareto frontier, stop when the ring
    fits; returns ``None`` when the program already fits and raises
    :class:`PartialPlanError` when no slicing can fit.  ``force=N``
    slices the pinning group with exactly ``N`` slices, fit or not.
    """
    seg_bytes = program.seg_width * program.elem_bytes
    ranges = [tuple(r) for r in group_ranges]
    choices: dict[tuple[int, int], int] = {}

    if force is not None:
        # most-pinning SLICEABLE group first (the op pinning the ring
        # may sit in the unsliceable first/last group)
        spans = live_spans(program.ops)
        by_span = sorted(ranges, key=lambda r: -max(spans[r[0]:r[1]]))
        c = rng = None
        for rng in by_span:
            c = candidate(program, rng[0], rng[1], force)
            if c is not None:
                break
        if c is None:
            chk = chain_range(program, by_span[0][0], by_span[0][1])
            why = chk if isinstance(chk, str) else "halo-infeasible split"
            raise PartialPlanError(
                f"cannot slice any group into {force} slices; pinning "
                f"group ops[{by_span[0][0]}:{by_span[0][1]}): {why}")
        choices[rng] = force
    else:
        if program.pool_bytes <= sram_bytes:
            return None
        frontiers: dict[tuple[int, int], list[SliceCandidate]] = {}
        while True:
            sliced_prog, parents = apply_partial(program, choices)
            if sliced_prog.pool_bytes <= sram_bytes:
                break
            spans = live_spans(sliced_prog.ops)
            rng = _pinning_range(spans, parents, ranges)
            ring = sliced_prog.pool_bytes
            if rng is None:
                raise PartialPlanError(
                    f"ring {ring} B > {sram_bytes} B SRAM is pinned "
                    "outside every fusion group")
            if rng not in frontiers:
                chk = chain_range(program, rng[0], rng[1])
                frontiers[rng] = ([] if isinstance(chk, str) else
                                  pareto(program, rng[0], rng[1],
                                         max_slices=max_slices))
            cur_n = choices.get(rng, 1)
            nxt = next((c for c in frontiers[rng] if c.n_slices > cur_n),
                       None)
            if nxt is None:
                chk = chain_range(program, rng[0], rng[1])
                why = (chk if isinstance(chk, str)
                       else "its slice frontier is exhausted")
                raise PartialPlanError(
                    f"ring {ring} B > {sram_bytes} B SRAM: pinned by "
                    f"group ops[{rng[0]}:{rng[1]}) and {why}")
            choices[rng] = nxt.n_slices

    sliced_prog, parents = apply_partial(program, choices)
    rows = []
    for (lo, hi), n in sorted(choices.items()):
        c = candidate(program, lo, hi, n)
        rows.append({"op_lo": lo, "op_hi": hi, "n_slices": n,
                     "region_segments": c.region_segments,
                     "region_bytes": c.region_segments * seg_bytes,
                     "extra_macs": c.extra_macs,
                     "extra_read_segments": c.extra_read_segments})
    return PartialPlan(
        program=sliced_prog, parents=parents, choices=dict(choices),
        groups=tuple(rows),
        ring_bytes_before=program.pool_bytes,
        ring_bytes_after=sliced_prog.pool_bytes,
        net_macs=program_macs(program))


__all__ = ["PartialLowerError", "PartialPlan", "PartialPlanError",
           "SliceCandidate", "apply_partial", "candidate", "chain_range",
           "chain_steps", "estimate_slices", "finalize", "live_spans",
           "op_macs", "pareto", "plan_partial", "program_macs",
           "recompute_spans", "slice_group_ops", "slice_layout"]
