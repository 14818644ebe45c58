"""Lowering — rewrite sliced groups into per-slice PoolOp runs inside
ONE merged :class:`PoolProgram`.

Counterpart of :mod:`repro.partial.lower`.

The surgery replaces a group's conv chain ``ops[g_lo:hi)`` with
``n_slices`` copies of the chain, one per output row band:

  * the group input ``X`` stays exactly where the plan put it; every
    slice reads a halo window of it in place (``in_row0``/``h_src``
    windowed reads, ``hold_input`` + ``in_op`` record sharing) and the
    LAST slice frees it (``free_src``) — unless the group ends in a
    residual ``add`` that still needs ``X``, which then frees it as its
    held aux source exactly as in the unsliced plan;
  * interior tensors live in per-chain-position scratch BANDS stacked
    directly below ``X`` — each band is sized for the worst slice and
    reused by every slice, with ordinary produce/consume semantics;
  * output bands land at their final resting offsets ``y0 + oa*yrow``
    and merge into ONE output record via ``out_op``/``out_row0``
    deferred-write ownership, so the consumer op reads the assembled
    tensor exactly as before;
  * every op after the group shifts down by the (block-aligned) ring
    savings, and the program's ring length is re-derived from the live
    spans of the rewritten schedule (:func:`recompute_spans` — the same
    max-live-span accounting ``plan_program`` uses).

Pointers stay multiples of their DMA blocks and ``n_segments`` a
multiple of every block, so ``check_alignment`` and the static
verifier's decidable fragment still cover the result.
"""
from __future__ import annotations

import dataclasses
import math

from ..core.program import (EXECUTABLE_KINDS, PoolOp, PoolProgram,
                            _floor_mult)
from ..core.vpool import ceil_div, segments_for
from .slicer import chain_chunks, chain_range, chain_steps, slice_layout


class PartialLowerError(ValueError):
    """The requested slicing cannot be lowered onto the ring."""


def _blocks(op: PoolOp, seg_width: int, block_rows: int | None
            ) -> tuple[int, int]:
    """(in, out) DMA block sizes in segments (PoolProgram.op_blocks)."""
    br = block_rows or 1
    ci = segments_for(op.d_in, seg_width)
    co = segments_for(op.d_out, seg_width)
    if op.kind in ("conv_pw", "conv_dw", "conv_k2d", "ib_fused"):
        return op.w_in * ci, op.w_out * co
    if op.kind == "pool_avg":
        return op.w_in * ci, co
    if op.kind == "add":
        return ci, co
    return br * ci, br * co


def live_spans(ops: tuple[PoolOp, ...]) -> list[int]:
    """Per-op instantaneous live span (segments) of an op schedule.

    Mirrors ``plan_program``'s ring accounting on the FINAL pointers:
    tracks every live tensor record (program input, chained tensors,
    held branch/residual sources, partially-assembled ``out_op``
    outputs) and reports the lo..hi extent each op observes.
    """
    live: dict[int, tuple[int, int]] = {}

    def _union(key: int, lo: int, hi: int) -> None:
        cur = live.get(key)
        live[key] = ((min(cur[0], lo), max(cur[1], hi)) if cur
                     else (lo, hi))

    first = ops[0]
    _union(0, first.in_ptr, first.in_ptr + first.in_segments)
    spans = []
    for i, op in enumerate(ops):
        ikey = op.in_op if op.in_op >= 0 else i
        okey = op.out_op if op.out_op >= 0 else i + 1
        _union(ikey, op.in_ptr, op.in_ptr + op.in_segments)
        _union(okey, op.out_ptr, op.out_ptr + op.out_segments)
        if op.aux_op >= 0:
            _union(op.aux_op, op.aux_ptr, op.aux_ptr + op.in_segments)
        lo = min(v[0] for v in live.values())
        hi = max(v[1] for v in live.values())
        spans.append(hi - lo)
        if not op.hold_input or op.free_src:
            live.pop(ikey, None)
        if op.aux_op >= 0:
            live.pop(op.aux_op, None)
    return spans


def recompute_spans(ops: tuple[PoolOp, ...]) -> int:
    """Max instantaneous live span (segments) — the merged ring length."""
    return max(live_spans(ops))


def slice_group_ops(program: PoolProgram, op_lo: int, op_hi: int,
                    n_slices: int) -> tuple[list[PoolOp], list[int]]:
    """Replace group ``[op_lo, op_hi)``'s conv chain with per-slice runs.

    Returns ``(ops, parents)`` where ``parents[i]`` is the index of the
    op in ``program`` that new op ``i`` descends from (slices map to
    their chain op — the parameter/qparam sharing map).  The returned
    list is NOT finalized: run :func:`finalize` (or let
    :func:`apply_partial` do it) to re-derive the ring length.
    """
    rng = chain_range(program, op_lo, op_hi)
    if isinstance(rng, str):
        raise PartialLowerError(
            f"group ops[{op_lo}:{op_hi}) is not sliceable: {rng}")
    g_lo, hi = rng
    ops = list(program.ops)
    chain = tuple(ops[g_lo:hi])
    L = len(chain)
    steps = chain_steps(chain)
    layout = slice_layout(steps, n_slices)
    if layout is None:
        raise PartialLowerError(
            f"no feasible {n_slices}-slice split of group "
            f"ops[{g_lo}:{hi}) (h_out={steps[-1].h_out}, halos clash "
            "with interior padding)")
    chunks = chain_chunks(program, chain)
    aligned = program.block_rows is not None

    # -- scratch bands stacked below X (addresses descend) ----------------
    x0 = chain[0].in_ptr
    base = x0
    band_base = [0] * L                       # [0] unused (X in place)
    for j in range(1, L):
        size = layout.band_rows[j] * chunks[j][0]
        b = base - size
        if aligned:
            b = _floor_mult(b, chunks[j][0])
        band_base[j] = b
        base = b

    # -- the assembled output record, shifted down with everything after --
    yrow = chunks[-1][1]
    y_tot = steps[-1].h_out * yrow
    y0_orig = chain[-1].out_ptr
    y0_raw = base - y_tot
    if aligned:
        down_align = math.lcm(yrow, *(
            math.lcm(*_blocks(op, program.seg_width, program.block_rows))
            for op in ops[hi:] if op.kind in EXECUTABLE_KINDS))
    else:
        down_align = 1
    dshift = _floor_mult(y0_raw - y0_orig, down_align)
    y0 = y0_orig + dshift

    # X survives the chain for a trailing residual add (the unsliced op
    # held it too); otherwise the last slice frees the whole record.
    free_x = not chain[0].hold_input
    shiftn = n_slices * L - L
    consumer_new = hi + shiftn

    sliced: list[PoolOp] = []
    parents_mid: list[int] = []
    for i, wins in enumerate(layout.windows):
        for j in range(L):
            op, w = chain[j], wins[j]
            in_chunk, out_chunk = chunks[j]
            last = j == L - 1
            in_ptr = x0 if j == 0 else band_base[j]
            out_ptr = (y0 + w.out_lo * yrow) if last else band_base[j + 1]
            sliced.append(dataclasses.replace(
                op,
                in_ptr=in_ptr, out_ptr=out_ptr, delta=in_ptr - out_ptr,
                in_segments=(op.in_segments if j == 0
                             else w.h_in * in_chunk),
                out_segments=w.h_out * out_chunk,
                rows_in=w.h_in * op.w_in, rows_out=w.h_out * op.w_out,
                h_in=w.h_in, h_out=w.h_out, padding=w.padding,
                in_op=(g_lo if (j == 0 and i > 0) else -1),
                hold_input=(j == 0),
                in_row0=(w.in_lo if j == 0 else 0),
                h_src=(op.h_in if j == 0 else 0),
                out_op=(consumer_new if last else -1),
                out_row0=(w.out_lo if last else 0),
                free_src=(j == 0 and i == n_slices - 1 and free_x)))
            parents_mid.append(g_lo + j)

    # -- every op after the chain shifts by the ring savings --------------
    tail: list[PoolOp] = []
    for op in ops[hi:]:
        kw: dict = {"out_ptr": op.out_ptr + dshift}
        if op.in_op == -1 or op.in_op >= hi:
            kw["in_ptr"] = op.in_ptr + dshift
        if op.in_op >= hi:
            kw["in_op"] = op.in_op + shiftn
        if op.aux_op >= hi:
            kw["aux_op"] = op.aux_op + shiftn
            kw["aux_ptr"] = op.aux_ptr + dshift
        if op.out_op >= hi:
            kw["out_op"] = op.out_op + shiftn
        tail.append(dataclasses.replace(op, **kw))

    new_ops = ops[:g_lo] + sliced + tail
    parents = (list(range(g_lo)) + parents_mid
               + list(range(hi, len(ops))))
    return new_ops, parents


def finalize(program: PoolProgram,
             ops: list[PoolOp]) -> PoolProgram:
    """Re-derive the ring from a rewritten op list.

    Shifts every pointer non-negative (preserving block alignment) and
    recomputes ``pool_segments``/``n_segments`` from the live spans —
    ``n_segments`` stays a multiple of every op's DMA blocks so
    ``check_alignment`` holds on the merged program.
    """
    aligned = program.block_rows is not None
    execs = [op for op in ops if op.kind in EXECUTABLE_KINDS]
    align = (math.lcm(*(math.lcm(*_blocks(op, program.seg_width,
                                          program.block_rows))
                        for op in execs)) if aligned and execs else 1)
    base = min(min(op.in_ptr, op.out_ptr) if op.aux_op < 0
               else min(op.in_ptr, op.out_ptr, op.aux_ptr)
               for op in ops)
    if base < 0:
        shift = -_floor_mult(base, align)
        ops = [dataclasses.replace(
            op, in_ptr=op.in_ptr + shift, out_ptr=op.out_ptr + shift,
            aux_ptr=op.aux_ptr + shift if op.aux_op >= 0 else op.aux_ptr)
            for op in ops]
    span = recompute_spans(tuple(ops))
    n = ceil_div(span, align) * align if aligned else span
    out = dataclasses.replace(program, ops=tuple(ops),
                              pool_segments=span, n_segments=n)
    if aligned:
        out.check_alignment()
    return out


def apply_partial(program: PoolProgram,
                  choices: dict[tuple[int, int], int]
                  ) -> tuple[PoolProgram, tuple[int, ...]]:
    """Slice every group in ``choices`` (``{(op_lo, op_hi): n_slices}``,
    ranges over the UNSLICED program) and finalize the merged ring.

    Returns ``(program, parents)`` — ``parents[i]`` maps op ``i`` of the
    sliced program back to its originating op, for parameter/qparam
    sharing and trace attribution.
    """
    parents = list(range(len(program.ops)))
    ops = list(program.ops)
    cur = program
    # descending op order: each surgery only renumbers ops AFTER its
    # group, so earlier (lower) group ranges stay valid throughout
    for (op_lo, op_hi), n in sorted(choices.items(), reverse=True):
        cur = dataclasses.replace(cur, ops=tuple(ops))
        ops, step_parents = slice_group_ops(cur, op_lo, op_hi, n)
        parents = [parents[p] for p in step_parents]
    return finalize(program, ops), tuple(parents)
