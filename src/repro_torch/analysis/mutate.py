"""Plan mutators — adversarial inputs for the differential fault-
injection tests.

Each mutation corrupts ONE solved quantity of a clobber-free
:class:`~repro_torch.core.program.PoolProgram` the way a planner bug, a stale
artifact, or a hand-edited plan would: a stream offset nudged, a hold
flag flipped, the ring shrunk, a dtype/delta field rewritten.  The
differential property then asserts that
:func:`repro_torch.analysis.verify_program` and the sim clobber-oracle return
the SAME verdict on every mutant — no false-safe, no false-unsafe.

The enumeration is deterministic (no RNG) so the ≥200-plan matrix is
reproducible; hypothesis layers extra randomized shifts on top when
installed.

The port's copy of :mod:`repro.analysis.mutate`: the same tags and the
same corrupted programs, in the same order
(``tests/test_torch_verifier.py``).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Iterator

from ..core.program import PoolProgram

#: offset nudges applied to in/out/aux pointers (n/2 and n added per-plan)
_SHIFTS = (1, -1, 2, 7)


def _with_op(program: PoolProgram, i: int, **changes) -> PoolProgram:
    ops = list(program.ops)
    ops[i] = dataclasses.replace(ops[i], **changes)
    return dataclasses.replace(program, ops=tuple(ops))


@dataclasses.dataclass(frozen=True)
class Mutation:
    """One corrupted plan plus a human-readable provenance tag."""

    tag: str
    program: PoolProgram


def mutations(program: PoolProgram, *, ops_stride: int = 1
              ) -> Iterator[Mutation]:
    """Deterministically enumerate corrupted variants of ``program``.

    ``ops_stride`` subsamples the op axis (every op is O(ops) mutants —
    stride keeps the matrix affordable on deep nets).  Covers: solved
    in/out/aux segment offsets (±small, ±n/2, ±n), ``hold_input`` flips,
    ``in_op``/``aux_op`` chain rewires, ring size changes, and the
    verdict-inert fields (``delta``, dtype) the verifier must NOT judge
    by."""
    n = program.n_segments
    shifts = _SHIFTS + (n // 2, n) if n > 4 else _SHIFTS
    for i in range(0, len(program.ops), max(1, ops_stride)):
        op = program.ops[i]
        for s in shifts:
            if s == 0:
                continue
            yield Mutation(f"op{i}.in_ptr{s:+d}",
                           _with_op(program, i, in_ptr=op.in_ptr + s))
            yield Mutation(f"op{i}.out_ptr{s:+d}",
                           _with_op(program, i, out_ptr=op.out_ptr + s))
            if op.aux_op >= 0:
                yield Mutation(
                    f"op{i}.aux_ptr{s:+d}",
                    _with_op(program, i, aux_ptr=op.aux_ptr + s))
        yield Mutation(f"op{i}.hold_input={not op.hold_input}",
                       _with_op(program, i,
                                hold_input=not op.hold_input))
        if op.in_op >= 0:
            yield Mutation(f"op{i}.in_op={op.in_op - 1}",
                           _with_op(program, i, in_op=op.in_op - 1))
        # verdict-inert corruption: delta is documentation of the solved
        # offset, not an input to execution — flipping it must not flip
        # the verdict (the sim never reads it; nor may the verifier).
        yield Mutation(f"op{i}.delta{+3:+d}",
                       _with_op(program, i, delta=op.delta + 3))
    for dn in (-1, -2, -(n // 2)):
        if n + dn >= 1:
            yield Mutation(
                f"n_segments{dn:+d}",
                dataclasses.replace(program, n_segments=n + dn))
    yield Mutation("n_segments+1",
                   dataclasses.replace(program, n_segments=n + 1))


def break_plan(program: PoolProgram) -> Mutation:
    """One canonical deliberately-broken plan (for docs / --smoke): nudge
    an op's solved output offset until the verifier derives a clobber —
    the exact failure the Eq. (1)/(2) offsets exist to prevent."""
    from .verifier import verify_program

    for i, op in enumerate(program.ops):
        for s in (1, -1, 2):
            broken = _with_op(program, i, out_ptr=op.out_ptr + s)
            if verify_program(broken).safe is False:
                return Mutation(f"op{i}.out_ptr{s:+d}", broken)
    # tight plans always break above; a fully-slack plan still breaks
    # when the ring shrinks below its peak footprint
    m = dataclasses.replace(program,
                            n_segments=max(1, program.n_segments // 2))
    return Mutation(f"n_segments={m.n_segments}", m)


__all__ = ["Mutation", "mutations", "break_plan"]
