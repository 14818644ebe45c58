"""Static ring-safety verifier — proves clobber-freedom without executing.

``verify_program`` is an abstract interpreter over a
:class:`~repro_torch.core.program.PoolProgram` and the SAME
:mod:`repro_torch.core.rowsched` row schedules the sim oracle replays.
Its abstract state is a set of **live records** — one per resident
tensor, each a contiguous modular run of pool segments
(``repro_torch.analysis.intervals``).  Per op it checks, symbolically
and per step, exactly the three ways ``run_program_sim`` can raise
:class:`PoolClobberError`:

  * a read that misses its tensor (broken chain pointer, dead record,
    branch/residual alias to a tensor that is not live) — ``VMCU2xx``,
  * a write that lands on a live segment of another tensor (the solved
    offset is too small, the output wraps the ring onto itself, a held
    residual source is overrun) — ``VMCU1xx`` with the exact first
    clobbered byte and step,
  * the final outputs failing to survive the ring.

Streaming programs (``repro_torch.stream``) add a fourth lifetime class:
persistent state regions (``conv_stream`` windows, ``gru_cell`` hidden
vectors) that live across invocations.  They are registered as live
records up front and NEVER freed, so the same write sweeps prove frame
traffic can never touch them — ``VMCU211``/``VMCU212``/``VMCU213`` —
and one verified step certifies an unbounded step horizon (see
``stream_horizon`` in the stats).

Soundness against the byte oracle (DESIGN.md §11): for the monotone
schedules the planner emits, the live part of the tensor being streamed
over is always a contiguous suffix ``[needed_min(t+1), in_rows)`` at
write time, frees can never be the oracle's *first* error (a clobbering
write or a failed read always precedes), and every read/aux/other-record
hazard reduces to a congruence or modular-interval question answered
exactly.  When a program falls outside that proof fragment (plan-only
kinds, non-monotone schedules, producer/consumer geometry divergence)
the verifier returns ``safe=None`` with a ``VMCU105`` diagnostic and the
caller falls back to the sim oracle — it never guesses.

When the proof succeeds the result carries the same access statistics
the sim pool would have counted (``reads`` / ``writes`` / ``peak_live``),
so a ``certify="static"`` certificate is byte-identical to the replayed
one.  Row schedules and their derived frontiers are memoized per op
*geometry* (nets repeat module shapes heavily), which is what makes the
static path O(ops) in practice where the replay is O(rows executed).

The port's copy of :mod:`repro.analysis.verifier`, which is plain Python
and numpy: its verdicts, diagnostics, statistics and certificates are
the reference's (``tests/test_torch_verifier.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.program import EXECUTABLE_KINDS, PoolOp, PoolProgram
from ..core.rowsched import RowSchedule, schedule_for_op
from ..core.vpool import segments_for
from .intervals import first_static_clash, first_stream_clash

_ROWSCHED_KINDS = ("conv_pw", "conv_dw", "conv_k2d", "ib_fused", "add",
                   "pool_avg", "conv_stream", "gru_cell")

#: Streaming op kinds whose ``state_ptr``/``state_segments`` region holds
#: persistent cross-invocation state (the fourth lifetime class).
_STREAM_KINDS = ("conv_stream", "gru_cell")

#: Stable diagnostic codes (DESIGN.md §11 carries the full table).
CODES = {
    "VMCU101": "write clobbers the op's own streaming input "
               "(solved offset too small)",
    "VMCU102": "write clobbers a live segment of another tensor "
               "(held input / residual source / survivor)",
    "VMCU103": "tensor wraps the ring onto itself "
               "(span exceeds n_segments)",
    "VMCU104": "final outputs do not survive the ring",
    "VMCU105": "static proof unavailable for this program "
               "(fall back to the sim oracle)",
    "VMCU201": "chained input pointer does not reach the producer's "
               "live record",
    "VMCU202": "input tensor is not live "
               "(freed too early, or a bad branch/hold index)",
    "VMCU203": "residual pointer does not reach the residual source's "
               "live record",
    "VMCU204": "residual source tensor is not live",
    "VMCU211": "persistent stream state clobbered by frame traffic "
               "(staged input or an op's output overwrites live state)",
    "VMCU212": "stream state extent wrong — the step cannot write the "
               "full state back",
    "VMCU213": "stale-state read (state region wraps the ring or "
               "overlaps another op's state)",
    "VMCU301": "pool exceeds the target's SRAM budget",
    "VMCU302": "parameter payload exceeds the target's flash budget",
    "VMCU303": "SRAM overflow resolvable by partial execution "
               "(re-compile with partial='auto')",
    "VMCU401": "program elem_bytes inconsistent with its dtype",
    "VMCU402": "op segment_bytes inconsistent with the program geometry",
    "VMCU403": "artifact certificate does not match the program "
               "(stale or tampered plan)",
    "VMCU404": "artifact quantization payload inconsistent with the "
               "program dtype",
    "VMCU501": "emitted C unit diverges from the plan's ring geometry",
    "VMCU502": "emitted C unit missing for a planned op",
    "VMCU503": "emitted C unit does not correspond to any planned op",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One structured finding, with a stable ``VMCUxxx`` code."""

    code: str
    message: str
    severity: str = "error"          # "error" | "warning"
    op_index: int | None = None
    step: int | None = None
    segment: int | None = None       # pool slot (mod n_segments)
    byte: int | None = None          # first affected pool byte

    def __str__(self) -> str:
        loc = []
        if self.op_index is not None:
            loc.append(f"op {self.op_index}")
        if self.step is not None:
            loc.append(f"step {self.step}")
        if self.segment is not None:
            loc.append(f"slot {self.segment}")
        if self.byte is not None:
            loc.append(f"byte {self.byte}")
        where = f" [{', '.join(loc)}]" if loc else ""
        return f"{self.code}{where}: {self.message}"


@dataclasses.dataclass
class VerifyResult:
    """Outcome of :func:`verify_program`.

    ``safe`` is ``True`` (proven clobber-free), ``False`` (a concrete
    first clobber/read failure was derived) or ``None`` (the program is
    outside the decidable fragment — fall back to the sim oracle).
    ``stats`` mirrors the sim pool counters exactly when ``safe``."""

    safe: bool | None
    diagnostics: list[Diagnostic]
    stats: dict | None = None

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    def certificate(self, program_sha256: str | None = None) -> dict:
        """The machine-checkable safety certificate (requires safe)."""
        if not self.safe or self.stats is None:
            raise ValueError("no certificate: program not proven safe")
        cert = {"clobbers": 0, **self.stats}
        if program_sha256 is not None:
            cert["program_sha256"] = program_sha256
        return cert


@dataclasses.dataclass
class _Record:
    """A live tensor: segments ``(base + s) % n`` for ``s in [0, length)``,
    tagged with the sim's ownership id (input tensor of op ``rid``)."""

    rid: int
    base: int
    length: int


@dataclasses.dataclass(frozen=True)
class _SchedInfo:
    """A row schedule plus every derived frontier the verifier needs,
    memoized per op *geometry* (nets repeat module shapes heavily)."""

    sched: RowSchedule
    monotone_error: str | None
    in_tot: int
    out_tot: int
    t_read: int                 # step of the first input read
    t_aux: int                  # step of the first aux read (aux only)
    aux_tot: int                # 0 when the schedule has no aux reads
    n_read_events: int
    n_aux_events: int
    we: np.ndarray              # cumulative output segs after step t
    lo: np.ndarray              # first live input seg at step t's writes
    aux_lo: np.ndarray | None   # same for the residual source
    # max over write steps of (we - lo - aux_freed) / (we - aux_freed):
    # peak_live contribution of the op on top of the resident records.
    stream_peak: int
    stream_peak_hold: int
    # max over write steps of (we - lo) / (we - aux_lo): the O(1)
    # no-wrap safety precheck (delta >= stream_max => no j=0 clash).
    stream_max: int
    aux_stream_max: int


def _flatten(rows_per_step: tuple[tuple[int, ...], ...],
             steps: int) -> tuple[np.ndarray, np.ndarray]:
    """One pass over a per-step row list: (flat row indices, per-step
    counts)."""
    cnt = np.fromiter((len(rows) for rows in rows_per_step),
                      dtype=np.int64, count=steps)
    flat = np.fromiter((r for rows in rows_per_step for r in rows),
                       dtype=np.int64, count=int(cnt.sum()))
    return flat, cnt


def _is_sweep(flat: np.ndarray, rows: int) -> bool:
    """Is ``flat`` exactly ``0, 1, ..., rows-1`` (the in-order sweep)?"""
    return len(flat) == rows and (np.array_equal(
        flat, np.arange(rows, dtype=np.int64)) if rows else True)


def _sched_key(op: PoolOp, seg_width: int,
               m_rows: int) -> tuple:
    rows = op.rows_in or m_rows
    return (op.kind, rows, op.h_in, op.h_out, op.w_in, op.w_out,
            op.d_in, op.d_out, op.stride, op.rs, op.padding,
            op.resample, op.residual, op.hop, seg_width)


_SCHED_CACHE: dict[tuple, _SchedInfo] = {}


def _inconclusive_info(sched: RowSchedule, err: str) -> _SchedInfo:
    empty = np.zeros(0, dtype=np.int64)
    return _SchedInfo(
        sched=sched, monotone_error=err, in_tot=0, out_tot=0, t_read=0,
        t_aux=0, aux_tot=0, n_read_events=0, n_aux_events=0, we=empty,
        lo=empty, aux_lo=None, stream_peak=0, stream_peak_hold=0,
        stream_max=0, aux_stream_max=0)


def _window(rows: tuple[int, ...]) -> tuple[int, int] | None:
    """``(start, end)`` if ``rows`` is a strictly-increasing contiguous
    window, else ``None``.  Single rows are the overwhelmingly common
    case; multi-row windows are the k x k halos."""
    k = len(rows)
    if k == 1:
        return rows[0], rows[0]
    if rows[-1] - rows[0] + 1 != k:
        return None
    prev = rows[0]
    for r in rows[1:]:
        if r != prev + 1:
            return None
        prev = r
    return rows[0], rows[-1]


def _sched_info_build(op: PoolOp, seg_width: int,
                      m_rows: int) -> _SchedInfo:
    """Fast path: all builders emit contiguous monotone read windows and
    in-order write sweeps, so the decidable-fragment check and every
    frontier reduce to O(steps) scans with no per-event work.  Any
    schedule outside that shape falls back to the event-exact
    :func:`_sched_info_build_generic` (the two are pinned equal by
    ``tests/test_torch_verifier.py``)."""
    sched = schedule_for_op(op, seg_width, m_rows=m_rows)
    steps = sched.steps
    ic, oc = sched.in_chunk, sched.out_chunk
    in_tot = sched.in_rows * ic
    out_tot = sched.out_rows * oc

    w_steps = sched.writes
    r_steps = sched.reads
    a_steps = sched.aux_reads
    have_aux = a_steps is not None and any(a_steps)
    aux_chunk = sched.aux_chunk

    # forward pass: writes must be the exact in-order row sweep, reads
    # contiguous windows with monotone starts AND ends (then a freed row
    # can never be re-read and the live input is always a contiguous
    # suffix — the decidable fragment), aux reads an in-order sweep.
    we_list = [0] * steps
    starts = [-1] * steps          # -1: no read at this step
    a_freed = [0] * steps
    n_read_events = n_aux = 0
    t_read = t_aux = -1
    pos = apos = 0
    prev_s = prev_e = -1
    for t in range(steps):
        rows = w_steps[t]
        if rows:
            if len(rows) == 1:
                s = e = rows[0]
            else:
                w = _window(rows)
                if w is None:
                    return _sched_info_build_generic(sched)
                s, e = w
            if s != pos:
                return _sched_info_build_generic(sched)
            pos = e + 1
        we_list[t] = pos
        rows = r_steps[t]
        if rows:
            if len(rows) == 1:
                s = e = rows[0]
            else:
                w = _window(rows)
                if w is None:
                    return _sched_info_build_generic(sched)
                s, e = w
            if s < prev_s or e < prev_e:
                return _sched_info_build_generic(sched)
            prev_s, prev_e = s, e
            starts[t] = s
            n_read_events += len(rows)
            if t_read < 0:
                t_read = t
        if have_aux:
            rows = a_steps[t]
            if rows:
                if len(rows) == 1:
                    s = e = rows[0]
                else:
                    w = _window(rows)
                    if w is None:
                        return _sched_info_build_generic(sched)
                    s, e = w
                if s != apos:
                    return _sched_info_build_generic(sched)
                apos = e + 1
                n_aux += len(rows)
                if t_aux < 0:
                    t_aux = t
            a_freed[t] = apos * aux_chunk
    if pos != sched.out_rows:
        return _sched_info_build_generic(sched)
    if have_aux and apos != sched.aux_rows:
        return _sched_info_build_generic(sched)

    # backward pass: lo[t] = (lowest row still read strictly after step
    # t) * ic — with monotone window starts that is simply the NEXT
    # reading step's start — fused with the stream peak maxima (which
    # can be negative when frees outrun writes, hence the None floor).
    nxt = sched.in_rows            # clamped +inf: everything is freed
    lo = [0] * steps
    peak = peak_hold = stream_max = None
    for t in range(steps - 1, -1, -1):
        lo_t = nxt * ic
        lo[t] = lo_t
        s0 = starts[t]
        if s0 >= 0:
            nxt = s0
        w = we_list[t] * oc
        if w > (we_list[t - 1] * oc if t else 0):   # a step that writes
            s_hold = w - a_freed[t]
            if peak_hold is None or s_hold > peak_hold:
                peak_hold = s_hold
            s = s_hold - lo_t
            if peak is None or s > peak:
                peak = s
            sm = w - lo_t
            if stream_max is None or sm > stream_max:
                stream_max = sm
    if peak is None:
        peak = peak_hold = stream_max = 0

    aux_lo = None
    aux_tot = 0
    if have_aux:
        aux_tot = sched.aux_rows * aux_chunk
        aux_lo = np.asarray(a_freed, dtype=np.int64)

    return _SchedInfo(
        sched=sched, monotone_error=None, in_tot=in_tot, out_tot=out_tot,
        t_read=max(t_read, 0), t_aux=max(t_aux, 0), aux_tot=aux_tot,
        n_read_events=n_read_events, n_aux_events=n_aux,
        we=np.asarray(we_list, dtype=np.int64) * oc,
        lo=np.asarray(lo, dtype=np.int64), aux_lo=aux_lo,
        stream_peak=peak, stream_peak_hold=peak_hold,
        stream_max=stream_max, aux_stream_max=peak_hold)


def _sched_info_build_generic(sched: RowSchedule) -> _SchedInfo:
    """Event-exact fallback: derives the same frontiers from the flat
    read/write event streams, for schedules outside the contiguous-
    window shape the fast path handles."""
    steps = sched.steps
    ic, oc = sched.in_chunk, sched.out_chunk
    in_tot = sched.in_rows * ic
    out_tot = sched.out_rows * oc

    # Decidable-fragment gate first (see _SchedInfo / DESIGN.md §11):
    # writes must be the in-order row sweep, reads must never resurrect
    # a freed row, aux reads must sweep once in order.  Everything else
    # below RELIES on these facts (e.g. we = cumsum of write counts).
    flat_w, w_cnt = _flatten(sched.writes, steps)
    if not _is_sweep(flat_w, sched.out_rows):
        return _inconclusive_info(
            sched, "writes are not the in-order row sweep")
    flat_r, r_cnt = _flatten(sched.reads, steps)
    lr = np.full(sched.in_rows, -1, dtype=np.int64)
    if len(flat_r):
        np.maximum.at(lr, flat_r,
                      np.repeat(np.arange(steps, dtype=np.int64), r_cnt))
    nm = sched.needed_min(lr)
    rows = np.nonzero(lr >= 0)[0]
    if rows.size and not (nm[lr[rows] + 1] > rows).all():
        return _inconclusive_info(
            sched, "read frontier is not monotone (freed rows re-read)")

    we = np.cumsum(w_cnt) * oc          # exact: writes are the sweep
    lo = np.minimum(nm[1:], sched.in_rows) * ic
    aux_lo = None
    aux_tot = n_aux = 0
    t_aux = 0
    if sched.aux_reads is not None and any(sched.aux_reads):
        flat_a, a_cnt = _flatten(sched.aux_reads, steps)
        if not _is_sweep(flat_a, sched.aux_rows):
            return _inconclusive_info(
                sched, "aux reads are not the in-order row sweep")
        t_aux = int(np.argmax(a_cnt > 0))
        aux_tot = sched.aux_rows * sched.aux_chunk
        n_aux = len(flat_a)
        aux_lo = np.cumsum(a_cnt) * sched.aux_chunk
    has_write = w_cnt > 0
    a_freed = aux_lo if aux_lo is not None else 0
    stream = we - lo - a_freed
    stream_hold = we - a_freed
    any_write = bool(has_write.any())
    peak = int(stream[has_write].max()) if any_write else 0
    peak_hold = int(stream_hold[has_write].max()) if any_write else 0
    stream_max = int((we - lo)[has_write].max()) if any_write else 0
    return _SchedInfo(
        sched=sched, monotone_error=None, in_tot=in_tot, out_tot=out_tot,
        t_read=int(np.argmax(r_cnt > 0)) if len(flat_r) else 0,
        t_aux=t_aux, aux_tot=aux_tot, n_read_events=len(flat_r),
        n_aux_events=n_aux, we=we, lo=lo, aux_lo=aux_lo,
        stream_peak=peak, stream_peak_hold=peak_hold,
        stream_max=stream_max, aux_stream_max=peak_hold)


def _sched_info(op: PoolOp, seg_width: int, m_rows: int) -> _SchedInfo:
    key = _sched_key(op, seg_width, m_rows)
    info = _SCHED_CACHE.get(key)
    if info is None:
        if len(_SCHED_CACHE) >= 4096:       # unbounded-growth backstop
            _SCHED_CACHE.clear()
        info = _SCHED_CACHE[key] = _sched_info_build(op, seg_width,
                                                     m_rows)
    return info


def _inconclusive(reason: str, op_index: int | None = None
                  ) -> VerifyResult:
    return VerifyResult(safe=None, diagnostics=[Diagnostic(
        "VMCU105", reason + " — fall back to certify='sim'",
        severity="warning", op_index=op_index)])


def verify_program(program: PoolProgram) -> VerifyResult:
    """Statically prove (or refute) that ``program`` replays through the
    :class:`~repro_torch.core.pool.SegmentPool` clobber oracle without error.

    Agreement contract: whenever the result is ``safe=True`` /
    ``safe=False`` it matches the sim oracle's verdict on the same
    program, and on ``safe=True`` the ``stats`` equal the sim pool's
    counters (``tests/test_torch_verifier.py`` pins both against the
    reference's verifier, on every mutant of the zoo's plans)."""
    n = program.n_segments
    if n <= 0:
        return _inconclusive(f"invalid pool size n_segments={n}")
    if not program.ops:
        return _inconclusive("empty program")
    for i, op in enumerate(program.ops):
        if op.kind not in EXECUTABLE_KINDS:
            return _inconclusive(
                f"plan-only op kind {op.kind!r} has no executable "
                "schedule", op_index=i)

    seg_bytes = program.seg_width * program.elem_bytes
    first = program.ops[0]

    # -- staging: the net input tensor becomes record 0 ------------------
    if first.in_segments > n:
        d = Diagnostic(
            "VMCU103",
            f"staged input ({first.in_segments} segments) wraps the "
            f"{n}-segment ring onto itself; first self-clobber at "
            f"segment {n}",
            op_index=0, step=0,
            segment=(first.in_ptr + n) % n,
            byte=((first.in_ptr + n) % n) * seg_bytes)
        return VerifyResult(safe=False, diagnostics=[d])
    records: dict[int, _Record] = {
        0: _Record(0, first.in_ptr, first.in_segments)}
    peak = first.in_segments
    reads_total = 0
    writes_total = first.in_segments

    # -- persistent stream state: pre-registered live records -------------
    # State regions (repro_torch.stream) outlive every frame tensor: the
    # sim pre-writes them under ("state", i, j) owners before staging, so the
    # verifier registers them as live records that are NEVER freed — the
    # static-clash sweep (f) below then proves every frame write misses
    # them, which is exactly the VMCU211 obligation.  Records get rid
    # -(100 + i) so they can never collide with tensor ids (>= 0).
    state_rids: list[int] = []
    state_total = 0
    for i, op in enumerate(program.ops):
        if not op.state_segments:
            continue
        if op.kind not in _STREAM_KINDS:
            return _inconclusive(
                f"op kind {op.kind!r} carries state_segments but has no "
                "streaming semantics", op_index=i)
        expect = (op.h_in * op.w_in
                  * segments_for(op.d_in, program.seg_width)
                  if op.kind == "conv_stream"
                  else segments_for(op.d_out, program.seg_width))
        if op.state_segments != expect:
            d = Diagnostic(
                "VMCU212",
                f"{op.kind} op {i} carries {op.state_segments} state "
                f"segments but its geometry needs {expect} — the step "
                "cannot write the full state back",
                op_index=i)
            return VerifyResult(safe=False, diagnostics=[d])
        base = op.state_ptr % n
        if base + op.state_segments > n:
            d = Diagnostic(
                "VMCU213",
                f"{op.kind} op {i} state wraps the ring (base {base} + "
                f"{op.state_segments} segments > n={n}); the next step "
                "would read re-staged frame bytes as state",
                op_index=i, segment=base, byte=base * seg_bytes)
            return VerifyResult(safe=False, diagnostics=[d])
        for rid in state_rids:
            other = records[rid]
            clash = first_static_clash(
                op.state_segments, other.length,
                (other.base - op.state_ptr) % n, n)
            if clash is not None:
                slot = (op.state_ptr + clash[0]) % n
                d = Diagnostic(
                    "VMCU213",
                    f"state of op {i} overlaps state of op "
                    f"{-(rid + 100)} at pool slot {slot} — each step "
                    "reads the other's bytes as its own stale state",
                    op_index=i, segment=slot, byte=slot * seg_bytes)
                return VerifyResult(safe=False, diagnostics=[d])
        rid = -(100 + i)
        records[rid] = _Record(rid, op.state_ptr, op.state_segments)
        state_rids.append(rid)
        state_total += op.state_segments
    if state_total:
        for rid in state_rids:   # staging must not overwrite live state
            other = records[rid]
            clash = first_static_clash(
                first.in_segments, other.length,
                (other.base - first.in_ptr) % n, n)
            if clash is not None:
                slot = (first.in_ptr + clash[0]) % n
                d = Diagnostic(
                    "VMCU211",
                    f"staged frame input clobbers live stream state of "
                    f"op {-(rid + 100)} at pool slot {slot}",
                    op_index=0, step=0, segment=slot,
                    byte=slot * seg_bytes)
                return VerifyResult(safe=False, diagnostics=[d])
        peak += state_total
        writes_total += state_total

    for i, op in enumerate(program.ops):
        info = _sched_info(op, program.seg_width, program.m_rows)
        if info.monotone_error is not None:
            return _inconclusive(f"{op.kind} schedule: "
                                 f"{info.monotone_error}", op_index=i)
        sched = info.sched
        oc = sched.out_chunk
        in_tot, out_tot = info.in_tot, info.out_tot
        iown = op.in_op if (op.in_op >= 0 and op.kind in _ROWSCHED_KINDS) \
            else i

        # sliced ops (partial execution) read a row WINDOW of a longer held
        # source record; the proof treats the whole record as static,
        # which requires the op to hold it and the window to fit.
        src_tot = op.h_src * sched.in_chunk if op.h_src else in_tot
        if op.h_src:
            if not op.hold_input:
                return _inconclusive(
                    f"op {i} windows its source (h_src={op.h_src}) "
                    "without holding it", op_index=i)
            if (op.in_row0 + sched.in_rows) * sched.in_chunk > src_tot:
                return _inconclusive(
                    f"op {i} reads rows [{op.in_row0}, "
                    f"{op.in_row0 + sched.in_rows}) beyond its "
                    f"{op.h_src}-row source", op_index=i)

        # candidate first errors within this op: key (step, phase, seg)
        # with phases read=0, aux=1, write=3 — the sim's in-step order.
        candidates: list[tuple[tuple[int, int, int], Diagnostic]] = []

        rec = records.get(iown)
        if rec is None:
            candidates.append(((info.t_read, 0, 0), Diagnostic(
                "VMCU202",
                f"{op.kind} op {i} reads tensor {iown} which is not "
                "live (freed by an earlier consumer, or in_op/hold_input "
                "is wrong)", op_index=i, step=info.t_read)))
        elif (rec.base - op.in_ptr) % n != 0:
            candidates.append(((info.t_read, 0, 0), Diagnostic(
                "VMCU201",
                f"{op.kind} op {i} reads its input at segment "
                f"{op.in_ptr} but tensor {iown} is live at segment "
                f"{rec.base} (offset {(rec.base - op.in_ptr) % n} mod "
                f"{n})", op_index=i, step=info.t_read,
                segment=op.in_ptr % n, byte=(op.in_ptr % n) * seg_bytes)))
        elif rec.length != src_tot:
            return _inconclusive(
                f"{op.kind} op {i} expects {src_tot} input segments but "
                f"tensor {iown} is live with {rec.length}", op_index=i)

        aux_rec = None
        if info.aux_tot:
            if op.aux_op == iown:
                return _inconclusive(
                    f"op {i} aliases its residual source to its own "
                    "input tensor", op_index=i)
            aux_rec = records.get(op.aux_op)
            if aux_rec is None:
                candidates.append(((info.t_aux, 1, 0), Diagnostic(
                    "VMCU204",
                    f"{op.kind} op {i} reads residual tensor "
                    f"{op.aux_op} which is not live", op_index=i,
                    step=info.t_aux)))
            elif (aux_rec.base - op.aux_ptr) % n != 0:
                candidates.append(((info.t_aux, 1, 0), Diagnostic(
                    "VMCU203",
                    f"{op.kind} op {i} reads its residual at segment "
                    f"{op.aux_ptr} but tensor {op.aux_op} is live at "
                    f"segment {aux_rec.base}", op_index=i,
                    step=info.t_aux, segment=op.aux_ptr % n,
                    byte=(op.aux_ptr % n) * seg_bytes)))
            elif aux_rec.length != info.aux_tot:
                return _inconclusive(
                    f"op {i} expects {info.aux_tot} residual segments "
                    f"but tensor {op.aux_op} is live with "
                    f"{aux_rec.length}", op_index=i)

        def _write_diag(code: str, w: int, victim_rid: int,
                        victim_seg: int, step: int | None = None
                        ) -> tuple[tuple[int, int, int], Diagnostic]:
            if step is None:
                ev_t = [t for t, rows in enumerate(sched.writes)
                        for _ in rows]
                step = ev_t[min(w // oc, len(ev_t) - 1)]
            slot = (op.out_ptr + w) % n
            victim = (f"stream state of op {-(victim_rid + 100)}"
                      if victim_rid < 0 else f"tensor {victim_rid}")
            return ((step, 3, w), Diagnostic(
                code,
                f"{op.kind} op {i} writes output segment {w} over live "
                f"segment {victim_seg} of {victim} at pool "
                f"slot {slot}", op_index=i, step=step, segment=slot,
                byte=slot * seg_bytes))

        # (c) the output wrapping the ring onto itself
        if out_tot > n:
            candidates.append(_write_diag("VMCU103", n, i + 1, 0))

        # (d) writes vs the shrinking live suffix of the streamed input
        if rec is not None and not any(k[1] == 0 for k, _ in candidates):
            delta = (rec.base - op.out_ptr) % n
            if op.hold_input:
                clash = first_static_clash(out_tot, rec.length, delta, n)
                if clash is not None:
                    candidates.append(_write_diag(
                        "VMCU102", clash[0], iown, clash[1]))
            elif (delta < info.stream_max or delta + in_tot > n
                  or out_tot > n):
                # O(1) precheck failed — run the exact modular scan
                clash3 = first_stream_clash(info.we, info.lo, in_tot,
                                            delta, n)
                if clash3 is not None:
                    t, w, r = clash3
                    candidates.append(_write_diag(
                        "VMCU101", w, iown, r, step=t))

        # (e) writes vs the shrinking residual source
        if aux_rec is not None and not any(
                k[1] == 1 for k, _ in candidates):
            a_delta = (aux_rec.base - op.out_ptr) % n
            if (a_delta < info.aux_stream_max
                    or a_delta + info.aux_tot > n or out_tot > n):
                clash3 = first_stream_clash(
                    info.we, info.aux_lo, info.aux_tot, a_delta, n)
                if clash3 is not None:
                    t, w, r = clash3
                    candidates.append(_write_diag(
                        "VMCU102", w, op.aux_op, r, step=t))

        # (f) writes vs every other live tensor (constant intervals)
        for rid, other in records.items():
            if rid == iown or (aux_rec is not None and rid == op.aux_op):
                continue
            clash = first_static_clash(
                out_tot, other.length, (other.base - op.out_ptr) % n, n)
            if clash is not None:
                candidates.append(_write_diag(
                    "VMCU211" if rid < 0 else "VMCU102",
                    clash[0], rid, clash[1]))

        if candidates:
            _, diag = min(candidates, key=lambda c: c[0])
            return VerifyResult(safe=False, diagnostics=[diag])

        # -- clean: update exact sim-pool statistics ----------------------
        reads_total += info.n_read_events * sched.in_chunk \
            + info.n_aux_events * sched.aux_chunk
        writes_total += out_tot
        if op.state_segments:
            # whole-state read then same-owner whole-state rewrite (the
            # window shift / hidden-state update) — mirrors _sim_stream_op
            reads_total += op.state_segments
            writes_total += op.state_segments
        live_before = sum(r.length for r in records.values())
        stream = info.stream_peak_hold if op.hold_input \
            else info.stream_peak
        peak = max(peak, live_before + stream)

        # -- records after the op -----------------------------------------
        if not op.hold_input or op.free_src:
            records.pop(iown, None)
        if aux_rec is not None:
            records.pop(op.aux_op, None)
        if op.out_op >= 0:
            # deferred-owner write (partial execution): this op contributes a
            # row band of the SHARED tensor consumed by op out_op — the
            # record grows contiguously slice by slice.
            dst = records.get(op.out_op)
            if dst is None:
                if op.out_row0:
                    return _inconclusive(
                        f"op {i} writes rows at offset {op.out_row0} of "
                        f"tensor {op.out_op} before its first rows exist",
                        op_index=i)
                records[op.out_op] = _Record(op.out_op, op.out_ptr,
                                             out_tot)
            elif (op.out_row0 * oc != dst.length
                  or (op.out_ptr - dst.base) % n != dst.length):
                return _inconclusive(
                    f"op {i} extends tensor {op.out_op} non-contiguously "
                    f"(record length {dst.length}, write row offset "
                    f"{op.out_row0})", op_index=i)
            else:
                dst.length += out_tot
        else:
            records[i + 1] = _Record(i + 1, op.out_ptr, out_tot)

    # -- the final outputs must survive the ring --------------------------
    last = program.ops[-1]
    final = records.get(len(program.ops))
    if final is None:
        return _inconclusive("last op defers its output to a consumer "
                             "beyond the program",
                             op_index=len(program.ops) - 1)
    if last.out_segments > final.length:
        d = Diagnostic(
            "VMCU104",
            f"program promises {last.out_segments} output segments but "
            f"only {final.length} were produced",
            op_index=len(program.ops) - 1)
        return VerifyResult(safe=False, diagnostics=[d])
    reads_total += last.out_segments
    if state_total:
        reads_total += state_total   # ...and so must persistent state

    stats = {"peak_live": peak, "reads": reads_total,
             "writes": writes_total, "n_segments": n}
    if state_total:
        # Multi-step horizon: one verified step plus the invariant that
        # the only records alive at end-of-step are the state regions and
        # the final output (which the stream session frees after fetching
        # it) means step k+1 starts from the SAME abstract state as step
        # k — the per-step proof lifts to an unbounded horizon.
        stats["n_states"] = len(state_rids)
        stats["state_segments"] = state_total
        leftover = set(records) - {len(program.ops)} - set(state_rids)
        stats["stream_horizon"] = "unbounded" if not leftover else 1
    return VerifyResult(safe=True, diagnostics=[], stats=stats)
