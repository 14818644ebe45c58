"""PoolProgram — the plan-program IR over one VirtualPool, and its
planner.

Counterpart of :mod:`repro.core.program`.  A program is an ordered list
of :class:`PoolOp` steps, each carrying its solved Eq.-(1)/(2) geometry
``(in_ptr, out_ptr, delta, segment_bytes)``; the executors in
:mod:`repro_torch.core.executors` run it.  :func:`plan_program` is the
single planning front-end (a copy of the reference's, in plain Python):
it solves every offset from the row schedules of
:mod:`repro_torch.core.rowsched`, so a program the port plans is the
reference's, field for field.

The dataclass fields, their order and their defaults are those of the
reference, so :meth:`PoolProgram.to_json_dict` gives the same dict and
``program_sha256`` the same hash.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Union

import torch

from .planner import gemm_offset_closed_form
from .vpool import PoolSpec, SEG_WIDTH, ceil_div, segments_for

EXECUTABLE_KINDS = ("gemm", "fused_mlp", "elementwise", "conv_pw",
                    "conv_dw", "conv_k2d", "ib_fused", "add", "pool_avg",
                    "conv_stream", "gru_cell")
PLAN_ONLY_KINDS = ("fused_chain", "inverted_bottleneck")

# Pool element dtypes a program can be planned for, with the itemsize
# every ``segment_bytes`` derivation uses.  ``"int8"`` selects quantized
# execution; ``"byte"`` is the accounting-only 1-byte label.
DTYPE_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
                  "byte": 1}

# Representative dtype per element width, for callers that pass only
# ``elem_bytes``.  Deliberately not "int8" for width 1: quantized
# execution is opted into with dtype="int8", never inferred.
_DTYPE_FOR_BYTES = {4: "float32", 2: "bfloat16", 1: "byte"}

_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int8": torch.int8,
                "byte": torch.int8}


def dtype_itemsize(dtype: str) -> int:
    try:
        return DTYPE_ITEMSIZE[dtype]
    except KeyError:
        raise ValueError(f"unknown pool dtype {dtype!r}; known: "
                         f"{sorted(DTYPE_ITEMSIZE)}") from None


# Element-wise maps usable as fp32 epilogues.  Every fn maps 0 -> 0 so
# segment padding columns stay zero through the ring.  ``gelu`` is the
# tanh approximation, the reference's (``jax.nn.gelu``) default.
ACTIVATIONS = {
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "silu": torch.nn.functional.silu,
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "square": lambda x: x * x,
    "identity": lambda x: x,
}

#: Each activation's code in the fp32 CUDA epilogue (``ring_f32.cu``).
ACTIVATION_CODES = {"identity": 0, "relu": 1, "gelu": 2, "silu": 3,
                    "square": 4}


def resolve_activation(name: str | None):
    if name is None:
        return ACTIVATIONS["identity"]
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; "
                         f"known: {sorted(ACTIVATIONS)}") from None


# ---------------------------------------------------------------------------
# Layer specs — the vocabulary the reference planner accepts.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GemmSpec:
    """FC layer ``[M, d_in] @ [d_in, d_out] (+ bias, + activation)`` with
    weights in "Flash" (un-pooled storage), paper Fig. 4."""

    d_out: int
    activation: str | None = None


@dataclasses.dataclass(frozen=True)
class FusedMLPSpec:
    """In-place fused (gated) MLP: ``d_ff`` never materializes,
    delta == 0."""

    d_ff: int
    gated: bool = True
    residual: bool = True
    activation: str = "gelu"
    ff_tile: int = 512


@dataclasses.dataclass(frozen=True)
class ElementwiseSpec:
    """In-place element-wise map over the resident rows (delta == 0)."""

    fn: str = "gelu"


@dataclasses.dataclass(frozen=True)
class FusedChainSpec:
    """Whole-FC-chain streaming fusion (Eq. 2, byte-granular, plan-only).

    ``dims`` are the hidden dims *after* the program input dim."""

    dims: tuple[int, ...]
    rows_per_step: int = 1
    elem_bytes: int = 2


@dataclasses.dataclass(frozen=True)
class InvertedBottleneckSpec:
    """Paper Fig.-6 PW->DW->PW(->add) module (byte-granular, plan-only)."""

    cfg: object  # a module configuration record
    workspace: str = "paper_11seg"


@dataclasses.dataclass(frozen=True)
class ConvPWSpec:
    """Pointwise (1x1) conv over pixel rows: ``[H,W,c_in] -> [P,Q,c_out]``.

    ``stride`` gives the standard strided conv (source pixel ``(p*s,
    q*s)``); ``resample_to=(P, Q)`` instead maps output pixel ``(p, q)``
    to source ``((p*H)//P, (q*W)//Q)``."""

    h_in: int
    w_in: int
    c_in: int
    c_out: int
    stride: int = 1
    resample_to: tuple[int, int] | None = None
    activation: str | None = None
    input_from: int = 0

    @property
    def out_hw(self) -> tuple[int, int]:
        if self.resample_to is not None:
            return self.resample_to
        return (ceil_div(self.h_in, self.stride),
                ceil_div(self.w_in, self.stride))


@dataclasses.dataclass(frozen=True)
class ConvDWSpec:
    """Depthwise RSxRS conv ('same' padding) over pixel rows."""

    h_in: int
    w_in: int
    c: int
    rs: int = 3
    stride: int = 1
    activation: str | None = None

    @property
    def out_hw(self) -> tuple[int, int]:
        return (ceil_div(self.h_in, self.stride),
                ceil_div(self.w_in, self.stride))


@dataclasses.dataclass(frozen=True)
class ConvK2DSpec:
    """General k x k spatial conv over pixel rows:
    ``[h_in, w_in, c_in] -> [h_out, w_out, c_out]``; ``input_from=m``
    (> 0) makes it a branch conv reading the input tensor of the op
    ``m`` positions back."""

    h_in: int
    w_in: int
    c_in: int
    c_out: int
    k: int = 3
    stride: int = 1
    padding: str = "same"
    activation: str | None = None
    input_from: int = 0

    @property
    def out_hw(self) -> tuple[int, int]:
        from .rowsched import conv_k2d_out
        return (conv_k2d_out(self.h_in, self.k, self.stride, self.padding),
                conv_k2d_out(self.w_in, self.k, self.stride, self.padding))


@dataclasses.dataclass(frozen=True)
class IBModuleSpec:
    """Executable fused inverted-bottleneck module (Fig. 6,
    row-granular), stride 1."""

    cfg: object  # a module configuration record


@dataclasses.dataclass(frozen=True)
class ResidualAddSpec:
    """Add the input tensor of the op ``src`` steps back to the current
    tensor; ``activation`` applies after the sum."""

    src: int = 3
    activation: str | None = None


@dataclasses.dataclass(frozen=True)
class AvgPoolSpec:
    """Global average pool ``[H,W,c] -> [1,1,c]`` (one output row)."""

    h_in: int
    w_in: int
    c: int


@dataclasses.dataclass(frozen=True)
class ConvStreamSpec:
    """Streaming temporal k x k conv over a ring-resident sliding window
    ``[h_win, w_in, c_in]`` that persists across invocations."""

    h_win: int
    w_in: int
    c_in: int
    c_out: int
    k: int = 3
    stride: int = 1
    padding: str = "same"
    hop: int = 1
    activation: str | None = None

    @property
    def out_hw(self) -> tuple[int, int]:
        from .rowsched import conv_k2d_out
        return (conv_k2d_out(self.h_win, self.k, self.stride, self.padding),
                conv_k2d_out(self.w_in, self.k, self.stride, self.padding))


@dataclasses.dataclass(frozen=True)
class GRUCellSpec:
    """GRU recurrence step ``[1, d_in] -> [1, d_h]`` with the hidden
    state pool-resident across invocations."""

    d_h: int


LayerSpec = Union[GemmSpec, FusedMLPSpec, ElementwiseSpec, FusedChainSpec,
                  InvertedBottleneckSpec, ConvPWSpec, ConvDWSpec,
                  ConvK2DSpec, IBModuleSpec, ResidualAddSpec, AvgPoolSpec,
                  ConvStreamSpec, GRUCellSpec]


# ---------------------------------------------------------------------------
# The IR.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PoolOp:
    """One step of a PoolProgram with its solved pool geometry.

    ``in_ptr``/``out_ptr`` are physical segment offsets; ``delta`` is the
    solved Eq.-(1)/(2) optimum ``b_In - b_Out``.  For plan-only kinds all
    segment quantities are in bytes (``segment_bytes == 1``).
    """

    kind: str
    in_ptr: int
    out_ptr: int
    delta: int
    in_segments: int
    out_segments: int
    segment_bytes: int
    d_in: int = 0
    d_out: int = 0
    activation: str | None = None
    gated: bool = False
    residual: bool = False
    d_ff: int = 0
    ff_tile: int = 0
    workspace_bytes: int = 0
    # -- whole-network op geometry (conv / pool / residual kinds) ---------
    rows_in: int = 0          # rows consumed (0 -> program.m_rows)
    rows_out: int = 0         # rows produced (0 -> program.m_rows)
    h_in: int = 0             # image geometry for conv kinds
    w_in: int = 0
    h_out: int = 0
    w_out: int = 0
    stride: int = 1
    rs: int = 0               # depthwise / k2d kernel extent
    padding: str = "same"     # conv halo convention
    resample: bool = False    # nearest-grid adapter row map
    d_mid: int = 0            # fused module expansion width
    aux_ptr: int = 0          # residual-source pool offset ("add" ops)
    aux_op: int = -1          # op index whose INPUT is the residual source
    in_op: int = -1           # branch convs: op index whose (held) INPUT
                              # this op reads instead of the chained tensor
    hold_input: bool = False  # input is a residual source: op must not
                              # free it; the consuming op frees it
    # -- partial execution (spatial slicing) ------------------------------
    in_row0: int = 0          # window start row within the source tensor
    h_src: int = 0            # full source image height (0 = not windowed)
    out_op: int = -1          # deferred write owner (-1 = ordinary chain)
    out_row0: int = 0         # row offset inside that shared output tensor
    free_src: bool = False    # free the whole source record after this op
    # -- streaming state (conv_stream / gru_cell) -------------------------
    state_ptr: int = 0        # pool offset of the persistent state tensor
    state_segments: int = 0   # its segment extent (0 = stateless op)
    hop: int = 0              # conv_stream: frame rows appended per step

    @property
    def rows_src(self) -> int:
        """Row extent of the op's SOURCE tensor record — the full image
        for a windowed (sliced) read, ``rows_in`` otherwise."""
        if self.h_src:
            return self.h_src * self.w_in if self.w_in else self.h_src
        return self.rows_in

    @property
    def span_segments(self) -> int:
        """Width of the live In ∪ Out window while this op runs."""
        lo = min(self.in_ptr, self.out_ptr)
        hi = max(self.in_ptr + self.in_segments,
                 self.out_ptr + self.out_segments)
        if self.aux_op >= 0:
            lo = min(lo, self.aux_ptr)
            hi = max(hi, self.aux_ptr + self.in_segments)
        return hi - lo


def op_grid_steps(op: PoolOp, row_block: int = 1) -> int:
    """Kernel steps ``op`` executes with ``row_block`` output rows fused
    per step (``row_block == 1`` is the certified fine-grained
    schedule; a larger one is execution granularity only)."""
    if row_block < 1:
        raise ValueError("row_block must be >= 1")
    steps = op.h_out if op.h_out else (op.rows_out or 1)
    if row_block == 1:
        return steps
    if steps % row_block:
        raise ValueError(f"row_block {row_block} does not divide the "
                         f"op's {steps} steps")
    return steps // row_block


@dataclasses.dataclass(frozen=True)
class PoolProgram:
    """An ordered list of PoolOps over one VirtualPool.

    ``pool_segments``/``pool_bytes`` — tight Eq.-(1) footprint.
    ``n_segments``/``physical_pool_bytes`` — the allocated ring length
    including DMA block-alignment padding.
    """

    m_rows: int
    seg_width: int
    block_rows: int | None
    n_segments: int
    pool_segments: int
    elem_bytes: int
    ops: tuple[PoolOp, ...]
    dtype: str = "float32"    # pool element dtype (DTYPE_ITEMSIZE key)

    # -- classification ----------------------------------------------------
    @property
    def executable(self) -> bool:
        return all(op.kind in EXECUTABLE_KINDS for op in self.ops)

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"

    @property
    def aligned(self) -> bool:
        return self.block_rows is not None

    # -- footprint accounting ---------------------------------------------
    @property
    def pool_bytes(self) -> int:
        op = self.ops[0]
        if op.kind in PLAN_ONLY_KINDS:
            return (max(op.in_segments + op.delta, op.out_segments)
                    + op.workspace_bytes) * op.segment_bytes
        return self.pool_segments * self.seg_width * self.elem_bytes

    @property
    def physical_pool_bytes(self) -> int:
        if self.ops[0].kind in PLAN_ONLY_KINDS:
            return self.pool_bytes
        return self.n_segments * self.seg_width * self.elem_bytes

    @property
    def naive_bytes(self) -> int:
        """Tensor-level footprint: worst coexisting in+out(+residual)."""
        worst = max(op.in_segments + op.out_segments
                    + (op.in_segments if op.aux_op >= 0 else 0)
                    + op.state_segments
                    for op in self.ops)
        op = self.ops[0]
        if op.kind in PLAN_ONLY_KINDS:
            return worst * op.segment_bytes
        return worst * self.seg_width * self.elem_bytes

    @property
    def saving_fraction(self) -> float:
        return 1.0 - self.pool_bytes / self.naive_bytes

    # -- I/O geometry ------------------------------------------------------
    @property
    def in_dim(self) -> int:
        return self.ops[0].d_in

    @property
    def out_dim(self) -> int:
        return self.ops[-1].d_out

    @property
    def in_rows(self) -> int:
        """Rows of the program input tensor."""
        return self.ops[0].rows_src or self.m_rows

    @property
    def out_rows(self) -> int:
        """Rows of the program output tensor."""
        return self.ops[-1].rows_out or self.m_rows

    @property
    def input_ptr(self) -> int:
        return self.ops[0].in_ptr

    @property
    def output_ptr(self) -> int:
        return self.ops[-1].out_ptr

    def spec(self, dtype: torch.dtype | None = None) -> PoolSpec:
        return PoolSpec(self.n_segments, self.seg_width,
                        _TORCH_DTYPE[self.dtype] if dtype is None else dtype)

    def with_dtype(self, dtype: str) -> "PoolProgram":
        """The SAME solved plan re-typed for another pool element dtype.

        Segment geometry (offsets, deltas, schedules — and therefore the
        sim-oracle certificate) is dtype-independent; only the byte
        accounting changes: every op's ``segment_bytes`` and the
        program's ``elem_bytes`` are re-derived from the new itemsize.
        ``with_dtype("float32")`` of a default program is the identity,
        so legacy fp32 footprints stay bit-identical.
        """
        eb = dtype_itemsize(dtype)
        if dtype == self.dtype and eb == self.elem_bytes:
            return self
        if not self.executable:
            raise ValueError("plan-only byte-granular programs are already "
                             "int8 (segment_bytes == 1); with_dtype applies "
                             "to executable programs")
        ops = tuple(dataclasses.replace(op,
                                        segment_bytes=self.seg_width * eb)
                    for op in self.ops)
        return dataclasses.replace(self, dtype=dtype, elem_bytes=eb,
                                   ops=ops)

    # -- serialization (plan artifacts) ------------------------------------
    def to_json_dict(self) -> dict:
        """The program as a JSON-safe dict (every field is an int/str/
        bool/None), in the reference's field order."""
        d = dataclasses.asdict(self)     # recurses into ops already
        d["ops"] = list(d["ops"])        # tuple -> JSON array
        return d

    @classmethod
    def from_json_dict(cls, d: dict) -> "PoolProgram":
        ops = tuple(PoolOp(**op) for op in d["ops"])
        return cls(**{**{k: v for k, v in d.items() if k != "ops"},
                      "ops": ops})

    # -- DMA blocks ----------------------------------------------------------
    def op_blocks(self, op: PoolOp) -> tuple[int, int]:
        """(in, out) contiguous DMA block sizes of ``op``, in segments.

        Conv-family kinds copy one image row per step; gemm/mlp/
        elementwise copy ``block_rows`` matrix rows; ``pool_avg`` reads
        image rows and writes one channel row; ``add`` streams single
        pixel rows from both sources.
        """
        sw = self.seg_width
        br = self.block_rows or 1
        ci = segments_for(op.d_in, sw)
        co = segments_for(op.d_out, sw)
        if op.kind in ("conv_pw", "conv_dw", "conv_k2d", "ib_fused",
                       "conv_stream"):
            return op.w_in * ci, op.w_out * co
        if op.kind == "pool_avg":
            return op.w_in * ci, co
        if op.kind in ("add", "gru_cell"):
            return ci, co
        return br * ci, br * co

    def check_alignment(self) -> None:
        """Assert no contiguous DMA block of any op can wrap mid-block.

        Sufficient condition (DESIGN.md §5): every pointer is a multiple of
        its op's block segment count and ``n_segments`` is a multiple of
        every block size — then ``(ptr + i*b) % n_segments`` is always
        block-aligned and ``off + b <= n_segments``.
        """
        if not self.aligned:
            raise ValueError("program was planned with block_rows=None "
                             "(tight geometry) — not DMA-block aligned")
        for op in self.ops:
            if op.kind not in EXECUTABLE_KINDS:
                continue
            bk, bn = self.op_blocks(op)
            if (op.in_ptr % bk or op.out_ptr % bn
                    or self.n_segments % math.lcm(bk, bn)
                    or (op.aux_op >= 0 and op.aux_ptr % bk)):
                raise AssertionError(f"misaligned op {op.kind} "
                                     f"({op.in_ptr},{op.out_ptr}) in pool "
                                     f"of {self.n_segments}")
            for ptr, blk, tot in ((op.in_ptr, bk, op.in_segments),
                                  (op.out_ptr, bn, op.out_segments)):
                for i in range(tot // blk):
                    off = (ptr + i * blk) % self.n_segments
                    assert off + blk <= self.n_segments, "mid-block wrap"


# ---------------------------------------------------------------------------
# The single planning front-end.
# ---------------------------------------------------------------------------

def _floor_mult(x: int, b: int) -> int:
    return (x // b) * b


def _conv_state(spec, rows: int, dim: int, img, pos: int):
    """Validate that ``spec``'s input geometry matches the running tensor."""
    if img is None:
        if rows != spec.h_in * spec.w_in:
            raise ValueError(f"layer {pos}: conv expects {spec.h_in}x"
                             f"{spec.w_in} pixel rows, program has {rows}")
    elif img != (spec.h_in, spec.w_in):
        raise ValueError(f"layer {pos}: conv image {spec.h_in}x{spec.w_in} "
                         f"!= running image {img[0]}x{img[1]}")
    c_in = spec.c if isinstance(spec, ConvDWSpec) else spec.c_in
    if dim != c_in:
        raise ValueError(f"layer {pos}: conv c_in={c_in} != running "
                         f"dim={dim}")


def plan_program(m_rows: int, d_in: int, layers: Sequence[LayerSpec], *,
                 seg_width: int = SEG_WIDTH, block_rows: int | None = None,
                 elem_bytes: int | None = None, dtype: str | None = None,
                 delta_slack: int = 0) -> PoolProgram:
    """Solve segment offsets for a layer sequence over ONE virtual pool.

    ``block_rows=None`` keeps the exact Eq.-(1) geometry (the ``sim``
    oracle); an integer plans DMA-block-aligned geometry, the one the
    ring kernels execute (deltas only ever rounded *up* — safety is
    preserved; ``pool_segments`` still reports the tight footprint).
    Conv-family specs (whole-network programs) use one image row as their
    DMA block regardless of ``block_rows``.

    ``dtype`` sets the pool element type the byte accounting uses
    (``"int8"`` programs report ``pool_bytes`` at 1 byte/element — the
    deployable MCU footprint); segment geometry itself is
    dtype-independent.  ``elem_bytes`` defaults to the dtype's itemsize
    and may not contradict it.

    Residual modules (:class:`ResidualAddSpec`) make the planner *hold*
    the source tensor: every op between the source and the add places its
    output clear of the held interval, and the add op records the source
    location as ``aux_ptr``.

    ``delta_slack`` exists for tightness testing only: it shrinks every
    solved delta, so ``delta_slack=1`` must make the ``sim`` backend raise
    :class:`repro_torch.core.pool.PoolClobberError` (the plans are exact
    optima).
    """
    from . import rowsched

    if dtype is None:   # legacy elem_bytes-only callers: derive the label
        dtype = (_DTYPE_FOR_BYTES.get(elem_bytes, "float32")
                 if elem_bytes is not None else "float32")
    if elem_bytes is None:
        elem_bytes = dtype_itemsize(dtype)
    elif elem_bytes != dtype_itemsize(dtype):
        raise ValueError(f"elem_bytes={elem_bytes} contradicts "
                         f"dtype={dtype!r} "
                         f"(itemsize {dtype_itemsize(dtype)})")
    layers = list(layers)
    if not layers:
        raise ValueError("need at least one layer spec")
    if any(isinstance(s, (FusedChainSpec, InvertedBottleneckSpec))
           for s in layers):
        if len(layers) != 1:
            raise ValueError("byte-granular plan-only specs (FusedChainSpec/"
                             "InvertedBottleneckSpec) must be the sole layer")
        return _plan_analytic(m_rows, d_in, layers[0])

    aligned = block_rows is not None
    br = block_rows if aligned else 1
    if br <= 0:
        raise ValueError(f"block_rows={block_rows} must be positive")

    # Pre-scan residual adds AND branch convs (input_from): ops in
    # (src..consumer] must avoid the held tensor; the held interval stays
    # in the live span through its consumer.
    aux_src: dict[int, int] = {}
    in_src: dict[int, int] = {}
    avoid_at: list[set[int]] = [set() for _ in layers]
    hold_at: list[set[int]] = [set() for _ in layers]
    for i, s in enumerate(layers):
        if isinstance(s, ResidualAddSpec):
            j = i - s.src
            if j < 0:
                raise ValueError(f"layer {i}: residual source {s.src} ops "
                                 "back reaches before the program input")
            aux_src[i] = j
            for k in range(j, i):
                avoid_at[k].add(j)
            for k in range(j, i + 1):
                hold_at[k].add(j)
        elif getattr(s, "input_from", 0):
            j = i - s.input_from
            if j < 0:
                raise ValueError(f"layer {i}: input_from {s.input_from} "
                                 "ops back reaches before the program "
                                 "input")
            in_src[i] = j
            for k in range(j, i):
                avoid_at[k].add(j)
            for k in range(j, i + 1):
                hold_at[k].add(j)
    # (consumer, held-record) pairs.  Op ``p`` must not free the tensor
    # it READS — record ``in_src.get(p, p)`` — iff a LATER consumer
    # still needs that record; the consumer frees it itself.
    holders = list(aux_src.items()) + list(in_src.items())

    def _hold_input(p: int) -> bool:
        r = in_src.get(p, p)
        return any(j == r and i > p for i, j in holders)

    ops: list[PoolOp] = []
    rows, cur, img = m_rows, d_in, None
    pt = 0   # tight running pointer
    pa = 0   # aligned running pointer
    spans_t: list[int] = []
    spans_a: list[int] = []
    aligns: list[int] = [1]
    # per-op CHAINED input tensor record (tight ptr, aligned ptr, total
    # segments) — for branch ops (input_from) this stays the chained
    # tensor that remains resident, NOT the held tensor the op reads
    tens: list[tuple[int, int, int]] = []
    # persistent-state demands: (op index, state segments, chunk align)
    state_needs: list[tuple[int, int, int]] = []
    # chain state (rows, dim, image) entering each op
    states: list[tuple[int, int, tuple | None]] = []

    def _avoid(out, out_tot, pos, coord, round_to=None, cur=None):
        """Push ``out`` below every held interval it overlaps.

        ``cur`` is the in-flight record of the op being planned (its own
        input may be the held tensor — it is not in ``tens`` yet)."""
        for _ in range(len(avoid_at[pos]) + 1):
            moved = False
            for j in sorted(avoid_at[pos]):
                rec = cur if j == len(tens) else tens[j]
                lo = rec[coord]
                hi = lo + rec[2]
                if out < hi and out + out_tot > lo:
                    out = lo - out_tot + delta_slack
                    if round_to:
                        out = _floor_mult(out, round_to)
                    moved = True
            if not moved:
                break
        return out

    for pos, spec in enumerate(layers):
        if isinstance(spec, (GemmSpec, FusedMLPSpec)):
            resolve_activation(spec.activation)  # fail at plan time
        elif isinstance(spec, ElementwiseSpec):
            resolve_activation(spec.fn)
        elif isinstance(spec, (ConvPWSpec, ConvDWSpec, ConvK2DSpec,
                               ConvStreamSpec, ResidualAddSpec)):
            resolve_activation(spec.activation)
        states.append((rows, cur, img))
        rows_in = rows
        it, ia = pt, pa
        extra: dict = {}
        src_j = in_src.get(pos)
        if src_j is not None:
            if not isinstance(spec, (ConvPWSpec, ConvK2DSpec)):
                raise TypeError(f"layer {pos}: input_from is only "
                                "supported on ConvPWSpec/ConvK2DSpec")
            # the op reads the HELD input of op src_j; the chained
            # tensor stays resident at (pt, pa) for a later consumer
            it, ia = tens[src_j][0], tens[src_j][1]
        if isinstance(spec, GemmSpec):
            if rows % br:
                raise ValueError(f"block_rows={br} must divide rows={rows}")
            k_segs = segments_for(cur, seg_width)
            n_segs = segments_for(spec.d_out, seg_width)
            bk, bn = br * k_segs, br * n_segs
            delta = (gemm_offset_closed_form(rows, n_segs, k_segs)
                     - delta_slack)
            in_tot, out_tot = rows * k_segs, rows * n_segs
            ot = _avoid(pt - delta, out_tot, pos, 0,
                        cur=(it, ia, in_tot))
            if not aligned:
                oa = ot
            elif pos == 0:
                # First op: both tensors are still placeable — pick the
                # cheaper of "shift In up to a bk multiple" (the legacy
                # aligned_pool_geometry choice) and "shift Out down to a
                # bn multiple".
                gap_k = ceil_div(max(delta, 0), bk) * bk
                gap_n = ceil_div(max(delta, 0), bn) * bn
                ia, oa = ((gap_k, 0) if gap_k <= gap_n else (0, -gap_n))
                oa = _avoid(oa, out_tot, pos, 1, round_to=bn,
                            cur=(it, ia, in_tot))
            else:
                oa = _avoid(_floor_mult(pa - delta, bn), out_tot, pos, 1,
                            round_to=bn, cur=(it, ia, in_tot))
            kind, d_out = "gemm", spec.d_out
            extra = dict(activation=spec.activation, rows_in=rows,
                         rows_out=rows)
            aligns.append(math.lcm(bk, bn))
            new_state = (rows, spec.d_out, None if img is None else img)
        elif isinstance(spec, (FusedMLPSpec, ElementwiseSpec)):
            if rows % br:
                raise ValueError(f"block_rows={br} must divide rows={rows}")
            d_segs = segments_for(cur, seg_width)
            bd = br * d_segs
            delta = -delta_slack  # Eq.-(2) optimum for these chains is 0
            ot = pt - delta
            oa = pa if (not aligned or delta == 0) else pa - delta
            in_tot = out_tot = rows * d_segs
            kind, d_out = ("fused_mlp" if isinstance(spec, FusedMLPSpec)
                           else "elementwise"), cur
            if isinstance(spec, FusedMLPSpec):
                if spec.d_ff % spec.ff_tile:
                    raise ValueError(f"ff_tile={spec.ff_tile} must divide "
                                     f"d_ff={spec.d_ff}")
                extra = dict(activation=spec.activation, gated=spec.gated,
                             residual=spec.residual, d_ff=spec.d_ff,
                             ff_tile=spec.ff_tile, rows_in=rows,
                             rows_out=rows)
            else:
                extra = dict(activation=spec.fn, rows_in=rows,
                             rows_out=rows)
            aligns.append(bd)
            new_state = (rows, cur, img)
        elif isinstance(spec, (ConvPWSpec, ConvDWSpec, ConvK2DSpec)):
            if src_j is not None:   # branch conv: validate vs held state
                v_rows, v_dim, v_img = states[src_j]
            else:
                v_rows, v_dim, v_img = rows, cur, img
            _conv_state(spec, v_rows, v_dim, v_img, pos)
            h_in, w_in = spec.h_in, spec.w_in
            h_out, w_out = spec.out_hw
            c_in = spec.c if isinstance(spec, ConvDWSpec) else spec.c_in
            c_out = spec.c if isinstance(spec, ConvDWSpec) else spec.c_out
            ci = segments_for(c_in, seg_width)
            co = segments_for(c_out, seg_width)
            in_chunk, out_chunk = w_in * ci, w_out * co
            if isinstance(spec, ConvPWSpec):
                sched = rowsched.conv_pw_schedule(
                    h_in, h_out, in_chunk, out_chunk, stride=spec.stride,
                    resample=spec.resample_to is not None)
                kind = "conv_pw"
                extra = dict(activation=spec.activation, stride=spec.stride,
                             resample=spec.resample_to is not None)
            elif isinstance(spec, ConvK2DSpec):
                sched = rowsched.conv_k2d_schedule(
                    h_in, h_out, in_chunk, out_chunk, k=spec.k,
                    stride=spec.stride, padding=spec.padding)
                kind = "conv_k2d"
                extra = dict(activation=spec.activation, stride=spec.stride,
                             rs=spec.k, padding=spec.padding)
            else:
                sched = rowsched.conv_dw_schedule(
                    h_in, h_out, in_chunk, out_chunk, rs=spec.rs,
                    stride=spec.stride)
                kind = "conv_dw"
                extra = dict(activation=spec.activation, stride=spec.stride,
                             rs=spec.rs)
            delta = sched.solve_delta() - delta_slack
            in_tot, out_tot = h_in * w_in * ci, h_out * w_out * co
            if src_j is not None:
                # the in-flight avoid record is the CHAINED tensor (it
                # stays resident for a later consumer, e.g. the add)
                chain_rec = (pt, pa, rows * segments_for(cur, seg_width))
                extra["in_op"] = src_j
            else:
                chain_rec = (it, ia, in_tot)
            ot = _avoid(it - delta, out_tot, pos, 0, cur=chain_rec)
            oa = (ot if not aligned else
                  _avoid(_floor_mult(ia - delta, out_chunk), out_tot, pos,
                         1, round_to=out_chunk, cur=chain_rec))
            d_out = c_out
            extra.update(h_in=h_in, w_in=w_in, h_out=h_out, w_out=w_out,
                         rows_in=v_rows, rows_out=h_out * w_out)
            aligns.append(math.lcm(in_chunk, out_chunk))
            new_state = (h_out * w_out, c_out, (h_out, w_out))
        elif isinstance(spec, ConvStreamSpec):
            if spec.hop <= 0 or spec.h_win % spec.hop:
                raise ValueError(f"layer {pos}: hop={spec.hop} must divide "
                                 f"h_win={spec.h_win}")
            frame_rows = spec.hop * spec.w_in
            if img is None:
                if rows != frame_rows:
                    raise ValueError(f"layer {pos}: conv_stream expects a "
                                     f"{spec.hop}x{spec.w_in} frame, "
                                     f"program has {rows} rows")
            elif img != (spec.hop, spec.w_in):
                raise ValueError(f"layer {pos}: conv_stream frame "
                                 f"{spec.hop}x{spec.w_in} != running image "
                                 f"{img[0]}x{img[1]}")
            if cur != spec.c_in:
                raise ValueError(f"layer {pos}: conv_stream c_in="
                                 f"{spec.c_in} != running dim={cur}")
            h_out, w_out = spec.out_hw
            ci = segments_for(spec.c_in, seg_width)
            co = segments_for(spec.c_out, seg_width)
            in_chunk, out_chunk = spec.w_in * ci, w_out * co
            sched = rowsched.conv_stream_schedule(spec.hop, h_out, in_chunk,
                                                  out_chunk)
            delta = sched.solve_delta() - delta_slack
            in_tot, out_tot = frame_rows * ci, h_out * w_out * co
            ot = _avoid(it - delta, out_tot, pos, 0, cur=(it, ia, in_tot))
            oa = (ot if not aligned else
                  _avoid(_floor_mult(ia - delta, out_chunk), out_tot, pos,
                         1, round_to=out_chunk, cur=(it, ia, in_tot)))
            kind, d_out = "conv_stream", spec.c_out
            extra = dict(activation=spec.activation, stride=spec.stride,
                         rs=spec.k, padding=spec.padding, hop=spec.hop,
                         h_in=spec.h_win, w_in=spec.w_in, h_out=h_out,
                         w_out=w_out, rows_in=frame_rows,
                         rows_out=h_out * w_out)
            state_needs.append((pos, spec.h_win * spec.w_in * ci, in_chunk))
            aligns.append(math.lcm(in_chunk, out_chunk))
            new_state = (h_out * w_out, spec.c_out, (h_out, w_out))
        elif isinstance(spec, GRUCellSpec):
            if rows != 1:
                raise ValueError(f"layer {pos}: gru_cell expects a single "
                                 f"row, program has {rows}")
            ci = segments_for(cur, seg_width)
            co = segments_for(spec.d_h, seg_width)
            sched = rowsched.gru_cell_schedule(ci, co)
            delta = sched.solve_delta() - delta_slack
            in_tot, out_tot = ci, co
            ot = _avoid(it - delta, out_tot, pos, 0, cur=(it, ia, in_tot))
            oa = (ot if not aligned else
                  _avoid(_floor_mult(ia - delta, co), out_tot, pos, 1,
                         round_to=co, cur=(it, ia, in_tot)))
            kind, d_out = "gru_cell", spec.d_h
            extra = dict(rows_in=1, rows_out=1)
            state_needs.append((pos, co, co))
            aligns.append(math.lcm(ci, co))
            new_state = (1, spec.d_h, None)
        elif isinstance(spec, IBModuleSpec):
            cfg = spec.cfg
            if any(s != 1 for s in cfg.strides):
                raise ValueError("IBModuleSpec (fused execution) is "
                                 "stride-1 only; lower strided modules "
                                 "unfused")
            if (segments_for(cfg.c_in, seg_width) != 1
                    or segments_for(cfg.c_out, seg_width) != 1):
                raise ValueError("ib_fused needs one segment per pixel "
                                 f"(c_in={cfg.c_in}, c_out={cfg.c_out}, "
                                 f"seg_width={seg_width})")
            h = w = cfg.hw
            if img is None:
                if rows != h * w:
                    raise ValueError(f"layer {pos}: module expects {h}x{w} "
                                     f"pixel rows, program has {rows}")
            elif img != (h, w):
                raise ValueError(f"layer {pos}: module image {h}x{w} != "
                                 f"running image {img}")
            if cur != cfg.c_in:
                raise ValueError(f"layer {pos}: module c_in={cfg.c_in} != "
                                 f"running dim={cur}")
            sched = rowsched.ib_fused_schedule(h, w, w, rs=cfg.rs,
                                               residual=cfg.has_residual)
            delta = sched.solve_delta() - delta_slack
            in_tot = out_tot = h * w
            ot = _avoid(pt - delta, out_tot, pos, 0,
                        cur=(it, ia, in_tot))
            oa = (ot if not aligned else
                  _avoid(_floor_mult(pa - delta, w), out_tot, pos, 1,
                         round_to=w, cur=(it, ia, in_tot)))
            kind, d_out = "ib_fused", cfg.c_out
            extra = dict(h_in=h, w_in=w, h_out=h, w_out=w, rs=cfg.rs,
                         residual=cfg.has_residual, d_mid=cfg.c_mid,
                         rows_in=rows, rows_out=rows)
            aligns.append(w)
            new_state = (rows, cfg.c_out, (h, w))
        elif isinstance(spec, ResidualAddSpec):
            j = aux_src[pos]
            src_rows, src_dim, _src_img = states[j]
            if src_rows != rows or src_dim != cur:
                raise ValueError(f"layer {pos}: residual source shape "
                                 f"({src_rows},{src_dim}) != current "
                                 f"({rows},{cur})")
            d_segs = segments_for(cur, seg_width)
            delta = -delta_slack
            ot, oa = pt - delta, pa + delta_slack
            in_tot = out_tot = rows * d_segs
            kind, d_out = "add", cur
            extra = dict(rows_in=rows, rows_out=rows,
                         activation=spec.activation,
                         aux_op=j, aux_ptr=tens[j][0 if not aligned else 1])
            aligns.append(d_segs)
            new_state = (rows, cur, img)
        elif isinstance(spec, AvgPoolSpec):
            _conv_state_pool(spec, rows, cur, img, pos)
            ci = segments_for(spec.c, seg_width)
            in_chunk, out_chunk = spec.w_in * ci, ci
            sched = rowsched.avgpool_schedule(spec.h_in, in_chunk,
                                              out_chunk)
            delta = sched.solve_delta() - delta_slack
            in_tot, out_tot = spec.h_in * spec.w_in * ci, ci
            ot = _avoid(pt - delta, out_tot, pos, 0,
                        cur=(it, ia, in_tot))
            oa = (ot if not aligned else
                  _avoid(_floor_mult(pa - delta, out_chunk), out_tot, pos,
                         1, round_to=out_chunk, cur=(it, ia, in_tot)))
            kind, d_out = "pool_avg", spec.c
            extra = dict(h_in=spec.h_in, w_in=spec.w_in, h_out=1, w_out=1,
                         rows_in=rows, rows_out=1)
            aligns.append(math.lcm(in_chunk, out_chunk))
            new_state = (1, spec.c, (1, 1))
        else:
            raise TypeError(f"unknown layer spec {spec!r}")

        if not aligned:
            ia, oa = it, ot
        op = PoolOp(kind=kind, in_ptr=ia, out_ptr=oa, delta=delta,
                    in_segments=in_tot, out_segments=out_tot,
                    segment_bytes=seg_width * elem_bytes,
                    d_in=states[src_j][1] if src_j is not None else cur,
                    d_out=d_out, hold_input=_hold_input(pos), **extra)
        if src_j is not None:
            tens.append(chain_rec)   # the chained tensor, not the held one
        else:
            tens.append((it, ia, in_tot))
        # Live span at this op: In, Out and every held residual interval.
        lo_t, hi_t = min(it, ot), max(it + in_tot, ot + out_tot)
        lo_a, hi_a = min(ia, oa), max(ia + in_tot, oa + out_tot)
        for j in hold_at[pos]:
            lo_t = min(lo_t, tens[j][0])
            hi_t = max(hi_t, tens[j][0] + tens[j][2])
            lo_a = min(lo_a, tens[j][1])
            hi_a = max(hi_a, tens[j][1] + tens[j][2])
        spans_t.append(hi_t - lo_t)
        spans_a.append(hi_a - lo_a)
        ops.append(op)
        pt, pa = ot, oa
        rows, cur, img = new_state

    pool_segments = max(spans_t)

    if aligned:
        align = math.lcm(*aligns)
        n_segments = ceil_div(max(spans_a), align) * align
        base = min(min(op.in_ptr, op.out_ptr) for op in ops)
        shift = -_floor_mult(base, align) if base < 0 else 0
    else:
        n_segments = pool_segments
        base = min(min(op.in_ptr, op.out_ptr) for op in ops)
        shift = -base
    if shift:
        ops = [dataclasses.replace(
                   op, in_ptr=op.in_ptr + shift, out_ptr=op.out_ptr + shift,
                   aux_ptr=op.aux_ptr + shift if op.aux_op >= 0 else 0)
               for op in ops]

    if state_needs:
        # Persistent state pins the ring's origin across invocations, so
        # the frame program must be WRAP-FREE — the infinite-horizon form
        # of the Eq.-(2) avoid constraint: a held interval avoided by
        # every op of every future step degenerates to "past the linear
        # extent of all frame traffic".  The modulus grows to the linear
        # extent and states are carved out above it; frame accesses then
        # never reduce into a state interval, by construction (the
        # static verifier re-proves this, VMCU211/213).
        ext = n_segments
        for op in ops:
            ext = max(ext, op.in_ptr + op.in_segments,
                      op.out_ptr + op.out_segments)
            if op.aux_op >= 0:
                ext = max(ext, op.aux_ptr + op.in_segments)
        repl: dict[int, tuple[int, int]] = {}
        for op_i, segs_n, chunk in state_needs:
            if aligned and ext % chunk:
                ext = ceil_div(ext, chunk) * chunk
            repl[op_i] = (ext, segs_n)
            ext += segs_n
        pool_segments = ext
        n_segments = (ceil_div(ext, math.lcm(*aligns)) * math.lcm(*aligns)
                      if aligned else ext)
        ops = [dataclasses.replace(op, state_ptr=repl[i][0],
                                   state_segments=repl[i][1])
               if i in repl else op
               for i, op in enumerate(ops)]

    return PoolProgram(m_rows=m_rows, seg_width=seg_width,
                       block_rows=block_rows, n_segments=n_segments,
                       pool_segments=pool_segments, elem_bytes=elem_bytes,
                       dtype=dtype, ops=tuple(ops))


def _conv_state_pool(spec, rows, dim, img, pos):
    if img is None:
        if rows != spec.h_in * spec.w_in:
            raise ValueError(f"layer {pos}: pool expects {spec.h_in}x"
                             f"{spec.w_in} pixel rows, program has {rows}")
    elif img != (spec.h_in, spec.w_in):
        raise ValueError(f"layer {pos}: pool image mismatch")
    if dim != spec.c:
        raise ValueError(f"layer {pos}: pool c={spec.c} != dim={dim}")


# ---------------------------------------------------------------------------
# Byte-granular plan-only programs (Eq. 2 analytic plans).
# ---------------------------------------------------------------------------

def _plan_analytic(m_rows: int, d_in: int, spec) -> PoolProgram:
    from .graph_planner import plan_fc_chain, plan_inverted_bottleneck
    if isinstance(spec, FusedChainSpec):
        dims = [d_in, *spec.dims]
        fp = plan_fc_chain(m_rows, dims, elem_bytes=spec.elem_bytes,
                           rows_per_step=spec.rows_per_step)
        op = PoolOp(kind="fused_chain", in_ptr=fp.delta_bytes, out_ptr=0,
                    delta=fp.delta_bytes, in_segments=fp.input_bytes,
                    out_segments=fp.output_bytes, segment_bytes=1,
                    d_in=d_in, d_out=dims[-1],
                    workspace_bytes=fp.workspace_bytes)
    else:
        fp = plan_inverted_bottleneck(spec.cfg, spec.workspace)
        op = PoolOp(kind="inverted_bottleneck", in_ptr=fp.delta_bytes,
                    out_ptr=0, delta=fp.delta_bytes,
                    in_segments=fp.input_bytes,
                    out_segments=fp.output_bytes, segment_bytes=1,
                    d_in=spec.cfg.c_in, d_out=spec.cfg.c_out,
                    workspace_bytes=fp.workspace_bytes)
    pool_bytes = (max(op.in_segments + op.delta, op.out_segments)
                  + op.workspace_bytes)
    return PoolProgram(m_rows=m_rows, seg_width=1, block_rows=None,
                       n_segments=pool_bytes, pool_segments=pool_bytes,
                       elem_bytes=1, dtype="byte", ops=(op,))


def plan_module_program(cfg, workspace: str = "paper_11seg") -> PoolProgram:
    """One-op program for a fused inverted-bottleneck module (Fig. 6).

    ``pool_bytes`` equals ``plan_inverted_bottleneck(cfg).pool_bytes``."""
    return plan_program(cfg.hw * cfg.hw, cfg.c_in,
                        [InvertedBottleneckSpec(cfg, workspace)])


def plan_stream_chain_program(m_rows: int, dims: Sequence[int], *,
                              rows_per_step: int = 1,
                              elem_bytes: int = 2) -> PoolProgram:
    """One-op program for a whole-chain streaming fusion (Eq. 2).

    ``pool_bytes`` equals ``plan_fc_chain(m_rows, dims, ...).pool_bytes``."""
    return plan_program(m_rows, dims[0],
                        [FusedChainSpec(tuple(dims[1:]),
                                        rows_per_step=rows_per_step,
                                        elem_bytes=elem_bytes)])


# ---------------------------------------------------------------------------
# Multi-program composition.
# ---------------------------------------------------------------------------

def concat_programs(programs: Sequence[PoolProgram]) -> PoolProgram:
    """Chain programs over ONE pool: program ``i+1``'s input is placed
    exactly where program ``i``'s output landed, so consecutive programs
    overlap in the ring instead of each resetting the pool.

    The merged pool length is the *largest* single-program live span, not
    the sum — the whole point of cross-boundary Eq.-(1)/(2) chaining.
    Aligned programs concatenate only when the required shift lands on
    every op's DMA block (plan the whole net in one :func:`plan_program`
    call otherwise — this hook is for composing independently planned
    stages).
    """
    programs = list(programs)
    if not programs:
        raise ValueError("need at least one program")
    base = programs[0]
    if any(p.seg_width != base.seg_width or p.elem_bytes != base.elem_bytes
           or p.dtype != base.dtype for p in programs):
        raise ValueError("programs must share seg_width, elem_bytes and "
                         "dtype")
    aligned = base.aligned
    if any(p.aligned != aligned for p in programs):
        raise ValueError("cannot mix aligned and tight programs")
    if not all(p.executable for p in programs):
        raise ValueError("plan-only programs cannot be concatenated")

    align_all = 1
    if aligned:
        for p in programs:
            for op in p.ops:
                align_all = math.lcm(align_all, math.lcm(*p.op_blocks(op)))

    merged: list[PoolOp] = []
    cursor = None  # previous program's (shifted) output pointer
    prev_p = None
    for p in programs:
        if cursor is None:
            shift = 0
        else:
            if prev_p.out_rows != p.in_rows or prev_p.out_dim != p.in_dim:
                raise ValueError(
                    f"program boundary mismatch: {prev_p.out_rows} rows x "
                    f"{prev_p.out_dim} -> {p.in_rows} rows x {p.in_dim}")
            shift = cursor - p.input_ptr
            if aligned and shift % align_all:
                raise ValueError(
                    f"aligned concat needs a shift multiple of {align_all} "
                    f"(got {shift}); plan the chain in one plan_program "
                    "call instead")
        idx0 = len(merged)
        for op in p.ops:
            merged.append(dataclasses.replace(
                op, in_ptr=op.in_ptr + shift, out_ptr=op.out_ptr + shift,
                aux_ptr=op.aux_ptr + shift if op.aux_op >= 0 else 0,
                aux_op=op.aux_op + idx0 if op.aux_op >= 0 else -1))
        cursor = merged[-1].out_ptr
        prev_p = p

    pool_segments = max(p.pool_segments for p in programs)
    if aligned:
        n_segments = ceil_div(max(p.n_segments for p in programs),
                              align_all) * align_all
    else:
        n_segments = pool_segments
    lo = min(min(op.in_ptr, op.out_ptr) for op in merged)
    shift = (-_floor_mult(lo, align_all) if aligned and lo < 0
             else (-lo if lo < 0 else 0))
    if shift:
        merged = [dataclasses.replace(
            op, in_ptr=op.in_ptr + shift, out_ptr=op.out_ptr + shift,
            aux_ptr=op.aux_ptr + shift if op.aux_op >= 0 else 0)
            for op in merged]
    return PoolProgram(m_rows=base.m_rows, seg_width=base.seg_width,
                       block_rows=base.block_rows, n_segments=n_segments,
                       pool_segments=pool_segments,
                       elem_bytes=base.elem_bytes, dtype=base.dtype,
                       ops=tuple(merged))
