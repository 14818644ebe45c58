"""PoolProgram — the plan-program IR over one VirtualPool (the data half).

Counterpart of :mod:`repro.core.program`.  A program is an ordered list
of :class:`PoolOp` steps, each carrying its solved Eq.-(1)/(2) geometry
``(in_ptr, out_ptr, delta, segment_bytes)``; the executors in
:mod:`repro_torch.core.executors` run it.  Planning (``plan_program``
and its helpers) is not ported yet: the port loads programs that the
reference planner solved, from a plan artifact.

The dataclass fields, their order and their defaults are those of the
reference, so :meth:`PoolProgram.to_json_dict` gives the same dict and
``program_sha256`` the same hash.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from .vpool import PoolSpec, ceil_div, segments_for

EXECUTABLE_KINDS = ("gemm", "fused_mlp", "elementwise", "conv_pw",
                    "conv_dw", "conv_k2d", "ib_fused", "add", "pool_avg",
                    "conv_stream", "gru_cell")
PLAN_ONLY_KINDS = ("fused_chain", "inverted_bottleneck")

# Pool element dtypes a program can be planned for, with the itemsize
# every ``segment_bytes`` derivation uses.  ``"int8"`` selects quantized
# execution; ``"byte"`` is the accounting-only 1-byte label.
DTYPE_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
                  "byte": 1}

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
