"""vMCU compiler support (paper §6): plan → intrinsic kernel source.

The paper lowers a Python kernel description through an IR to C++ built on
seven intrinsics (RegAlloc / RAMLoad / FlashLoad / Dot / RAMStore /
RAMFree / Broadcast).  This module reproduces that layer: given a
``SegmentPlan`` it emits the paper's Fig.-4 fully-connected kernel as
intrinsic-level C, with the solved pointer offsets and the circular-buffer
modulo checks baked in — the artifact a MCU toolchain would compile.

(The TPU path replaces this with JAX tracing → Mosaic; emitting the C form
keeps the paper's third contribution concretely reproduced and testable.)

The port's copy of :mod:`repro.core.codegen`, which is plain Python: every
unit it emits is the reference's, byte for byte (the goldens under
``tests/golden/`` are those bytes, and the header below names the module
that first wrote them).  Requant tables are formatted from host numpy
arrays, never from tensors on a device.
"""
from __future__ import annotations

from .planner import SegmentPlan
from .vpool import segments_for

_HEADER = """\
// generated by repro.core.codegen — vMCU Fig. 4 kernel
// pool: {pool} segments x {seg} B (circular); In@{b_in}, Out@{b_out}
#define POOL_SEGS {pool}
#define SEG_BYTES {seg}
#define WRAP(a) ((a) % POOL_SEGS)
"""

_FC_BODY = """\
void fc_kernel(int8_t* Pool, const int8_t* Weight /*Flash*/) {{
  // In[{M},{K}] @ Weight[{K}x{N}] -> Out[{M},{N}]   (segment units)
  for (int m = 0; m < {M}; ++m) {{               // outer tiling (segments)
    for (int n = 0; n < {N}; ++n) {{
      int32_t* Accum = RegAlloc({seg}, 0);
      for (int k = 0; k < {K}; ++k) {{
        // RAMLoad with circular bounds check (addr % PoolSegs)
        const int8_t* a = RAMLoad(Pool, WRAP({b_in} + m*{K} + k));
        const int8_t* b = FlashLoad(Weight, (k*{N} + n));
        for (int ki = 0; ki < SEG_BYTES; ki += {KI})   // inner tiling:
          for (int ni = 0; ni < SEG_BYTES; ni += {NI}) // vector lanes
            Dot(Accum + ni, a + ki, b + ki*{NI} + ni); // __SMLAD/__SADD16
      }}
      // RAMStore at the Eq.(1) offset: overwrites freed In segments
      RAMStore(Pool, WRAP({b_out} + m*{N} + n), Accum);
    }}
    for (int k = 0; k < {K}; ++k)
      RAMFree(Pool, WRAP({b_in} + m*{K} + k));   // row m fully consumed
  }}
}}
"""


def emit_fc_kernel(plan: SegmentPlan, M: int, N: int, K: int, *,
                   lane_ki: int = 16, lane_ni: int = 2) -> str:
    """Emit the Fig.-4 kernel with this plan's pointers.

    ``lane_ki/lane_ni`` are the paper's 2x2x16 `Dot` intrinsic lanes."""
    if plan.in_segments != M * K or plan.out_segments != M * N:
        raise ValueError("plan does not match the GEMM dimensions")
    b_out = 0
    b_in = plan.delta
    return (_HEADER.format(pool=plan.pool_segments, seg=plan.segment_bytes,
                           b_in=b_in, b_out=b_out)
            + _FC_BODY.format(M=M, N=N, K=K, KI=lane_ki, NI=lane_ni,
                              b_in=b_in, b_out=b_out,
                              seg=plan.segment_bytes))


INTRINSICS = ("RegAlloc", "RAMLoad", "FlashLoad", "Dot", "RAMStore",
              "RAMFree", "WRAP")


# ---------------------------------------------------------------------------
# Whole-program emission: one C translation unit per PoolOp (§6 for nets).
# ---------------------------------------------------------------------------

_GEMM_TU = """\
void {name}(int8_t* Pool, const int8_t* Weight /*Flash*/) {{
  // gemm: In[{m},{k}seg]@{b_in} x W -> Out[{m},{n}seg]@{b_out}
  for (int r = 0; r < {m}; ++r) {{
    for (int n = 0; n < {n}; ++n) {{
      int32_t* Accum = RegAlloc(SEG_BYTES, 0);
      for (int k = 0; k < {k}; ++k) {{
        const int8_t* a = RAMLoad(Pool, WRAP({b_in} + r*{k} + k));
        const int8_t* w = FlashLoad(Weight, (k*{n} + n));
        Dot(Accum, a, w);
      }}
      RAMStore(Pool, WRAP({b_out} + r*{n} + n), Accum);
    }}
    for (int k = 0; k < {k}; ++k)
      RAMFree(Pool, WRAP({b_in} + r*{k} + k));
  }}
}}
"""

_CONV_PW_TU = """\
void {name}(int8_t* Pool, const int8_t* Weight /*Flash*/) {{
  // pointwise conv {h_in}x{w_in}x{c_in} -> {h_out}x{w_out}x{c_out},
  // stride {stride}{resample}; In@{b_in} Out@{b_out} (chunks: {ic}/{oc})
  int freed = 0;                 // Eq.-(2) read-frontier cursor
  for (int p = 0; p < {h_out}; ++p) {{
    int src = {src_expr};
    for (int q = 0; q < {w_out}; ++q) {{
      int32_t* Accum = RegAlloc({c_out}, 0);
      const int8_t* a = RAMLoad(Pool, WRAP({b_in} + src*{ic} + ({col_expr})*{cseg}));
      const int8_t* w = FlashLoad(Weight, 0);
      Dot(Accum, a, w);
      RAMStore(Pool, WRAP({b_out} + p*{oc} + q*{oseg}), Accum);
    }}
    int nxt = (p + 1 < {h_out}) ? ({src_next}) : {h_in};
    if (nxt > {free_cap}) nxt = {free_cap};
    for (; freed < nxt; ++freed)   // rows the frontier has passed
      for (int j = 0; j < {ic}; ++j)
        RAMFree(Pool, WRAP({b_in} + freed*{ic} + j));
  }}
}}
"""

_CONV_DW_TU = """\
void {name}(int8_t* Pool, const int8_t* Weight /*Flash*/) {{
  // depthwise {rs}x{rs} conv {h_in}x{w_in}x{c} s{stride};
  // In@{b_in} Out@{b_out}
  int freed = 0;                 // Eq.-(2) read-frontier cursor
  for (int p = 0; p < {h_out}; ++p) {{
    for (int q = 0; q < {w_out}; ++q) {{
      int32_t* Accum = RegAlloc({c}, 0);
      for (int r = 0; r < {rs}; ++r)
        for (int s = 0; s < {rs}; ++s) {{
          int hp = p*{stride} - {pad_v} + r, wq = q*{stride} - {pad_h} + s;
          if (hp < 0 || hp >= {h_in} || wq < 0 || wq >= {w_in}) continue;
          const int8_t* a = RAMLoad(Pool, WRAP({b_in} + hp*{ic} + wq*{cseg}));
          const int8_t* w = FlashLoad(Weight, r*{rs} + s);
          Dot(Accum, a, w);
        }}
      RAMStore(Pool, WRAP({b_out} + p*{oc} + q*{cseg}), Accum);
    }}
    int nxt = (p + 1 < {h_out}) ? ((p + 1)*{stride} - {pad_v}) : {h_in};
    if (nxt < 0) nxt = 0;
    if (nxt > {free_cap}) nxt = {free_cap};
    for (; freed < nxt; ++freed)   // halo rows below the next window
      for (int j = 0; j < {ic}; ++j)
        RAMFree(Pool, WRAP({b_in} + freed*{ic} + j));
  }}
}}
"""

_IB_TU = """\
void {name}(int8_t* Pool, const int8_t* W1, const int8_t* Wd,
            const int8_t* W2 /*Flash*/) {{
  // fused inverted bottleneck (Fig. 6): {h}x{w}x{c_in} -> x{c_out},
  // C_mid={c_mid} lives only in the {rs}-row workspace; In@{b_in} Out@{b_out}
  int8_t* B = RegAlloc({rs}*{w}*{c_mid}, 0);    // halo workspace
  for (int p = 0; p < {h}; ++p) {{
    for (int r = 0; r < {rs}; ++r) {{
      const int8_t* a = RAMLoad(Pool, WRAP({b_in} + (p + r - {pad})*{w}));
      const int8_t* w1 = FlashLoad(W1, 0);
      Dot(B + (r % {rs})*{w}*{c_mid}, a, w1);   // PW1 -> workspace row
    }}
    for (int q = 0; q < {w}; ++q) {{
      int32_t* Accum = RegAlloc({c_out}, 0);
      const int8_t* wd = FlashLoad(Wd, 0);
      const int8_t* w2 = FlashLoad(W2, 0);
      Dot(Accum, B + q, wd);                    // DW over the halo
      Dot(Accum, Accum_cast(Accum), w2);        // PW2
{residual_code}
      RAMStore(Pool, WRAP({b_out} + p*{w} + q), Accum);
    }}
    for (int q = 0; q < {w}; ++q)
      RAMFree(Pool, WRAP({b_in} + p*{w} + q));  // A row p fully consumed
  }}
}}
"""

_CONV_K2D_TU = """\
void {name}(int8_t* Pool, const int8_t* Weight /*Flash*/) {{
  // k2d {rs}x{rs} conv {h_in}x{w_in}x{c_in} -> {h_out}x{w_out}x{c_out}
  // s{stride} '{padding}' padding; In@{b_in} Out@{b_out}
  int freed = 0;                 // Eq.-(2) read-frontier cursor
  for (int p = 0; p < {h_out}; ++p) {{
    for (int q = 0; q < {w_out}; ++q) {{
      int32_t* Accum = RegAlloc({c_out}, 0);
      for (int r = 0; r < {rs}; ++r)
        for (int s = 0; s < {rs}; ++s) {{
          int hp = p*{stride} - {pad_v} + r, wq = q*{stride} - {pad_h} + s;
          if (hp < 0 || hp >= {h_in} || wq < 0 || wq >= {w_in}) continue;
          for (int kc = 0; kc < {cseg}; ++kc) {{
            const int8_t* a = RAMLoad(Pool, WRAP({b_in} + hp*{ic} + wq*{cseg} + kc));
            const int8_t* w = FlashLoad(Weight, (r*{rs} + s)*{cseg} + kc);
            Dot(Accum, a, w);
          }}
        }}
      RAMStore(Pool, WRAP({b_out} + p*{oc} + q*{oseg}), Accum);
    }}
    int nxt = (p + 1 < {h_out}) ? ((p + 1)*{stride} - {pad_v}) : {h_in};
    if (nxt < 0) nxt = 0;
    if (nxt > {free_cap}) nxt = {free_cap};
    for (; freed < nxt; ++freed)   // halo rows below the next window
      for (int j = 0; j < {ic}; ++j)
        RAMFree(Pool, WRAP({b_in} + freed*{ic} + j));
  }}
}}
"""

_CONV_STREAM_TU = """\
void {name}(int8_t* Pool, const int8_t* Weight /*Flash*/) {{
  // streaming {rs}x{rs} conv: persistent {h_win}-row window
  // x{w_in}x{c_in} @{b_state} (wrap-free above the frame extent),
  // {hop}-row frame @{b_in} -> {h_out}x{w_out}x{c_out} @{b_out}
  for (int t = 0; t < {keep}*{ic}; ++t) {{     // shift out the oldest rows
    const int8_t* a = RAMLoad(Pool, WRAP({b_state} + {hop}*{ic} + t));
    RAMStore(Pool, WRAP({b_state} + t), Accum_cast(a));
  }}
  for (int t = 0; t < {hop}*{ic}; ++t) {{      // append the new frame
    const int8_t* a = RAMLoad(Pool, WRAP({b_in} + t));
    RAMStore(Pool, WRAP({b_state} + {keep}*{ic} + t), Accum_cast(a));
    RAMFree(Pool, WRAP({b_in} + t));           // frame consumed
  }}
  for (int p = 0; p < {h_out}; ++p) {{         // k2d over the full window
    for (int q = 0; q < {w_out}; ++q) {{
      int32_t* Accum = RegAlloc({c_out}, 0);
      for (int r = 0; r < {rs}; ++r)
        for (int s = 0; s < {rs}; ++s) {{
          int hp = p*{stride} - {pad_v} + r, wq = q*{stride} - {pad_h} + s;
          if (hp < 0 || hp >= {h_win} || wq < 0 || wq >= {w_in}) continue;
          for (int kc = 0; kc < {cseg}; ++kc) {{
            const int8_t* a = RAMLoad(Pool, WRAP({b_state} + hp*{ic} + wq*{cseg} + kc));
            const int8_t* w = FlashLoad(Weight, (r*{rs} + s)*{cseg} + kc);
            Dot(Accum, a, w);
          }}
        }}
      RAMStore(Pool, WRAP({b_out} + p*{oc} + q*{oseg}), Accum);
    }}
  }}
}}
"""

_GRU_TU = """\
void {name}(int8_t* Pool, const int8_t* Wx, const int8_t* Wh /*Flash*/) {{
  // GRU cell d_in={d_in} -> d_h={d_h}; x@{b_in}, persistent Q7 hidden
  // state @{b_state} (wrap-free), h'@{b_out}; hard z,r,n gates in Q12
  int32_t* Gx = RegAlloc(3*{d_h}, 0);          // x @ Wx (+ bias, Q12)
  int32_t* Gh = RegAlloc(3*{d_h}, 0);          // h @ Wh        (Q12)
  for (int k = 0; k < {ci}; ++k)
    Dot(Gx, RAMLoad(Pool, WRAP({b_in} + k)), FlashLoad(Wx, k));
  for (int k = 0; k < {co}; ++k)
    Dot(Gh, RAMLoad(Pool, WRAP({b_state} + k)), FlashLoad(Wh, k));
  int32_t* H = RegAlloc({d_h}, 0);
  GruUpdateQ12(H, Gx, Gh);                     // z,r,n blend at Q7
  RAMStore(Pool, WRAP({b_state}), Accum_cast(H)); // state writeback
  RAMStore(Pool, WRAP({b_out}), Accum_cast(H));   // ...and the step output
  for (int k = 0; k < {ci}; ++k)
    RAMFree(Pool, WRAP({b_in} + k));           // frame consumed
}}
"""

_ADD_TU = """\
void {name}(int8_t* Pool) {{
  // residual add: Out[{rows}]@{b_out} = In@{b_in} + Res@{b_aux}
  for (int t = 0; t < {rows}; ++t) {{
    int32_t* Accum = RegAlloc({chunk}, 0);
    const int8_t* x = RAMLoad(Pool, WRAP({b_in} + t*{chunk}));
    const int8_t* r = RAMLoad(Pool, WRAP({b_aux} + t*{chunk}));
    Dot(Accum, x, r);                           // vector add epilogue
{act_code}    RAMFree(Pool, WRAP({b_aux} + t*{chunk}));   // residual source dies here
    RAMStore(Pool, WRAP({b_out} + t*{chunk}), Accum);
  }}
}}
"""

_POOL_TU = """\
void {name}(int8_t* Pool) {{
  // global avgpool {h}x{w}x{c}: In@{b_in} -> one row Out@{b_out}
  int32_t* Accum = RegAlloc({oc}, 0);
  const int8_t* Ones = FlashLoad(0, 0);
  for (int p = 0; p < {h}; ++p) {{
    for (int q = 0; q < {w}; ++q)
      Dot(Accum, RAMLoad(Pool, WRAP({b_in} + p*{ic} + q*{cseg})), Ones);
    for (int j = 0; j < {ic}; ++j)
      RAMFree(Pool, WRAP({b_in} + p*{ic} + j));
  }}
  RAMStore(Pool, WRAP({b_out}), Accum);
}}
"""

_MLP_TU = """\
void {name}(int8_t* Pool, const int8_t* Wg, const int8_t* Wu,
            const int8_t* Wd /*Flash*/) {{
  // in-place fused MLP (d_ff={d_ff} never materializes); rows@{b_in}
  for (int t = 0; t < {rows}; ++t) {{
    int32_t* Accum = RegAlloc({chunk}, 0);
    for (int f = 0; f < {d_ff}; f += {ff_tile}) {{
      const int8_t* x = RAMLoad(Pool, WRAP({b_in} + t*{chunk}));
      Dot(Accum, x, FlashLoad(Wu, f));
      Dot(Accum, x, FlashLoad(Wd, f));
    }}
    RAMFree(Pool, WRAP({b_in} + t*{chunk}));
    RAMStore(Pool, WRAP({b_out} + t*{chunk}), Accum);
  }}
}}
"""

_EW_TU = """\
void {name}(int8_t* Pool) {{
  // in-place elementwise {fn}; rows@{b_in}
  for (int t = 0; t < {rows}; ++t) {{
    int32_t* Accum = RegAlloc({chunk}, 0);
    Dot(Accum, RAMLoad(Pool, WRAP({b_in} + t*{chunk})), FlashLoad(0, 0));
    RAMFree(Pool, WRAP({b_in} + t*{chunk}));
    RAMStore(Pool, WRAP({b_out} + t*{chunk}), Accum);
  }}
}}
"""


# ---------------------------------------------------------------------------
# Int8 requantization constants + epilogue (quantized programs).
# ---------------------------------------------------------------------------

# The Dot intrinsic maps to __SMLAD (dual 16-bit MAC, int8 widened) on
# Cortex-M4/M7 and to the Helium/MVE VMLADAVA.S8 reduction on M55/M85;
# the requant epilogue is CMSIS-NN's arm_nn_requantize shape: 64-bit
# multiply, round-to-nearest-even shift, __SSAT to int8 (MVE idiom:
# VQRDMULH + VRSHR + VQMOVNB) — see the Arm Helium optimization notes.
_REQUANT_BLOCK = """\
// int8 requantization constants for {name} (per output channel):
// q_out = __SSAT(rne64((int64_t)acc * mult[c] >> (31 - shift[c])), 8)
static const int32_t {name}_mult[{c}] = {{{mults}}};
static const int32_t {name}_shift[{c}] = {{{shifts}}};
static inline int8_t {name}_requant(int32_t acc, int c) {{
  // SMLAD accumulators in, saturated int8 out (VQRDMULH/VRSHR on MVE)
  return Requant(acc, {name}_mult[c], {name}_shift[c]);
}}
"""


_GRU_REQUANT_BLOCK = """\
// int8 GRU constants for {name}: per-gate-channel requant into Q12
// gx = rne64((int64_t)acc_x * mult_x[c] >> (31 - shift_x[c])) + bias_q12[c]
// gh = rne64((int64_t)acc_h * mult_u[c] >> (31 - shift_u[c]))  (h fixed Q7)
static const int32_t {name}_mult_x[{c}] = {{{mx}}};
static const int32_t {name}_shift_x[{c}] = {{{sx}}};
static const int32_t {name}_mult_u[{c}] = {{{mu}}};
static const int32_t {name}_shift_u[{c}] = {{{su}}};
static const int32_t {name}_bias_q12[{c}] = {{{bq}}};
"""


def _fmt_i32(vals) -> str:
    return ", ".join(str(int(v)) for v in vals)


def _emit_requant(op, i: int, qentry) -> str:
    """The requant constant table + epilogue helper of one quantized op.

    ``qentry`` is the op's executor qparam entry (``quantize_net``):
    per-channel ``(w, b, mult, shift)`` for gemm/conv, scalar pairs for
    add / pool_avg."""
    name = f"op{i:02d}_{op.kind}"
    if op.kind in ("gemm", "conv_pw", "conv_dw", "conv_k2d",
                   "conv_stream"):
        import numpy as np

        _w, _b, mult, shift = qentry
        mults, shifts = np.asarray(mult).ravel(), np.asarray(shift).ravel()
        return _REQUANT_BLOCK.format(name=name, c=len(mults),
                                     mults=_fmt_i32(mults),
                                     shifts=_fmt_i32(shifts))
    if op.kind == "add":
        m_i, s_i, m_a, s_a = qentry
        return _REQUANT_BLOCK.format(name=name, c=2,
                                     mults=_fmt_i32([m_i, m_a]),
                                     shifts=_fmt_i32([s_i, s_a]))
    if op.kind == "pool_avg":
        m, s = qentry
        return _REQUANT_BLOCK.format(name=name, c=1, mults=_fmt_i32([m]),
                                     shifts=_fmt_i32([s]))
    if op.kind == "gru_cell":
        import numpy as np

        _w, _u, b_q12, mx, sx, mu, su = qentry
        return _GRU_REQUANT_BLOCK.format(
            name=name, c=len(np.asarray(mx).ravel()),
            mx=_fmt_i32(np.asarray(mx).ravel()),
            sx=_fmt_i32(np.asarray(sx).ravel()),
            mu=_fmt_i32(np.asarray(mu).ravel()),
            su=_fmt_i32(np.asarray(su).ravel()),
            bq=_fmt_i32(np.asarray(b_q12).ravel()))
    raise ValueError(f"op kind {op.kind!r} has no int8 requant unit")


def _emit_op(op, i: int, seg_width: int, m_rows: int) -> str:
    name = f"op{i:02d}_{op.kind}"
    rows = op.rows_in or m_rows
    ci = segments_for(op.d_in, seg_width)
    co = segments_for(op.d_out, seg_width)
    # sliced ops (partial execution): reads window the source at row offset
    # in_row0 (baked into the base pointer) and held sources are never
    # freed by the read frontier (free_cap 0 keeps the loop dead)
    b_in = op.in_ptr + op.in_row0 * op.w_in * ci
    free_cap = 0 if op.hold_input else op.h_in
    if op.kind == "gemm":
        return _GEMM_TU.format(name=name, m=rows, k=ci, n=co,
                               b_in=op.in_ptr, b_out=op.out_ptr)
    if op.kind == "conv_pw":
        src = (f"(p*{op.h_in})/{op.h_out}" if op.resample
               else f"p*{op.stride}")
        # next step's lowest needed row — same map evaluated at p+1
        src_next = (f"((p + 1)*{op.h_in})/{op.h_out}" if op.resample
                    else f"(p + 1)*{op.stride}")
        col = (f"(q*{op.w_in})/{op.w_out}" if op.resample
               else f"q*{op.stride}")
        return _CONV_PW_TU.format(
            name=name, h_in=op.h_in, w_in=op.w_in, h_out=op.h_out,
            w_out=op.w_out, c_in=op.d_in, c_out=op.d_out,
            stride=op.stride,
            resample=" (resample)" if op.resample else "",
            ic=op.w_in * ci, oc=op.w_out * co, cseg=ci, oseg=co,
            b_in=b_in, b_out=op.out_ptr, src_expr=src,
            src_next=src_next, col_expr=col, free_cap=free_cap)
    if op.kind == "conv_dw":
        from .rowsched import conv_k2d_pad, conv_k2d_pad_w
        return _CONV_DW_TU.format(
            name=name, rs=op.rs, h_in=op.h_in, w_in=op.w_in,
            h_out=op.h_out, w_out=op.w_out, c=op.d_in, stride=op.stride,
            pad_v=conv_k2d_pad(op.rs, op.padding),
            pad_h=conv_k2d_pad_w(op.rs, op.padding),
            ic=op.w_in * ci, oc=op.w_out * co, cseg=ci,
            b_in=b_in, b_out=op.out_ptr, free_cap=free_cap)
    if op.kind == "conv_k2d":
        from .rowsched import conv_k2d_pad, conv_k2d_pad_w
        return _CONV_K2D_TU.format(
            name=name, rs=op.rs, h_in=op.h_in, w_in=op.w_in,
            h_out=op.h_out, w_out=op.w_out, c_in=op.d_in, c_out=op.d_out,
            stride=op.stride, padding=op.padding,
            pad_v=conv_k2d_pad(op.rs, op.padding),
            pad_h=conv_k2d_pad_w(op.rs, op.padding),
            ic=op.w_in * ci, oc=op.w_out * co, cseg=ci, oseg=co,
            b_in=b_in, b_out=op.out_ptr, free_cap=free_cap)
    if op.kind == "conv_stream":
        from .rowsched import conv_k2d_pad, conv_k2d_pad_w
        return _CONV_STREAM_TU.format(
            name=name, rs=op.rs, h_win=op.h_in, w_in=op.w_in,
            h_out=op.h_out, w_out=op.w_out, c_in=op.d_in, c_out=op.d_out,
            stride=op.stride, hop=op.hop, keep=op.h_in - op.hop,
            pad_v=conv_k2d_pad(op.rs, op.padding),
            pad_h=conv_k2d_pad_w(op.rs, op.padding),
            ic=op.w_in * ci, oc=op.w_out * co, cseg=ci, oseg=co,
            b_in=op.in_ptr, b_out=op.out_ptr, b_state=op.state_ptr)
    if op.kind == "gru_cell":
        return _GRU_TU.format(name=name, d_in=op.d_in, d_h=op.d_out,
                              ci=ci, co=co, b_in=op.in_ptr,
                              b_out=op.out_ptr, b_state=op.state_ptr)
    if op.kind == "ib_fused":
        pad = (op.rs - 1) // 2
        res = ("      Dot(Accum, RAMLoad(Pool, WRAP({b} + p*{w} + q)), "
               "Identity);  // residual"
               .format(b=op.in_ptr, w=op.w_in)) if op.residual else \
            "      // no residual (channel change)"
        return _IB_TU.format(name=name, h=op.h_in, w=op.w_in,
                             c_in=op.d_in, c_out=op.d_out, c_mid=op.d_mid,
                             rs=op.rs, pad=pad, b_in=op.in_ptr,
                             b_out=op.out_ptr, residual_code=res)
    if op.kind == "add":
        act = ("    Accum = ReLU(Accum);                       "
               "// post-add relu\n" if op.activation == "relu" else "")
        return _ADD_TU.format(name=name, rows=rows, chunk=ci,
                              b_in=op.in_ptr, b_out=op.out_ptr,
                              b_aux=op.aux_ptr, act_code=act)
    if op.kind == "pool_avg":
        return _POOL_TU.format(name=name, h=op.h_in, w=op.w_in, c=op.d_in,
                               ic=op.w_in * ci, cseg=ci, oc=co,
                               b_in=op.in_ptr, b_out=op.out_ptr)
    if op.kind == "fused_mlp":
        return _MLP_TU.format(name=name, rows=rows, chunk=ci,
                              d_ff=op.d_ff, ff_tile=op.ff_tile,
                              b_in=op.in_ptr, b_out=op.out_ptr)
    if op.kind == "elementwise":
        return _EW_TU.format(name=name, rows=rows, chunk=ci,
                             fn=op.activation, b_in=op.in_ptr,
                             b_out=op.out_ptr)
    raise ValueError(f"cannot emit op kind {op.kind!r}")


# Per-target requantization idiom banners (compile.targets.Target).  The
# intrinsic skeleton is idiom-independent; the banner pins which MCU
# instruction sequence Dot/Requant lower to on the selected target.
_IDIOM_BANNERS = {
    "smlad": "// target idiom: __SMLAD dual-MAC Dot, "
             "arm_nn_requantize (SSAT) epilogue\n",
    "mve": "// target idiom: Helium MVE VMLADAVA.S8 Dot, "
           "VQRDMULH+VRSHR+VQMOVNB requant\n",
    "none": "// target idiom: host simulation (no MCU ISA lowering)\n",
}


def emit_program(program, net_name: str = "net",
                 quant=None, idiom: str | None = None) -> dict[str, str]:
    """Emit one C translation unit per op of a PoolProgram / NetProgram.

    Every unit carries the shared pool header (POOL_SEGS, the modulo
    bounds check) and the op's SOLVED ring offsets baked in — the
    artifact set a MCU toolchain would compile and link against the
    intrinsic runtime.  Returns ``{filename: source}``.

    ``quant`` (the per-op qparams of a quantized program — required iff
    ``program.quantized``) additionally bakes each op's requantization
    multiplier/shift tables and an ``opNN_requant`` epilogue into its
    unit, mirroring how the solved pointers are baked in.

    ``idiom`` (a :data:`repro_torch.compile.targets.Target.requant_idiom`
    value) prepends the target's instruction-idiom banner to every unit;
    ``None`` leaves the units byte-identical to pre-target emission.
    """
    if not program.executable:
        raise ValueError("emit_program needs an executable program "
                         "(plan-only byte programs have no kernel loop)")
    if program.quantized and quant is None:
        raise ValueError("quantized program needs its qparams (pass "
                         "quant=qnet.qparams) to emit requant constants")
    if quant is not None and len(quant) != len(program.ops):
        raise ValueError(f"{len(quant)} quant entries for "
                         f"{len(program.ops)} ops")
    banner = ""
    if idiom is not None:
        try:
            banner = _IDIOM_BANNERS[idiom]
        except KeyError:
            raise ValueError(f"unknown requant idiom {idiom!r}; known: "
                             f"{sorted(_IDIOM_BANNERS)}") from None
    header = _HEADER.format(pool=program.n_segments,
                            seg=program.seg_width * program.elem_bytes,
                            b_in=program.input_ptr,
                            b_out=program.output_ptr)
    units: dict[str, str] = {}
    for i, op in enumerate(program.ops):
        src = _emit_op(op, i, program.seg_width, program.m_rows)
        if quant is not None:
            src = _emit_requant(op, i, quant[i]) + src
        units[f"{net_name}_op{i:02d}_{op.kind}.c"] = banner + header + src
    return units


def validate_kernel_source(src: str) -> bool:
    """Structural check: every paper intrinsic present, modulo guard on
    every RAM access, free-after-last-read ordering."""
    if not all(name in src for name in INTRINSICS):
        return False
    for op in ("RAMLoad(Pool, WRAP(", "RAMStore(Pool, WRAP(",
               "RAMFree(Pool, WRAP("):
        if op not in src:
            return False
    return src.index("RAMStore") < src.index("RAMFree")
