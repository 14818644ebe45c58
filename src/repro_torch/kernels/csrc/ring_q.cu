// Int8 segment-ring kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Each kernel replaces one Pallas TPU kernel of src/repro/kernels/quantized.py
// or src/repro/kernels/stream.py:
//
//   ring_gemm_q        <- ring_gemm_q        (quantized.py:87)   ring FC
//   ring_conv_pw_q     <- ring_conv_pw_q     (quantized.py:196)  1x1 conv
//   ring_conv_dw_q     <- ring_conv_dw_q     (quantized.py:310)  depthwise rs x rs conv
//   ring_conv_k2d_q    <- ring_conv_k2d_q    (quantized.py:419)  k x k conv
//   ring_add_q         <- ring_add_q         (quantized.py:515)  residual add
//   ring_avgpool_q     <- ring_avgpool_q     (quantized.py:603)  global average pool
//   ring_conv_stream_q <- ring_conv_stream_q (stream.py:235)     streaming k x k conv
//   ring_gru_cell_q    <- ring_gru_cell_q    (stream.py:417)     int8 GRU cell
//
// The pool is one int8 tensor [n_seg, 128]: a tensor of c-wide rows takes
// ceil(c / 128) consecutive segments per row, and every segment address is
// taken modulo n_seg.  Every op reads its input rows from the ring and writes
// its output rows into the same ring, often over input rows it has already
// consumed (a depthwise op stores output row p onto input row p - 1, which
// output rows p - 2 and p - 1 still read).  The plan is certified clobber-free
// only for the order of the TPU's sequential grid: no store of step i may move
// ahead of a read of an earlier step, so in that order every read of an op
// sees the pool as it was before the op.  A kernel keeps that in one of two
// ways: it reads all of the op before it stores anything (in one CTA, or over
// many CTAs with a grid barrier between), or, the residual add where no
// output row lands on an operand row of another index, it stores each word
// right after the same thread read it.
//
// The 1x1, depthwise, k x k and streaming convs (ring_conv_pw_q,
// ring_conv_dw_q, ring_conv_k2d_q, ring_conv_stream_q) read EVERYTHING
// before they store anything, over many CTAs in one cooperative launch: each
// CTA stages what its tile of output rows x output channels reads (the
// stream also its share of the window rows), computes its outputs into
// shared memory, meets every other CTA at one grid-wide barrier, then stores
// (see their section below).  What bounds them is the floor of that launch
// and its barrier, not bytes or MACs; their products (__dp4a for the 1x1, k x
// k and streaming convs, scalar for the depthwise) are bitwise the
// reference's wrapping int32 sums.
//
// The FC (ring_gemm_q) reads first too, with __dp4a products: in one CTA and
// an ordinary launch where its tiling gives one (every plan's head and
// ToyADMOS's 128-wide layers), else over many CTAs in one cooperative launch
// with one grid barrier (see its section).
//
// The residual add (ring_add_q) maps its rows over many CTAs: where no
// output row lands on an operand row of another index (every plan's add) a
// thread reads a 32-bit word of row t and stores that word of out row t,
// with no barrier, in an ordinary launch; elsewhere it reads first, as the
// convs do (see its section).
//
// The average pool (ring_avgpool_q) is one CTA in an ordinary launch: every
// thread stages 16-byte vectors of the pixels, then sums one channel of a
// share of them; after a __syncthreads (every read of the op is done) a
// thread a channel adds the shares, requantizes and stores, the row landing
// on the input's pixel 0 in every plan.  The GRU cell (ring_gru_cell_q)
// stages x, h and its columns of W and U, then computes its gates with
// __dp4a: in one CTA and an ordinary launch, or over channel tiles in one
// cooperative launch with one grid barrier before any CTA stores h' (which
// lands on h, and in place on x).  No int8 kernel walks an op in one block.
// Channel tails (c .. segs(c) * 128) are stored as zeros.
//
// The Python wrappers (kernels/quantized.py, kernels/stream.py) size shared
// memory: they pass the read-first kernels' tilings (conv2d.py::conv_tiling,
// quantized.py::gemm_q_tiling, stream.py::gru_q_tiling), the add's mode and
// rows a CTA and the pool's pixels a chunk (quantized.py::pool_q_tiling),
// and the entry points below only turn those into the launch's byte count.
//
// Requantization is the reference's (src/repro/quant/requant.py): the exact
// 64-bit product acc * mult, one round-to-nearest-even at 31 - shift,
// saturation to int32, a clip to +-2**24, then a clip to int8.  The int32
// accumulator wraps on overflow as the reference's int32 arithmetic does, and
// so do the residual add's sum and the GRU's gx + bias (summed in uint32).
//
// The streaming kernels keep persistent state in the ring, above the frame
// program's extent (it never wraps).  ring_conv_stream_q reads its window
// rows and the new frame's before any CTA writes anything: the shifted window
// goes back to the state region as raw segments, then the output rows, which
// may land on the frame's rows.  ring_gru_cell_q reads x and h before it
// stores h' to the state and to the chained output (across the grid
// barrier in its tile mode).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int SEG = 128;              // bytes per int8 segment
constexpr int VEC = SEG / 16;         // 16-byte vectors per segment
constexpr long long I24 = 1LL << 24;
constexpr long long I32_MIN = -2147483648LL;
constexpr long long I32_MAX = 2147483647LL;

__host__ __device__ __forceinline__ int segs_for(int c) {
  return (c + SEG - 1) / SEG;
}

__device__ __forceinline__ int32_t requant_i32(int32_t acc, int32_t mult,
                                               int32_t shift) {
  const long long p = (long long)acc * (long long)mult;
  int s = 31 - shift;
  s = s < 1 ? 1 : (s > 62 ? 62 : s);
  const long long half = 1LL << (s - 1);
  long long q = (p + half) >> s;                      // arithmetic: floor
  if ((p & ((1LL << s) - 1)) == half && (q & 1)) q -= 1;  // ties to even
  q = q < I32_MIN ? I32_MIN : (q > I32_MAX ? I32_MAX : q);
  q = q < -I24 ? -I24 : (q > I24 ? I24 : q);
  return (int32_t)q;
}

__device__ __forceinline__ int8_t sat8(int32_t v) {
  return (int8_t)(v < -128 ? -128 : (v > 127 ? 127 : v));
}

// int32 accumulator (wrapping) + bias -> relu? -> requantize -> int8
__device__ __forceinline__ int8_t epilogue(uint32_t acc, int32_t bias,
                                           int32_t mult, int32_t shift,
                                           int relu) {
  int32_t a = (int32_t)(acc + (uint32_t)bias);
  if (relu && a < 0) a = 0;
  return sat8(requant_i32(a, mult, shift));
}

// ---------------------------------------------------------------------------
// 1x1, depthwise, k x k and streaming convs that read first, over many CTAs
// in one cooperative launch.  CTA i owns tile i of conv2d.py::conv_tiling
// (kinds ring_conv_pw_q, ring_conv_dw_q, ring_conv_k2d_q,
// ring_conv_stream_q): output rows p0 .. p0 +
// np - 1 (fewer in the last row block) x output channels c0 .. c0 + cn - 1,
// channel tiles fastest.  It
//   (a) stages, with 16-byte cp.async copies all in flight at once, what
//       its taps reach: the k x k and depthwise convs' input rows lo .. lo
//       + nh - 1 (the depthwise conv only its channel tile of each pixel),
//       the 1x1 conv the source pixel of each of its outputs (p * stride,
//       or the nearest-grid pick when resampling); and, with plain loads,
//       its weight slice (the 1x1 and k x k convs' transposed, STAGE_WORDS
//       words a thread in flight) and its bias, mult and shift; then
//       computes every output of its tile into shared memory as int8,
//       storing nothing;
//   (b) meets every other CTA at the grid barrier;
//   (c) stores its outputs as 32-bit words, and the last channel tile the
//       channel tail as zeros.
// A certified plan never stores onto a segment that a later step of the op
// still reads, so every read of the sequential walk sees the pool from
// before the op; so does every read here, and each output lands where the
// walk puts it: the final pool is the walk's, in place too.
//
// Products: a staged pixel keeps its first c_in bytes in whole 16-byte
// chunks (`chunks`), at a pitch of an odd number of chunks (`pitch`, so
// that the 16-byte shared loads of neighbouring pixels and channels fall in
// different banks); channel c0 + co's weights at a tap are `pitch`
// consecutive bytes, input channels in order, zero from c_in on.  A thread
// (x over the tile's channels, y over its pixels) reads a chunk of pixel
// and of weights and takes four __dp4a, so a 16-channel tap is 4 dp4a and
// DS-CNN's 1-channel stem costs a 16-byte chunk a tap (the 15 bytes past
// c_in, whatever the pool holds there, meet zero weights).  __dp4a adds in
// 32-bit modular arithmetic and a sum mod 2**32 is the same in any order,
// so the accumulator is bitwise the reference's wrapping int32 one.
//
// What bounds them: not bytes (ResNet-8's 3x3 convs move 36-150 KB, tens of
// ns at 3.35 TB/s) nor operations (its largest is 2.26 M multiply-adds at
// in-image taps: over 128 CTAs of 512 threads about 9 dp4a a thread), but
// the floor of a cooperative launch and its grid barrier, about 4.5 us
// (PERF.md).  So the products stay on the CUDA cores: tensor cores
// (mma.sync s8) would cut nothing that shows above that floor.
// ---------------------------------------------------------------------------
constexpr int CONV_THREADS = 512;   // threads of a read-first conv CTA
constexpr int STAGE_WORDS = 4;      // weight words a thread loads at once

struct ConvTile {
  int p0, np, c0, cn, lo, nh;
};

// The tile of CTA blockIdx.x (conv2d.py::ConvTiling.tile): output rows
// p0 .. p0 + np - 1, channels c0 .. c0 + cn - 1, and the input rows
// lo .. lo + nh - 1 inside the image that its taps reach.
__device__ __forceinline__ ConvTile conv_tile(int h_in, int h_out, int c,
                                              int k, int stride, int pad_v,
                                              int rows, int ctile) {
  const int n_ct = (c + ctile - 1) / ctile;
  const int rb = blockIdx.x / n_ct, cb = blockIdx.x - rb * n_ct;
  ConvTile t;
  t.p0 = rb * rows;
  t.np = min(rows, h_out - t.p0);
  t.c0 = cb * ctile;
  t.cn = min(ctile, c - t.c0);
  const int top = t.p0 * stride - pad_v;
  t.lo = max(0, top);
  t.nh = max(0, min(h_in - 1, top + (t.np - 1) * stride + k - 1) - t.lo + 1);
  return t;
}

// A staged pixel's (and a channel's weights') 16-byte chunks: ceil(c_in /
// 16), made odd (conv2d.py::q_pixel_pitch).
__host__ __device__ __forceinline__ int q_pitch(int c_in) {
  return ((c_in + 15) / 16) | 1;
}

__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ int round4(int n) {
  return (n + 3) / 4 * 4;
}

// A read-first int8 conv CTA's shared memory, byte offsets
// (conv2d.py::_conv_smem_q): the staged pixels [pixels, px_bytes] from 0,
// the held outputs [rows * w_out, ctile] int8, bias, mult and shift [3,
// ctile] int32, the weight slice (w_bytes, a multiple of 16), the ring
// segment of each output row [rows].
struct ConvQSmem {
  int y, prm, w, out_row, bytes;
};

__host__ __device__ __forceinline__ ConvQSmem conv_q_layout(
    int pixels, int px_bytes, int rows, int w_out, int ctile, int w_bytes) {
  ConvQSmem m;
  m.y = pixels * px_bytes;
  m.prm = m.y + round16(rows * w_out * ctile);
  m.w = m.prm + round16(12 * ctile);
  m.out_row = m.w + w_bytes;
  m.bytes = m.out_row + 4 * rows;
  return m;
}

// The 1x1 and k x k convs' layout: a staged pixel and a channel's weights
// at a tap take `pitch` 16-byte chunks.
__host__ __device__ __forceinline__ ConvQSmem conv_q_layout_dense(
    int pixels, int pitch, int rows, int w_out, int ctile, int taps) {
  return conv_q_layout(pixels, pitch * 16, rows, w_out, ctile,
                       taps * ctile * pitch * 16);
}

// The depthwise conv's layout: a staged pixel keeps its channel tile in
// whole 16-byte chunks, and the weight slice [rs * rs, round4(ctile)] each
// tap's channels in whole 32-bit words.
__host__ __device__ __forceinline__ ConvQSmem conv_dw_q_layout(
    int rows, int stride, int rs, int w_in, int w_out, int ctile) {
  return conv_q_layout(((rows - 1) * stride + rs) * w_in, round16(ctile),
                       rows, w_out, ctile, round16(rs * rs * round4(ctile)));
}

// Asynchronous 16-byte copy from global to shared memory (sm_80 and later):
// a thread issues all of its copies before it waits on any.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int conv_tid() {
  return threadIdx.y * blockDim.x + threadIdx.x;
}

// Stage tile t's bias, mult and shift and the ring segment of each of its
// output rows (one modulo a row: a row never wraps, the wrappers require
// the pool and the pointers aligned to whole rows).
__device__ __forceinline__ void stage_q_consts(
    const ConvTile& t, const ConvQSmem& m, char* smem,
    const int32_t* __restrict__ b, const int32_t* __restrict__ mult,
    const int32_t* __restrict__ shift, int ctile, int n_seg, int out_ptr,
    int out_seg) {
  const int tid = conv_tid(), nthr = blockDim.x * blockDim.y;
  int32_t* prm = reinterpret_cast<int32_t*>(smem + m.prm);
  for (int i = tid; i < t.cn; i += nthr) {
    prm[i] = b[t.c0 + i];
    prm[ctile + i] = mult[t.c0 + i];
    prm[2 * ctile + i] = shift[t.c0 + i];
  }
  int* out_row = reinterpret_cast<int*>(smem + m.out_row);
  for (int i = tid; i < t.np; i += nthr)
    out_row[i] = (out_ptr + (t.p0 + i) * out_seg) % n_seg;
}

// Tile t's weight slice of w [taps, c_in, c_out], transposed to [taps,
// ctile, pitch chunks] with zeros past c_in (and for channels past the
// tile's cn), byte by byte.
__device__ __forceinline__ void stage_q_weights(
    const ConvTile& t, const ConvQSmem& m, char* smem,
    const int8_t* __restrict__ w, int taps, int c_in, int c_out, int ctile,
    int pitch) {
  const int tid = conv_tid(), nthr = blockDim.x * blockDim.y;
  // word j of channel co at tap r; co fastest, so a warp reads runs of a
  // weight row.  A thread loads STAGE_WORDS words before it stores any, so
  // that their loads are in flight together (a plan's slice is at most
  // about four words a thread).
  const int words = 4 * pitch, total = taps * words * ctile;
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem + m.w);
  for (int i0 = tid; i0 < total; i0 += STAGE_WORDS * nthr) {
    uint32_t word[STAGE_WORDS];
#pragma unroll
    for (int u = 0; u < STAGE_WORDS; ++u) {
      const int i = i0 + u * nthr;
      const int co = i % ctile, rest = i / ctile;
      const int j = rest % words, r = rest / words;
      word[u] = 0;
      if (i < total && co < t.cn)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ci = 4 * j + k;
          if (ci < c_in)
            word[u] |= (uint32_t)(uint8_t)w[((size_t)r * c_in + ci) * c_out +
                                            t.c0 + co] << (8 * k);
        }
    }
#pragma unroll
    for (int u = 0; u < STAGE_WORDS; ++u) {
      const int i = i0 + u * nthr;
      if (i < total) {
        const int co = i % ctile, rest = i / ctile;
        ws[(rest / words * ctile + co) * words + rest % words] = word[u];
      }
    }
  }
}

// stage_q_consts, then stage_q_weights.
__device__ __forceinline__ void stage_q_tile(
    const ConvTile& t, const ConvQSmem& m, char* smem,
    const int8_t* __restrict__ w, const int32_t* __restrict__ b,
    const int32_t* __restrict__ mult, const int32_t* __restrict__ shift,
    int taps, int c_in, int c_out, int ctile, int pitch, int n_seg,
    int out_ptr, int out_seg) {
  stage_q_consts(t, m, smem, b, mult, shift, ctile, n_seg, out_ptr, out_seg);
  stage_q_weights(t, m, smem, w, taps, c_in, c_out, ctile, pitch);
}

// The int32 (wrapping) dot product of chunks first, first + step, ... <
// chunks of x and w (a staged pixel, or row, and a channel's weights at one
// tap), 16 bytes each: four independent dp4a chains, summed mod 2**32.
__device__ __forceinline__ uint32_t dot_q(const int4* x, const int4* w,
                                          int first, int chunks, int step) {
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  for (int c = first; c < chunks; c += step) {
    const int4 u = x[c], v = w[c];
    a0 = __dp4a(u.x, v.x, a0);
    a1 = __dp4a(u.y, v.y, a1);
    a2 = __dp4a(u.z, v.z, a2);
    a3 = __dp4a(u.w, v.w, a3);
  }
  return (uint32_t)a0 + (uint32_t)a1 + (uint32_t)a2 + (uint32_t)a3;
}

// (c) Store the tile's held outputs y [np * w_out, ctile] over lanes c0 ..
// end of each output pixel as 32-bit words (c0 is 0 or a multiple of a
// channel tile of 4 to 32, or of a segment for the depthwise conv, and end
// a multiple of 4), zeros from channel c on: the last channel tile also
// stores the pixel's channel tail, up to osegs * SEG.
__device__ __forceinline__ void store_q_tile(int8_t* pool, const ConvTile& t,
                                             const int8_t* y,
                                             const int* out_row, int w_out,
                                             int c, int osegs, int ctile) {
  const int end = t.c0 + ctile >= c ? osegs * SEG : t.c0 + ctile;
  const int words = (end - t.c0) / 4;
  const int nthr = blockDim.x * blockDim.y;
  for (int i = conv_tid(); i < t.np * w_out * words; i += nthr) {
    const int px = i / words, wd = i - px * words;
    const int pl = px / w_out, q = px - pl * w_out;
    uint32_t v = 0;
    for (int k = 0; k < 4; ++k) {
      const int lane = t.c0 + 4 * wd + k;
      if (lane < c)
        v |= (uint32_t)(uint8_t)y[px * ctile + lane - t.c0] << (8 * k);
    }
    int8_t* dst = pool + ((size_t)out_row[pl] + (size_t)q * osegs) * SEG;
    reinterpret_cast<uint32_t*>(dst + t.c0)[wd] = v;
  }
}

// The ring segment of image row r of a run of rows `row_segs` segments long
// that starts at ring segment `ptr`: one modulo per row (a row never wraps:
// the wrappers require the pool and the pointers aligned to whole rows).
struct RunRows {
  int ptr, row_segs, n_seg;
  __device__ __forceinline__ int operator()(int r) const {
    return (ptr + r * row_segs) % n_seg;
  }
};

// The ring segment of row r of a streaming conv's shifted window: the first
// `keep` rows are old state rows r + hop at state_ptr, the rest the frame's
// rows at in_ptr, `wc` segments each (neither region wraps the ring).
struct WindowRows {
  int state_ptr, in_ptr, keep, hop, wc;
  __device__ __forceinline__ int operator()(int r) const {
    return r < keep ? state_ptr + (r + hop) * wc : in_ptr + (r - keep) * wc;
  }
};

// (a) Stage the first `chunks` 16-byte chunks of each pixel of image rows
// lo .. lo + n - 1 (w_in pixels of ksegs segments each; `seg` maps an image
// row to its ring segment) into x at `pitch` chunks a pixel, as cp.async
// copies all in flight at once.
template <typename Rows>
__device__ __forceinline__ void stage_q_rows(int4* x, const int8_t* pool,
                                             Rows seg, int lo, int n,
                                             int w_in, int ksegs, int pitch,
                                             int chunks) {
  const int nthr = blockDim.x * blockDim.y;
  for (int i = conv_tid(); i < n * w_in * chunks; i += nthr) {
    const int pix = i / chunks, c = i - pix * chunks;
    const int hr = pix / w_in, px = pix - hr * w_in;
    cp_async16(x + pix * pitch + c,
               pool + ((size_t)seg(lo + hr) + px * ksegs) * SEG + 16 * c);
  }
}

// (a) of the k x k convs: every output of tile t into y [np * w_out, ctile]
// as int8, from the staged input rows x (image rows t.lo ..) and the
// transposed weight slice ws.  Each output sums its in-image taps,
// row-major (sums mod 2**32 do not depend on the order).
__device__ __forceinline__ void k2d_q_outputs(
    int8_t* y, const int4* x, const int4* ws, const int32_t* prm,
    const ConvTile& t, int h_in, int w_in, int w_out, int k, int stride,
    int pad_v, int pad_h, int pitch, int chunks, int ctile, int relu) {
  const int co = threadIdx.x;
  if (co >= t.cn) return;
  const int4* wc = ws + co * pitch;
  for (int j = threadIdx.y; j < t.np * w_out; j += blockDim.y) {
    const int pl = j / w_out, q = j - pl * w_out;
    const int top = (t.p0 + pl) * stride - pad_v, left = q * stride - pad_h;
    // the in-image taps: rows r0 .. r1 - 1, columns s0 .. s1 - 1
    const int r0 = max(0, -top), r1 = min(k, h_in - top);
    const int s0 = max(0, -left), s1 = min(k, w_in - left);
    uint32_t acc = 0;
    for (int r = r0; r < r1; ++r) {
      const int4* xrow = x + (top + r - t.lo) * w_in * pitch;
      const int4* wr = wc + r * k * ctile * pitch;
      for (int s = s0; s < s1; ++s)
        acc += dot_q(xrow + (left + s) * pitch, wr + s * ctile * pitch, 0,
                     chunks, 1);
    }
    y[j * ctile + co] =
        epilogue(acc, prm[co], prm[ctile + co], prm[2 * ctile + co], relu);
  }
}

// k x k conv: w [k, k, c_in, c_out].  A CTA stages the input rows its taps
// reach ((rows - 1) * stride + k at most), then k2d_q_outputs.
__global__ void __launch_bounds__(CONV_THREADS)
conv_k2d_q_kernel(int8_t* pool, const int8_t* __restrict__ w,
                  const int32_t* __restrict__ b,
                  const int32_t* __restrict__ mult,
                  const int32_t* __restrict__ shift, int n_seg, int h_in,
                  int w_in, int h_out, int w_out, int c_in, int c_out, int k,
                  int stride, int pad_v, int pad_h, int in_ptr, int out_ptr,
                  int relu, int rows, int ctile) {
  extern __shared__ int4 qsmem[];
  char* smem = reinterpret_cast<char*>(qsmem);
  const int ksegs = segs_for(c_in), nsegs = segs_for(c_out);
  const int pitch = q_pitch(c_in), chunks = (c_in + 15) / 16;
  const ConvTile t = conv_tile(h_in, h_out, c_out, k, stride, pad_v, rows,
                               ctile);
  const ConvQSmem m = conv_q_layout_dense(((rows - 1) * stride + k) * w_in,
                                          pitch, rows, w_out, ctile, k * k);
  stage_q_rows(qsmem, pool, RunRows{in_ptr, w_in * ksegs, n_seg}, t.lo, t.nh,
               w_in, ksegs, pitch, chunks);
  stage_q_tile(t, m, smem, w, b, mult, shift, k * k, c_in, c_out, ctile,
               pitch, n_seg, out_ptr, w_out * nsegs);
  cp_async_wait_all();
  __syncthreads();
  int8_t* y = reinterpret_cast<int8_t*>(smem + m.y);
  k2d_q_outputs(y, qsmem, reinterpret_cast<const int4*>(smem + m.w),
                reinterpret_cast<const int32_t*>(smem + m.prm), t, h_in,
                w_in, w_out, k, stride, pad_v, pad_h, pitch, chunks, ctile,
                relu);
  cg::this_grid().sync();   // (b): every read of the op is done
  store_q_tile(pool, t, y, reinterpret_cast<const int*>(smem + m.out_row),
               w_out, c_out, nsegs, ctile);
}

// Streaming k x k conv: the [h_win, w_in, c_in] window at state_ptr drops
// its oldest `hop` image rows and appends the frame at in_ptr; the window
// goes back to state_ptr as an exact copy of its raw segments (channel tails
// and all, as the reference copies them), and the k x k conv over it is
// stored at out_ptr (modulo n_seg).  Tiled as the k x k conv (conv_tile with
// h_in = h_win, kind ring_conv_stream_q of conv2d.py::conv_tiling); CTA i
// also owns window rows i * win_rows .. of the writeback.  It
//   (a) stages the window rows its taps reach, each from its source (old
//       state or frame: WindowRows), as the k x k conv stages its halo, and
//       its own window rows as whole segments, then computes its outputs
//       into shared memory (k2d_q_outputs), storing nothing;
//   (b) meets every other CTA at the grid barrier: the writeback moves each
//       row by `hop` onto a row that another CTA's taps read;
//   (c) stores its window rows at state_ptr as 16-byte vectors, then its
//       outputs.
// The reference stores the window before the outputs, so where the output
// run overlaps the window region the output wins; the wrapper then passes
// `out_over_window` and a second grid barrier orders the two kinds of store
// (no committed plan has that overlap: the state lies above the frame
// program's extent).
//
// What bounds it: bytes (DS-CNN's 49 x 10 x 1 window and 25 x 5 x 64 output
// move about 82 KB, 24 ns at 3.35 TB/s); what remains is the cooperative
// launch, one staging round trip and the barrier, as for the k x k conv.

// The streaming conv's layout: the k x k conv's, with the CTA's window rows
// (`win_bytes`, whole segments) after its staged halo pixels, from byte
// `*win`.
__host__ __device__ __forceinline__ ConvQSmem conv_stream_q_layout(
    int rows, int stride, int k, int w_in, int pitch, int w_out, int ctile,
    int win_bytes, int* win) {
  *win = ((rows - 1) * stride + k) * w_in * pitch * 16;
  return conv_q_layout(1, *win + win_bytes, rows, w_out, ctile,
                       k * k * ctile * pitch * 16);
}

__global__ void __launch_bounds__(CONV_THREADS)
conv_stream_q_kernel(int8_t* pool, const int8_t* __restrict__ w,
                     const int32_t* __restrict__ b,
                     const int32_t* __restrict__ mult,
                     const int32_t* __restrict__ shift, int n_seg, int h_win,
                     int w_in, int h_out, int w_out, int c_in, int c_out,
                     int k, int stride, int hop, int pad_v, int pad_h,
                     int in_ptr, int out_ptr, int state_ptr, int relu,
                     int rows, int ctile, int out_over_window,
                     int win_rows) {
  extern __shared__ int4 qsmem[];
  char* smem = reinterpret_cast<char*>(qsmem);
  const int ksegs = segs_for(c_in), nsegs = segs_for(c_out);
  const int pitch = q_pitch(c_in), chunks = (c_in + 15) / 16;
  const int wc = w_in * ksegs;
  const ConvTile t = conv_tile(h_win, h_out, c_out, k, stride, pad_v, rows,
                               ctile);
  int win_at;
  const ConvQSmem m = conv_stream_q_layout(rows, stride, k, w_in, pitch,
                                           w_out, ctile, win_rows * wc * SEG,
                                           &win_at);
  const WindowRows src{state_ptr, in_ptr, h_win - hop, hop, wc};
  stage_q_rows(qsmem, pool, src, t.lo, t.nh, w_in, ksegs, pitch, chunks);
  const int r0 = blockIdx.x * win_rows;
  const int n = max(0, min(win_rows, h_win - r0)) * wc * VEC;  // vectors
  int4* win = reinterpret_cast<int4*>(smem + win_at);
  const int nthr = blockDim.x * blockDim.y;
  for (int i = conv_tid(); i < n; i += nthr) {
    const int r = i / (wc * VEC), v = i - r * wc * VEC;
    cp_async16(win + i, pool + (size_t)src(r0 + r) * SEG + 16 * v);
  }
  stage_q_tile(t, m, smem, w, b, mult, shift, k * k, c_in, c_out, ctile,
               pitch, n_seg, out_ptr, w_out * nsegs);
  cp_async_wait_all();
  __syncthreads();
  int8_t* y = reinterpret_cast<int8_t*>(smem + m.y);
  k2d_q_outputs(y, qsmem, reinterpret_cast<const int4*>(smem + m.w),
                reinterpret_cast<const int32_t*>(smem + m.prm), t, h_win,
                w_in, w_out, k, stride, pad_v, pad_h, pitch, chunks, ctile,
                relu);
  cg::grid_group grid = cg::this_grid();
  grid.sync();   // (b): every read of the op is done
  int4* state = reinterpret_cast<int4*>(pool +
                                        (size_t)(state_ptr + r0 * wc) * SEG);
  for (int i = conv_tid(); i < n; i += nthr) state[i] = win[i];
  if (out_over_window) grid.sync();   // the window's stores first
  store_q_tile(pool, t, y, reinterpret_cast<const int*>(smem + m.out_row),
               w_out, c_out, nsegs, ctile);
}

// 1x1 conv: w [c_in, c_out]; output pixel (p, q) reads source pixel (p *
// stride, q * stride), or (p * h_in / h_out, q * w_in / w_out) when
// resampling (rowsched.resample_src).  Tiled as the k x k conv (conv_tile
// with k = 1; its halo is not used): a CTA stages only the source pixel of
// each of its outputs.
__global__ void __launch_bounds__(CONV_THREADS)
conv_pw_q_kernel(int8_t* pool, const int8_t* __restrict__ w,
                 const int32_t* __restrict__ b,
                 const int32_t* __restrict__ mult,
                 const int32_t* __restrict__ shift, int n_seg, int h_in,
                 int w_in, int h_out, int w_out, int c_in, int c_out,
                 int stride, int resample, int in_ptr, int out_ptr, int relu,
                 int rows, int ctile) {
  extern __shared__ int4 qsmem[];
  char* smem = reinterpret_cast<char*>(qsmem);
  const int ksegs = segs_for(c_in), nsegs = segs_for(c_out);
  const int pitch = q_pitch(c_in), chunks = (c_in + 15) / 16;
  const ConvTile t = conv_tile(h_in, h_out, c_out, 1, stride, 0, rows,
                               ctile);
  const ConvQSmem m = conv_q_layout_dense(rows * w_out, pitch, rows, w_out,
                                          ctile, 1);
  const int nthr = blockDim.x * blockDim.y;
  for (int i = conv_tid(); i < t.np * w_out * chunks; i += nthr) {
    const int pix = i / chunks, c = i - pix * chunks;
    const int p = t.p0 + pix / w_out, q = pix % w_out;
    const int sr = resample ? p * h_in / h_out : p * stride;
    const int sc = resample ? q * w_in / w_out : q * stride;
    const int seg = (in_ptr + (sr * w_in + sc) * ksegs) % n_seg;
    cp_async16(qsmem + pix * pitch + c, pool + (size_t)seg * SEG + 16 * c);
  }
  stage_q_tile(t, m, smem, w, b, mult, shift, 1, c_in, c_out, ctile, pitch,
               n_seg, out_ptr, w_out * nsegs);
  cp_async_wait_all();
  __syncthreads();
  int8_t* y = reinterpret_cast<int8_t*>(smem + m.y);
  const int co = threadIdx.x;
  if (co < t.cn) {
    const int4* wc = reinterpret_cast<const int4*>(smem + m.w) + co * pitch;
    const int32_t* prm = reinterpret_cast<const int32_t*>(smem + m.prm);
    for (int j = threadIdx.y; j < t.np * w_out; j += blockDim.y)
      y[j * ctile + co] = epilogue(dot_q(qsmem + j * pitch, wc, 0, chunks, 1),
                                   prm[co], prm[ctile + co],
                                   prm[2 * ctile + co], relu);
  }
  cg::this_grid().sync();   // (b): every read of the op is done
  store_q_tile(pool, t, y, reinterpret_cast<const int*>(smem + m.out_row),
               w_out, c_out, nsegs, ctile);
}

// Depthwise rs x rs conv: w [rs, rs, c]; channel tiles of min(c, 128), one
// segment each.  A CTA stages its channel tile of each pixel of the input
// rows its taps reach (round16(ctile) bytes a pixel, the 16-byte chunks of
// lanes c0 .. c0 + cn - 1 of the pixel's segment) and its weight slice
// w[r, s, c0 .. c0 + cn - 1] as [rs * rs, round4(ctile)] with zeros past cn
// (a plain copy: a depthwise conv needs no transpose).  A thread owns 4
// consecutive channels of one output pixel, so each in-image tap is one
// 32-bit word of the staged pixel and one of the weights; __dp4a would add
// across the channels, so the four products are scalar int32
// multiply-adds, summed mod 2**32 (bitwise the reference's wrapping sum).
//
// What bounds it: not bytes (VWW's largest op, [20, 20, 48], reads 19 KB
// and stores 51 KB, about 21 ns at 3.35 TB/s) nor operations (its 173 k
// multiply-adds at in-image taps are about 17 a thread over its 20 CTAs of
// 512 threads), but the floor of a cooperative launch and its grid
// barrier, about 4.5 us (PERF.md).
__global__ void __launch_bounds__(CONV_THREADS)
conv_dw_q_kernel(int8_t* pool, const int8_t* __restrict__ w,
                 const int32_t* __restrict__ b,
                 const int32_t* __restrict__ mult,
                 const int32_t* __restrict__ shift, int n_seg, int h_in,
                 int w_in, int h_out, int w_out, int c, int rs, int stride,
                 int pad_v, int pad_h, int in_ptr, int out_ptr, int relu,
                 int rows, int ctile) {
  extern __shared__ int4 qsmem[];
  char* smem = reinterpret_cast<char*>(qsmem);
  const int segs = segs_for(c), px = round16(ctile), wpitch = round4(ctile);
  const ConvTile t = conv_tile(h_in, h_out, c, rs, stride, pad_v, rows,
                               ctile);
  const ConvQSmem m = conv_dw_q_layout(rows, stride, rs, w_in, w_out, ctile);
  const int tid = threadIdx.x;
  const int chunks = (t.cn + 15) / 16;   // c0 is a multiple of a segment
  for (int i = tid; i < t.nh * w_in * chunks; i += CONV_THREADS) {
    const int pix = i / chunks, ch = i - pix * chunks;
    const int hr = pix / w_in, q = pix - hr * w_in;
    const int seg = (in_ptr + (t.lo + hr) * w_in * segs) % n_seg + q * segs +
                    t.c0 / SEG;
    cp_async16(smem + pix * px + 16 * ch, pool + (size_t)seg * SEG + 16 * ch);
  }
  stage_q_consts(t, m, smem, b, mult, shift, ctile, n_seg, out_ptr,
                 w_out * segs);
  int8_t* ws = reinterpret_cast<int8_t*>(smem + m.w);
  for (int i = tid; i < rs * rs * wpitch; i += CONV_THREADS) {
    const int r = i / wpitch, ci = i - r * wpitch;
    ws[i] = ci < t.cn ? w[(size_t)r * c + t.c0 + ci] : (int8_t)0;
  }
  cp_async_wait_all();
  __syncthreads();
  int8_t* y = reinterpret_cast<int8_t*>(smem + m.y);
  const int32_t* prm = reinterpret_cast<const int32_t*>(smem + m.prm);
  const int quads = (t.cn + 3) / 4;
  for (int i = tid; i < t.np * w_out * quads; i += CONV_THREADS) {
    const int j = i / quads, g = i - j * quads;
    const int pl = j / w_out, q = j - pl * w_out;
    const int top = (t.p0 + pl) * stride - pad_v, left = q * stride - pad_h;
    // the in-image taps: rows r0 .. r1 - 1, columns s0 .. s1 - 1
    const int r0 = max(0, -top), r1 = min(rs, h_in - top);
    const int s0 = max(0, -left), s1 = min(rs, w_in - left);
    uint32_t acc[4] = {0, 0, 0, 0};
    for (int r = r0; r < r1; ++r) {
      const char* xrow = smem + (top + r - t.lo) * w_in * px + 4 * g;
      const char* wr = smem + m.w + r * rs * wpitch + 4 * g;
      for (int s = s0; s < s1; ++s) {
        const uint32_t xv =
            *reinterpret_cast<const uint32_t*>(xrow + (left + s) * px);
        const uint32_t wv = *reinterpret_cast<const uint32_t*>(wr + s * wpitch);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[k] += (uint32_t)((int)(int8_t)(xv >> (8 * k)) *
                               (int)(int8_t)(wv >> (8 * k)));
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int co = 4 * g + k;
      if (co < t.cn)
        y[j * ctile + co] = epilogue(acc[k], prm[co], prm[ctile + co],
                                     prm[2 * ctile + co], relu);
    }
  }
  cg::this_grid().sync();   // (b): every read of the op is done
  store_q_tile(pool, t, y, reinterpret_cast<const int*>(smem + m.out_row),
               w_out, c, segs, ctile);
}

// ---------------------------------------------------------------------------
// FC: m_rows rows of d_in channels at in_ptr -> d_out channels at out_ptr,
// w [d_in, d_out], each output an int32 (wrapping) sum, bias, relu? and the
// per-channel requantization.  On every committed plan m_rows is 1 and the
// op is in place (its output run overlaps its input run) but ToyADMOS's
// last layer.  CTA i owns tile i of quantized.py::gemm_q_tiling: rows r0 ..
// r0 + nr - 1 x output columns c0 .. c0 + cn - 1, column tiles fastest,
// which is a 1x1 conv's tile over an image of m_rows one-pixel rows, so its
// shared memory and its stores are the convs' (conv_q_layout_dense,
// store_q_tile).  It
//   (a) stages its rows' first ceil(d_in / 16) 16-byte chunks and its
//       bias, mult and shift (cp.async), and its weight slice transposed to
//       [ctile, pitch] with zeros from d_in on (the bytes of a row past d_in
//       meet zero weights): from 32-bit words transposed in registers where
//       d_out is a multiple of 4 (every plan FC but ResNet-8's and VWW's
//       heads), else byte by byte (stage_q_weights); then computes its
//       outputs into shared memory as int8, storing nothing;
//   (b) meets the other threads of its CTA (one CTA, an ordinary launch:
//       the tiling's rule for a small op, exact for any overlap) or every
//       CTA at the grid barrier (BARRIER, a cooperative launch);
//   (c) stores its outputs as 32-bit words, the last column tile the
//       channel tail as zeros.
// Products: `ks` lanes of one warp (a power of two up to 32, as many as the
// CTA's threads allow, at most the chunks) share an output; lane j takes
// chunks j, j + ks, ... (16 bytes of x and of w, four __dp4a each), and the
// lanes' partials are summed with shuffles.  Any split of k is exact: a sum
// mod 2**32 is the same in any order, so the accumulator is bitwise the
// reference's wrapping int32 one.
//
// What bounds it: bytes (ToyADMOS's 640 -> 128 layer moves 83 KB, 25 ns
// at 3.35 TB/s); what remains is the launch (and, with BARRIER, the
// barrier) and one staging round trip of the weight slice.
constexpr int GEMM_Q_THREADS = 512;   // quantized.py::GEMM_Q_THREADS

// Asynchronous 4-byte copy from global to shared memory.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// stage_q_consts with cp.async copies: the threads that copy the constants
// do not wait on them before their weight loads are in flight: one global
// round trip fewer, 0.1-0.4 us a launch on every plan FC on an H100
// (tools/chip_ab.py, PERF.md §6).
__device__ __forceinline__ void stage_gemm_consts(
    const ConvTile& t, const ConvQSmem& m, char* smem,
    const int32_t* __restrict__ b, const int32_t* __restrict__ mult,
    const int32_t* __restrict__ shift, int ctile, int n_seg, int out_ptr,
    int out_seg) {
  int32_t* prm = reinterpret_cast<int32_t*>(smem + m.prm);
  for (int i = threadIdx.x; i < t.cn; i += blockDim.x) {
    cp_async4(prm + i, b + t.c0 + i);
    cp_async4(prm + ctile + i, mult + t.c0 + i);
    cp_async4(prm + 2 * ctile + i, shift + t.c0 + i);
  }
  int* out_row = reinterpret_cast<int*>(smem + m.out_row);
  for (int i = threadIdx.x; i < t.np; i += blockDim.x)
    out_row[i] = (out_ptr + (t.p0 + i) * out_seg) % n_seg;
}

constexpr int GEMM_ITEMS = 4;   // weight items a thread loads at once

// A 4 x 4 block of bytes transposed in registers: byte c of row word
// r[kk] becomes byte kk of column word col[c].
__device__ __forceinline__ void transpose4(const uint32_t* r, uint32_t* col) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  col[0] = __byte_perm(lo01, lo23, 0x5410);
  col[1] = __byte_perm(lo01, lo23, 0x7632);
  col[2] = __byte_perm(hi01, hi23, 0x5410);
  col[3] = __byte_perm(hi01, hi23, 0x7632);
}

// The weight slice as stage_q_weights lays it out ([ctile, pitch chunks],
// zeros from d_in on), from 32-bit words where d_out is a multiple of 4
// and w is 4-byte aligned: an item is rows 4j .. 4j + 3 x columns c0 + 4q
// .. c0 + 4q + 3, four word loads transposed in registers into word j of
// each of the four columns.  Items run 16 values of j fastest, then q,
// then blocks of 16 j: a column's words lie `words` = 4 * pitch apart,
// and 4 * words is 16 mod 32 (pitch is odd), so the two quads x 16 words
// of a warp's stores fall in 32 distinct banks (with q fastest, all 32
// fell in two).  A thread loads GEMM_ITEMS items before it stores any.
__device__ __forceinline__ void stage_gemm_quads(const ConvTile& t,
                                                 const ConvQSmem& m,
                                                 char* smem,
                                                 const int8_t* __restrict__ w,
                                                 int d_in, int d_out,
                                                 int pitch) {
  const int words = 4 * pitch, quads = (t.cn + 3) / 4;
  const int total = (words + 15) / 16 * 16 * quads;
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(w) + t.c0 / 4;
  const int ld = d_out / 4;
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem + m.w);
  for (int i0 = threadIdx.x; i0 < total; i0 += GEMM_ITEMS * blockDim.x) {
    uint32_t r[GEMM_ITEMS][4];
#pragma unroll
    for (int u = 0; u < GEMM_ITEMS; ++u) {
      const int i = i0 + u * blockDim.x, rest = i / 16;
      const int q = rest % quads, j = rest / quads * 16 + i % 16;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = 4 * j + kk;
        r[u][kk] = i < total && k < d_in ? __ldg(w32 + (size_t)k * ld + q) : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < GEMM_ITEMS; ++u) {
      const int i = i0 + u * blockDim.x, rest = i / 16;
      const int q = rest % quads, j = rest / quads * 16 + i % 16;
      if (i >= total || j >= words) continue;
      uint32_t col[4];
      transpose4(r[u], col);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * q + c < t.cn) ws[(4 * q + c) * words + j] = col[c];
    }
  }
}

template <bool BARRIER>
__global__ void __launch_bounds__(GEMM_Q_THREADS)
gemm_q_kernel(int8_t* pool, const int8_t* __restrict__ w,
              const int32_t* __restrict__ b, const int32_t* __restrict__ mult,
              const int32_t* __restrict__ shift, int n_seg, int m_rows,
              int d_in, int d_out, int in_ptr, int out_ptr, int relu,
              int rows, int ctile) {
  extern __shared__ int4 qsmem[];
  char* smem = reinterpret_cast<char*>(qsmem);
  const int ksegs = segs_for(d_in), nsegs = segs_for(d_out);
  const int pitch = q_pitch(d_in), chunks = (d_in + 15) / 16;
  const ConvTile t = conv_tile(m_rows, m_rows, d_out, 1, 1, 0, rows, ctile);
  const ConvQSmem m = conv_q_layout_dense(rows, pitch, rows, 1, ctile, 1);
  stage_q_rows(qsmem, pool, RunRows{in_ptr, ksegs, n_seg}, t.p0, t.np, 1,
               ksegs, pitch, chunks);
  stage_gemm_consts(t, m, smem, b, mult, shift, ctile, n_seg, out_ptr,
                    nsegs);
  if (d_out % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 3) == 0)
    stage_gemm_quads(t, m, smem, w, d_in, d_out, pitch);
  else
    stage_q_weights(t, m, smem, w, 1, d_in, d_out, ctile, pitch);
  cp_async_wait_all();
  __syncthreads();
  int8_t* y = reinterpret_cast<int8_t*>(smem + m.y);
  const int4* ws = reinterpret_cast<const int4*>(smem + m.w);
  const int32_t* prm = reinterpret_cast<const int32_t*>(smem + m.prm);
  const int n_out = t.np * t.cn;
  int ks = 1;
  while (ks < 32 && 2 * ks <= chunks && 2 * ks * n_out <= GEMM_Q_THREADS)
    ks *= 2;
  const int lane = threadIdx.x % ks, per = GEMM_Q_THREADS / ks;
  // every thread runs every pass (base is the same for all), so each
  // shuffle meets the whole warp
  for (int base = 0; base < n_out; base += per) {
    const int o = base + threadIdx.x / ks;
    const int r = o / t.cn, co = o - r * t.cn;
    uint32_t acc = 0;
    if (o < n_out)
      acc = dot_q(qsmem + r * pitch, ws + co * pitch, lane, chunks, ks);
    for (int off = ks / 2; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (o < n_out && lane == 0)
      y[r * ctile + co] =
          epilogue(acc, prm[co], prm[ctile + co], prm[2 * ctile + co], relu);
  }
  if constexpr (BARRIER)
    cg::this_grid().sync();   // (b): every read of the op is done
  else
    __syncthreads();          // (b): one CTA, every read of the op is done
  store_q_tile(pool, t, y, reinterpret_cast<const int*>(smem + m.out_row), 1,
               d_out, nsegs, ctile);
}

// ---------------------------------------------------------------------------
// Residual add: `rows` pixel rows of d channels (`chunk` segments each) at
// in_ptr and at aux_ptr, each requantized to the output scale, summed
// (wrapping), relu'd, clipped to int8 and stored at out_ptr as whole
// segments (channel tails zero), often in place.  CTA i owns rows i *
// tile_rows .. (fewer in the last block); a thread takes one 32-bit word
// (4 lanes) of one row at a time: it reads that word of both operands
// (nothing past d) and computes its lanes.  A word and not a 16-byte
// vector: what a thread costs is its chain of requantizations (a 64-bit
// product and a rounding each, two a lane), 8 for a word and 32 for a
// vector, not its bytes.
//   READ_FIRST false, an ordinary launch (quantized.py::add_needs_barrier
//   is False: every plan's add, in place): the thread stores the word of
//   out row t at once.  No output row lands on an operand row of another
//   index, and where out row t lies on row t of an operand this same thread
//   read that word first, so the op is exact with no barrier
//   (quantized.py::add_map_rows gives each thread one word).
//   READ_FIRST true, one cooperative launch over conv2d.py::add_tiling's
//   row blocks (an op that stores row t onto an operand row t - 1): the
//   thread holds the live lanes in shared memory as int8 ([tile_rows, d]),
//   every CTA meets the grid barrier, then each stores its rows as whole
//   segments, a word a thread.
// Bound by its bytes (ResNet-8's first add reads 32 KB and stores 128 KB,
// about 49 ns at 3.35 TB/s); what remains is the launch (and the barrier).
// ---------------------------------------------------------------------------
constexpr int ADD_THREADS = 256;   // quantized.py::ADD_THREADS
constexpr int WORDS = SEG / 4;     // 32-bit words per segment

struct AddQ {
  int mult_in, shift_in, mult_aux, shift_aux, relu;
};

// Lanes 0 .. 3 of two operand words (the first `live` of them; the rest
// zero): requantized, summed mod 2**32, relu'd, clipped to int8.
__device__ __forceinline__ uint32_t add_word(uint32_t x, uint32_t r,
                                             int live, const AddQ& q) {
  uint32_t y = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < live) {
      const uint32_t sum =
          (uint32_t)requant_i32((int8_t)(x >> (8 * k)), q.mult_in,
                                q.shift_in) +
          (uint32_t)requant_i32((int8_t)(r >> (8 * k)), q.mult_aux,
                                q.shift_aux);
      int32_t a = (int32_t)sum;
      if (q.relu && a < 0) a = 0;
      y |= (uint32_t)(uint8_t)sat8(a) << (8 * k);
    }
  }
  return y;
}

// Word v of the row that starts `row` segments into the run at ring
// segment `ptr` (one modulo: a row never wraps, the wrappers require the
// pool and the pointers aligned to whole rows).
__device__ __forceinline__ uint32_t* row_word(int8_t* pool, int ptr,
                                              int row, int v, int n_seg) {
  return reinterpret_cast<uint32_t*>(pool +
                                     (size_t)((ptr + row) % n_seg) * SEG) +
         v;
}

template <bool READ_FIRST>
__global__ void __launch_bounds__(ADD_THREADS)
add_q_kernel(int8_t* pool, int n_seg, int rows, int d, int in_ptr,
             int aux_ptr, int out_ptr, int mult_in, int shift_in,
             int mult_aux, int shift_aux, int relu, int tile_rows) {
  extern __shared__ int4 qsmem[];
  int8_t* y = reinterpret_cast<int8_t*>(qsmem);   // [tile_rows, d]
  const AddQ q{mult_in, shift_in, mult_aux, shift_aux, relu};
  const int chunk = segs_for(d), words = chunk * WORDS;   // words a row
  const int r0 = blockIdx.x * tile_rows, n = min(tile_rows, rows - r0);
  for (int i = threadIdx.x; i < n * words; i += ADD_THREADS) {
    const int p = i / words, v = i - p * words, c = 4 * v;
    const int row = (r0 + p) * chunk;
    uint32_t out = 0;
    if (c < d)
      out = add_word(*row_word(pool, in_ptr, row, v, n_seg),
                     *row_word(pool, aux_ptr, row, v, n_seg), d - c, q);
    if constexpr (!READ_FIRST) {
      *row_word(pool, out_ptr, row, v, n_seg) = out;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c + k < d) y[p * d + c + k] = (int8_t)(out >> (8 * k));
    }
  }
  if constexpr (READ_FIRST) {
    cg::this_grid().sync();   // every read of the op is done
    for (int i = threadIdx.x; i < n * words; i += ADD_THREADS) {
      const int p = i / words, v = i - p * words, c = 4 * v;
      uint32_t out = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c + k < d) out |= (uint32_t)(uint8_t)y[p * d + c + k] << (8 * k);
      *row_word(pool, out_ptr, (r0 + p) * chunk, v, n_seg) = out;
    }
  }
}

// ---------------------------------------------------------------------------
// Global average pool: the int32 column sums of h x w pixels of c channels
// (`segs` segments each) at in_ptr, requantized (the 1/(h*w) is folded into
// mult) into one row stored at out_ptr as whole segments, channel tail
// zero.  Every plan's pool is in place (out_ptr == in_ptr): the row lands
// on pixel 0.  One CTA of pool_q_threads(c) in an ordinary launch, every
// thread in every phase; the pixels go through shared memory in chunks of
// `chunk_pix` (all of a plan's at once):
//   (a) the CTA stages the chunk's pixels with 16-byte cp.async copies, a
//       thread a vector of a pixel (neighbouring threads on neighbouring
//       vectors), then __syncthreads;
//   (b) thread (j, ch), channels fastest over cw = pow2 >= c lanes (a
//       warp reads 32 neighbouring bytes of one pixel: no bank conflict),
//       adds channel ch of pixels j, j + parts, ... into its partial
//       part[j][ch]: `parts` = clamp(h w / POOL_PIX_PER_PART, 1,
//       threads / cw) short chains in place of one chain of h w loads;
//       __syncthreads: after the last chunk every read of the op is done;
//   (c) a thread a lane of the output row adds its channel's `parts`
//       partials, requantizes once and stores its byte, zero from c on.
// Sums mod 2**32 do not depend on their order, so the sums are bitwise the
// reference's int32 ones.  What bounds it: bytes (DS-CNN's 25 x 5 x 64
// pool reads 8,000 B, 2.4 ns at 3.35 TB/s); what remains is the launch of
// one CTA and one round trip of its loads, then the longest thread's
// chain, which the parts shorten.  Neither a reduction of every pixel's
// vectors in registers (no staging) nor one of 16-byte partials over
// pixel groups beat the CTA that walks (tools/q_pool_gru_variants.cu,
// PERF.md).
// ---------------------------------------------------------------------------
constexpr int POOL_Q_THREADS = 256;        // quantized.py::POOL_Q_THREADS
constexpr int POOL_Q_THREADS_WIDE = 512;   // above 256 channels
constexpr int POOL_PIX_PER_PART = 16;      // quantized.py::POOL_PIX_PER_PART

// log2 of cw, the power of two >= c (at least a warp) of the channel lanes;
// one __clz on the card, where a loop lengthened every thread's chain.
__host__ __device__ __forceinline__ int pool_q_lg(int c) {
#ifdef __CUDA_ARCH__
  return 32 - __clz(max(c, 32) - 1);
#else
  int lg = 5;
  while ((1 << lg) < c) ++lg;
  return lg;
#endif
}

__host__ __device__ __forceinline__ int pool_q_threads(int c) {
  return c <= POOL_Q_THREADS ? POOL_Q_THREADS : POOL_Q_THREADS_WIDE;
}

// The parts of a channel's sum for `threads` threads.
__host__ __device__ __forceinline__ int pool_q_parts(int threads, int lg,
                                                     int npix) {
  return max(1, min(npix / POOL_PIX_PER_PART, threads >> lg));
}

template <int THR>
__global__ void __launch_bounds__(THR)
avgpool_q_kernel(int8_t* pool, int n_seg, int h, int w, int c, int in_ptr,
                 int out_ptr, int mult, int shift, int chunk_pix) {
  extern __shared__ int4 qsmem[];
  const int segs = segs_for(c), vecs = segs * VEC, npix = h * w;
  const int lanes = segs * SEG, lg = pool_q_lg(c), cw = 1 << lg;
  const int parts = pool_q_parts(THR, lg, npix);
  uint32_t* part = reinterpret_cast<uint32_t*>(qsmem);   // [parts][cw]
  int4* tile = qsmem + parts * cw / 4;
  const int8_t* x = reinterpret_cast<const int8_t*>(tile);
  for (int p0 = 0; p0 < npix; p0 += chunk_pix) {
    const int n = min(chunk_pix, npix - p0);
    // (a) a pixel never wraps: the wrapper requires the pool and the
    // pointers aligned to whole image rows
    if (vecs <= THR) {
      const int v = threadIdx.x % vecs, step = THR / vecs;
      int seg = in_ptr + (p0 + threadIdx.x / vecs) * segs;
      if (seg >= n_seg) seg %= n_seg;
      if (threadIdx.x < step * vecs)
        for (int p = threadIdx.x / vecs; p < n; p += step) {
          cp_async16(tile + p * vecs + v, pool + (size_t)seg * SEG + 16 * v);
          seg += step * segs;
          if (seg >= n_seg) seg %= n_seg;
        }
    } else {
      for (int i = threadIdx.x; i < n * vecs; i += THR) {
        const int p = i / vecs, v = i - p * vecs;
        cp_async16(tile + i, pool + (size_t)((in_ptr + (p0 + p) * segs) %
                                             n_seg) * SEG + 16 * v);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // (b) chunks are a multiple of `parts` pixels, so part j keeps pixels
    // p = j (mod parts)
    for (int t = threadIdx.x; t < parts * cw; t += THR) {
      const int ch = t & (cw - 1), j = t >> lg;
      if (ch < c) {
        uint32_t s = 0;
#pragma unroll 4
        for (int p = j; p < n; p += parts)
          s += (uint32_t)(int)x[p * lanes + ch];
        part[t] = p0 ? part[t] + s : s;
      }
    }
    __syncthreads();   // every read of the chunk (of the op, the last) done
  }
  // (c)
  for (int i = threadIdx.x; i < lanes; i += THR) {
    int8_t y = 0;
    if (i < c) {
      uint32_t sum = 0;
#pragma unroll 4
      for (int j = 0; j < parts; ++j) sum += part[j * cw + i];
      y = sat8(requant_i32((int32_t)sum, mult, shift));
    }
    int seg = out_ptr + i / SEG;
    if (seg >= n_seg) seg -= n_seg;
    pool[(size_t)seg * SEG + i % SEG] = y;
  }
}

// ---------------------------------------------------------------------------
// Int8 GRU cell: gx = rq(x @ W, mx, sx) + b (wrapping) and gh = rq(h @ U, mu,
// su) in the Q12 gate domain, then the fixed-point hard-gate update of
// src/repro/quant/requant.py::gru_update_q12 into the Q7 state, stored at
// state_ptr and at out_ptr.  W is [d_in, 3 d_h], U [d_h, 3 d_h]; gates z, r, n.
// The GRU chain's op is in place: h' lands on x (out_ptr == in_ptr) and on
// h.  CTA i owns hidden channels i0 = i * ctile .. i0 + tn - 1
// (stream.py::gru_q_tiling: one CTA of all d_h channels, or channel tiles
// of a multiple of 4) and the six matching column slices (z, r and n of W
// and of U), "columns" j = s * ctile + co of gate s below.  It
//   (a) stages x and h (16-byte cp.async chunks), its b, mx, sx, mu, su
//       (4-byte cp.async) and its columns of W and U as they lie, rows of
//       `P` = round4(3 ctile) bytes: the whole matrix as 16-byte cp.async
//       copies in one CTA, else 4-byte ones of each row's three slices
//       where d_h is a multiple of 4, else byte by byte;
//   (b) computes its 6 tn gate pre-activations: a thread owns a quad of 4
//       columns of W or U and a share (`ks` lanes) of its rows; for each 4
//       rows it reads the 4 words of its quad (neighbouring threads on
//       neighbouring words of one row), transposes them in registers
//       (transpose4) and takes a __dp4a of each column with the 4 bytes of
//       x or h (zero past d_in or d_h); the lanes' partials go to shared
//       memory and one thread a column sums them (mod 2**32: bitwise the
//       reference's wrapping int32 sum) and requantizes the gate, storing
//       nothing;
//   (c) meets the other threads of its CTA (one CTA, an ordinary launch)
//       or every CTA at the grid barrier (BARRIER, a cooperative launch):
//       every read of the op is done;
//   (d) runs the update of its channels from the gates and the OLD h held
//       in shared memory, a 32-bit word of h' a thread, and stores each
//       word to the state and to the output (the last tile the channel
//       tail as zeros).
// What bounds it: bytes (the chain's 64 -> 64 cell moves 28 KB, 8.6 ns at
// 3.35 TB/s, mostly W and U); what remains is the launch (and, with
// BARRIER, the barrier) and one staging round trip.
// ---------------------------------------------------------------------------
constexpr int GRU_Q_THREADS = 256;   // stream.py::GRU_Q_THREADS
constexpr int GRU_BYTES = 8;         // weight bytes a thread loads at once

__device__ __forceinline__ int32_t clip32(int32_t v, int32_t lo, int32_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int8_t gru_update_q12(int32_t xz, int32_t xr,
                                                 int32_t xn, int32_t hz,
                                                 int32_t hr, int32_t hn,
                                                 int32_t h) {
  const int32_t lim = 1 << 18;     // all products below fit int32
  xz = clip32(xz, -lim, lim); xr = clip32(xr, -lim, lim);
  xn = clip32(xn, -lim, lim); hz = clip32(hz, -lim, lim);
  hr = clip32(hr, -lim, lim); hn = clip32(hn, -lim, lim);
  const int32_t z = clip32(((xz + hz + 2) >> 2) + 2048, 0, 4096);
  const int32_t r = clip32(((xr + hr + 2) >> 2) + 2048, 0, 4096);
  const int32_t n = clip32(xn + ((r * hn + 2048) >> 12), -4096, 4096);
  const int32_t n_q7 = clip32((n + 16) >> 5, -128, 127);
  return sat8((z * h + (4096 - z) * n_q7 + 2048) >> 12);
}

// A GRU CTA's shared memory, byte offsets (stream.py::_gru_q_smem): x from
// 0 and h, whole 16-byte chunks; W's and U's columns [round4(d), P] (each
// region a multiple of 16 bytes); b, mx, sx, mu, su [5, 3 ctile] int32;
// each thread's 4 partial sums; gx, gh [2, 3 ctile] int32.
struct GruQSmem {
  int h, w, u, prm, part, gates, bytes;
};

__host__ __device__ __forceinline__ int gru_row_bytes(int ctile) {
  return round4(3 * ctile);
}

__host__ __device__ __forceinline__ GruQSmem gru_q_layout(int d_in, int d_h,
                                                          int ctile) {
  const int p = gru_row_bytes(ctile);
  GruQSmem m;
  m.h = round16(d_in);
  m.w = m.h + round16(d_h);
  m.u = m.w + round16(round4(d_in) * p);
  m.prm = m.u + round16(round4(d_h) * p);
  m.part = m.prm + 4 * 15 * ctile;
  m.gates = m.part + 16 * GRU_Q_THREADS;
  m.bytes = m.gates + 4 * 6 * ctile;
  return m;
}

// Columns s * d_h + i0 .. + tn - 1 of w [depth, 3 d_h] for each gate s, as
// rows of p bytes at byte `at` (gate s from byte s * ctile of a row).
__device__ __forceinline__ void stage_gru_matrix(char* smem, int at,
                                                 const int8_t* __restrict__ w,
                                                 int depth, int d_h, int i0,
                                                 int tn, int ctile, int p) {
  const int g = 3 * d_h;
  char* dst = smem + at;
  const uintptr_t align = reinterpret_cast<uintptr_t>(w);
  if (tn == d_h && p == g && (depth * g) % 16 == 0 && align % 16 == 0) {
    for (int i = threadIdx.x; i < depth * g / 16; i += GRU_Q_THREADS)
      cp_async16(dst + 16 * i, w + 16 * i);
  } else if (d_h % 4 == 0 && align % 4 == 0) {
    // i0, tn and ctile are multiples of 4 here
    const int words = tn / 4;
    for (int i = threadIdx.x; i < depth * 3 * words; i += GRU_Q_THREADS) {
      const int k = i / (3 * words), r = i - k * 3 * words;
      const int s = r / words, wd = r - s * words;
      cp_async4(dst + k * p + s * ctile + 4 * wd,
                w + (size_t)k * g + s * d_h + i0 + 4 * wd);
    }
  } else {
    const int n = depth * 3 * tn;
    for (int first = threadIdx.x; first < n;
         first += GRU_BYTES * GRU_Q_THREADS) {
      int8_t v[GRU_BYTES];
#pragma unroll
      for (int u = 0; u < GRU_BYTES; ++u) {
        const int i = first + u * GRU_Q_THREADS;
        const int k = i / (3 * tn), r = i - k * 3 * tn, s = r / tn;
        v[u] = i < n ? w[(size_t)k * g + s * d_h + i0 + r - s * tn] : 0;
      }
#pragma unroll
      for (int u = 0; u < GRU_BYTES; ++u) {
        const int i = first + u * GRU_Q_THREADS;
        const int k = i / (3 * tn), r = i - k * 3 * tn, s = r / tn;
        if (i < n) dst[k * p + s * ctile + r - s * tn] = v[u];
      }
    }
  }
}

template <bool BARRIER>
__global__ void __launch_bounds__(GRU_Q_THREADS)
gru_q_kernel(int8_t* pool, const int8_t* __restrict__ w,
             const int8_t* __restrict__ u, const int32_t* __restrict__ b,
             const int32_t* __restrict__ mx, const int32_t* __restrict__ sx,
             const int32_t* __restrict__ mu, const int32_t* __restrict__ su,
             int n_seg, int d_in, int d_h, int in_ptr, int out_ptr,
             int state_ptr, int ctile) {
  extern __shared__ int4 qsmem[];
  char* smem = reinterpret_cast<char*>(qsmem);
  const GruQSmem m = gru_q_layout(d_in, d_h, ctile);
  const int p = gru_row_bytes(ctile), nq = p / 4;
  const int i0 = blockIdx.x * ctile, tn = min(ctile, d_h - i0);
  // (a) x and h (neither region wraps the ring), the constants, W and U
  stage_q_rows(qsmem, pool, RunRows{in_ptr, 0, n_seg}, 0, 1, 1, 0, 0,
               (d_in + 15) / 16);
  stage_q_rows(reinterpret_cast<int4*>(smem + m.h), pool,
               RunRows{state_ptr, 0, n_seg}, 0, 1, 1, 0, 0,
               (d_h + 15) / 16);
  int32_t* prm = reinterpret_cast<int32_t*>(smem + m.prm);
  const int32_t* consts[5] = {b, mx, sx, mu, su};
  for (int i = threadIdx.x; i < 3 * tn; i += GRU_Q_THREADS) {
    const int s = i / tn, co = i - s * tn;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      cp_async4(prm + (3 * k + s) * ctile + co, consts[k] + s * d_h + i0 + co);
  }
  stage_gru_matrix(smem, m.w, w, d_in, d_h, i0, tn, ctile, p);
  stage_gru_matrix(smem, m.u, u, d_h, d_h, i0, tn, ctile, p);
  cp_async_wait_all();
  __syncthreads();
  // (b) quad q of W (qq < nq) or of U, rows 4j .. 4j + 3 for j = lane, lane
  // + ks, ...
  const int qqs = 2 * nq, rq = (max(d_in, d_h) + 3) / 4;
  int ks = 1;
  while (2 * ks <= rq && 2 * ks * qqs <= GRU_Q_THREADS) ks *= 2;
  const int lane = threadIdx.x / qqs, qq = threadIdx.x - lane * qqs;
  int32_t* part = reinterpret_cast<int32_t*>(smem + m.part);
  if (lane < ks) {
    const bool rec = qq >= nq;
    const int q = rec ? qq - nq : qq, depth = rec ? d_h : d_in;
    const uint32_t* v = reinterpret_cast<const uint32_t*>(rec ? smem + m.h
                                                              : smem);
    const uint32_t* mat =
        reinterpret_cast<const uint32_t*>(smem + (rec ? m.u : m.w)) + q;
    int acc[4] = {0, 0, 0, 0};
    for (int j = lane; 4 * j < depth; j += ks) {
      uint32_t xw = v[j];
      if (4 * j + 4 > depth) xw &= (1u << (8 * (depth - 4 * j))) - 1u;
      uint32_t r[4], col[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) r[kk] = mat[(4 * j + kk) * nq];
      transpose4(r, col);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[c] = __dp4a((int)xw, (int)col[c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) part[4 * threadIdx.x + c] = acc[c];
  }
  __syncthreads();
  // the lanes' partials of each column, summed mod 2**32, requantized
  int32_t* gx = reinterpret_cast<int32_t*>(smem + m.gates);
  int32_t* gh = gx + 3 * ctile;
  for (int i = threadIdx.x; i < 6 * ctile; i += GRU_Q_THREADS) {
    const bool rec = i >= 3 * ctile;
    const int col = rec ? i - 3 * ctile : i;
    if (col - col / ctile * ctile >= tn) continue;   // past the last tile
    const int32_t* src = part + 4 * ((rec ? nq : 0) + col / 4) + col % 4;
    uint32_t acc = 0;
    for (int l = 0; l < ks; ++l) acc += (uint32_t)src[4 * l * qqs];
    if (rec)
      gh[col] = requant_i32((int32_t)acc, prm[9 * ctile + col],
                            prm[12 * ctile + col]);
    else
      gx[col] = (int32_t)((uint32_t)requant_i32((int32_t)acc,
                                                prm[3 * ctile + col],
                                                prm[6 * ctile + col]) +
                          (uint32_t)prm[col]);
  }
  if constexpr (BARRIER)
    cg::this_grid().sync();   // (c): every read of the op is done
  else
    __syncthreads();          // (c): one CTA, every read of the op is done
  // (d) a word of h' a thread, from the gates and the old h
  const int8_t* hb = reinterpret_cast<const int8_t*>(smem + m.h);
  const int end = i0 + ctile >= d_h ? segs_for(d_h) * SEG : i0 + ctile;
  uint32_t* state =
      reinterpret_cast<uint32_t*>(pool + (size_t)state_ptr * SEG);
  for (int wd = threadIdx.x; wd < (end - i0) / 4; wd += GRU_Q_THREADS) {
    const int c0 = i0 + 4 * wd;
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + k - i0;
      if (c0 + k < d_h)
        v |= (uint32_t)(uint8_t)gru_update_q12(
                 gx[c], gx[ctile + c], gx[2 * ctile + c], gh[c],
                 gh[ctile + c], gh[2 * ctile + c], hb[c0 + k])
             << (8 * k);
    }
    state[c0 / 4] = v;
    *row_word(pool, out_ptr, c0 / SEG, c0 % SEG / 4, n_seg) = v;
  }
}

// Launch `blocks` blocks of `threads` with `smem` bytes of dynamic shared
// memory (above 48 KB only after raising the kernel's limit) and report the
// launch's error code.
template <typename Kernel, typename... Args>
int launch_grid(Kernel kernel, int blocks, int threads, size_t smem,
                void* stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// Launch `blocks` CTAs of `threads` cooperatively (all resident at once, so
// that cg::this_grid().sync() can meet them) and report the launch's error
// code: cudaErrorCooperativeLaunchTooLarge when they do not fit together.
template <typename Kernel, typename... Args>
int launch_cooperative(Kernel kernel, int blocks, dim3 threads, size_t smem,
                       void* stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  void* argv[] = {static_cast<void*>(&args)...};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                          dim3(blocks), threads, argv, smem,
                                          (cudaStream_t)stream);
}

// Threads of a read-first conv CTA, all CONV_THREADS of them (staging
// spreads its copies over every thread; the outputs may need fewer): x over
// the tile's channels, y over its pixels.
inline dim3 conv_block(int ctile) { return dim3(ctile, CONV_THREADS / ctile); }

}  // namespace

extern "C" {

const char* ring_q_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int ring_gemm_q(void* pool, const void* w, const void* b, const void* mult,
                const void* shift, int n_seg, int m_rows, int d_in,
                int d_out, int in_ptr, int out_ptr, int relu, int rows,
                int ctile, int barrier, void* stream) {
  const ConvQSmem m = conv_q_layout_dense(rows, q_pitch(d_in), rows, 1,
                                          ctile, 1);
  const int ctas = (m_rows + rows - 1) / rows * ((d_out + ctile - 1) / ctile);
  if (barrier)
    return launch_cooperative(gemm_q_kernel<true>, ctas, dim3(GEMM_Q_THREADS),
                              (size_t)m.bytes, stream, (int8_t*)pool,
                              (const int8_t*)w, (const int32_t*)b,
                              (const int32_t*)mult, (const int32_t*)shift,
                              n_seg, m_rows, d_in, d_out, in_ptr, out_ptr,
                              relu, rows, ctile);
  return launch_grid(gemm_q_kernel<false>, ctas, GEMM_Q_THREADS,
                     (size_t)m.bytes, stream, (int8_t*)pool,
                     (const int8_t*)w, (const int32_t*)b,
                     (const int32_t*)mult, (const int32_t*)shift, n_seg,
                     m_rows, d_in, d_out, in_ptr, out_ptr, relu, rows, ctile);
}

int ring_conv_pw_q(void* pool, const void* w, const void* b,
                   const void* mult, const void* shift, int n_seg, int h_in,
                   int w_in, int h_out, int w_out, int c_in, int c_out,
                   int stride, int resample, int in_ptr, int out_ptr,
                   int relu, int rows, int ctile, void* stream) {
  const ConvQSmem m = conv_q_layout_dense(rows * w_out, q_pitch(c_in), rows,
                                          w_out, ctile, 1);
  const int ctas = (h_out + rows - 1) / rows * ((c_out + ctile - 1) / ctile);
  return launch_cooperative(conv_pw_q_kernel, ctas, conv_block(ctile),
                            (size_t)m.bytes, stream, (int8_t*)pool,
                            (const int8_t*)w, (const int32_t*)b,
                            (const int32_t*)mult, (const int32_t*)shift,
                            n_seg, h_in, w_in, h_out, w_out, c_in, c_out,
                            stride, resample, in_ptr, out_ptr, relu, rows,
                            ctile);
}

int ring_conv_dw_q(void* pool, const void* w, const void* b,
                   const void* mult, const void* shift, int n_seg, int h_in,
                   int w_in, int h_out, int w_out, int c, int rs, int stride,
                   int pad_v, int pad_h, int in_ptr, int out_ptr, int relu,
                   int rows, int ctile, void* stream) {
  const ConvQSmem m = conv_dw_q_layout(rows, stride, rs, w_in, w_out, ctile);
  const int ctas = (h_out + rows - 1) / rows * ((c + ctile - 1) / ctile);
  return launch_cooperative(conv_dw_q_kernel, ctas, dim3(CONV_THREADS),
                            (size_t)m.bytes, stream, (int8_t*)pool,
                            (const int8_t*)w, (const int32_t*)b,
                            (const int32_t*)mult, (const int32_t*)shift,
                            n_seg, h_in, w_in, h_out, w_out, c, rs, stride,
                            pad_v, pad_h, in_ptr, out_ptr, relu, rows, ctile);
}

int ring_conv_k2d_q(void* pool, const void* w, const void* b,
                    const void* mult, const void* shift, int n_seg, int h_in,
                    int w_in, int h_out, int w_out, int c_in, int c_out,
                    int k, int stride, int pad_v, int pad_h, int in_ptr,
                    int out_ptr, int relu, int rows, int ctile,
                    void* stream) {
  const ConvQSmem m = conv_q_layout_dense(((rows - 1) * stride + k) * w_in,
                                          q_pitch(c_in), rows, w_out, ctile,
                                          k * k);
  const int ctas = (h_out + rows - 1) / rows * ((c_out + ctile - 1) / ctile);
  return launch_cooperative(conv_k2d_q_kernel, ctas, conv_block(ctile),
                            (size_t)m.bytes, stream, (int8_t*)pool,
                            (const int8_t*)w, (const int32_t*)b,
                            (const int32_t*)mult, (const int32_t*)shift,
                            n_seg, h_in, w_in, h_out, w_out, c_in, c_out, k,
                            stride, pad_v, pad_h, in_ptr, out_ptr, relu, rows,
                            ctile);
}

int ring_avgpool_q(void* pool, int n_seg, int h, int w, int c, int in_ptr,
                   int out_ptr, int mult, int shift, int chunk_pix,
                   void* stream) {
  const int lg = pool_q_lg(c);
  const size_t smem =
      (size_t)pool_q_parts(pool_q_threads(c), lg, h * w) * (1 << lg) *
          sizeof(uint32_t) +
      (size_t)chunk_pix * segs_for(c) * SEG;
  if (pool_q_threads(c) == POOL_Q_THREADS)
    return launch_grid(avgpool_q_kernel<POOL_Q_THREADS>, 1, POOL_Q_THREADS,
                       smem, stream, (int8_t*)pool, n_seg, h, w, c, in_ptr,
                       out_ptr, mult, shift, chunk_pix);
  return launch_grid(avgpool_q_kernel<POOL_Q_THREADS_WIDE>, 1,
                     POOL_Q_THREADS_WIDE, smem, stream, (int8_t*)pool, n_seg,
                     h, w, c, in_ptr, out_ptr, mult, shift, chunk_pix);
}

int ring_add_q(void* pool, int n_seg, int rows, int d, int in_ptr,
               int aux_ptr, int out_ptr, int mult_in, int shift_in,
               int mult_aux, int shift_aux, int relu, int barrier,
               int tile_rows, void* stream) {
  const int blocks = (rows + tile_rows - 1) / tile_rows;
  if (barrier)
    return launch_cooperative(add_q_kernel<true>, blocks, dim3(ADD_THREADS),
                              (size_t)tile_rows * d, stream, (int8_t*)pool,
                              n_seg, rows, d, in_ptr, aux_ptr, out_ptr,
                              mult_in, shift_in, mult_aux, shift_aux, relu,
                              tile_rows);
  return launch_grid(add_q_kernel<false>, blocks, ADD_THREADS, 0, stream,
                     (int8_t*)pool, n_seg, rows, d, in_ptr, aux_ptr, out_ptr,
                     mult_in, shift_in, mult_aux, shift_aux, relu, tile_rows);
}

int ring_conv_stream_q(void* pool, const void* w, const void* b,
                       const void* mult, const void* shift, int n_seg,
                       int h_win, int w_in, int h_out, int w_out, int c_in,
                       int c_out, int k, int stride, int hop, int pad_v,
                       int pad_h, int in_ptr, int out_ptr, int state_ptr,
                       int relu, int rows, int ctile, int out_over_window,
                       void* stream) {
  const int ctas = (h_out + rows - 1) / rows * ((c_out + ctile - 1) / ctile);
  const int win_rows = (h_win + ctas - 1) / ctas;
  int win_at;
  const ConvQSmem m = conv_stream_q_layout(
      rows, stride, k, w_in, q_pitch(c_in), w_out, ctile,
      win_rows * w_in * segs_for(c_in) * SEG, &win_at);
  return launch_cooperative(conv_stream_q_kernel, ctas, conv_block(ctile),
                            (size_t)m.bytes, stream, (int8_t*)pool,
                            (const int8_t*)w, (const int32_t*)b,
                            (const int32_t*)mult, (const int32_t*)shift,
                            n_seg, h_win, w_in, h_out, w_out, c_in, c_out, k,
                            stride, hop, pad_v, pad_h, in_ptr, out_ptr,
                            state_ptr, relu, rows, ctile, out_over_window,
                            win_rows);
}

int ring_gru_cell_q(void* pool, const void* w, const void* u, const void* b,
                    const void* mx, const void* sx, const void* mu,
                    const void* su, int n_seg, int d_in, int d_h, int in_ptr,
                    int out_ptr, int state_ptr, int ctile, int barrier,
                    void* stream) {
  const size_t smem = (size_t)gru_q_layout(d_in, d_h, ctile).bytes;
  const int ctas = (d_h + ctile - 1) / ctile;
  if (barrier)
    return launch_cooperative(gru_q_kernel<true>, ctas, dim3(GRU_Q_THREADS),
                              smem, stream, (int8_t*)pool, (const int8_t*)w,
                              (const int8_t*)u, (const int32_t*)b,
                              (const int32_t*)mx, (const int32_t*)sx,
                              (const int32_t*)mu, (const int32_t*)su, n_seg,
                              d_in, d_h, in_ptr, out_ptr, state_ptr, ctile);
  return launch_grid(gru_q_kernel<false>, ctas, GRU_Q_THREADS, smem, stream,
                     (int8_t*)pool, (const int8_t*)w, (const int8_t*)u,
                     (const int32_t*)b, (const int32_t*)mx,
                     (const int32_t*)sx, (const int32_t*)mu,
                     (const int32_t*)su, n_seg, d_in, d_h, in_ptr, out_ptr,
                     state_ptr, ctile);
}

}  // extern "C"
