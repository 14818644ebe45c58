// Fp32 segment-ring kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Each kernel replaces one Pallas TPU kernel of src/repro/kernels/:
//
//   ring_gemm     <- ring_gemm     (segment_matmul.py:117)  ring FC, Fig. 4
//   ring_conv_pw  <- ring_conv_pw  (conv2d.py:108)          1x1 conv
//   ring_conv_dw  <- ring_conv_dw  (conv2d.py:225)          depthwise rs x rs conv
//   ring_conv_k2d <- ring_conv_k2d (conv2d.py:336)          k x k conv
//   ring_add      <- ring_add      (conv2d.py:432)          residual add
//   ring_avgpool  <- ring_avgpool  (conv2d.py:514)          global average pool
//   ring_inverted_bottleneck <- ring_inverted_bottleneck
//                    (inverted_bottleneck.py:107)           fused PW-DW-PW, Fig. 6
//   ring_conv_stream <- ring_conv_stream (stream.py:142)    streaming k x k conv
//   ring_gru_cell    <- ring_gru_cell    (stream.py:350)    fp32 GRU cell
//   ring_fused_mlp   <- ring_fused_mlp   (fused_mlp.py:97)  in-place (gated) MLP
//   ring_elementwise <- ring_elementwise (elementwise.py:61) in-place activation
//
// They are the fp32 twins of the int8 kernels of ring_q.cu.  The pool is
// one float tensor [n_seg, 128]: a tensor of c-wide rows takes
// ceil(c / 128) consecutive segments per row, and every segment address is
// taken modulo n_seg.  Every op writes its output rows into the ring it
// reads, often over input rows it has already consumed.  A certified plan
// never stores onto a segment that a later step of the same op still
// reads, so in the TPU's sequential grid every read of an op sees the pool
// as it was before the op.  No kernel here walks an op in one block; each
// keeps that order in one of the ways below.
//
// The FC, the pointwise, depthwise, k x k and streaming convs, the residual
// add and the inverted bottleneck read EVERYTHING before they store
// anything, over many CTAs in one cooperative launch: (a) each CTA reads
// its share of the op (the FC's rows and a weight slice of a tile of output
// columns; a conv's tile, a block of output image rows x a channel tile: the
// pointwise conv's the source pixel of each output, and a stream's share
// of its window rows; a block of the add's rows; a bottleneck's tile of
// output pixels and the halo its taps reach) from the ring and computes
// into shared memory, storing nothing; (b) one grid-wide barrier; (c) each
// CTA stores its share, channel tails as zeros.  Every read then sees the
// pool from before the op, as in the sequential walk, and every output
// lands on the same segment, so the final pool is the same (the superblock
// argument of DESIGN.md, "coalescing only delays stores relative to
// reads", applied to the whole op); it holds for any overlap of input and
// output, in place too.  The fused MLP and the elementwise map are delta-0
// ops: the fused MLP's first kernel reads every row it needs and stores
// only into a scratch tensor, and a second launch stores the rows; the
// elementwise map reads and stores each float in one thread (see each
// kernel's comment).  The average pool is one CTA in an ordinary launch:
// every thread stages pixels, then sums a channel over a share of them,
// and after the last __syncthreads (every read of the op is done) a thread
// a channel adds the shares and stores.  The GRU cell reads first too, in
// one CTA and an ordinary launch or over channel tiles in one cooperative
// launch with one grid barrier before any CTA stores h' (which lands on h,
// and in place on x).
//
// The read-first kernels take one modulo per row (a row of the FC,
// an image row of the dw, the output rows of a conv; a staged pixel of the
// pointwise, the k x k and the streaming conv; a row of the add; a pixel of
// the bottleneck), since their
// wrappers require the pool and the pointers aligned to whole rows (the
// bottleneck's rows are one segment a pixel), so no row wraps; the add,
// the stream's window and the bottleneck store a row's (a pixel's)
// segments one warp a row, a float4 a lane.
// Shared memory holds only the live channels of each row (c of its
// segs(c) * 128 floats), so a 16-channel image row costs 64 bytes a pixel
// and not 512; threads run over the live outputs only, and the channel
// tails (c .. segs(c) * 128) are stored as exact zeros after them, as the
// reference's jnp.pad does.
//
// What bounds these kernels on the card: bytes and operations are tiny
// (ResNet-8's largest conv is 4.7 MFLOP over about 0.2 MB), so the bound is
// a few microseconds at most; what remains is the launch, a staging round
// trip and each CTA's longest chain.  The wrappers (kernels/segment_matmul.py,
// kernels/conv2d.py, kernels/stream.py, kernels/fused_mlp.py,
// kernels/elementwise.py) size shared memory and pass whether a conv's
// weight slice is staged (`stage_w`), the pool's (conv2d.py::pool_tiling)
// and the GRU cell's (stream.py::gru_tiling) tilings, the FC's
// tiling (segment_matmul.py::gemm_tiling), the convs'
// (conv2d.py::conv_tiling), the add's (conv2d.py::add_tiling), the fused
// MLP's (fused_mlp.py::mlp_tiling) and the elementwise map's runs and grid
// (elementwise.py::ring_runs, ew_blocks).  The fused MLP alone is
// bound by operations (fp32 FMAs, whisper-tiny's layer 52.9 us at the
// card's peak): a register-tiled product, see its comment.
//
// The fused inverted bottleneck keeps the C_mid-wide expansion of its
// tile's halo in shared memory (the Pallas kernel's VMEM halo ring) and
// never writes it to the ring; its three weight tensors are staged in each
// CTA when they fit (84 KB for MCUNet-VWW's widest op).  The streaming
// conv's CTAs stage the window rows their taps reach, live channels only,
// each from where it lies (old state or the new frame), and never assemble
// the whole window.  The GRU cell stages its columns of W and U in each
// CTA.
//
// Numerics: fp32 FMA accumulation over the reduction in its natural order
// (the FC's over d_in, in slices of 32 summed in order; taps row-major, then input channels; the fused MLP's over d_model, then
// over each d_ff sub-tile, the sub-tiles' partials summed in order), then
// the bias, then the activation
// of core/program.py::ACTIVATIONS with precise expf/tanhf (gelu is the tanh
// approximation, the reference's default).  No fast math, no TF32.  The
// average pool sums in fp32 (parts of a channel, then the parts in order)
// and divides once by h * w (IEEE division).  The GRU cell's products sum
// a chain a lane of its k split, then the lanes in order; its gates round
// each product and sum on its own (__fmul_rn, __fadd_rn), as PyTorch's
// elementwise ops do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SEG = 128;              // floats per segment
constexpr int THREADS = 1024;

namespace cg = cooperative_groups;

enum Activation { IDENTITY = 0, RELU = 1, GELU = 2, SILU = 3, SQUARE = 4 };

__host__ __device__ __forceinline__ int segs_for(int c) {
  return (c + SEG - 1) / SEG;
}

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case RELU:
      return fmaxf(x, 0.f);
    case GELU: {
      const float k0 = 0.7978845608028654f;   // sqrt(2 / pi)
      const float cdf = 0.5f * (1.f + tanhf(k0 * (x + 0.044715f * x * x * x)));
      return x * cdf;
    }
    case SILU:
      return x * (1.f / (1.f + expf(-x)));
    case SQUARE:
      return x * x;
    default:
      return x;
  }
}

// Index into the pool of channel `col` of row `row` of a run of rows that
// are `chunk` segments long and start at ring segment `ptr`.  (Pointers are
// normalized into [0, n_seg) by the wrappers and no run is longer than the
// ring, so segment numbers stay well inside int32.)
__device__ __forceinline__ size_t ring_index(int ptr, int row, int col,
                                             int chunk, int n_seg) {
  return (size_t)((ptr + row * chunk + col / SEG) % n_seg) * SEG + col % SEG;
}

// Asynchronous copies from global to shared memory (sm_80 and later): a
// thread issues many before it waits on any.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// FC: act(x @ w + b), w [d_in, d_out], over m_rows rows of d_in channels at
// in_ptr, stored at out_ptr (every ToyADMOS layer but the last in place).
// One cooperative launch: CTA i owns tile i of
// kernels/segment_matmul.py::gemm_tiling, `rows` rows (fewer in the last
// row block) x `ctile` output columns (fewer in the last column tile),
// column tiles fastest.  It
//   (a) stages the live channels of its rows (all of d_in), its weight
//       slice [d_in, ctile] (transposed) and its bias, every copy in flight
//       at once (cp.async), and computes its outputs into shared memory,
//       storing nothing;
//   (b) meets every other CTA at the grid barrier;
//   (c) stores its outputs over lanes c0 .. c0 + ctile - 1 of each row (the
//       last column tile on through the channel tail, as zeros).
// Each output sums its d_in inputs in slices of GEMM_KSLICE, an fp32 FMA chain
// each in k order from 0, then the slices' partials in order, then the bias,
// then the activation: with d_in <= GEMM_KSLICE one chain, the walking
// kernel's bit for bit; a wider input (ToyADMOS's 640) takes 20 chains of 32
// in parallel, within the fp32 tolerance of it (one d_in-long chain an output
// keeps the walking kernel's bits, but is then that layer's critical path,
// 640 dependent FMAs).  What bounds it: bytes (a 640 -> 128 layer's 331 KB
// in 0.1 us); what remains is the launch, one staging round trip per CTA (at
// ctile 8 a weight row's slice is one 32-byte sector, so no two CTAs of a row
// block read one sector), a chain of at most GEMM_KSLICE FMAs, the partials'
// sum and the barrier.  The rows never wrap the ring (the wrapper requires
// the reference's block alignment), so one modulo a row.
// ---------------------------------------------------------------------------
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_KSLICE = 32;    // inputs a thread's FMA chain takes

// A gemm CTA's shared memory, in 4-byte words: its rows x [rows, xp], its
// weight slice transposed, ws [ctile, wp], its bias [ctile], the partial sums
// of its outputs' k slices part [kslices, rows * ctile] and its outputs
// y [rows, ctile].  xp is d_in rounded up to 4 and wp d_in rounded up to 32,
// plus 4, so that a thread reads 4 of its k at a time and the 8 columns of a
// quarter warp lie in distinct banks.
struct GemmSmem {
  int xp, wp, kslices, ws, bias, part, y, words;
};

__host__ __device__ __forceinline__ GemmSmem gemm_smem_layout(int rows,
                                                              int ctile,
                                                              int d_in) {
  GemmSmem m;
  m.xp = (d_in + 3) / 4 * 4;
  m.wp = (d_in + 31) / 32 * 32 + 4;
  m.kslices = (d_in + GEMM_KSLICE - 1) / GEMM_KSLICE;
  m.ws = rows * m.xp;
  m.bias = m.ws + ctile * m.wp;
  m.part = m.bias + ctile;
  m.y = m.part + m.kslices * rows * ctile;
  m.words = m.y + rows * ctile;
  return m;
}

__global__ void __launch_bounds__(GEMM_THREADS)
gemm_f32_kernel(float* pool, const float* __restrict__ w,
                const float* __restrict__ b, int n_seg, int m_rows, int d_in,
                int d_out, int in_ptr, int out_ptr, int act, int rows,
                int ctile) {
  extern __shared__ float4 gemm_smem4[];             // 16-byte aligned
  float* smem = reinterpret_cast<float*>(gemm_smem4);
  const int ksegs = segs_for(d_in), nsegs = segs_for(d_out);
  const int n_ct = (d_out + ctile - 1) / ctile;
  const int rb = blockIdx.x / n_ct, cb = blockIdx.x - rb * n_ct;
  const int r0 = rb * rows, nr = min(rows, m_rows - r0);
  const int c0 = cb * ctile, cn = min(ctile, d_out - c0);
  const GemmSmem m = gemm_smem_layout(rows, ctile, d_in);
  float *x = smem, *ws = smem + m.ws, *bias = smem + m.bias,
        *part = smem + m.part, *y = smem + m.y;
  // (a) every copy in flight before any wait: weight row k's slice is cn
  // floats of one sector, consecutive threads on consecutive columns
  for (int i = threadIdx.x; i < d_in * cn; i += GEMM_THREADS) {
    const int k = i / cn, j = i - k * cn;
    cp_async4(ws + j * m.wp + k, w + (size_t)k * d_out + c0 + j, 4);
  }
  for (int i = threadIdx.x; i < nr * d_in; i += GEMM_THREADS) {
    const int r = i / d_in, k = i - r * d_in;
    cp_async4(x + r * m.xp + k,
              pool + (size_t)((in_ptr + (r0 + r) * ksegs) % n_seg) * SEG + k,
              4);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < cn; i += GEMM_THREADS) bias[i] = b[c0 + i];
  cp_async_wait<0>();
  __syncthreads();
  // one FMA chain per (output, k slice), in k order from 0; output o of
  // row r = o / cn, column co = o % cn, fastest, so the columns of a quarter
  // warp share a slice
  const int n_out = nr * cn;
  for (int j = threadIdx.x; j < n_out * m.kslices; j += GEMM_THREADS) {
    const int sl = j / n_out, o = j - sl * n_out;
    const int r = o / cn, co = o - r * cn;
    const int k0 = sl * GEMM_KSLICE, k1 = min(d_in, k0 + GEMM_KSLICE);
    const float* xr = x + r * m.xp;
    const float* wc = ws + co * m.wp;
    const float4* x4 = reinterpret_cast<const float4*>(xr + k0);
    const float4* w4 = reinterpret_cast<const float4*>(wc + k0);
    const int nq = (k1 - k0) / 4;
    float acc = 0.f;
#pragma unroll 8
    for (int q = 0; q < nq; ++q) {
      const float4 a = x4[q], c = w4[q];
      acc = fmaf(a.x, c.x, acc);
      acc = fmaf(a.y, c.y, acc);
      acc = fmaf(a.z, c.z, acc);
      acc = fmaf(a.w, c.w, acc);
    }
    for (int k = k0 + 4 * nq; k < k1; ++k) acc = fmaf(xr[k], wc[k], acc);
    part[sl * n_out + o] = acc;
  }
  __syncthreads();
  // the slices' partials summed in order, then the bias and the activation
  for (int o = threadIdx.x; o < n_out; o += GEMM_THREADS) {
    float acc = part[o];
    for (int sl = 1; sl < m.kslices; ++sl) acc += part[sl * n_out + o];
    const int r = o / cn, co = o - r * cn;
    y[r * ctile + co] = activate(acc + bias[co], act);
  }
  cg::this_grid().sync();   // (b): every read of the op is done
  const int span = (c0 + ctile >= d_out ? nsegs * SEG : c0 + ctile) - c0;
  for (int i = threadIdx.x; i < nr * span; i += GEMM_THREADS) {
    const int r = i / span, lane = c0 + (i - r * span);
    pool[(size_t)((out_ptr + (r0 + r) * nsegs) % n_seg) * SEG + lane] =
        lane < d_out ? y[r * ctile + lane - c0] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Depthwise rs x rs conv and k x k conv (and the streaming conv below): many
// CTAs, one grid-wide barrier.
// CTA i owns tile i: `rows` output image rows (the last block may have
// fewer) x a tile of `ctile` output channels, channel tiles fastest.  It
//   (a) stages what it reads and computes every output of its tile into
//       shared memory, storing nothing into the pool;
//   (b) meets every other CTA at the grid barrier;
//   (c) stores its outputs, and its share of the channel tails as zeros.
// The wrapper keeps the tiles at most the card's SM count, so the
// cooperative launch has every CTA resident at once whatever its occupancy
// (the launch is refused otherwise).  Threads run x over the tile's
// channels and y over its pixels.
//
// What bounds them: the bound is tens of nanoseconds (bytes); what remains
// is one launch, the staging of a CTA's inputs, its longest FMA chain
// (k * k * c_in for the k x k conv) and the barrier.
// ---------------------------------------------------------------------------
constexpr int CONV_THREADS = 512;   // most threads a conv CTA runs

// The tile of CTA blockIdx.x: output rows p0 .. p0 + np - 1, channels
// c0 .. c0 + cn - 1, and the input rows lo .. lo + nh - 1 inside the image
// that its taps reach.
struct ConvTile {
  int p0, np, c0, cn, lo, nh;
};

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

// A conv CTA's shared memory, in 4-byte words: the staged input rows
// (`x_len`: the k x k conv's halo, and after it a streaming conv's share of
// its window rows; 0 for the depthwise conv, which reads the pool directly),
// the held outputs [rows * w_out, ctile], the bias [ctile], the weight slice
// (`w_len`, when staged), then the ring segment of each input row the tile
// reaches (`in_rows` ints: the depthwise conv's halo; 0 for the k x k and
// the streaming conv, which stage their rows at once) and of each output
// row ([rows]).
struct ConvSmem {
  int y, bias, w, in_row, out_row, words;
};

__host__ __device__ __forceinline__ ConvSmem conv_smem_layout(
    int x_len, int rows, int w_out, int ctile, int w_len, int stage_w,
    int in_rows) {
  ConvSmem m;
  m.y = x_len;
  m.bias = m.y + rows * w_out * ctile;
  m.w = m.bias + ctile;
  m.in_row = m.w + (stage_w ? w_len : 0);
  m.out_row = m.in_row + in_rows;
  m.words = m.out_row + rows;
  return m;
}

// Threads of a conv CTA, all CONV_THREADS of them (staging spreads its loads
// over every thread; the outputs may need fewer): x over the tile's
// channels, y over its pixels.
inline dim3 conv_block(int ctile) { return dim3(ctile, CONV_THREADS / ctile); }

// Stage a tile's output row segments (one modulo per image row), its bias
// and, when `stage_w`, its weight slice [taps, ctile] of w [taps, ldw]
// (columns c0 .. c0 + cn - 1); returns where the kernel reads the slice
// from and its row stride.
__device__ __forceinline__ const float* stage_tile(
    const ConvTile& t, const ConvSmem& m, float* smem, const float* w,
    const float* b, int taps, int ldw, int ctile, int stage_w, int n_seg,
    int out_ptr, int out_seg, int* ld) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  int* out_row = reinterpret_cast<int*>(smem + m.out_row);
  for (int i = tid; i < t.np; i += nthr)
    out_row[i] = (out_ptr + (t.p0 + i) * out_seg) % n_seg;
  if (threadIdx.y == 0 && threadIdx.x < t.cn)
    smem[m.bias + threadIdx.x] = b[t.c0 + threadIdx.x];
  if (!stage_w) {
    *ld = ldw;
    return w + t.c0;
  }
  float* ws = smem + m.w;
  if (threadIdx.x < t.cn)
    for (int r = threadIdx.y; r < taps; r += blockDim.y)
      ws[r * ctile + threadIdx.x] = w[(size_t)r * ldw + t.c0 + threadIdx.x];
  *ld = ctile;
  return ws;
}

// (c) Store the tile's held outputs y [np * w_out, ctile] over lanes
// c0 .. end of each output pixel, zeros from channel c on: the last channel
// tile also stores the pixel's channel tail, up to osegs * SEG.
__device__ __forceinline__ void store_tile(float* pool, const ConvTile& t,
                                           const float* y, const int* out_row,
                                           int w_out, int c, int osegs,
                                           int ctile) {
  const int end = t.c0 + ctile >= c ? osegs * SEG : t.c0 + ctile;
  for (int m = threadIdx.y; m < t.np * w_out; m += blockDim.y) {
    const int pl = m / w_out, q = m - pl * w_out;
    float* dst = pool + (size_t)out_row[pl] * SEG + (size_t)q * osegs * SEG;
    for (int lane = t.c0 + threadIdx.x; lane < end; lane += blockDim.x)
      dst[lane] = lane < c ? y[m * ctile + lane - t.c0] : 0.f;
  }
}

// Depthwise rs x rs conv: w [rs, rs, c]; channel tiles of min(c, 128), one
// segment each.  Each thread reads its taps straight from the pool
// (channels fastest, so a warp's loads are coalesced).
__global__ void __launch_bounds__(CONV_THREADS)
conv_dw_f32_kernel(float* pool, const float* __restrict__ w,
                   const float* __restrict__ b, int n_seg, int h_in, int w_in,
                   int h_out, int w_out, int c, int rs, int stride, int pad_v,
                   int pad_h, int in_ptr, int out_ptr, int act, int rows,
                   int stage_w) {
  extern __shared__ float smem[];
  const int ct = min(c, SEG), segs = segs_for(c);
  const ConvTile t = conv_tile(h_in, h_out, c, rs, stride, pad_v, rows, ct);
  const ConvSmem m = conv_smem_layout(0, rows, w_out, ct, rs * rs * ct,
                                      stage_w, (rows - 1) * stride + rs);
  int* in_row = reinterpret_cast<int*>(smem + m.in_row);
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < t.nh;
       i += blockDim.x * blockDim.y)
    in_row[i] = (in_ptr + (t.lo + i) * w_in * segs) % n_seg;
  int ldw;
  const float* wp = stage_tile(t, m, smem, w, b, rs * rs, c, ct, stage_w,
                               n_seg, out_ptr, w_out * segs, &ldw);
  __syncthreads();
  float* y = smem + m.y;
  const int x = threadIdx.x, ch = t.c0 + x;
  if (x < t.cn) {
    for (int j = threadIdx.y; j < t.np * w_out; j += blockDim.y) {
      const int pl = j / w_out, q = j - pl * w_out;
      const int top = (t.p0 + pl) * stride - pad_v;
      float acc = 0.f;
      for (int r = 0; r < rs; ++r) {
        const int src = top + r;
        if (src < 0 || src >= h_in) continue;
        const float* row = pool + (size_t)in_row[src - t.lo] * SEG + ch;
        for (int s = 0; s < rs; ++s) {
          const int col = q * stride - pad_h + s;
          if (col < 0 || col >= w_in) continue;
          acc = fmaf(row[(size_t)col * segs * SEG], wp[(r * rs + s) * ldw + x],
                     acc);
        }
      }
      y[j * ct + x] = activate(acc + smem[m.bias + x], act);
    }
  }
  cg::this_grid().sync();   // (b): every read of the op is done
  store_tile(pool, t, y, reinterpret_cast<const int*>(smem + m.out_row),
             w_out, c, segs, ct);
}

// The ring segment of row r of a run of rows `row_segs` segments long that
// starts at ring segment `ptr`: one modulo per row (a row never wraps: the
// wrappers require the pool and the pointers aligned to whole rows).
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

// Stage the live channels of image rows lo .. lo + n - 1 (w_in pixels of
// c_in channels, ksegs segments each; `seg` maps an image row to its ring
// segment) into x [n, w_in, c_in]: threads y over pixels, x over channels.
template <typename Rows>
__device__ __forceinline__ void stage_image_rows(float* x, const float* pool,
                                                 Rows seg, int lo, int n,
                                                 int w_in, int c_in,
                                                 int ksegs) {
  for (int i = threadIdx.y; i < n * w_in; i += blockDim.y) {
    const int hr = i / w_in, px = i - hr * w_in;
    const float* src =
        pool + (size_t)seg(lo + hr) * SEG + (size_t)px * ksegs * SEG;
    for (int ci = threadIdx.x; ci < c_in; ci += blockDim.x)
      x[i * c_in + ci] = src[ci];
  }
}

// (a) of the k x k conv: every output of tile t into y [np * w_out, ctile]
// from the staged input rows x (image rows t.lo ..; [nh, w_in, c_in]) and
// the weight slice wp (row stride ldw).  Each thread accumulates one output
// at a time in a register: taps row-major, then input channels.
__device__ __forceinline__ void k2d_outputs(
    float* y, const float* x, const float* wp, int ldw, const float* bias,
    const ConvTile& t, int h_in, int w_in, int w_out, int c_in, int k,
    int stride, int pad_v, int pad_h, int ctile, int act) {
  const int co = threadIdx.x, row_len = w_in * c_in;
  if (co >= t.cn) return;
  for (int j = threadIdx.y; j < t.np * w_out; j += blockDim.y) {
    const int pl = j / w_out, q = j - pl * w_out;
    const int top = (t.p0 + pl) * stride - pad_v;
    float acc = 0.f;
    for (int r = 0; r < k; ++r) {
      const int src = top + r;
      if (src < 0 || src >= h_in) continue;
      const float* xrow = x + (size_t)(src - t.lo) * row_len;
      for (int s = 0; s < k; ++s) {
        const int col = q * stride - pad_h + s;
        if (col < 0 || col >= w_in) continue;
        const float* xr = xrow + col * c_in;
        const float* wc = wp + (size_t)(r * k + s) * c_in * ldw + co;
        for (int ci = 0; ci < c_in; ++ci)
          acc = fmaf(xr[ci], wc[(size_t)ci * ldw], acc);
      }
    }
    y[j * ctile + co] = activate(acc + bias[co], act);
  }
}

// Store n rows y [n, d] as whole segments (`segs` a row, at ring segment
// seg(p) for row p): live channels, then zeros up to segs * SEG.  One warp a
// row, a float4 a lane, so each store instruction writes 512 contiguous
// bytes; the warps of a CTA whose size is no multiple of 32 leave out the
// partial one.
template <typename Rows>
__device__ __forceinline__ void store_rows(float* pool, const float* y,
                                           Rows seg, int n, int d,
                                           int segs) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int warps = blockDim.x * blockDim.y / 32;
  if (warp >= warps) return;
  for (int p = warp; p < n; p += warps) {
    float4* dst = reinterpret_cast<float4*>(pool + (size_t)seg(p) * SEG);
    const float* yr = y + (size_t)p * d;
    for (int v = lane; v < segs * (SEG / 4); v += 32) {
      const int c = 4 * v;
      dst[v] = make_float4(c < d ? yr[c] : 0.f, c + 1 < d ? yr[c + 1] : 0.f,
                           c + 2 < d ? yr[c + 2] : 0.f,
                           c + 3 < d ? yr[c + 3] : 0.f);
    }
  }
}

// k x k conv: w [k, k, c_in, c_out].  A CTA stages the live channels of the
// input rows its taps reach ((rows - 1) * stride + k at most) and its weight
// slice [k, k, c_in, ctile] in shared memory, then k2d_outputs.
__global__ void __launch_bounds__(CONV_THREADS)
conv_k2d_f32_kernel(float* pool, const float* __restrict__ w,
                    const float* __restrict__ b, int n_seg, int h_in,
                    int w_in, int h_out, int w_out, int c_in, int c_out, int k,
                    int stride, int pad_v, int pad_h, int in_ptr, int out_ptr,
                    int act, int rows, int ctile, int stage_w) {
  extern __shared__ float smem[];
  const int ksegs = segs_for(c_in), nsegs = segs_for(c_out);
  const int halo = (rows - 1) * stride + k;
  const ConvTile t = conv_tile(h_in, h_out, c_out, k, stride, pad_v, rows,
                               ctile);
  const ConvSmem m = conv_smem_layout(halo * w_in * c_in, rows, w_out, ctile,
                                      k * k * c_in * ctile, stage_w, 0);
  int ldw;
  const float* wp = stage_tile(t, m, smem, w, b, k * k * c_in, c_out, ctile,
                               stage_w, n_seg, out_ptr, w_out * nsegs, &ldw);
  stage_image_rows(smem, pool, RunRows{in_ptr, w_in * ksegs, n_seg}, t.lo,
                   t.nh, w_in, c_in, ksegs);
  __syncthreads();
  float* y = smem + m.y;
  k2d_outputs(y, smem, wp, ldw, smem + m.bias, t, h_in, w_in, w_out, c_in, k,
              stride, pad_v, pad_h, ctile, act);
  cg::this_grid().sync();   // (b): every read of the op is done
  store_tile(pool, t, y, reinterpret_cast<const int*>(smem + m.out_row),
             w_out, c_out, nsegs, ctile);
}

// 1x1 conv: w [c_in, c_out]; output pixel (p, q) reads source pixel (p *
// stride, q * stride), or (p * h_in / h_out, q * w_in / w_out) when
// resampling (rowsched.resample_src).  Tiled as the k x k conv (conv_tile
// with k = 1; its halo is not used): a CTA stages only the live channels of
// the source pixel of each of its outputs, one pixel pitch c_in | 1 (odd,
// so that the pixels a warp's y-threads read lie in different banks), and
// its weight slice [c_in, ctile]; then each output is the walking kernel's
// FMA chain over c_in in order, + bias, activation.
__global__ void __launch_bounds__(CONV_THREADS)
conv_pw_f32_kernel(float* pool, const float* __restrict__ w,
                   const float* __restrict__ b, int n_seg, int h_in, int w_in,
                   int h_out, int w_out, int c_in, int c_out, int stride,
                   int resample, int in_ptr, int out_ptr, int act, int rows,
                   int ctile, int stage_w) {
  extern __shared__ float smem[];
  const int ksegs = segs_for(c_in), nsegs = segs_for(c_out), xp = c_in | 1;
  const ConvTile t = conv_tile(h_in, h_out, c_out, 1, stride, 0, rows, ctile);
  const ConvSmem m = conv_smem_layout(rows * w_out * xp, rows, w_out, ctile,
                                      c_in * ctile, stage_w, 0);
  int ldw;
  const float* wp = stage_tile(t, m, smem, w, b, c_in, c_out, ctile, stage_w,
                               n_seg, out_ptr, w_out * nsegs, &ldw);
  for (int i = threadIdx.y; i < t.np * w_out; i += blockDim.y) {
    const int p = t.p0 + i / w_out, q = i % w_out;
    const int sr = resample ? p * h_in / h_out : p * stride;
    const int sc = resample ? q * w_in / w_out : q * stride;
    const float* src =
        pool + (size_t)((in_ptr + (sr * w_in + sc) * ksegs) % n_seg) * SEG;
    for (int ci = threadIdx.x; ci < c_in; ci += blockDim.x)
      smem[i * xp + ci] = src[ci];
  }
  __syncthreads();
  float* y = smem + m.y;
  const int co = threadIdx.x;
  if (co < t.cn) {
    for (int j = threadIdx.y; j < t.np * w_out; j += blockDim.y) {
      const float* xr = smem + j * xp;
      float acc = 0.f;
      for (int k = 0; k < c_in; ++k) acc = fmaf(xr[k], wp[k * ldw + co], acc);
      y[j * ctile + co] = activate(acc + smem[m.bias + co], act);
    }
  }
  cg::this_grid().sync();   // (b): every read of the op is done
  store_tile(pool, t, y, reinterpret_cast<const int*>(smem + m.out_row),
             w_out, c_out, nsegs, ctile);
}

// ---------------------------------------------------------------------------
// Residual add: act(x + r) over `rows` pixel rows of d channels at in_ptr and
// at aux_ptr (the held residual), stored at out_ptr, often in place, in one
// cooperative launch: CTA i owns rows i * tile_rows .. (the last block may
// have fewer).  It
//   (a) reads the live channels of its rows of both operands, one warp a
//       row, and holds act(x + r) in shared memory, storing nothing;
//   (b) meets every other CTA at the grid barrier;
//   (c) stores its rows as whole segments, channel tails zero.
// The barrier is needed: an output row may land on an input row of another
// block (row t onto input row t - 1 when out_ptr is one row below in_ptr)
// or on residual rows another block reads.  Bound by its bytes; what
// remains is the launch, one row's loads and stores per warp and the
// barrier.
// ---------------------------------------------------------------------------
constexpr int ADD_THREADS = 256;

__global__ void __launch_bounds__(ADD_THREADS)
add_f32_kernel(float* pool, int n_seg, int rows, int d, int in_ptr,
               int aux_ptr, int out_ptr, int act, int tile_rows) {
  extern __shared__ float smem[];                  // y [tile_rows, d]
  const int chunk = segs_for(d);
  const int r0 = blockIdx.x * tile_rows, n = min(tile_rows, rows - r0);
  const int first = (r0 * chunk) % n_seg;          // r0's offset in a run
  const RunRows xs{(in_ptr + first) % n_seg, chunk, n_seg};
  const RunRows rs{(aux_ptr + first) % n_seg, chunk, n_seg};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < n; p += ADD_THREADS / 32) {
    const float* x = pool + (size_t)xs(p) * SEG;
    const float* r = pool + (size_t)rs(p) * SEG;
    for (int c = lane; c < d; c += 32)
      smem[p * d + c] = activate(x[c] + r[c], act);
  }
  cg::this_grid().sync();   // (b): every read of the op is done
  store_rows(pool, smem, RunRows{(out_ptr + first) % n_seg, chunk, n_seg}, n,
             d, chunk);
}

// ---------------------------------------------------------------------------
// Global average pool: the fp32 column sums of h x w pixels of c channels
// (`segs` segments each) at in_ptr, divided once by h * w (IEEE division),
// stored as one row at out_ptr as whole segments, channel tail zero.  Every
// plan's pool is in place (out_ptr == in_ptr): the row lands on pixel 0.
// One CTA of `THR` threads in an ordinary launch (conv2d.py::pool_tiling
// picks THR, `parts` and `chunk_pix`), every thread in every phase; the
// pixels go through shared memory in chunks of `chunk_pix` (all of a plan's
// at once):
//   (a) the CTA stages the live vectors of the chunk's pixels (ceil(c / 4)
//       float4s a pixel, 16-byte cp.async copies), a thread a vector of a
//       pixel (neighbouring threads on neighbouring vectors), then
//       __syncthreads;
//   (b) thread (j, ch), channels fastest over cw = pow2 >= c lanes (a warp
//       reads 32 neighbouring floats of one pixel: no bank conflict), adds
//       channel ch of pixels j, j + parts, ... into its partial
//       part[j][ch]: `parts` short chains in place of one chain of h w
//       adds; __syncthreads: after the last chunk every read of the op is
//       done;
//   (c) a thread a lane of the output row adds its channel's `parts`
//       partials in order, divides once by h * w and stores, zero from c
//       on.
// The sums run in another order than the walk's (parts of pixels j mod
// parts, then the parts), so the result is the plain version's within the
// fp32 tolerance, not bit for bit.  What bounds it: bytes (DS-CNN's 25 x 5
// x 64 pool reads 32,000 B, 9.6 ns at 3.35 TB/s); what remains is the launch
// of one CTA, one round trip of its loads and the longest thread's chain,
// which the parts shorten (tools/f32_pool_gru_variants.cu, PERF.md).
// ---------------------------------------------------------------------------

// log2 of cw, the power of two >= c (at least a warp) of the channel lanes;
// one __clz on the card.
__host__ __device__ __forceinline__ int pool_lg(int c) {
#ifdef __CUDA_ARCH__
  return 32 - __clz(max(c, 32) - 1);
#else
  int lg = 5;
  while ((1 << lg) < c) ++lg;
  return lg;
#endif
}

// The pool CTA's shared memory in floats (conv2d.py::PoolTiling.smem): the
// partials [parts, cw], then a chunk of pixels [chunk_pix, 4 ceil(c / 4)].
__host__ __device__ __forceinline__ size_t pool_smem_floats(int c, int parts,
                                                            int chunk_pix) {
  return (size_t)parts * (1 << pool_lg(c)) +
         (size_t)chunk_pix * 4 * ((c + 3) / 4);
}

template <int THR>
__global__ void __launch_bounds__(THR)
avgpool_f32_kernel(float* pool, int n_seg, int h, int w, int c, int in_ptr,
                   int out_ptr, int parts, int chunk_pix) {
  extern __shared__ float4 vsmem[];
  const int segs = segs_for(c), vecs = (c + 3) / 4, npix = h * w;
  const int lg = pool_lg(c), cw = 1 << lg, pitch = 4 * vecs;
  float* part = reinterpret_cast<float*>(vsmem);      // [parts][cw]
  float4* tile = vsmem + parts * cw / 4;              // cw % 4 == 0
  const float* x = reinterpret_cast<const float*>(tile);
  for (int p0 = 0; p0 < npix; p0 += chunk_pix) {
    const int n = min(chunk_pix, npix - p0);
    // (a) a pixel never wraps: the wrapper requires the pool and the
    // pointers aligned to whole image rows
    if (vecs <= THR) {
      const int v = threadIdx.x % vecs, step = THR / vecs;
      int seg = (in_ptr + (p0 + threadIdx.x / vecs) * segs) % n_seg;
      if (threadIdx.x < step * vecs)
        for (int p = threadIdx.x / vecs; p < n; p += step) {
          cp_async16(reinterpret_cast<float*>(tile + p * vecs + v),
                     pool + (size_t)seg * SEG + 4 * v, 16);
          seg = (seg + step * segs) % n_seg;
        }
    } else {
      for (int i = threadIdx.x; i < n * vecs; i += THR) {
        const int p = i / vecs, v = i - p * vecs;
        cp_async16(reinterpret_cast<float*>(tile + i),
                   pool + (size_t)((in_ptr + (p0 + p) * segs) % n_seg) * SEG +
                       4 * v,
                   16);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // (b)
    for (int t = threadIdx.x; t < parts * cw; t += THR) {
      const int ch = t & (cw - 1), j = t >> lg;
      if (ch < c) {
        float s = 0.f;
#pragma unroll 4
        for (int p = j; p < n; p += parts) s += x[p * pitch + ch];
        part[t] = p0 ? part[t] + s : s;
      }
    }
    __syncthreads();   // every read of the chunk (of the op, the last) done
  }
  // (c)
  const float count = (float)npix;
  for (int i = threadIdx.x; i < segs * SEG; i += THR) {
    float y = 0.f;
    if (i < c) {
      float sum = part[i];
      for (int j = 1; j < parts; ++j) sum += part[j * cw + i];
      y = sum / count;
    }
    int seg = out_ptr + i / SEG;
    if (seg >= n_seg) seg -= n_seg;
    pool[(size_t)seg * SEG + i % SEG] = y;
  }
}

// ---------------------------------------------------------------------------
// Fused inverted bottleneck (paper Fig. 6): A [H, W, C_in] at in_ptr, one
// segment per pixel, -> E [H, W, C_out] at out_ptr; stride 1, 'same'
// padding, relu after the expansion and after the depthwise conv.  One
// cooperative launch: CTA i owns tile i, `rows` x `cols` output pixels
// (fewer at the bottom and right edges), column tiles fastest
// (kernels/inverted_bottleneck.py::ib_tiling).  It
//   (a) walks its tile in sub-tiles of `sub_rows` x `sub_cols` pixels
//       (the whole tile when its halo fits); for each it stages the live
//       channels of the A pixels its taps reach (the sub-tile plus a
//       (RS - 1) / 2 halo on each side, clipped to the image), expands them
//       (relu(A @ w1)), runs the depthwise RS x RS conv (relu) and the
//       projection (@ w2), adds the residual from the staged centre pixels,
//       and keeps the E pixels in shared memory, storing nothing;
//   (b) meets every other CTA at the grid barrier;
//   (c) stores its E pixels as whole segments, channel tails zero.
// Only the E pixels are held across the barrier: a sub-tile's staged A,
// its expansion and its depthwise outputs are scratch, safe to reuse
// because nothing is stored before (b).  Neighbouring tiles expand their
// shared halo pixels each on their own.  Every output keeps the walking
// kernel's FMA order (the expansion over C_in, the taps row-major, the
// projection over C_mid, then the residual), so the result is the same
// bit for bit.  w1, wd and w2 are staged in each CTA when they fit beside
// the tile (`stage_w`), else read through L2.
// ---------------------------------------------------------------------------

// A bottleneck CTA's shared memory, in 4-byte words: the held E pixels
// [rows * cols, C_out], a sub-tile's staged A pixels [halo, C_in] and their
// expansion [halo, C_mid] (halo: the most pixels a sub-tile's taps reach),
// its depthwise outputs [sub_rows * sub_cols, C_mid], then w1, wd and w2
// when staged.
struct IbSmem {
  int a, b, c, w, words;
};

__host__ __device__ __forceinline__ IbSmem ib_smem_layout(
    int H, int W, int C_in, int C_mid, int C_out, int RS, int rows, int cols,
    int sub_rows, int sub_cols, int stage_w) {
  const int halo =
      min(H, sub_rows + RS - 1) * min(W, sub_cols + RS - 1);
  IbSmem m;
  m.a = rows * cols * C_out;
  m.b = m.a + halo * C_in;
  m.c = m.b + halo * C_mid;
  m.w = m.c + sub_rows * sub_cols * C_mid;
  m.words = m.w + (stage_w ? C_mid * (C_in + RS * RS + C_out) : 0);
  return m;
}

// The ring segment of pixel p (row-major) of a tile of nq columns whose
// first pixel is image pixel (p0, q0) of an image W pixels wide at `ptr`.
struct TilePixels {
  int ptr, W, p0, q0, nq, n_seg;
  __device__ __forceinline__ int operator()(int p) const {
    const int r = p / nq;
    return (ptr + (p0 + r) * W + q0 + p - r * nq) % n_seg;
  }
};

__global__ void __launch_bounds__(THREADS)
ib_f32_kernel(float* pool, const float* __restrict__ w1,
              const float* __restrict__ wd, const float* __restrict__ w2,
              int n_seg, int H, int W, int C_in, int C_mid, int C_out, int RS,
              int in_ptr, int out_ptr, int residual, int rows, int cols,
              int sub_rows, int sub_cols, int stage_w) {
  extern __shared__ float smem[];
  const IbSmem m = ib_smem_layout(H, W, C_in, C_mid, C_out, RS, rows, cols,
                                  sub_rows, sub_cols, stage_w);
  const int pad = (RS - 1) / 2;
  const int col_tiles = (W + cols - 1) / cols;
  const int rb = blockIdx.x / col_tiles, cb = blockIdx.x - rb * col_tiles;
  const int t0 = rb * rows, tn = min(rows, H - t0);
  const int u0 = cb * cols, un = min(cols, W - u0);
  float* e = smem;                                  // [tn * un, C_out]
  float* a = smem + m.a;
  float* b = smem + m.b;
  float* c = smem + m.c;
  const float *pw1 = w1, *pwd = wd, *pw2 = w2;
  if (stage_w) {   // read only after the first sub-tile's first barrier
    float* ws = smem + m.w;
    const int n1 = C_in * C_mid, nd = RS * RS * C_mid, n2 = C_mid * C_out;
    for (int i = threadIdx.x; i < n1; i += blockDim.x) ws[i] = w1[i];
    for (int i = threadIdx.x; i < nd; i += blockDim.x) ws[n1 + i] = wd[i];
    for (int i = threadIdx.x; i < n2; i += blockDim.x) ws[n1 + nd + i] = w2[i];
    pw1 = ws;
    pwd = ws + n1;
    pw2 = ws + n1 + nd;
  }
  for (int p0 = t0; p0 < t0 + tn; p0 += sub_rows) {
    for (int q0 = u0; q0 < u0 + un; q0 += sub_cols) {
      const int np = min(sub_rows, t0 + tn - p0);
      const int nq = min(sub_cols, u0 + un - q0);
      const int lo = max(0, p0 - pad), nh = min(H, p0 + np + pad) - lo;
      const int lc = max(0, q0 - pad), nc = min(W, q0 + nq + pad) - lc;
      const int halo = nh * nc;
      for (int j = threadIdx.x; j < halo * C_in; j += blockDim.x) {
        const int px = j / C_in, k = j - px * C_in, hr = px / nc;
        const int seg = (in_ptr + (lo + hr) * W + lc + px - hr * nc) % n_seg;
        a[j] = pool[(size_t)seg * SEG + k];
      }
      __syncthreads();
      for (int j = threadIdx.x; j < halo * C_mid; j += blockDim.x) {
        const int px = j / C_mid, mm = j - px * C_mid;
        const float* ar = a + px * C_in;
        float acc = 0.f;
        for (int k = 0; k < C_in; ++k)
          acc = fmaf(ar[k], pw1[k * C_mid + mm], acc);
        b[j] = fmaxf(acc, 0.f);
      }
      __syncthreads();
      for (int j = threadIdx.x; j < np * nq * C_mid; j += blockDim.x) {
        const int o = j / C_mid, mm = j - o * C_mid;
        const int ph = p0 + o / nq, pq = q0 + o % nq;
        float acc = 0.f;
        for (int r = 0; r < RS; ++r) {
          const int src = ph + r - pad;
          if (src < 0 || src >= H) continue;
          const float* row = b + (size_t)(src - lo) * nc * C_mid + mm;
          for (int s = 0; s < RS; ++s) {
            const int col = pq + s - pad;
            if (col < 0 || col >= W) continue;
            acc = fmaf(row[(col - lc) * C_mid], pwd[(r * RS + s) * C_mid + mm],
                       acc);
          }
        }
        c[j] = fmaxf(acc, 0.f);
      }
      __syncthreads();
      for (int j = threadIdx.x; j < np * nq * C_out; j += blockDim.x) {
        const int o = j / C_out, co = j - o * C_out;
        const int oh = o / nq, oq = o - oh * nq;
        const float* cr = c + o * C_mid;
        float acc = 0.f;
        for (int mm = 0; mm < C_mid; ++mm)
          acc = fmaf(cr[mm], pw2[mm * C_out + co], acc);
        if (residual)
          acc += a[((p0 + oh - lo) * nc + q0 + oq - lc) * C_in + co];
        e[((p0 - t0 + oh) * un + q0 - u0 + oq) * C_out + co] = acc;
      }
      __syncthreads();   // the next sub-tile reuses a, b and c
    }
  }
  cg::this_grid().sync();   // (b): every read of the op is done
  store_rows(pool, e, TilePixels{out_ptr, W, t0, u0, un, n_seg}, tn * un,
             C_out, 1);
}

// ---------------------------------------------------------------------------
// Streaming k x k conv: the [h_win, w_in, c_in] window at state_ptr drops its
// oldest `hop` image rows and appends the frame at in_ptr; the window goes
// back to state_ptr (live channels, channel tails zero) and the k x k conv
// over it is stored at out_ptr (modulo n_seg).  One cooperative launch, tiled
// as the k x k conv (conv_tile with h_in = h_win); CTA i also owns window rows
// i * win_rows .. of the writeback.  It
//   (a) stages the window rows its taps reach, each from its source (old
//       state or frame: WindowRows), and its own window rows, then computes
//       its outputs into shared memory (k2d_outputs), storing nothing;
//   (b) meets every other CTA at the grid barrier;
//   (c) stores its window rows at state_ptr, then its outputs.
// The reference stores the window before the outputs, so where the output
// run overlaps the window region the output wins; the wrapper then passes
// `out_over_window` and a second grid barrier orders the two kinds of store
// (no committed plan has that overlap: the state lies above the frame
// program's extent).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(CONV_THREADS)
conv_stream_f32_kernel(float* pool, const float* __restrict__ w,
                       const float* __restrict__ b, int n_seg, int h_win,
                       int w_in, int h_out, int w_out, int c_in, int c_out,
                       int k, int stride, int hop, int pad_v, int pad_h,
                       int in_ptr, int out_ptr, int state_ptr, int act,
                       int rows, int ctile, int stage_w, int out_over_window,
                       int win_rows) {
  extern __shared__ float smem[];
  const int ksegs = segs_for(c_in), nsegs = segs_for(c_out);
  const int wc = w_in * ksegs, row_len = w_in * c_in;
  const int halo = (rows - 1) * stride + k;
  const ConvTile t = conv_tile(h_win, h_out, c_out, k, stride, pad_v, rows,
                               ctile);
  const ConvSmem m = conv_smem_layout((halo + win_rows) * row_len, rows,
                                      w_out, ctile, k * k * c_in * ctile,
                                      stage_w, 0);
  int ldw;
  const float* wp = stage_tile(t, m, smem, w, b, k * k * c_in, c_out, ctile,
                               stage_w, n_seg, out_ptr, w_out * nsegs, &ldw);
  const WindowRows src{state_ptr, in_ptr, h_win - hop, hop, wc};
  const int r0 = blockIdx.x * win_rows;
  const int nw = max(0, min(win_rows, h_win - r0));
  float* win = smem + (size_t)halo * row_len;       // [nw, w_in, c_in]
  stage_image_rows(smem, pool, src, t.lo, t.nh, w_in, c_in, ksegs);
  stage_image_rows(win, pool, src, r0, nw, w_in, c_in, ksegs);
  __syncthreads();
  float* y = smem + m.y;
  k2d_outputs(y, smem, wp, ldw, smem + m.bias, t, h_win, w_in, w_out, c_in,
              k, stride, pad_v, pad_h, ctile, act);
  cg::grid_group grid = cg::this_grid();
  grid.sync();   // (b): every read of the op is done
  store_rows(pool, win, RunRows{state_ptr + r0 * wc, ksegs, n_seg}, nw * w_in,
             c_in, ksegs);
  if (out_over_window) grid.sync();   // the window's stores first
  store_tile(pool, t, y, reinterpret_cast<const int*>(smem + m.out_row),
             w_out, c_out, nsegs, ctile);
}

// ---------------------------------------------------------------------------
// Fp32 GRU cell: gx = x @ W + b and gh = h @ U (W [d_in, 3 d_h], U [d_h,
// 3 d_h], gates z, r, n), then the hard-gate update of
// src/repro/quant/requant.py::gru_update, stored at state_ptr and at out_ptr
// with zero channel tails.  The GRU chain's op is in place: h' lands on x
// (out_ptr == in_ptr) and on h.  CTA i owns hidden channels i0 = i * ctile
// .. i0 + tn - 1 (stream.py::gru_tiling: one CTA of all d_h channels, or
// channel tiles of a multiple of 4) and the six matching column slices (z,
// r and n of W and of U), "columns" j = s * ctile + co of gate s below.  It
//   (a) stages x and h (16-byte cp.async copies), its biases and its
//       columns of W and U as rows of P = round4(3 ctile) floats: in one
//       CTA with 3 d_h a multiple of 4, W and U as they lie, one flat run of
//       16-byte copies each; else 16-byte copies of each row's three slices
//       where d_h is a multiple of 4, else 4-byte ones;
//   (b) computes its 6 tn gate pre-activations: a thread owns a quad of 4
//       columns of W or U and a share (`ks` lanes, the k split) of its rows
//       k = lane, lane + ks, ...; for each it reads the float4 of its quad
//       (neighbouring threads on neighbouring float4s of one row) and takes
//       4 FMAs with x[k] or h[k]; the lanes' partials go to shared memory
//       and one thread a column sums them in lane order (+ the bias for
//       gx), storing nothing;
//   (c) meets the other threads of its CTA (one CTA, an ordinary launch)
//       or every CTA at the grid barrier (BARRIER, a cooperative launch):
//       every read of the op is done;
//   (d) runs the update of its channels from the gates and the OLD h held
//       in shared memory and stores h' to the state and to the output (the
//       last tile the channel tail as zeros).
// The products sum in another order than the walk's one chain a column (a
// chain a lane, then the lanes), so h' is the plain version's within the
// fp32 tolerance, not bit for bit; the update keeps the plain version's
// rounding (each product and sum on its own: __fmul_rn, __fadd_rn).  What
// bounds it: bytes (the chain's 64 -> 64 cell moves 100 KB, 30 ns at 3.35
// TB/s, nearly all W and U); what remains is the launch (and, with BARRIER,
// the barrier) and the staging round trip of W and U through one SM, which
// the channel tiles spread over many.
// ---------------------------------------------------------------------------
constexpr int GRU_THREADS = 256;   // stream.py::GRU_THREADS

__device__ __forceinline__ float hard_sigmoid(float t) {
  return fminf(fmaxf(__fadd_rn(__fmul_rn(0.25f, t), 0.5f), 0.f), 1.f);
}

__device__ __forceinline__ float gru_update(float xz, float xr, float xn,
                                            float hz, float hr, float hn,
                                            float h) {
  const float z = hard_sigmoid(__fadd_rn(xz, hz));
  const float r = hard_sigmoid(__fadd_rn(xr, hr));
  const float n = fminf(fmaxf(__fadd_rn(xn, __fmul_rn(r, hn)), -1.f), 1.f);
  return __fadd_rn(__fmul_rn(__fsub_rn(1.f, z), n), __fmul_rn(z, h));
}

__host__ __device__ __forceinline__ int round4f(int n) {
  return (n + 3) / 4 * 4;
}

// A GRU CTA's shared memory, float offsets (stream.py::_gru_smem): x, h
// (each in whole float4s); W's and U's columns [d, P]; the biases [P];
// 4 partial sums a thread (or a quad, where the quads outnumber the
// threads); gx, gh [2, 3 ctile].  Every region starts on a float4.
struct GruSmem {
  int h, w, u, b, part, gates, words;
};

__host__ __device__ __forceinline__ GruSmem gru_layout(int d_in, int d_h,
                                                       int ctile, int thr) {
  const int p = round4f(3 * ctile);
  GruSmem m;
  m.h = round4f(d_in);
  m.w = m.h + round4f(d_h);
  m.u = m.w + d_in * p;
  m.b = m.u + d_h * p;
  m.part = m.b + p;
  m.gates = m.part + 4 * (thr > p / 2 ? thr : p / 2);
  m.words = m.gates + 6 * ctile;
  return m;
}

// Columns s * d_h + i0 .. + tn - 1 of w [depth, 3 d_h] for each gate s, as
// rows of p floats at `dst` (gate s from float s * ctile of a row).
template <int THR>
__device__ __forceinline__ void stage_gru_matrix(float* dst,
                                                 const float* __restrict__ w,
                                                 int depth, int d_h, int i0,
                                                 int tn, int ctile, int p) {
  const int g = 3 * d_h;
  const bool aligned = reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (tn == d_h && p == g && aligned) {
    for (int i = threadIdx.x; i < depth * g / 4; i += THR)
      cp_async16(dst + 4 * i, w + 4 * i, 16);
  } else if (d_h % 4 == 0 && aligned) {
    // i0, tn and ctile are multiples of 4 here
    const int vecs = tn / 4;
    for (int i = threadIdx.x; i < depth * 3 * vecs; i += THR) {
      const int k = i / (3 * vecs), r = i - k * 3 * vecs;
      const int s = r / vecs, v = r - s * vecs;
      cp_async16(dst + k * p + s * ctile + 4 * v,
                 w + (size_t)k * g + s * d_h + i0 + 4 * v, 16);
    }
  } else {
    for (int i = threadIdx.x; i < depth * 3 * tn; i += THR) {
      const int k = i / (3 * tn), r = i - k * 3 * tn, s = r / tn;
      cp_async4(dst + k * p + s * ctile + r - s * tn,
                w + (size_t)k * g + s * d_h + i0 + r - s * tn, 4);
    }
  }
}

// The k split: the most lanes (a power of two) whose quads fit THR
// threads, with no more lanes than rows a lane.
__host__ __device__ __forceinline__ int gru_lanes(int d_in, int d_h, int p,
                                                  int thr) {
  const int qqs = p / 2, depth = d_in > d_h ? d_in : d_h;
  int ks = 1;
  while (4 * ks * ks <= depth && 2 * ks * qqs <= thr) ks *= 2;
  return ks;
}

template <int THR, bool BARRIER>
__global__ void __launch_bounds__(THR)
gru_f32_kernel(float* pool, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ b,
               int n_seg, int d_in, int d_h, int in_ptr, int out_ptr,
               int state_ptr, int ctile) {
  extern __shared__ float4 vsmem[];
  float* smem = reinterpret_cast<float*>(vsmem);
  const GruSmem m = gru_layout(d_in, d_h, ctile, THR);
  const int p = round4f(3 * ctile), nq = p / 4, qqs = 2 * nq;
  const int i0 = blockIdx.x * ctile, tn = min(ctile, d_h - i0);
  // (a) x and h (neither row wraps the ring), the biases, W and U
  const float* xs = pool + (size_t)in_ptr * SEG;
  const float* hs = pool + (size_t)state_ptr * SEG;
  for (int i = threadIdx.x; i < m.h / 4; i += THR)
    cp_async16(smem + 4 * i, xs + 4 * i, 16);
  for (int i = threadIdx.x; i < (m.w - m.h) / 4; i += THR)
    cp_async16(smem + m.h + 4 * i, hs + 4 * i, 16);
  for (int i = threadIdx.x; i < 3 * tn; i += THR) {
    const int s = i / tn, co = i - s * tn;
    cp_async4(smem + m.b + s * ctile + co, b + s * d_h + i0 + co, 4);
  }
  stage_gru_matrix<THR>(smem + m.w, w, d_in, d_h, i0, tn, ctile, p);
  stage_gru_matrix<THR>(smem + m.u, u, d_h, d_h, i0, tn, ctile, p);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // (b) quad q of W (qq < nq) or of U, rows lane, lane + ks, ...
  const int ks = gru_lanes(d_in, d_h, p, THR);
  float4* part = reinterpret_cast<float4*>(smem + m.part);
  for (int t = threadIdx.x; t < ks * qqs; t += THR) {
    const int lane = t / qqs, qq = t - lane * qqs;
    const bool rec = qq >= nq;
    const int depth = rec ? d_h : d_in;
    const float* v = smem + (rec ? m.h : 0);
    const float4* mat =
        reinterpret_cast<const float4*>(smem + (rec ? m.u : m.w)) +
        (rec ? qq - nq : qq);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = lane; k < depth; k += ks) {
      const float a = v[k];
      const float4 wv = mat[k * nq];
      acc.x = fmaf(a, wv.x, acc.x);
      acc.y = fmaf(a, wv.y, acc.y);
      acc.z = fmaf(a, wv.z, acc.z);
      acc.w = fmaf(a, wv.w, acc.w);
    }
    part[t] = acc;
  }
  __syncthreads();
  // the lanes' partials of each column, in lane order, + the bias for gx
  const float* pf = smem + m.part;
  float* gx = smem + m.gates;
  float* gh = gx + 3 * ctile;
  for (int i = threadIdx.x; i < 6 * ctile; i += THR) {
    const bool rec = i >= 3 * ctile;
    const int col = rec ? i - 3 * ctile : i;
    if (col - col / ctile * ctile >= tn) continue;   // past the last tile
    const float* src = pf + 4 * ((rec ? nq : 0) + col / 4) + col % 4;
    float acc = src[0];
    for (int l = 1; l < ks; ++l) acc += src[4 * l * qqs];
    if (rec)
      gh[col] = acc;
    else
      gx[col] = __fadd_rn(acc, smem[m.b + col]);
  }
  if constexpr (BARRIER)
    cg::this_grid().sync();   // (c): every read of the op is done
  else
    __syncthreads();          // (c): one CTA, every read of the op is done
  // (d) the update from the gates and the old h
  const int co = segs_for(d_h);
  const int end = i0 + ctile >= d_h ? co * SEG : i0 + ctile;
  const float* h = smem + m.h;
  for (int c = i0 + threadIdx.x; c < end; c += THR) {
    const int j = c - i0;
    const float y = c < d_h ? gru_update(gx[j], gx[ctile + j],
                                         gx[2 * ctile + j], gh[j],
                                         gh[ctile + j], gh[2 * ctile + j],
                                         h[c])
                            : 0.f;
    pool[(size_t)state_ptr * SEG + c] = y;
    pool[ring_index(out_ptr, 0, c, co, n_seg)] = y;
  }
}

// ---------------------------------------------------------------------------
// Fused MLP, in place (delta 0): over m_rows rows of d_model channels at ptr,
//   up = x @ W_up, gate = x @ W_gate (gated only), h = act(gate) * up or
//   act(up), y = h @ W_down (+ x), stored over the rows it was read from.
// W_gate, W_up [d_model, d_ff], W_down [d_ff, d_model].  The [m_rows, d_ff]
// intermediate never exists, and no whole row of x or of the sum is ever
// held, so d_model is not bounded by shared memory.
//
// Two launches; the boundary between them is the op's barrier (every read
// of x before any store):
//   1. fused_mlp_f32_kernel, one CTA per (block of 16 * TM rows, ff
//      sub-tile): d_ff is cut into the op's ff_tile tiles (the reference's
//      accumulation unit) and each tile into `splits` sub-tiles of `sub`
//      columns (the last one shorter).  The CTA computes h = act(...) of its
//      rows x sub-tile into shared memory (the up and gate products over
//      d_model in k-chunks, x read straight from the ring), then its partial
//      h @ W_down[sub-tile] over d_model in blocks of 128 columns, and
//      writes it to scratch[sub-tile][row][:] (fp32, rows padded to whole
//      segments; the wrapper allocates it).  It stores nothing into the pool.
//   2. mlp_reduce_f32_kernel sums each row's partials in sub-tile order from
//      zero (ff-tile order, as the reference's acc + h_tile @ W_down[tile]),
//      adds x read from the pool, and stores whole segments, channel tails
//      zero; one thread reads and stores the same four lanes.
//
// Each product is a register-tiled fp32 SIMT matrix product: 256 threads,
// each holding TM rows x 8 columns of a [16 TM, 128] output block in
// registers; both operands pass through shared memory in k-chunks of
// MLP_BK, double-buffered with cp.async (zero-filled past the rows, the
// columns and d_model), so that one shared-memory load feeds several FMAs.
// Each output's sum runs over k in order, one FMA at a time.  What bounds it:
// whisper-tiny's layer (1,500 rows, d_model 384, d_ff 1536) is 1.77 G FMAs
// over 9.3 MB, so the FMA rate (no tensor cores: fp32 without TF32);
// kernels/fused_mlp.py::mlp_tiling picks TM and the sub-tiles that leave
// the busiest SM the fewest FMAs (whisper-tiny's layer: 114 CTAs of 80 rows
// x 256 d_ff columns, one an SM).
// ---------------------------------------------------------------------------
constexpr int MLP_THREADS = 256;
constexpr int MLP_BK = 32;     // depth of a staged k-chunk
constexpr int MLP_BN = 128;    // columns of an output block (16 x 8)
constexpr int MLP_AP = MLP_BK + 4;   // row pitch of a staged x chunk
constexpr int MLP_STAGES = 2;  // k-chunks in flight (shared-memory buffers)

__host__ __device__ __forceinline__ int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Shared memory of a phase-1 CTA, in floats: h [16 TM, hp] (hp: the
// sub-tile's columns rounded up to MLP_BK, + 4), MLP_STAGES x chunks
// [16 TM, MLP_AP] and MLP_STAGES weight chunks [MLP_BK, MLP_BN].
struct MlpSmem {
  int a, b, words;
};

__host__ __device__ __forceinline__ MlpSmem mlp_smem_layout(int tm, int sub) {
  const int bm = 16 * tm, hp = round_up(sub, MLP_BK) + 4;
  MlpSmem m;
  m.a = bm * hp;
  m.b = m.a + MLP_STAGES * bm * MLP_AP;
  m.words = m.b + MLP_STAGES * MLP_BK * MLP_BN;
  return m;
}

// Copy the `n` (0..4) floats at src to dst and zero the rest of the four:
// one 16-byte copy where src is 16-byte aligned (`vec`), else four.
__device__ __forceinline__ void copy4(float* dst, const float* src, int n,
                                      int vec) {
  if (vec) {
    cp_async16(dst, src, 4 * n);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) cp_async4(dst + j, src + (j < n ? j : 0),
                                          j < n ? 4 : 0);
  }
}

// This thread's share of a stream of weight chunks [MLP_BK, MLP_BN]: chunk
// c is rows c * MLP_BK .. of w (row stride ldw; those below k_end) and
// columns c0 .. (those below c_end).  The addresses are found once, and
// each chunk moves them MLP_BK rows on.
struct WeightChunks {
  static constexpr int N = MLP_BK * MLP_BN / 4 / MLP_THREADS;
  const float* src[N];
  int row[N], n[N];

  __device__ __forceinline__ WeightChunks(const float* w, int ldw, int c0,
                                          int c_end) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int e = threadIdx.x + j * MLP_THREADS;
      const int cq = 4 * (e % (MLP_BN / 4));
      row[j] = e / (MLP_BN / 4);
      n[j] = max(0, min(4, c_end - c0 - cq));
      src[j] = w + (size_t)row[j] * ldw + c0 + cq;
    }
  }

  __device__ __forceinline__ void stage(float* dst, int c, int ldw,
                                        int k_end, int vec) const {
    const size_t step = (size_t)c * MLP_BK * ldw;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int live = c * MLP_BK + row[j] < k_end ? n[j] : 0;
      copy4(dst + 4 * (threadIdx.x + j * MLP_THREADS),
            live ? src[j] + step : src[j], live, vec);
    }
  }
};

// acc[i][j] += sum_k a[i][k] * b[k][j] over the MLP_BK depths of a chunk,
// for this thread's TM rows (a: its first row; rows 16 apart, row pitch
// lda) and its 8 columns (b: its first column of a [MLP_BK, MLP_BN] chunk;
// columns +0..3 and +64..67).  In order of k, one FMA at a time per
// output.  A warp reads 4 rows (consecutive: in different banks for the
// pitches used) and 8 float4s of b (contiguous) per load.
template <int TM>
__device__ __forceinline__ void mma_chunk(float (&acc)[TM][8], const float* a,
                                          int lda, const float* b) {
#pragma unroll
  for (int k = 0; k < MLP_BK; k += 4) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + 16 * i * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 =
          *reinterpret_cast<const float4*>(b + (k + kk) * MLP_BN);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b + (k + kk) * MLP_BN + 64);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y
                        : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
      }
    }
  }
}

// Run `nk` k-chunks through MLP_STAGES shared-memory buffers: load(c, buf)
// issues chunk c's copies MLP_STAGES - 1 chunks ahead, compute(c, buf)
// uses them once they have landed.  One barrier a chunk: after it, every
// thread is done with the buffer the next load overwrites.
template <typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int nk, Load load, Compute compute) {
  for (int c = 0; c < MLP_STAGES - 1; ++c) {
    if (c < nk) load(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<MLP_STAGES - 2>();
    __syncthreads();
    const int next = c + MLP_STAGES - 1;
    if (next < nk) load(next, next % MLP_STAGES);
    cp_async_commit();
    compute(c, c % MLP_STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();   // the caller's next pipeline reuses the buffers
}

template <int TM>
__global__ void __launch_bounds__(MLP_THREADS)
fused_mlp_f32_kernel(const float* __restrict__ pool,
                     const float* __restrict__ w_gate,
                     const float* __restrict__ w_up,
                     const float* __restrict__ w_down,
                     float* __restrict__ scratch, int n_seg, int m_rows,
                     int d, int d_ff, int ptr, int gated, int act,
                     int ff_tile, int sub, int splits, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int BM = 16 * TM;
  const MlpSmem m = mlp_smem_layout(TM, sub);
  const int hp = round_up(sub, MLP_BK) + 4;
  const int n_sub = d_ff / ff_tile * splits;
  const int rb = blockIdx.x / n_sub, s = blockIdx.x - rb * n_sub;
  const int tile = s / splits;
  const int f0 = tile * ff_tile + (s - tile * splits) * sub;
  const int ft = min(sub, (tile + 1) * ff_tile - f0);   // > 0 (wrapper)
  const int ftp = round_up(ft, MLP_BK);
  const int r0 = rb * BM, dsegs = segs_for(d), dp = dsegs * SEG;
  // this thread's rows rg + 16 i and columns cg * 4 .. (+ 64 ..) of a block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = (warp / 2) * 4 + lane / 8, cg = (warp % 2) * 8 + lane % 8;
  float* hs = smem;                                  // [BM, hp]
  float acc[TM][8];

  // x chunk c ([BM, MLP_BK] at columns c * MLP_BK) straight from the ring:
  // lanes past d and rows past m_rows are zeros.  Each thread copies the
  // same rows in every chunk, so it finds their ring segments once.
  constexpr int XC = (BM * MLP_BK / 4 + MLP_THREADS - 1) / MLP_THREADS;
  int xseg[XC];
#pragma unroll
  for (int j = 0; j < XC; ++j) {
    const int r = r0 + (threadIdx.x + j * MLP_THREADS) / (MLP_BK / 4);
    xseg[j] = r < m_rows ? (ptr + r * dsegs) % n_seg : -1;
  }
  auto load_x = [&](int c, int buf) {
    float* dst = smem + m.a + buf * BM * MLP_AP;
#pragma unroll
    for (int j = 0; j < XC; ++j) {
      const int e = threadIdx.x + j * MLP_THREADS;
      if (e >= BM * MLP_BK / 4) break;
      const int i = e / (MLP_BK / 4), k = c * MLP_BK + 4 * (e % (MLP_BK / 4));
      const int n = xseg[j] < 0 ? 0 : max(0, min(4, d - k));
      int seg = xseg[j] + k / SEG;   // k / SEG < dsegs: wraps at most once
      if (seg >= n_seg) seg -= n_seg;
      cp_async16(dst + i * MLP_AP + k - c * MLP_BK,
                 n ? pool + (size_t)seg * SEG + k % SEG : pool,
                 4 * n);   // 16-byte aligned
    }
  };
  // h = act(x @ W[:, sub-tile]) (the gate, or the ungated up), or
  // h *= x @ W_up[:, sub-tile] (the gated up), over 128-column passes.
  auto up_product = [&](const float* __restrict__ w, bool gate) {
    for (int n0 = 0; n0 < ftp; n0 += MLP_BN) {
      const WeightChunks wc(w, d_ff, f0 + n0, f0 + ft);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      pipeline(
          (d + MLP_BK - 1) / MLP_BK,
          [&](int c, int buf) {
            load_x(c, buf);
            wc.stage(smem + m.b + buf * MLP_BK * MLP_BN, c, d_ff, d, vec);
          },
          [&](int, int buf) {
            mma_chunk<TM>(acc, smem + m.a + (buf * BM + rg) * MLP_AP,
                          MLP_AP, smem + m.b + buf * MLP_BK * MLP_BN + cg * 4);
          });
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + cg * 4 + (j < 4 ? j : 60 + j);
          if (col >= ftp) continue;
          float* h = hs + (rg + 16 * i) * hp + col;
          if (gate || !gated)
            *h = activate(acc[i][j], act);
          else
            *h = *h * acc[i][j];   // act(gate) * up, this thread's own h
        }
    }
  };
  if (gated) up_product(w_gate, true);
  up_product(w_up, false);

  // partial = h @ W_down[sub-tile, :] in blocks of 128 output columns
  float* part = scratch + ((size_t)s * m_rows + r0) * dp;
  for (int n0 = 0; n0 < d; n0 += MLP_BN) {
    const WeightChunks wc(w_down + (size_t)f0 * d, d, n0, d);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    pipeline(
        ftp / MLP_BK,
        [&](int c, int buf) {
          wc.stage(smem + m.b + buf * MLP_BK * MLP_BN, c, d, ft, vec);
        },
        [&](int c, int buf) {
          mma_chunk<TM>(acc, hs + rg * hp + c * MLP_BK, hp,
                        smem + m.b + buf * MLP_BK * MLP_BN + cg * 4);
        });
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = rg + 16 * i;
      if (r0 + r >= m_rows) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = n0 + cg * 4 + 64 * half;   // < dp
        *reinterpret_cast<float4*>(part + (size_t)r * dp + col) =
            make_float4(acc[i][4 * half], acc[i][4 * half + 1],
                        acc[i][4 * half + 2], acc[i][4 * half + 3]);
      }
    }
  }
}

// Phase 2: y = sum of the n_sub partials in order (+ x), whole segments.
constexpr int EW_THREADS = 256;

__global__ void __launch_bounds__(EW_THREADS)
mlp_reduce_f32_kernel(float* pool, const float* __restrict__ scratch,
                      int n_seg, int m_rows, int d, int ptr, int n_sub,
                      int residual) {
  float4* p4 = reinterpret_cast<float4*>(pool);
  const float4* s4 = reinterpret_cast<const float4*>(scratch);
  constexpr int V = SEG / 4;                        // float4s per segment
  const int dsegs = segs_for(d), row = dsegs * V;
  const size_t plane = (size_t)m_rows * row;        // float4s per partial
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m_rows * row;
       i += gridDim.x * blockDim.x) {
    const int r = i / row, v = i - r * row, c = 4 * v;
    const size_t at = (size_t)((ptr + r * dsegs + v / V) % n_seg) * V + v % V;
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < d) {
      for (int s = 0; s < n_sub; ++s) {
        const float4 q = s4[s * plane + i];
        y.x += q.x;
        y.y += q.y;
        y.z += q.z;
        y.w += q.w;
      }
      if (residual) {
        const float4 x = p4[at];
        y.x += x.x;
        y.y += x.y;
        y.z += x.z;
        y.w += x.w;
      }
      if (c + 1 >= d) y.y = 0.f;
      if (c + 2 >= d) y.z = 0.f;
      if (c + 3 >= d) y.w = 0.f;
    }
    p4[at] = y;
  }
}

// ---------------------------------------------------------------------------
// Elementwise map, in place (delta 0): act over the n_segs whole segments at
// ptr (the padded [m_rows * segs(d), 128] region, channel tails included;
// every activation maps 0 to 0, so tails stay zero), on past the ring's end
// from segment 0.  Each float is read and stored by the same thread, so many
// blocks keep the op in place.  The region is at most two linear runs, [ptr,
// ptr + first) and [0, n_segs - first) (kernels/elementwise.py::ring_runs
// gives `first`), so an index maps to its float4 with one compare and no
// modulo, and the activation is a template argument, so its code has no
// branch.  Bound by its bytes: a float4 a thread, a warp's on 512 contiguous
// bytes, over a grid the wrapper sizes to the SMs
// (kernels/elementwise.py::ew_blocks: whisper-tiny's 144,000 float4s are all
// in flight at once, 563 blocks of 256 threads).
// ---------------------------------------------------------------------------
template <int ACT>
__global__ void __launch_bounds__(EW_THREADS)
elementwise_f32_kernel(float* pool, int n_segs, int ptr, int first) {
  float4* p4 = reinterpret_cast<float4*>(pool);
  constexpr int V = SEG / 4;                        // float4s per segment
  const int n = n_segs * V, head = first * V;
  const size_t base = (size_t)ptr * V;
  for (int i = blockIdx.x * EW_THREADS + threadIdx.x; i < n;
       i += gridDim.x * EW_THREADS) {
    const size_t at = i < head ? base + i : (size_t)(i - head);
    float4 v = p4[at];
    v.x = activate(v.x, ACT);
    v.y = activate(v.y, ACT);
    v.z = activate(v.z, ACT);
    v.w = activate(v.w, ACT);
    p4[at] = v;
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

}  // namespace

extern "C" {

const char* ring_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int ring_gemm(void* pool, const void* w, const void* b, int n_seg, int m_rows,
              int d_in, int d_out, int in_ptr, int out_ptr, int act, int rows,
              int ctile, void* stream) {
  const int ctas = (m_rows + rows - 1) / rows * ((d_out + ctile - 1) / ctile);
  const GemmSmem m = gemm_smem_layout(rows, ctile, d_in);
  return launch_cooperative(gemm_f32_kernel, ctas, dim3(GEMM_THREADS),
                            sizeof(float) * (size_t)m.words, stream,
                            (float*)pool, (const float*)w, (const float*)b,
                            n_seg, m_rows, d_in, d_out, in_ptr, out_ptr, act,
                            rows, ctile);
}

int ring_conv_pw(void* pool, const void* w, const void* b, int n_seg,
                 int h_in, int w_in, int h_out, int w_out, int c_in,
                 int c_out, int stride, int resample, int in_ptr, int out_ptr,
                 int act, int rows, int ctile, int stage_w, void* stream) {
  const ConvSmem m = conv_smem_layout(rows * w_out * (c_in | 1), rows, w_out,
                                      ctile, c_in * ctile, stage_w, 0);
  const int ctas = (h_out + rows - 1) / rows * ((c_out + ctile - 1) / ctile);
  return launch_cooperative(conv_pw_f32_kernel, ctas, conv_block(ctile),
                            sizeof(float) * (size_t)m.words, stream,
                            (float*)pool, (const float*)w, (const float*)b,
                            n_seg, h_in, w_in, h_out, w_out, c_in, c_out,
                            stride, resample, in_ptr, out_ptr, act, rows,
                            ctile, stage_w);
}

int ring_conv_dw(void* pool, const void* w, const void* b, int n_seg,
                 int h_in, int w_in, int h_out, int w_out, int c, int rs,
                 int stride, int pad_v, int pad_h, int in_ptr, int out_ptr,
                 int act, int rows, int stage_w, void* stream) {
  const int ct = c < SEG ? c : SEG;
  const ConvSmem m = conv_smem_layout(0, rows, w_out, ct, rs * rs * ct,
                                      stage_w, (rows - 1) * stride + rs);
  const int ctas = (h_out + rows - 1) / rows * segs_for(c);
  return launch_cooperative(conv_dw_f32_kernel, ctas, conv_block(ct),
                            sizeof(float) * (size_t)m.words, stream,
                            (float*)pool, (const float*)w, (const float*)b,
                            n_seg, h_in, w_in, h_out, w_out, c, rs, stride,
                            pad_v, pad_h, in_ptr, out_ptr, act, rows, stage_w);
}

int ring_conv_k2d(void* pool, const void* w, const void* b, int n_seg,
                  int h_in, int w_in, int h_out, int w_out, int c_in,
                  int c_out, int k, int stride, int pad_v, int pad_h,
                  int in_ptr, int out_ptr, int act, int rows, int ctile,
                  int stage_w, void* stream) {
  const int halo = (rows - 1) * stride + k;
  const ConvSmem m = conv_smem_layout(halo * w_in * c_in, rows, w_out, ctile,
                                      k * k * c_in * ctile, stage_w, 0);
  const int ctas = (h_out + rows - 1) / rows * ((c_out + ctile - 1) / ctile);
  return launch_cooperative(conv_k2d_f32_kernel, ctas, conv_block(ctile),
                            sizeof(float) * (size_t)m.words, stream,
                            (float*)pool, (const float*)w, (const float*)b,
                            n_seg, h_in, w_in, h_out, w_out, c_in, c_out, k,
                            stride, pad_v, pad_h, in_ptr, out_ptr, act, rows,
                            ctile, stage_w);
}

int ring_add(void* pool, int n_seg, int rows, int d, int in_ptr, int aux_ptr,
             int out_ptr, int act, int tile_rows, void* stream) {
  return launch_cooperative(add_f32_kernel, (rows + tile_rows - 1) / tile_rows,
                            dim3(ADD_THREADS),
                            sizeof(float) * (size_t)tile_rows * d, stream,
                            (float*)pool, n_seg, rows, d, in_ptr, aux_ptr,
                            out_ptr, act, tile_rows);
}

int ring_avgpool(void* pool, int n_seg, int h, int w, int c, int in_ptr,
                 int out_ptr, int threads, int parts, int chunk_pix,
                 void* stream) {
  const size_t smem = sizeof(float) * pool_smem_floats(c, parts, chunk_pix);
  float* p = (float*)pool;
  switch (threads) {
    case 256:
      return launch_grid(avgpool_f32_kernel<256>, 1, 256, smem, stream, p,
                         n_seg, h, w, c, in_ptr, out_ptr, parts, chunk_pix);
    case 512:
      return launch_grid(avgpool_f32_kernel<512>, 1, 512, smem, stream, p,
                         n_seg, h, w, c, in_ptr, out_ptr, parts, chunk_pix);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int ring_inverted_bottleneck(void* pool, const void* w1, const void* wd,
                             const void* w2, int n_seg, int H, int W,
                             int C_in, int C_mid, int C_out, int RS,
                             int in_ptr, int out_ptr, int residual, int rows,
                             int cols, int sub_rows, int sub_cols,
                             int stage_w, void* stream) {
  const IbSmem m = ib_smem_layout(H, W, C_in, C_mid, C_out, RS, rows, cols,
                                  sub_rows, sub_cols, stage_w);
  const int ctas = (H + rows - 1) / rows * ((W + cols - 1) / cols);
  return launch_cooperative(ib_f32_kernel, ctas, dim3(THREADS),
                            sizeof(float) * (size_t)m.words, stream,
                            (float*)pool, (const float*)w1, (const float*)wd,
                            (const float*)w2, n_seg, H, W, C_in, C_mid, C_out,
                            RS, in_ptr, out_ptr, residual, rows, cols,
                            sub_rows, sub_cols, stage_w);
}

int ring_conv_stream(void* pool, const void* w, const void* b, int n_seg,
                     int h_win, int w_in, int h_out, int w_out, int c_in,
                     int c_out, int k, int stride, int hop, int pad_v,
                     int pad_h, int in_ptr, int out_ptr, int state_ptr,
                     int act, int rows, int ctile, int stage_w,
                     int out_over_window, void* stream) {
  const int ctas = (h_out + rows - 1) / rows * ((c_out + ctile - 1) / ctile);
  const int win_rows = (h_win + ctas - 1) / ctas;
  const int halo = (rows - 1) * stride + k;
  const ConvSmem m = conv_smem_layout((halo + win_rows) * w_in * c_in, rows,
                                      w_out, ctile, k * k * c_in * ctile,
                                      stage_w, 0);
  return launch_cooperative(conv_stream_f32_kernel, ctas, conv_block(ctile),
                            sizeof(float) * (size_t)m.words, stream,
                            (float*)pool, (const float*)w, (const float*)b,
                            n_seg, h_win, w_in, h_out, w_out, c_in, c_out, k,
                            stride, hop, pad_v, pad_h, in_ptr, out_ptr,
                            state_ptr, act, rows, ctile, stage_w,
                            out_over_window, win_rows);
}

int ring_gru_cell(void* pool, const void* w, const void* u, const void* b,
                  int n_seg, int d_in, int d_h, int in_ptr, int out_ptr,
                  int state_ptr, int ctile, int barrier, void* stream) {
  const size_t smem =
      sizeof(float) * (size_t)gru_layout(d_in, d_h, ctile, GRU_THREADS).words;
  const int ctas = (d_h + ctile - 1) / ctile;
  if (barrier)
    return launch_cooperative(gru_f32_kernel<GRU_THREADS, true>, ctas,
                              dim3(GRU_THREADS), smem, stream, (float*)pool,
                              (const float*)w, (const float*)u,
                              (const float*)b, n_seg, d_in, d_h, in_ptr,
                              out_ptr, state_ptr, ctile);
  return launch_grid(gru_f32_kernel<GRU_THREADS, false>, ctas, GRU_THREADS,
                     smem, stream, (float*)pool, (const float*)w,
                     (const float*)u, (const float*)b, n_seg, d_in, d_h,
                     in_ptr, out_ptr, state_ptr, ctile);
}

int ring_fused_mlp(void* pool, const void* w_gate, const void* w_up,
                   const void* w_down, void* scratch, int n_seg, int m_rows,
                   int d_model, int d_ff, int ptr, int gated, int residual,
                   int act, int ff_tile, int tm, int sub, int splits, int vec,
                   void* stream) {
  const int n_sub = d_ff / ff_tile * splits;
  const int ctas = (m_rows + 16 * tm - 1) / (16 * tm) * n_sub;
  const size_t smem = sizeof(float) * (size_t)mlp_smem_layout(tm, sub).words;
  const float* p = (const float*)pool;
  const float *wg = (const float*)w_gate, *wu = (const float*)w_up,
              *wd = (const float*)w_down;
  float* sc = (float*)scratch;
  int err;
#define MLP_LAUNCH(T)                                                        \
  case T:                                                                    \
    err = launch_grid(fused_mlp_f32_kernel<T>, ctas, MLP_THREADS, smem,      \
                      stream, p, wg, wu, wd, sc, n_seg, m_rows, d_model,     \
                      d_ff, ptr, gated, act, ff_tile, sub, splits, vec);     \
    break;
  switch (tm) {
    MLP_LAUNCH(1) MLP_LAUNCH(2) MLP_LAUNCH(3) MLP_LAUNCH(4)
    MLP_LAUNCH(5) MLP_LAUNCH(6) MLP_LAUNCH(7) MLP_LAUNCH(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MLP_LAUNCH
  if (err) return err;
  const int vecs = m_rows * segs_for(d_model) * (SEG / 4);
  int blocks = (vecs + EW_THREADS - 1) / EW_THREADS;
  blocks = blocks < 132 * 8 ? blocks : 132 * 8;
  return launch_grid(mlp_reduce_f32_kernel, blocks, EW_THREADS, 0, stream,
                     (float*)pool, (const float*)scratch, n_seg, m_rows,
                     d_model, ptr, n_sub, residual);
}

int ring_elementwise(void* pool, int n_segs, int ptr, int first, int act,
                     int blocks, void* stream) {
  float* p = (float*)pool;
  switch (act) {
    case IDENTITY:
      return launch_grid(elementwise_f32_kernel<IDENTITY>, blocks, EW_THREADS,
                         0, stream, p, n_segs, ptr, first);
    case RELU:
      return launch_grid(elementwise_f32_kernel<RELU>, blocks, EW_THREADS, 0,
                         stream, p, n_segs, ptr, first);
    case GELU:
      return launch_grid(elementwise_f32_kernel<GELU>, blocks, EW_THREADS, 0,
                         stream, p, n_segs, ptr, first);
    case SILU:
      return launch_grid(elementwise_f32_kernel<SILU>, blocks, EW_THREADS, 0,
                         stream, p, n_segs, ptr, first);
    case SQUARE:
      return launch_grid(elementwise_f32_kernel<SQUARE>, blocks, EW_THREADS,
                         0, stream, p, n_segs, ptr, first);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
