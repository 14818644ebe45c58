// Times the int8 global average pool and GRU cell designs tried for the
// H100 against each other and against the kernels in ring_q.cu, on one card,
// with held-stream CUDA events (a spin kernel holds the stream until every
// launch is enqueued, so the events time the device alone), 200 launches
// each, and checks each design bitwise against the one-block walk the port
// ran before.  Build and run from the root of a checkout:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/q_pool_gru_variants tools/q_pool_gru_variants.cu
//   build/q_pool_gru_variants
//
// Designs (us a launch, the plan pools' geometries and two wider ones):
//   pool  empty     an empty kernel of 256 threads (the launch floor);
//         walk      one block of 1024 threads: stage every pixel, then a
//                   thread a channel adds its h w bytes in order;
//         groups    each thread sums 16-byte vectors of a group of pixels in
//                   registers, the groups' partials are combined with
//                   shuffles and in shared memory after a barrier;
//         regs      no shared memory: R lanes of a warp share a vector,
//                   an xor butterfly sums them (uncoalesced loads);
//         words     stage, channel parts, a thread a word combines them;
//         kernel    ring_q.cu's avgpool_q_kernel (ring_avgpool_q);
//   gru   walk      one block of 1024 threads, a thread a gate column
//                   walking W or U in global memory;
//         kernel    ring_q.cu's gru_q_kernel in one CTA, and in channel
//                   tiles of 4 under a grid barrier;
//         direct    one CTA reading W and U from global memory where they
//                   lie (nothing staged), 256 threads.
#include "../src/repro_torch/kernels/csrc/ring_q.cu"

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {
constexpr int THREADS = 1024;
__device__ __forceinline__ void ring_load(int4* dst, const int8_t* pool,
                                          int ptr, int count, int n_seg) {
  for (int i = threadIdx.x; i < count * VEC; i += blockDim.x) {
    const int seg = (ptr + i / VEC) % n_seg;
    dst[i] = reinterpret_cast<const int4*>(pool + (size_t)seg * SEG)[i % VEC];
  }
}
__device__ __forceinline__ int8_t* ring_byte(int8_t* pool, int ptr, int j,
                                             int n_seg) {
  return pool + (size_t)((ptr + j / SEG) % n_seg) * SEG + j % SEG;
}
__global__ void __launch_bounds__(THREADS)
p0_kernel(int8_t* pool, int n_seg, int h, int w, int c, int in_ptr,
          int out_ptr, int mult, int shift, int chunk_pix) {
  extern __shared__ int4 smem[];
  const int segs = segs_for(c);
  uint32_t* sums = reinterpret_cast<uint32_t*>(smem);
  int4* tile = smem + segs * SEG * 4 / 16;
  const int8_t* x = reinterpret_cast<const int8_t*>(tile);
  for (int j = threadIdx.x; j < segs * SEG; j += blockDim.x) sums[j] = 0;
  for (int p0 = 0; p0 < h * w; p0 += chunk_pix) {
    const int n = min(chunk_pix, h * w - p0);
    ring_load(tile, pool, (in_ptr + p0 * segs) % n_seg, n * segs, n_seg);
    __syncthreads();
    for (int j = threadIdx.x; j < c; j += blockDim.x) {
      uint32_t acc = sums[j];
#pragma unroll 4
      for (int pix = 0; pix < n; ++pix)
        acc += (uint32_t)(int)x[pix * segs * SEG + j];
      sums[j] = acc;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < segs * SEG; j += blockDim.x)
    *ring_byte(pool, out_ptr, j, n_seg) =
        j < c ? sat8(requant_i32((int32_t)sums[j], mult, shift)) : (int8_t)0;
}

__device__ __forceinline__ void add_bytes(uint32_t* acc, const int4& q) {
  const uint32_t v[4] = {(uint32_t)q.x, (uint32_t)q.y, (uint32_t)q.z,
                         (uint32_t)q.w};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    acc[k] += (uint32_t)(int)(int8_t)(v[k / 4] >> (8 * (k % 4)));
}
constexpr int POOL_ITEMS = 4;

// groups: vectors over every thread, shuffle over the groups of a warp, per-warp
// partials in shared memory, one thread a word sums the rows.
template <int THR>
__global__ void __launch_bounds__(THR)
p3_kernel(int8_t* pool, int n_seg, int h, int w, int c, int in_ptr,
          int out_ptr, int mult, int shift) {
  extern __shared__ int4 qsmem[];
  uint32_t* part = reinterpret_cast<uint32_t*>(qsmem);
  const int segs = segs_for(c), vecs = segs * VEC, npix = h * w;
  const int groups = vecs < THR ? THR / vecs : 1;
  const bool shfl = vecs <= 32 && 32 % vecs == 0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int slot = threadIdx.x; slot < groups * vecs; slot += THR) {
    const int v = slot % vecs, g = slot / vecs;
    uint32_t acc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = 0;
    for (int p0 = g; p0 < npix; p0 += POOL_ITEMS * groups) {
      int4 q[POOL_ITEMS];
#pragma unroll
      for (int u = 0; u < POOL_ITEMS; ++u) {
        const int p = p0 + u * groups;
        q[u] = p < npix ? reinterpret_cast<const int4*>(
                              pool + (size_t)((in_ptr + p * segs) % n_seg) *
                                         SEG)[v]
                        : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < POOL_ITEMS; ++u) add_bytes(acc, q[u]);
    }
    if (shfl) {
      for (int off = vecs; off < 32; off *= 2)
#pragma unroll
        for (int k = 0; k < 16; ++k)
          acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
      if (lane < vecs)
#pragma unroll
        for (int k = 0; k < 16; ++k) part[warp * segs * SEG + 16 * v + k] = acc[k];
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) part[g * segs * SEG + 16 * v + k] = acc[k];
    }
  }
  const int rows = shfl ? THR / 32 : groups;
  __syncthreads();
  for (int i = threadIdx.x; i < segs * WORDS; i += THR) {
    uint32_t out = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ch = 4 * i + k;
      if (ch < c) {
        uint32_t s = 0;
#pragma unroll 8
        for (int r = 0; r < rows; ++r) s += part[r * segs * SEG + ch];
        out |= (uint32_t)(uint8_t)sat8(requant_i32((int32_t)s, mult, shift)) << (8 * k);
      }
    }
    *row_word(pool, out_ptr, i / WORDS, i % WORDS, n_seg) = out;
  }
}

// regs: no shared memory, no barrier.  R lanes of a warp share a 16-byte
// vector v of the live channels: lane j sums pixels j, j + R, ... of it
// (16 int32 partials), an xor butterfly gives every lane the sums, and
// lanes j < 4 requantize and store word j of vector v.  Only vector v's
// warp reads the bytes its stores land on, after the shuffle.
template <int THR, int RMAX>
__global__ void __launch_bounds__(THR)
p8_kernel(int8_t* pool, int n_seg, int h, int w, int c, int in_ptr,
          int out_ptr, int mult, int shift) {
  const int segs = segs_for(c), npix = h * w, vl = (c + 15) / 16;
  int R = 1;
  while (2 * R <= RMAX && 2 * R * vl <= THR && 2 * R <= npix) R *= 2;
  const int per = THR / R, j = threadIdx.x % R;
  const int step = (R * segs) % n_seg;
  for (int base = 0; base < vl; base += per) {
    const int v = base + threadIdx.x / R;
    const bool live = v < vl;
    uint32_t acc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = 0;
    if (live) {
      int seg = (in_ptr + j * segs) % n_seg;
      for (int p0 = j; p0 < npix; p0 += 4 * R) {
        int4 q[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          q[u] = p0 + u * R < npix
                     ? reinterpret_cast<const int4*>(pool + (size_t)seg * SEG)[v]
                     : make_int4(0, 0, 0, 0);
          seg += step;
          if (seg >= n_seg) seg -= n_seg;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) add_bytes(acc, q[u]);
      }
    }
    for (int off = 1; off < R; off *= 2)
#pragma unroll
      for (int k = 0; k < 16; ++k)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    if (live) {
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        if (wd % R != j) continue;
        uint32_t out = 0;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (16 * v + 4 * wd + kk < c)
            out |= (uint32_t)(uint8_t)sat8(requant_i32((int32_t)acc[4 * wd + kk], mult, shift)) << (8 * kk);
        *row_word(pool, out_ptr, v / VEC, v % VEC * 4 + wd, n_seg) = out;
      }
    }
  }
  for (int i = vl * 4 + threadIdx.x; i < segs * WORDS; i += THR)
    *row_word(pool, out_ptr, i / WORDS, i % WORDS, n_seg) = 0;
}

// words: stage pixels (cp.async 16 B, chunks of chunk_pix); thread (j, ch),
// channels fastest (a warp reads one pixel's 32 consecutive bytes: no bank
// conflict), sums pixels p = j mod R of channel ch into part[j][ch]; then a
// thread a word adds its 4 channels' R partials (16-byte loads),
// requantizes and stores.
template <int THR>
__global__ void __launch_bounds__(THR)
p9_kernel(int8_t* pool, int n_seg, int h, int w, int c, int in_ptr,
          int out_ptr, int mult, int shift, int chunk_pix) {
  extern __shared__ int4 qsmem[];
  const int segs = segs_for(c), vecs = segs * VEC, npix = h * w;
  const int lanes = segs * SEG, cw = (c + 31) / 32 * 32;
  const int R = cw < THR ? THR / cw : 1;
  uint32_t* part = reinterpret_cast<uint32_t*>(qsmem);          // [R][lanes]
  int4* tile = qsmem + R * lanes / 4;
  const int8_t* x = reinterpret_cast<const int8_t*>(tile);
  for (int t = threadIdx.x; t < R * cw; t += THR)
    part[(t / cw) * lanes + t % cw] = 0;
  for (int p0 = 0; p0 < npix; p0 += chunk_pix) {
    const int n = min(chunk_pix, npix - p0);
    for (int i = threadIdx.x; i < n * vecs; i += THR) {
      const int p = i / vecs, v = i - p * vecs;
      cp_async16(tile + i, pool + (size_t)((in_ptr + (p0 + p) * segs) % n_seg) * SEG + 16 * v);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int t = threadIdx.x; t < R * cw; t += THR) {
      const int ch = t % cw, j = t / cw;
      if (ch < c) {
        uint32_t s = 0;
#pragma unroll 4
        for (int p = ((j - p0) % R + R) % R; p < n; p += R)
          s += (uint32_t)(int)x[p * lanes + ch];
        part[j * lanes + ch] += s;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < segs * WORDS; i += THR) {
    uint32_t out = 0;
    if (4 * i < c) {
      uint32_t sum[4] = {0, 0, 0, 0};
      for (int j = 0; j < R; ++j) {
        const int4 q = reinterpret_cast<const int4*>(part + j * lanes)[i];
        sum[0] += (uint32_t)q.x; sum[1] += (uint32_t)q.y;
        sum[2] += (uint32_t)q.z; sum[3] += (uint32_t)q.w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * i + k < c)
          out |= (uint32_t)(uint8_t)sat8(requant_i32((int32_t)sum[k], mult, shift)) << (8 * k);
    }
    *row_word(pool, out_ptr, i / WORDS, i % WORDS, n_seg) = out;
  }
}

template <int THR>
__global__ void __launch_bounds__(THR) empty_t(int8_t* pool) {
  if (threadIdx.x == THR - 1 && pool == nullptr) pool[0] = 1;
}

// the walking GRU cell
__global__ void __launch_bounds__(THREADS)
g0_kernel(int8_t* pool, const int8_t* __restrict__ w,
           const int8_t* __restrict__ u, const int32_t* __restrict__ b,
           const int32_t* __restrict__ mx, const int32_t* __restrict__ sx,
           const int32_t* __restrict__ mu, const int32_t* __restrict__ su,
           int n_seg, int d_in, int d_h, int in_ptr, int out_ptr,
           int state_ptr) {
  extern __shared__ int4 smem[];
  const int ci = segs_for(d_in), co = segs_for(d_h), g = 3 * d_h;
  const int8_t* x = reinterpret_cast<const int8_t*>(smem);
  const int8_t* h = x + (size_t)ci * SEG;
  int32_t* gx = reinterpret_cast<int32_t*>(smem + (ci + co) * VEC);
  int32_t* gh = gx + g;
  ring_load(smem, pool, in_ptr, ci, n_seg);
  ring_load(smem + ci * VEC, pool, state_ptr, co, n_seg);
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * g; j += blockDim.x) {
    const bool rec = j >= g;
    const int col = rec ? j - g : j, depth = rec ? d_h : d_in;
    const int8_t* v = rec ? h : x;
    const int8_t* m = (rec ? u : w) + col;
    uint32_t acc = 0;
#pragma unroll 4
    for (int kk = 0; kk < depth; ++kk)
      acc += (uint32_t)((int)v[kk] * (int)m[kk * g]);
    if (rec)
      gh[col] = requant_i32((int32_t)acc, mu[col], su[col]);
    else
      gx[col] = (int32_t)((uint32_t)requant_i32((int32_t)acc, mx[col],
                                                sx[col]) +
                          (uint32_t)b[col]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < co * SEG; i += blockDim.x) {
    int8_t y = 0;
    if (i < d_h)
      y = gru_update_q12(gx[i], gx[d_h + i], gx[2 * d_h + i], gh[i],
                         gh[d_h + i], gh[2 * d_h + i], h[i]);
    pool[(size_t)state_ptr * SEG + i] = y;
    *ring_byte(pool, out_ptr, i, n_seg) = y;
  }
}

// direct: one CTA, W and U read from global memory where they lie (no staging),
// the same quads x lanes as gru_q_kernel.
template <int THR>
__global__ void __launch_bounds__(THR)
g3_kernel(int8_t* pool, const int8_t* __restrict__ w,
             const int8_t* __restrict__ u, const int32_t* __restrict__ b,
             const int32_t* __restrict__ mx, const int32_t* __restrict__ sx,
             const int32_t* __restrict__ mu, const int32_t* __restrict__ su,
             int n_seg, int d_in, int d_h, int in_ptr, int out_ptr,
             int state_ptr) {
  extern __shared__ int4 qsmem[];
  char* smem = reinterpret_cast<char*>(qsmem);
  const int g = 3 * d_h, nq = g / 4;
  const int xh = round16(d_in);
  int32_t* part = reinterpret_cast<int32_t*>(smem + xh + round16(d_h));
  int32_t* gx = part + 4 * THR;
  int32_t* gh = gx + g;
  stage_q_rows(qsmem, pool, RunRows{in_ptr, 0, n_seg}, 0, 1, 1, 0, 0, (d_in + 15) / 16);
  stage_q_rows(reinterpret_cast<int4*>(smem + xh), pool, RunRows{state_ptr, 0, n_seg}, 0, 1, 1, 0, 0, (d_h + 15) / 16);
  const int qqs = 2 * nq, rq = (max(d_in, d_h) + 3) / 4;
  int ks = 1;
  while (2 * ks <= rq && 2 * ks * qqs <= THR) ks *= 2;
  const int lane = threadIdx.x / qqs, qq = threadIdx.x - lane * qqs;
  // weights first (global loads in flight), then wait for x and h
  const bool rec = qq >= nq;
  const int q = rec ? qq - nq : qq, depth = rec ? d_h : d_in;
  const uint32_t* mat = reinterpret_cast<const uint32_t*>(rec ? u : w) + q;
  constexpr int MAXJ = 12;
  uint32_t r[MAXJ][4];
  const int nj = lane < ks ? (((depth + 3) / 4) - lane + ks - 1) / ks : 0;
#pragma unroll
  for (int t = 0; t < MAXJ; ++t)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int row = 4 * (lane + t * ks) + kk;
      r[t][kk] = t < nj && row < depth ? __ldg(mat + (size_t)row * nq) : 0u;
    }
  cp_async_wait_all();
  __syncthreads();
  if (lane < ks) {
    const uint32_t* v = reinterpret_cast<const uint32_t*>(rec ? smem + xh : smem);
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int t = 0; t < MAXJ; ++t) {
      const int j = lane + t * ks;
      if (t < nj) {
        uint32_t xw = v[j];
        if (4 * j + 4 > depth) xw &= (1u << (8 * (depth - 4 * j))) - 1u;
        uint32_t col[4];
        transpose4(r[t], col);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = __dp4a((int)xw, (int)col[c], acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) part[4 * threadIdx.x + c] = acc[c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * g; i += THR) {
    const bool rc = i >= g;
    const int col = rc ? i - g : i;
    const int32_t* src = part + 4 * ((rc ? nq : 0) + col / 4) + col % 4;
    uint32_t acc = 0;
    for (int l = 0; l < ks; ++l) acc += (uint32_t)src[4 * l * qqs];
    if (rc) gh[col] = requant_i32((int32_t)acc, mu[col], su[col]);
    else gx[col] = (int32_t)((uint32_t)requant_i32((int32_t)acc, mx[col], sx[col]) + (uint32_t)b[col]);
  }
  __syncthreads();
  const int8_t* hb = reinterpret_cast<const int8_t*>(smem + xh);
  uint32_t* state = reinterpret_cast<uint32_t*>(pool + (size_t)state_ptr * SEG);
  for (int wd = threadIdx.x; wd < segs_for(d_h) * WORDS; wd += THR) {
    const int c0 = 4 * wd;
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c0 + k < d_h)
        v |= (uint32_t)(uint8_t)gru_update_q12(gx[c0 + k], gx[d_h + c0 + k], gx[2 * d_h + c0 + k], gh[c0 + k], gh[d_h + c0 + k], gh[2 * d_h + c0 + k], hb[c0 + k]) << (8 * k);
    state[wd] = v;
    *row_word(pool, out_ptr, c0 / SEG, c0 % SEG / 4, n_seg) = v;
  }
}

__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {}
}

}  // namespace

#define CK(x)                                                          \
  do {                                                                 \
    cudaError_t e_ = (x);                                              \
    if (e_ != cudaSuccess) {                                           \
      printf("CUDA error %s at line %d\n", cudaGetErrorString(e_),     \
             __LINE__);                                                \
      exit(1);                                                         \
    }                                                                  \
  } while (0)

// Mean device time of launch() over `reps` launches, us.
template <typename F>
float held_us(F launch, int reps = 200) {
  launch();
  CK(cudaGetLastError());
  CK(cudaDeviceSynchronize());
  cudaEvent_t a, b;
  CK(cudaEventCreate(&a));
  CK(cudaEventCreate(&b));
  spin<<<1, 1>>>(40000000LL);
  CK(cudaEventRecord(a));
  for (int i = 0; i < reps; ++i) launch();
  CK(cudaEventRecord(b));
  CK(cudaEventSynchronize(b));
  float ms;
  CK(cudaEventElapsedTime(&ms, a, b));
  CK(cudaEventDestroy(a));
  CK(cudaEventDestroy(b));
  return ms * 1e3f / reps;
}

struct PoolGeom { const char* name; int n_seg, h, w, c, ptr; };
struct GruGeom { const char* name; int n_seg, d_in, d_h, in_ptr, out_ptr, state_ptr; };

int main() {
  constexpr int kMaxSmem = 232448;
  const PoolGeom pools[] = {{"ds-cnn 25x5x64", 500, 25, 5, 64, 5},
                            {"resnet-8 8x8x64", 2080, 8, 8, 64, 288},
                            {"vww 3x3x96", 900, 3, 3, 96, 153},
                            {"7x7x1000", 448, 7, 7, 1000, 336},
                            {"3x4x200", 40, 3, 4, 200, 24}};
  const GruGeom grus[] = {{"gru chain 64->64", 630, 64, 64, 0, 0, 620},
                          {"gru 130->40", 20, 130, 40, 4, 5, 19}};
  int8_t *d_pool, *d_want;
  CK(cudaMalloc(&d_pool, 1 << 20));
  CK(cudaMalloc(&d_want, 1 << 20));
  std::vector<int8_t> host(1 << 20), want(1 << 20), got(1 << 20);
  srand(1);
  for (auto& x : host) x = (int8_t)(rand() & 0xff);
  CK(cudaFuncSetAttribute(p0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
  CK(cudaFuncSetAttribute(p3_kernel<256>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
  CK(cudaFuncSetAttribute(p9_kernel<512>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
  const int mult = 1518500250, shift = -6;
  int failures = 0;
  for (const PoolGeom& g : pools) {
    const size_t bytes = (size_t)g.n_seg * SEG;
    const int segs = segs_for(g.c), pixb = segs * SEG, npix = g.h * g.w;
    const int chunk = std::min(npix, (kMaxSmem - 4 * pixb) / pixb);
    auto walk = [&](int8_t* p) {
      p0_kernel<<<1, 1024, (4 + chunk) * pixb>>>(p, g.n_seg, g.h, g.w, g.c, g.ptr, g.ptr, mult, shift, chunk);
    };
    const int vecs = segs * VEC, groups = vecs < 256 ? 256 / vecs : 1;
    const int rows = vecs < 32 && 32 % vecs == 0 ? 256 / 32 : groups;
    auto grp = [&](int8_t* p) {
      p3_kernel<256><<<1, 256, rows * pixb * 4>>>(p, g.n_seg, g.h, g.w, g.c, g.ptr, g.ptr, mult, shift);
    };
    auto regs = [&](int8_t* p) {
      p8_kernel<256, 32><<<1, 256>>>(p, g.n_seg, g.h, g.w, g.c, g.ptr, g.ptr, mult, shift);
    };
    const int cw = (g.c + 31) / 32 * 32, R = cw < 512 ? 512 / cw : 1;
    const int wchunk = std::min(npix, (kMaxSmem - R * pixb * 4) / pixb);
    auto words = [&](int8_t* p) {
      p9_kernel<512><<<1, 512, R * pixb * 4 + wchunk * pixb>>>(p, g.n_seg, g.h, g.w, g.c, g.ptr, g.ptr, mult, shift, wchunk);
    };
    // the kernel's tiling, as quantized.py::pool_q_tiling gives it
    const int parts = pool_q_parts(pool_q_threads(g.c), pool_q_lg(g.c), npix);
    const int kpart = 4 * parts * (1 << pool_q_lg(g.c));
    int kchunk = std::min(npix, (kMaxSmem - kpart) / pixb);
    if (kchunk < npix) kchunk = kchunk / parts * parts;
    auto kernel = [&](int8_t* p) {
      CK((cudaError_t)ring_avgpool_q(p, g.n_seg, g.h, g.w, g.c, g.ptr, g.ptr, mult, shift, kchunk, nullptr));
    };
    CK(cudaMemcpy(d_want, host.data(), bytes, cudaMemcpyHostToDevice));
    walk(d_want);
    CK(cudaDeviceSynchronize());
    CK(cudaMemcpy(want.data(), d_want, bytes, cudaMemcpyDeviceToHost));
    auto check = [&](const char* name, auto launch) {
      CK(cudaMemcpy(d_pool, host.data(), bytes, cudaMemcpyHostToDevice));
      launch(d_pool);
      CK(cudaGetLastError());
      CK(cudaDeviceSynchronize());
      CK(cudaMemcpy(got.data(), d_pool, bytes, cudaMemcpyDeviceToHost));
      if (memcmp(got.data(), want.data(), bytes)) {
        printf("pool %s: %s differs from the walk\n", g.name, name);
        ++failures;
      }
    };
    check("groups", grp); check("regs", regs); check("words", words); check("kernel", kernel);
    for (int round = 0; round < 2; ++round)
      printf("pool %s (%d parts): empty %.2f walk %.2f groups %.2f regs %.2f words %.2f kernel %.2f us\n",
             g.name, parts, held_us([&] { empty_t<256><<<1, 256>>>(d_pool); }),
             held_us([&] { walk(d_pool); }), held_us([&] { grp(d_pool); }), held_us([&] { regs(d_pool); }),
             held_us([&] { words(d_pool); }), held_us([&] { kernel(d_pool); }));
  }
  int8_t *dw, *du;
  int32_t* dc;
  CK(cudaMalloc(&dw, 1 << 16));
  CK(cudaMalloc(&du, 1 << 16));
  CK(cudaMalloc(&dc, 5 * 4096 * 4));
  std::vector<int8_t> hw(1 << 16);
  for (auto& x : hw) x = (int8_t)(rand() & 0xff);
  CK(cudaMemcpy(dw, hw.data(), 1 << 16, cudaMemcpyHostToDevice));
  for (auto& x : hw) x = (int8_t)(rand() & 0xff);
  CK(cudaMemcpy(du, hw.data(), 1 << 16, cudaMemcpyHostToDevice));
  std::vector<int32_t> hc(5 * 4096);
  for (int i = 0; i < 4096; ++i) {
    hc[i] = rand() % 16384 - 8192;
    hc[4096 + i] = (1 << 30) + rand() % (1 << 30);
    hc[2 * 4096 + i] = -3 + rand() % 3;
    hc[3 * 4096 + i] = (1 << 30) + rand() % (1 << 30);
    hc[4 * 4096 + i] = -3 + rand() % 3;
  }
  CK(cudaMemcpy(dc, hc.data(), 5 * 4096 * 4, cudaMemcpyHostToDevice));
  const int32_t *b = dc, *mx = dc + 4096, *sx = dc + 2 * 4096, *mu = dc + 3 * 4096, *su = dc + 4 * 4096;
  for (const GruGeom& g : grus) {
    const size_t bytes = (size_t)g.n_seg * SEG;
    const size_t s0 = (size_t)(segs_for(g.d_in) + segs_for(g.d_h)) * SEG + 24 * g.d_h;
    auto walk = [&](int8_t* p) {
      g0_kernel<<<1, 1024, s0>>>(p, dw, du, b, mx, sx, mu, su, g.n_seg, g.d_in, g.d_h, g.in_ptr, g.out_ptr, g.state_ptr);
    };
    auto one = [&](int8_t* p) {
      CK((cudaError_t)ring_gru_cell_q(p, dw, du, b, mx, sx, mu, su, g.n_seg, g.d_in, g.d_h, g.in_ptr, g.out_ptr, g.state_ptr, g.d_h, 0, nullptr));
    };
    auto tiles = [&](int8_t* p) {
      CK((cudaError_t)ring_gru_cell_q(p, dw, du, b, mx, sx, mu, su, g.n_seg, g.d_in, g.d_h, g.in_ptr, g.out_ptr, g.state_ptr, 4, 1, nullptr));
    };
    const size_t s3 = round16(g.d_in) + round16(g.d_h) + 16 * 256 + 24 * g.d_h;
    auto direct = [&](int8_t* p) {
      g3_kernel<256><<<1, 256, s3>>>(p, dw, du, b, mx, sx, mu, su, g.n_seg, g.d_in, g.d_h, g.in_ptr, g.out_ptr, g.state_ptr);
    };
    CK(cudaMemcpy(d_want, host.data(), bytes, cudaMemcpyHostToDevice));
    walk(d_want);
    CK(cudaDeviceSynchronize());
    CK(cudaMemcpy(want.data(), d_want, bytes, cudaMemcpyDeviceToHost));
    auto check = [&](const char* name, auto launch) {
      CK(cudaMemcpy(d_pool, host.data(), bytes, cudaMemcpyHostToDevice));
      launch(d_pool);
      CK(cudaGetLastError());
      CK(cudaDeviceSynchronize());
      CK(cudaMemcpy(got.data(), d_pool, bytes, cudaMemcpyDeviceToHost));
      if (memcmp(got.data(), want.data(), bytes)) {
        printf("%s: %s differs from the walk\n", g.name, name);
        ++failures;
      }
    };
    check("kernel one CTA", one); check("kernel tiles", tiles); check("direct", direct);
    for (int round = 0; round < 2; ++round)
      printf("%s: walk %.2f kernel one CTA %.2f kernel tiles %.2f direct %.2f us\n", g.name,
             held_us([&] { walk(d_pool); }), held_us([&] { one(d_pool); }), held_us([&] { tiles(d_pool); }),
             held_us([&] { direct(d_pool); }));
  }
  printf("%s\n", failures ? "FAILED: a design differs from the walk" : "every design bitwise the walk");
  return failures ? 1 : 0;
}
