// Times the fp32 global average pool and GRU cell designs tried for the
// H100 against each other and against the one-block walk the port ran
// before, on one card, with held-stream CUDA events (a spin kernel holds the
// stream until every launch is enqueued, so the events time the device
// alone), 200 launches each, and checks each design against the walk within
// the fp32 tolerance (rtol 3e-4, atol 3e-5 max|walk|; every lane the call
// does not write, channel tails included, exact).  Build and run from the
// root of a checkout:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/f32_pool_gru_variants tools/f32_pool_gru_variants.cu
//   build/f32_pool_gru_variants
//
// Designs (us a launch, the plan pools' and GRU cells' geometries and a few
// wider ones):
//   pool  empty     an empty kernel of 256 threads (the launch floor);
//         walk      one block of 1024 threads: stage every pixel (a float a
//                   thread), then a thread a channel adds its h w floats in
//                   order;
//         T/P       ring_f32.cu's avgpool_f32_kernel<T> with the parts of a
//                   channel's sum of about P pixels each (T threads);
//         kernel    the kernel at the tiling conv2d.py::pool_tiling gives;
//         regs      nothing staged: 256 threads add float4s of groups of
//                   pixels in registers straight from the ring, the groups'
//                   partials summed in shared memory after one barrier;
//   gru   walk      one block of 1024 threads, a thread a gate column
//                   walking W or U in global memory;
//         one T     ring_f32.cu's gru_f32_kernel<T> in one CTA (W and U
//                   staged as they lie, T threads; -1 where they do not
//                   fit shared memory);
//         tiles C   the kernel in channel tiles of C under a grid barrier;
//         direct    one CTA of 256 threads reading W and U from global
//                   memory where they lie (nothing staged), the kernel's k
//                   split;
//         cluster N the kernel's channel tiles (N CTAs, tiles of a
//                   multiple of 4) in one thread-block cluster, an
//                   ordinary launch: the cluster's barrier in place of the
//                   grid barrier.
#include "../src/repro_torch/kernels/csrc/ring_f32.cu"

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

namespace {

// The walk: what ring_f32.cu ran before, one block of THREADS.
__device__ __forceinline__ void walk_load_rows(float* dst, const float* pool,
                                               int ptr, int n, int d,
                                               int chunk, int n_seg) {
  for (int j = threadIdx.x; j < n * d; j += blockDim.x) {
    const int row = j / d, col = j - row * d;
    dst[j] = pool[ring_index(ptr, row, col, chunk, n_seg)];
  }
}

__global__ void __launch_bounds__(THREADS)
walk_pool_kernel(float* pool, int n_seg, int h, int w, int c, int in_ptr,
                 int out_ptr, int chunk_pix) {
  extern __shared__ float smem[];
  const int segs = segs_for(c);
  float* sums = smem;
  float* x = smem + c;
  for (int j = threadIdx.x; j < c; j += blockDim.x) sums[j] = 0.f;
  for (int p0 = 0; p0 < h * w; p0 += chunk_pix) {
    const int n = min(chunk_pix, h * w - p0);
    walk_load_rows(x, pool, (in_ptr + p0 * segs) % n_seg, n, c, segs, n_seg);
    __syncthreads();
    for (int j = threadIdx.x; j < c; j += blockDim.x) {
      float acc = sums[j];
      for (int pix = 0; pix < n; ++pix) acc += x[pix * c + j];
      sums[j] = acc;
    }
    __syncthreads();
  }
  const float count = (float)(h * w);
  for (int j = threadIdx.x; j < segs * SEG; j += blockDim.x)
    pool[ring_index(out_ptr, 0, j, segs, n_seg)] = j < c ? sums[j] / count
                                                         : 0.f;
}

__global__ void __launch_bounds__(THREADS)
walk_gru_kernel(float* pool, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ b,
                int n_seg, int d_in, int d_h, int in_ptr, int out_ptr,
                int state_ptr) {
  extern __shared__ float smem[];
  const int ci = segs_for(d_in), co = segs_for(d_h), g = 3 * d_h;
  float* x = smem;
  float* h = x + d_in;
  float* gx = h + d_h;
  float* gh = gx + g;
  walk_load_rows(x, pool, in_ptr, 1, d_in, ci, n_seg);
  walk_load_rows(h, pool, state_ptr, 1, d_h, co, n_seg);
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * g; j += blockDim.x) {
    const bool rec = j >= g;
    const int col = rec ? j - g : j, depth = rec ? d_h : d_in;
    const float* v = rec ? h : x;
    const float* m = (rec ? u : w) + col;
    float acc = 0.f;
    for (int kk = 0; kk < depth; ++kk) acc = fmaf(v[kk], m[kk * g], acc);
    if (rec)
      gh[col] = acc;
    else
      gx[col] = __fadd_rn(acc, b[col]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < co * SEG; i += blockDim.x) {
    float y = 0.f;
    if (i < d_h)
      y = gru_update(gx[i], gx[d_h + i], gx[2 * d_h + i], gh[i], gh[d_h + i],
                     gh[2 * d_h + i], h[i]);
    pool[ring_index(state_ptr, 0, i, co, n_seg)] = y;
    pool[ring_index(out_ptr, 0, i, co, n_seg)] = y;
  }
}

// One CTA reading W and U where they lie (3 d_h a multiple of 4): thread
// (lane, quad) as the kernel's, its float4s loaded from global memory.
template <int THR>
__global__ void __launch_bounds__(THR)
direct_gru_kernel(float* pool, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ b,
                  int n_seg, int d_in, int d_h, int in_ptr, int out_ptr,
                  int state_ptr) {
  extern __shared__ float4 vsmem[];
  float* smem = reinterpret_cast<float*>(vsmem);
  const int g = 3 * d_h, nq = g / 4, qqs = 2 * nq;
  GruSmem m = gru_layout(d_in, d_h, d_h, THR);   // x, h; no W, U or b
  m.part = m.w;
  m.gates = m.part + 4 * (THR > g / 2 ? THR : g / 2);
  const float* xs = pool + (size_t)in_ptr * SEG;
  const float* hs = pool + (size_t)state_ptr * SEG;
  for (int i = threadIdx.x; i < m.h / 4; i += THR)
    cp_async16(smem + 4 * i, xs + 4 * i, 16);
  for (int i = threadIdx.x; i < (m.w - m.h) / 4; i += THR)
    cp_async16(smem + m.h + 4 * i, hs + 4 * i, 16);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int ks = gru_lanes(d_in, d_h, g, THR);
  float4* part = reinterpret_cast<float4*>(smem + m.part);
  for (int t = threadIdx.x; t < ks * qqs; t += THR) {
    const int lane = t / qqs, qq = t - lane * qqs;
    const bool rec = qq >= nq;
    const int depth = rec ? d_h : d_in;
    const float* v = smem + (rec ? m.h : 0);
    const float4* mat =
        reinterpret_cast<const float4*>(rec ? u : w) + (rec ? qq - nq : qq);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int k = lane; k < depth; k += ks) {
      const float a = v[k];
      const float4 wv = __ldg(mat + (size_t)k * nq);
      acc.x = fmaf(a, wv.x, acc.x);
      acc.y = fmaf(a, wv.y, acc.y);
      acc.z = fmaf(a, wv.z, acc.z);
      acc.w = fmaf(a, wv.w, acc.w);
    }
    part[t] = acc;
  }
  __syncthreads();
  const float* pf = smem + m.part;
  float* gx = smem + m.gates;
  float* gh = gx + g;
  for (int i = threadIdx.x; i < 2 * g; i += THR) {
    const bool rec = i >= g;
    const int col = rec ? i - g : i;
    const float* src = pf + 4 * ((rec ? nq : 0) + col / 4) + col % 4;
    float acc = src[0];
    for (int l = 1; l < ks; ++l) acc += src[4 * l * qqs];
    if (rec)
      gh[col] = acc;
    else
      gx[col] = __fadd_rn(acc, b[col]);
  }
  __syncthreads();
  const int co = segs_for(d_h);
  const float* h = smem + m.h;
  for (int c = threadIdx.x; c < co * SEG; c += THR) {
    const float y = c < d_h ? gru_update(gx[c], gx[d_h + c], gx[2 * d_h + c],
                                         gh[c], gh[d_h + c], gh[2 * d_h + c],
                                         h[c])
                            : 0.f;
    pool[(size_t)state_ptr * SEG + c] = y;
    pool[ring_index(out_ptr, 0, c, co, n_seg)] = y;
  }
}

// The pool with nothing staged: thread (group, v), vectors fastest, adds
// float4 v of pixels group, group + groups, ... in registers straight from
// the ring; the groups' float4 partials go to shared memory and a thread a
// lane adds them after the barrier.
template <int THR>
__global__ void __launch_bounds__(THR)
regs_pool_kernel(float* pool, int n_seg, int h, int w, int c, int in_ptr,
                 int out_ptr) {
  extern __shared__ float4 vsmem[];
  const int segs = segs_for(c), vecs = (c + 3) / 4, npix = h * w;
  const int groups = max(1, THR / vecs);
  for (int t = threadIdx.x; t < groups * vecs; t += THR) {
    const int grp = t / vecs, v = t - grp * vecs;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int p = grp; p < npix; p += groups) {
      const float4 x = reinterpret_cast<const float4*>(
          pool + (size_t)((in_ptr + p * segs) % n_seg) * SEG)[v];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    vsmem[t] = acc;
  }
  __syncthreads();
  const float* part = reinterpret_cast<const float*>(vsmem);
  for (int i = threadIdx.x; i < segs * SEG; i += THR) {
    float y = 0.f;
    if (i < c) {
      float sum = part[i];
      for (int j = 1; j < groups; ++j) sum += part[j * 4 * vecs + i];
      y = sum / (float)npix;
    }
    int seg = out_ptr + i / SEG;
    if (seg >= n_seg) seg -= n_seg;
    pool[(size_t)seg * SEG + i % SEG] = y;
  }
}

// The kernel's channel tiles in one thread-block cluster (an ordinary
// launch, every CTA of the op in the cluster): the grid barrier becomes
// the cluster's hardware barrier.  gru_f32_kernel<THR, true> but for the
// barrier.
template <int THR>
__global__ void __launch_bounds__(THR)
cluster_gru_kernel(float* pool, const float* __restrict__ w,
                   const float* __restrict__ u, const float* __restrict__ b,
                   int n_seg, int d_in, int d_h, int in_ptr, int out_ptr,
                   int state_ptr, int ctile) {
  extern __shared__ float4 vsmem[];
  float* smem = reinterpret_cast<float*>(vsmem);
  const GruSmem m = gru_layout(d_in, d_h, ctile, THR);
  const int p = round4f(3 * ctile), nq = p / 4, qqs = 2 * nq;
  const int i0 = blockIdx.x * ctile, tn = min(ctile, d_h - i0);
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
  const float* pf = smem + m.part;
  float* gx = smem + m.gates;
  float* gh = gx + 3 * ctile;
  for (int i = threadIdx.x; i < 6 * ctile; i += THR) {
    const bool rec = i >= 3 * ctile;
    const int col = rec ? i - 3 * ctile : i;
    if (col - col / ctile * ctile >= tn) continue;
    const float* src = pf + 4 * ((rec ? nq : 0) + col / 4) + col % 4;
    float acc = src[0];
    for (int l = 1; l < ks; ++l) acc += src[4 * l * qqs];
    if (rec)
      gh[col] = acc;
    else
      gx[col] = __fadd_rn(acc, smem[m.b + col]);
  }
  cg::this_cluster().sync();   // every read of the op is done
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

template <int THR>
__global__ void __launch_bounds__(THR) empty_t(float* pool) {
  if (pool == nullptr) pool[threadIdx.x] = 0.f;
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

// `got` against `want` over n floats: within rtol 3e-4, atol 3e-5 max|want|
// where `live` (the lanes the call computes), exact elsewhere.
bool close_to(const std::vector<float>& got, const std::vector<float>& want,
              const std::vector<char>& live, double* worst) {
  double scale = 0;
  for (size_t i = 0; i < want.size(); ++i)
    if (live[i]) scale = std::max(scale, (double)std::fabs(want[i]));
  bool ok = true;
  *worst = 0;
  for (size_t i = 0; i < want.size(); ++i) {
    const double d = std::fabs((double)got[i] - (double)want[i]);
    if (live[i]) {
      *worst = std::max(*worst, d);
      if (!(d <= 3e-5 * scale + 3e-4 * std::fabs(want[i]))) ok = false;
    } else if (got[i] != want[i] && !(std::isnan(got[i]) &&
                                      std::isnan(want[i]))) {
      ok = false;
    }
  }
  return ok;
}

struct PoolGeom { const char* name; int n_seg, h, w, c, ptr; };
struct GruGeom { const char* name; int n_seg, d_in, d_h, in_ptr, out_ptr, state_ptr; };

int main() {
  constexpr int kMaxSmem = 232448;
  const PoolGeom pools[] = {{"ds-cnn 25x5x64", 500, 25, 5, 64, 5},
                            {"stream 25x5x64", 640, 25, 5, 64, 0},
                            {"resnet-8 8x8x64", 2080, 8, 8, 64, 288},
                            {"vww 3x3x96", 540, 3, 3, 96, 90},
                            {"7x7x256", 160, 7, 7, 256, 100},
                            {"7x7x1280", 600, 7, 7, 1280, 400},
                            {"3x4x200", 40, 3, 4, 200, 24}};
  const GruGeom grus[] = {{"gru chain 64->64", 630, 64, 64, 0, 0, 620},
                          {"gru 130->40", 20, 130, 40, 4, 5, 19},
                          {"gru 64->72", 12, 64, 72, 2, 3, 6},
                          {"gru 64->70", 12, 64, 70, 2, 3, 6},
                          {"gru 128->128", 8, 128, 128, 2, 2, 5}};
  const size_t kPool = 1 << 20;   // floats
  float *d_pool, *d_want;
  CK(cudaMalloc(&d_pool, kPool * 4));
  CK(cudaMalloc(&d_want, kPool * 4));
  std::vector<float> host(kPool), want(kPool), got(kPool);
  srand(1);
  for (auto& x : host) x = (float)(rand() % 20001 - 10000) / 5000.f;
  CK(cudaFuncSetAttribute(walk_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
  CK(cudaFuncSetAttribute(regs_pool_kernel<256>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
  int failures = 0;
  for (const PoolGeom& g : pools) {
    const size_t n = (size_t)g.n_seg * SEG;
    const int segs = segs_for(g.c), npix = g.h * g.w, lg = pool_lg(g.c);
    const int cw = 1 << lg, pixb = 16 * ((g.c + 3) / 4);
    const int wchunk = std::min(npix, kMaxSmem / (4 * g.c) - 1);
    auto walk = [&](float* p) {
      walk_pool_kernel<<<1, 1024, 4 * g.c * (1 + wchunk)>>>(p, g.n_seg, g.h, g.w, g.c, g.ptr, g.ptr, wchunk);
    };
    // the kernel at T threads and parts of about P pixels; chunks as
    // conv2d.py::pool_tiling cuts them
    auto design = [&](int T, int P) {
      const int parts = std::max(1, std::min(npix / P, T / cw));
      int chunk = std::min(npix, (kMaxSmem - 4 * parts * cw) / pixb);
      if (chunk < npix) chunk = chunk / parts * parts;
      const size_t smem = 4 * pool_smem_floats(g.c, parts, chunk);
      // through the port's launcher, which sets each launch's shared
      // memory limit (the kernel's calls lower it to their own size)
      return [=](float* p) {
        if (T == 256)
          CK((cudaError_t)launch_grid(avgpool_f32_kernel<256>, 1, 256, smem, nullptr, p, g.n_seg, g.h, g.w, g.c, g.ptr, g.ptr, parts, chunk));
        else if (T == 512)
          CK((cudaError_t)launch_grid(avgpool_f32_kernel<512>, 1, 512, smem, nullptr, p, g.n_seg, g.h, g.w, g.c, g.ptr, g.ptr, parts, chunk));
        else
          CK((cudaError_t)launch_grid(avgpool_f32_kernel<1024>, 1, 1024, smem, nullptr, p, g.n_seg, g.h, g.w, g.c, g.ptr, g.ptr, parts, chunk));
      };
    };
    const int tk = g.c <= 256 ? 256 : 512;
    const int kparts = std::max(1, std::min(npix / 16, tk / cw));
    int kchunk = std::min(npix, (kMaxSmem - 4 * kparts * cw) / pixb);
    if (kchunk < npix) kchunk = kchunk / kparts * kparts;
    auto kernel = [&](float* p) {
      CK((cudaError_t)ring_avgpool(p, g.n_seg, g.h, g.w, g.c, g.ptr, g.ptr, tk, kparts, kchunk, nullptr));
    };
    std::vector<char> live(n, 0);
    for (int i = 0; i < segs * SEG; ++i) live[(size_t)((g.ptr + i / SEG) % g.n_seg) * SEG + i % SEG] = i < g.c;
    CK(cudaMemcpy(d_want, host.data(), n * 4, cudaMemcpyHostToDevice));
    walk(d_want);
    CK(cudaDeviceSynchronize());
    CK(cudaMemcpy(want.data(), d_want, n * 4, cudaMemcpyDeviceToHost));
    want.resize(n); got.resize(n);
    auto check = [&](const char* name, auto launch) {
      CK(cudaMemcpy(d_pool, host.data(), n * 4, cudaMemcpyHostToDevice));
      launch(d_pool);
      CK(cudaGetLastError());
      CK(cudaDeviceSynchronize());
      CK(cudaMemcpy(got.data(), d_pool, n * 4, cudaMemcpyDeviceToHost));
      double worst;
      if (!close_to(got, want, live, &worst)) {
        printf("pool %s: %s differs from the walk\n", g.name, name);
        ++failures;
      }
    };
    const int Ts[] = {256, 512, 1024}, Ps[] = {4, 8, 16, 32};
    const int rgroups = std::max(1, 256 / ((g.c + 3) / 4));
    auto regs = [&](float* p) {
      regs_pool_kernel<256><<<1, 256, 16 * rgroups * ((g.c + 3) / 4)>>>(p, g.n_seg, g.h, g.w, g.c, g.ptr, g.ptr);
    };
    check("kernel", kernel);
    check("regs", regs);
    for (int T : Ts)
      for (int P : Ps) check("design", design(T, P));
    for (int round = 0; round < 2; ++round) {
      printf("pool %s: empty %.2f walk %.2f kernel(%d) %.2f regs %.2f |", g.name,
             held_us([&] { empty_t<256><<<1, 256>>>(d_pool); }),
             held_us([&] { walk(d_pool); }), tk, held_us([&] { kernel(d_pool); }),
             held_us([&] { regs(d_pool); }));
      for (int T : Ts)
        for (int P : Ps) printf(" %d/%d %.2f", T, P, held_us([&] { design(T, P)(d_pool); }));
      printf(" us\n");
    }
    want.resize(kPool); got.resize(kPool);
  }
  float *dw, *du, *db;
  const size_t kW = 1 << 18;
  CK(cudaMalloc(&dw, kW * 4));
  CK(cudaMalloc(&du, kW * 4));
  CK(cudaMalloc(&db, 4096 * 4));
  std::vector<float> hw(kW);
  for (auto& x : hw) x = (float)(rand() % 20001 - 10000) / 80000.f;
  CK(cudaMemcpy(dw, hw.data(), kW * 4, cudaMemcpyHostToDevice));
  for (auto& x : hw) x = (float)(rand() % 20001 - 10000) / 80000.f;
  CK(cudaMemcpy(du, hw.data(), kW * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(db, hw.data(), 4096 * 4, cudaMemcpyHostToDevice));
  CK(cudaFuncSetAttribute(gru_f32_kernel<256, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
  CK(cudaFuncSetAttribute(gru_f32_kernel<512, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
  CK(cudaFuncSetAttribute(gru_f32_kernel<1024, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
  CK(cudaFuncSetAttribute(direct_gru_kernel<256>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
  CK(cudaFuncSetAttribute(cluster_gru_kernel<256>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
  CK(cudaFuncSetAttribute(cluster_gru_kernel<256>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  for (const GruGeom& g : grus) {
    const size_t n = (size_t)g.n_seg * SEG;
    const int co = segs_for(g.d_h);
    const size_t s0 = 4 * ((size_t)g.d_in + 7 * g.d_h);
    auto walk = [&](float* p) {
      walk_gru_kernel<<<1, 1024, s0>>>(p, dw, du, db, g.n_seg, g.d_in, g.d_h, g.in_ptr, g.out_ptr, g.state_ptr);
    };
    auto one = [&](int T) {
      const size_t s = 4 * (size_t)gru_layout(g.d_in, g.d_h, g.d_h, T).words;
      return [=](float* p) {
        if (T == 256)
          gru_f32_kernel<256, false><<<1, 256, s>>>(p, dw, du, db, g.n_seg, g.d_in, g.d_h, g.in_ptr, g.out_ptr, g.state_ptr, g.d_h);
        else if (T == 512)
          gru_f32_kernel<512, false><<<1, 512, s>>>(p, dw, du, db, g.n_seg, g.d_in, g.d_h, g.in_ptr, g.out_ptr, g.state_ptr, g.d_h);
        else
          gru_f32_kernel<1024, false><<<1, 1024, s>>>(p, dw, du, db, g.n_seg, g.d_in, g.d_h, g.in_ptr, g.out_ptr, g.state_ptr, g.d_h);
      };
    };
    auto tiles = [&](int C) {
      return [=](float* p) {
        CK((cudaError_t)ring_gru_cell(p, dw, du, db, g.n_seg, g.d_in, g.d_h, g.in_ptr, g.out_ptr, g.state_ptr, C, 1, nullptr));
      };
    };
    const GruSmem m3 = gru_layout(g.d_in, g.d_h, g.d_h, 256);
    const size_t s3 = 4 * (size_t)(m3.w + 4 * std::max(256, 3 * g.d_h / 2) + 6 * g.d_h);
    auto direct = [&](float* p) {
      direct_gru_kernel<256><<<1, 256, s3>>>(p, dw, du, db, g.n_seg, g.d_in, g.d_h, g.in_ptr, g.out_ptr, g.state_ptr);
    };
    // every channel tile of the op in one cluster of `ctas` CTAs
    auto cluster = [&](int ctas) {
      const int C = (g.d_h + ctas - 1) / ctas, ctile = (C + 3) / 4 * 4;
      const int n_ctas = (g.d_h + ctile - 1) / ctile;
      const size_t s = 4 * (size_t)gru_layout(g.d_in, g.d_h, ctile, 256).words;
      return [=](float* p) {
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(n_ctas);
        cfg.blockDim = dim3(256);
        cfg.dynamicSmemBytes = s;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = n_ctas;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        return cudaLaunchKernelEx(&cfg, cluster_gru_kernel<256>, p, (const float*)dw, (const float*)du, (const float*)db, g.n_seg, g.d_in, g.d_h, g.in_ptr, g.out_ptr, g.state_ptr, ctile);
      };
    };
    // a cluster the card cannot place (more CTAs than a GPC holds) is
    // reported and left out
    bool cluster_ok[2];
    for (int i = 0; i < 2; ++i) {
      const cudaError_t e = cluster(8 << i)(d_pool);
      cudaGetLastError();
      CK(cudaDeviceSynchronize());
      cluster_ok[i] = e == cudaSuccess;
      if (!cluster_ok[i]) printf("%s: cluster %d not launched: %s\n", g.name, 8 << i, cudaGetErrorString(e));
    }
    const bool quads = g.d_h % 4 == 0;
    std::vector<char> live(n, 0);
    for (int i = 0; i < co * SEG; ++i) {
      live[(size_t)g.state_ptr * SEG + i] = i < g.d_h;
      live[(size_t)((g.out_ptr + i / SEG) % g.n_seg) * SEG + i % SEG] = i < g.d_h;
    }
    want.resize(n); got.resize(n);
    CK(cudaMemcpy(d_want, host.data(), n * 4, cudaMemcpyHostToDevice));
    walk(d_want);
    CK(cudaDeviceSynchronize());
    CK(cudaMemcpy(want.data(), d_want, n * 4, cudaMemcpyDeviceToHost));
    auto check = [&](const char* name, auto launch) {
      CK(cudaMemcpy(d_pool, host.data(), n * 4, cudaMemcpyHostToDevice));
      launch(d_pool);
      CK(cudaGetLastError());
      CK(cudaDeviceSynchronize());
      CK(cudaMemcpy(got.data(), d_pool, n * 4, cudaMemcpyDeviceToHost));
      double worst;
      if (!close_to(got, want, live, &worst)) {
        printf("%s: %s differs from the walk\n", g.name, name);
        ++failures;
      }
    };
    auto fits = [&](int T) { return 4 * (size_t)gru_layout(g.d_in, g.d_h, g.d_h, T).words <= (size_t)kMaxSmem; };
    if (fits(256)) check("one 256", one(256));
    if (fits(512)) check("one 512", one(512));
    if (fits(1024)) check("one 1024", one(1024));
    check("tiles 4", tiles(4)); check("tiles 8", tiles(8));
    if (quads) check("direct", direct);
    if (cluster_ok[0]) check("cluster 8", cluster(8));
    if (cluster_ok[1]) check("cluster 16", cluster(16));
    for (int round = 0; round < 2; ++round)
      printf("%s: cluster 8 %.2f cluster 16 %.2f | walk %.2f one 256 %.2f one 512 %.2f one 1024 %.2f tiles 4 %.2f tiles 8 %.2f direct %.2f us\n", g.name,
             cluster_ok[0] ? held_us([&] { cluster(8)(d_pool); }) : -1.f,
             cluster_ok[1] ? held_us([&] { cluster(16)(d_pool); }) : -1.f,
             held_us([&] { walk(d_pool); }), fits(256) ? held_us([&] { one(256)(d_pool); }) : -1.f,
             fits(512) ? held_us([&] { one(512)(d_pool); }) : -1.f, fits(1024) ? held_us([&] { one(1024)(d_pool); }) : -1.f,
             held_us([&] { tiles(4)(d_pool); }), held_us([&] { tiles(8)(d_pool); }),
             quads ? held_us([&] { direct(d_pool); }) : -1.f);
    want.resize(kPool); got.resize(kPool);
  }
  printf("%s\n", failures ? "FAILED: a design differs from the walk"
                          : "every design within the tolerance of the walk");
  return failures ? 1 : 0;
}
