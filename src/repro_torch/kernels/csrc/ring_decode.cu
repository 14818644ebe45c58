// Ring KV-cache decode attention for Hopper (sm_90a), bound to Python with
// ctypes.
//
//   ring_decode_attention <- ring_decode_attention (ring_decode.py:77)
//                            one decode step of attention over a ring cache
//
// A sliding-window KV cache is a vMCU segment ring: slot t % window holds
// token t's K/V, so a slot is valid where slot < seq_len or the ring has
// wrapped (seq_len >= window).  A cache of cache_len slots that never wraps
// (a global layer's) is the same ring with window = cache_len, where the rule
// reduces to slot < seq_len.  Shapes: q [B, q_heads, d]; k, v [B, window,
// kv_heads, d]; out [B, q_heads, d]; GQA with group = q_heads / kv_heads, q
// head h = kv_head * group + g.  Scores s = (q * d^-0.5) . k in fp32, an
// optional tanh(s / cap) * cap, invalid slots at -1e30 (the Pallas kernel's
// NEG_INF), o = softmax(s) . v accumulated in fp32 and stored in q's dtype
// (fp32 for the kernel tests, bf16 on the serve path).
//
// Flash-decoding: the window is split into `splits` contiguous ranges of
// `split_len` slots (kernels/ring_decode.py::decode_splits, a multiple of 16
// slots), and the grid is (kv head, batch row, split).  Each CTA holds the
// group's q rows in shared memory and runs the Pallas body's online softmax
// over its own range in blocks of at most `block` slots:
//
//   scores: one warp per slot, lanes across d, a shuffle sum per q row
//   __syncthreads()
//   per q row (one warp each): block max, m_new, p = exp(s - m_new),
//     alpha = exp(m_prev - m_new), l = l * alpha + sum(p)
//   __syncthreads()
//   acc = acc * alpha + p . v   (thread t owns column t % d of its q rows,
//                                in registers)
//   __syncthreads()
//
// then writes its partial (m, l, acc[group][d]), fp32, to a workspace.  A
// second kernel, one thread per output element, combines the splits:
// M = max m_i, o = sum_i acc_i exp(m_i - M) / sum_i l_i exp(m_i - M),
// stored in q's dtype.
//
// A range stops at `end`: seq_len, or the whole window once the ring has
// wrapped (seq_len >= window) or when seq_len < 1.  Slots past seq_len
// would add p = 0 (the range's first slot is valid, so m is a real score),
// and splits wholly past it (a global cache not yet full) are skipped and
// never reach the combine, which counts ceil(end / split_len) splits.  At
// seq_len < 1 every slot is masked (-1e30, not -inf), each split has
// m = -1e30 and p = 1 per slot, and the combine weighs them all by
// exp(0) = 1: the uniform average over the window, as the plain version
// gives.
//
// Given an lse pointer (a kv_seq slice of a cache split over ranks, whose
// partial attentions the ranks combine by their log-sum-exp), the combine
// also writes each q row's lse = M + log L (fp32, [B, q_heads]), and a row
// with seq_len < 1 (a slice that holds no valid slot yet) is empty: every
// split is skipped, and the combine stores o = 0 and lse = -inf, the
// partial that adds nothing to the ranks' sum.  Without it (null) nothing
// of the above changes.  The group (q heads per kv head, at most 16) is a template
// parameter rounded up to a power of two, so the per-row loops unroll to
// it; head_dim is a power of two up to 256.
//
// What bounds it on the card: bytes.  Each K/V element is read once (group q
// rows share it), 2 fp32 operations per multiply-add: at gemma3-1b's shapes
// (kv_heads 1, d 256, bf16) a 512-slot local ring is 0.52 MB per batch row,
// about 0.16 us at 3.35 TB/s.  One CTA per (kv head, batch row) walked its
// window one block after another on 4 of the 132 SMs at batch 4; the split
// grid puts about one CTA on every SM, each walking 16 or 32 slots, so the
// walk is a few loads deep and the time is two launches and their latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUP = 16;  // q heads per kv head
constexpr int KPL = 256 / 32;  // K elements a lane holds: head_dim <= 256
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
    ring_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ seq_lens,
                       float* __restrict__ part, int seq_scalar, int window,
                       int kv_heads, int group, int d, int block,
                       int split_len, float scale, float softcap,
                       int empty_rows) {
  // G: the group rounded up to a power of two (a template, so the per-row
  // loops unroll exactly); rows g >= group are skipped.
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                     // [group][d], times d^-0.5
  float* p_s = q_s + group * d;          // [group][block]: s, then p
  float* alpha_s = p_s + group * block;  // [group]
  float* l_s = alpha_s + group;          // [group]
  float* m_s = l_s + group;              // [group]

  const int kh = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_heads = kv_heads * group;
  const int seq = seq_lens ? seq_lens[b] : seq_scalar;
  const int end = seq >= window ? window : seq >= 1 ? seq
                                                  : empty_rows ? 0 : window;
  const int s0 = z * split_len, s1 = min(s0 + split_len, end);
  if (s0 >= end) return;   // wholly past seq: the combine skips it
  const size_t q_row = ((size_t)b * q_heads + (size_t)kh * group) * d;

  for (int e = tid; e < group * d; e += THREADS)
    q_s[e] = to_f(q[q_row + e]) * scale;
  for (int g = tid; g < group; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }

  // This thread's accumulators: column dd of q rows g0, g0 + gstep, ...
  const int dd = tid % d, g0 = tid / d, gstep = THREADS / d;
  float acc[G];
#pragma unroll
  for (int i = 0; i < G; ++i) acc[i] = 0.f;

  const size_t slot_stride = (size_t)kv_heads * d;
  const T* k_b = k + (size_t)b * window * slot_stride + (size_t)kh * d;
  const T* v_b = v + (size_t)b * window * slot_stride + (size_t)kh * d;
  const int per_lane = d >= 32 ? d / 32 : 1;  // K elements a lane reads
  __syncthreads();

  for (int base = s0; base < s1; base += block) {
    const int nb = min(block, s1 - base);

    // scores, one warp per slot, lanes across d
    for (int j = warp; j < nb; j += WARPS) {
      const int slot = base + j;
      const T* row = k_b + (size_t)slot * slot_stride;
      float kr[KPL];
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const int c = lane + 32 * i;
        kr[i] = (i < per_lane && c < d) ? to_f(row[c]) : 0.f;
      }
      const bool valid = slot < seq || seq >= window;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= group) break;
        float part_dot = 0.f;
#pragma unroll
        for (int i = 0; i < KPL; ++i) {
          const int c = lane + 32 * i;
          if (i < per_lane && c < d) part_dot += q_s[g * d + c] * kr[i];
        }
        float x = warp_sum(part_dot);
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        if (lane == 0) p_s[g * block + j] = valid ? x : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax, one warp per q row
    for (int g = warp; g < group; g += WARPS) {
      float* row = p_s + g * block;
      float mx = -INFINITY;
      for (int j = lane; j < nb; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < nb; j += 32) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v
    if (g0 < group) {
      float pv[G];
#pragma unroll
      for (int i = 0; i < G; ++i) pv[i] = 0.f;
      const T* vc = v_b + (size_t)base * slot_stride + dd;
#pragma unroll 8
      for (int j = 0; j < nb; ++j) {
        const float vj = to_f(vc[(size_t)j * slot_stride]);
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const int g = g0 + i * gstep;
          if (g < group) pv[i] += p_s[g * block + j] * vj;
        }
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int g = g0 + i * gstep;
        if (g < group) acc[i] = acc[i] * alpha_s[g] + pv[i];
      }
    }
    __syncthreads();
  }

  // the partial of split z of (b, kh): [m, l] per q row, then acc [group][d]
  float* pz = part + (((size_t)b * kv_heads + kh) * gridDim.z + z) *
                         (size_t)group * (d + 2);
  for (int g = tid; g < group; g += THREADS) {
    pz[2 * g] = m_s[g];
    pz[2 * g + 1] = l_s[g];
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int g = g0 + i * gstep;
    if (g < group) pz[2 * group + (size_t)g * d + dd] = acc[i];
  }
}

// Combine the live splits of each (kv head, batch row), over
// ceil(group * d / THREADS) CTAs of it, one output element a thread: m and
// l of every live split into shared memory; per q row (one warp each) M,
// the weights exp(m_i - M) and L = sum l_i exp(m_i - M); then each thread
// sums acc_i exp(m_i - M) over the splits in order and divides once by L.
// Given lse, the thread of a row's column 0 stores M + log L there (an
// empty row, no live split: o = 0, lse = -inf).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ring_decode_combine_kernel(const int* __restrict__ seq_lens,
                               const float* __restrict__ part,
                               T* __restrict__ out,
                               float* __restrict__ lse, int seq_scalar,
                               int window, int kv_heads, int group, int d,
                               int split_len, int splits) {
  extern __shared__ float w_s[];          // [group][splits]: m, then weights
  float* l_s = w_s + group * splits;      // [group][splits]: l
  float* big_l = l_s + group * splits;    // [group]: L
  float* big_m = big_l + group;           // [group]: M
  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seq = seq_lens ? seq_lens[b] : seq_scalar;
  const int end = seq >= window ? window : seq >= 1 ? seq : lse ? 0 : window;
  const int live = (end + split_len - 1) / split_len;
  const size_t stride = (size_t)group * (d + 2);
  const float* pb = part + ((size_t)b * kv_heads + kh) * splits * stride;

  for (int e = tid; e < 2 * group * live; e += THREADS) {
    const int i = e / (2 * group), r = e - i * 2 * group, g = r >> 1;
    (r & 1 ? l_s : w_s)[g * splits + i] = pb[i * stride + r];
  }
  __syncthreads();
  for (int g = warp; g < group; g += WARPS) {
    float* w = w_s + g * splits;
    float mx = -INFINITY;
    for (int i = lane; i < live; i += 32) mx = fmaxf(mx, w[i]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int i = lane; i < live; i += 32) {
      w[i] = expf(w[i] - mx);
      l += l_s[g * splits + i] * w[i];
    }
    l = warp_sum(l);
    if (lane == 0) {
      big_l[g] = l;
      big_m[g] = mx;
    }
  }
  __syncthreads();
  const int e = blockIdx.z * THREADS + tid;
  if (e >= group * d) return;
  const int g = e / d;
  const size_t row = (size_t)b * kv_heads + kh;
  if (live == 0) {   // an empty row of a slice (only given lse)
    store(&out[row * group * d + e], 0.f);
    if (e % d == 0) lse[row * group + g] = -INFINITY;
    return;
  }
  const float* w = w_s + g * splits;
  const float* acc = pb + 2 * group + e;
  float o = 0.f;
#pragma unroll 16
  for (int i = 0; i < live; ++i) o += acc[i * stride] * w[i];
  store(&out[row * group * d + e], o / big_l[g]);
  if (lse && e % d == 0) lse[row * group + g] = big_m[g] + logf(big_l[g]);
}

template <typename T, int G>
int launch_g(const void* q, const void* k, const void* v,
             const void* seq_lens, void* out, void* part, void* lse,
             int batch, int window, int kv_heads, int group, int d,
             int block, int seq_scalar, int split_len, int splits,
             float scale, float softcap, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)group * d + (size_t)group * block + 3 * group);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ring_decode_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ring_decode_kernel<T, G><<<dim3(kv_heads, batch, splits), THREADS, smem,
                             (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)seq_lens,
      (float*)part, seq_scalar, window, kv_heads, group, d, block, split_len,
      scale, softcap, lse != nullptr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ring_decode_combine_kernel<T><<<
      dim3(kv_heads, batch, (group * d + THREADS - 1) / THREADS), THREADS,
      sizeof(float) * (size_t)group * (2 * splits + 2),
      (cudaStream_t)stream>>>(
      (const int*)seq_lens, (const float*)part, (T*)out, (float*)lse,
      seq_scalar, window, kv_heads, group, d, split_len, splits);
  return (int)cudaGetLastError();
}

// The group rounded up to a power of two picks the instantiation.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* seq_lens,
           void* out, void* part, void* lse, int batch, int window,
           int kv_heads, int group, int d, int block, int seq_scalar,
           int split_len, int splits, float scale, float softcap,
           void* stream) {
#define RING_DECODE_LAUNCH(G)                                                 \
  return launch_g<T, G>(q, k, v, seq_lens, out, part, lse, batch, window,    \
                        kv_heads, group, d, block, seq_scalar, split_len,    \
                        splits, scale, softcap, stream)
  if (group <= 1) RING_DECODE_LAUNCH(1);
  if (group <= 2) RING_DECODE_LAUNCH(2);
  if (group <= 4) RING_DECODE_LAUNCH(4);
  if (group <= 8) RING_DECODE_LAUNCH(8);
  RING_DECODE_LAUNCH(MAX_GROUP);
#undef RING_DECODE_LAUNCH
}

}  // namespace

extern "C" {

const char* ring_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// seq_lens: an int32 [batch] device array, or NULL for seq_scalar in every
// row; part: the splits' fp32 workspace, batch * kv_heads * splits *
// group * (d + 2) floats, followed where with_lse is set by the rows'
// log-sum-exp, [batch, q_heads] fp32 (and empty rows at seq_len < 1);
// softcap 0 for none; bf16 selects bf16 q/k/v/out (else fp32).
int ring_decode_attention(const void* q, const void* k, const void* v,
                          const void* seq_lens, void* out, void* part,
                          int batch, int window, int kv_heads, int group,
                          int d, int block, int seq_scalar, int bf16,
                          int split_len, int splits, float scale,
                          float softcap, int with_lse, void* stream) {
  void* lse = with_lse ? (void*)((float*)part + (size_t)batch * kv_heads *
                                                    splits * group * (d + 2))
                       : nullptr;
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, seq_lens, out, part, lse, batch,
                                 window, kv_heads, group, d, block,
                                 seq_scalar, split_len, splits, scale,
                                 softcap, stream);
  return launch<float>(q, k, v, seq_lens, out, part, lse, batch, window,
                       kv_heads, group, d, block, seq_scalar, split_len,
                       splits, scale, softcap, stream);
}

}  // extern "C"
