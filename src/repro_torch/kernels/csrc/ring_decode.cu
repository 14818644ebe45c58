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
// One thread block per (kv head, batch row) holds the group's q rows in
// shared memory and walks the window in blocks of `block` slots, as the
// Pallas grid does, with the online softmax of its body:
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
// and divides by l once at the end.  A last block shorter than `block` (a
// cache_len that is no multiple of it) holds only the slots that exist, and
// blocks wholly past seq_len (a global cache not yet full) are skipped:
// they would add p = 0 with alpha = 1.  The group (q heads per kv head, at
// most 16) is a template parameter rounded up to a power of two, so the
// per-row loops unroll to it; head_dim is a power of two up to 256.
//
// What bounds it on the card: bytes.  Each K/V element is read once (group q
// rows share it), 2 fp32 operations per multiply-add: at gemma3-1b's shapes
// (kv_heads 1, d 256, bf16) a 512-slot local ring is 0.52 MB per batch row,
// about 0.16 us at 3.35 TB/s.  At batch 4 the grid is only 4 blocks on 4 of
// the 132 SMs, and each warp walks its slots one after another (load, dot,
// shuffle sums), so that walk, not bytes, sets the time.  Tried and slower
// on the card: one thread per slot with 16-byte K loads (rows 512 B apart
// in a warp), and two or four slots in flight per warp; the depth of the
// p . v unroll made no difference.  Splitting the window across blocks
// (flash-decoding with a second combine pass), TMA and wgmma are later
// work.

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
                       const int* __restrict__ seq_lens, T* __restrict__ out,
                       int seq_scalar, int window, int kv_heads, int group,
                       int d, int block, float scale, float softcap) {
  // G: the group rounded up to a power of two (a template, so the per-row
  // loops unroll exactly); rows g >= group are skipped.
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                     // [group][d], times d^-0.5
  float* p_s = q_s + group * d;          // [group][block]: s, then p
  float* alpha_s = p_s + group * block;  // [group]
  float* l_s = alpha_s + group;          // [group]
  float* m_s = l_s + group;              // [group]

  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_heads = kv_heads * group;
  const int seq = seq_lens ? seq_lens[b] : seq_scalar;
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

  // Blocks wholly past seq (a global cache not yet full) would add p = 0
  // with alpha = 1: they are skipped.
  const int end = (seq >= window || seq < 1) ? window : seq;
  for (int base = 0; base < end; base += block) {
    const int nb = min(block, window - base);

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
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < KPL; ++i) {
          const int c = lane + 32 * i;
          if (i < per_lane && c < d) part += q_s[g * d + c] * kr[i];
        }
        float x = warp_sum(part);
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

#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int g = g0 + i * gstep;
    if (g < group) store(&out[q_row + (size_t)g * d + dd], acc[i] / l_s[g]);
  }
}

template <typename T, int G>
int launch_g(const void* q, const void* k, const void* v,
             const void* seq_lens, void* out, int batch, int window,
             int kv_heads, int group, int d, int block, int seq_scalar,
             float scale, float softcap, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)group * d + (size_t)group * block + 3 * group);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ring_decode_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ring_decode_kernel<T, G><<<dim3(kv_heads, batch), THREADS, smem,
                             (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)seq_lens, (T*)out,
      seq_scalar, window, kv_heads, group, d, block, scale, softcap);
  return (int)cudaGetLastError();
}

// The group rounded up to a power of two picks the instantiation.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* seq_lens,
           void* out, int batch, int window, int kv_heads, int group, int d,
           int block, int seq_scalar, float scale, float softcap,
           void* stream) {
#define RING_DECODE_LAUNCH(G)                                                 \
  return launch_g<T, G>(q, k, v, seq_lens, out, batch, window, kv_heads,     \
                        group, d, block, seq_scalar, scale, softcap, stream)
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
// row; softcap 0 for none; bf16 selects bf16 q/k/v/out (else fp32).
int ring_decode_attention(const void* q, const void* k, const void* v,
                          const void* seq_lens, void* out, int batch,
                          int window, int kv_heads, int group, int d,
                          int block, int seq_scalar, int bf16, float scale,
                          float softcap, void* stream) {
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, seq_lens, out, batch, window,
                                 kv_heads, group, d, block, seq_scalar, scale,
                                 softcap, stream);
  return launch<float>(q, k, v, seq_lens, out, batch, window, kv_heads, group,
                       d, block, seq_scalar, scale, softcap, stream);
}

}  // extern "C"
