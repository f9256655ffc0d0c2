// Beam self-attention over the flat physical KV cache (ops/beam_attn.py):
// the softmax partials over the old cache (replaces
// mmdx_tpu/ops/pallas_beam_attn.py:beam_decode_attention_partial), and the
// normalised read over the written cache, bf16 or int8 (replaces
// beam_decode_attention and beam_decode_attention_int8; below the partials).
//
// For one (sample b, head h) per block and each of the nb beam queries i:
//   s[i, k] = (q[b, i, h] . k[b, k, h] + bias[h, k]) + mask[b, i, k]
//   m[i]    = max_k s[i, k]
//   l[i]    = sum_k exp(s[i, k] - m[i])
//   acc[i]  = sum_k bf16(exp(s[i, k] - m[i])) * v[b, k, h]
// over the OLD cache; the caller composes the current token's own column
// (models/t5.py). The cache is [B, K, 2*h*d] bf16, position-major, with head
// h's k in columns h*d .. h*d+d-1 and its v at +h*d.
//
// Bounded by bytes: every step reads the whole cache once (K rows x 2 x 128
// bytes per head) for only nb query rows, far below the tensor cores'
// break-even, so the products run on the CUDA cores in f32. Pass 1 streams
// the k rows (each lane loads one key's 128-byte head slice with 16-byte
// loads) and keeps the nb x K scores in shared memory; pass 2 streams the v
// rows with consecutive threads on consecutive columns. The TPU kernel packs
// several samples into one block-diagonal score matrix; here a block owns
// one sample, so no cross-sample score is ever computed.
//
// Masks are additive -1e9, never -inf: with every column masked (the first
// decode step) the scores are all about -1e9, m is finite, and the caller's
// exp(m - m_own) underflows to exactly 0. No row is special-cased.
#include "common.cuh"

namespace {

constexpr int MAX_NB = 8;
constexpr int HEAD_DIM = 64;
constexpr int THREADS = 2 * HEAD_DIM;

__global__ void __launch_bounds__(THREADS)
beam_attn_partial_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                         const float* __restrict__ mask,
                         const float* __restrict__ bias, float* __restrict__ acc,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         int nb, int K, int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nwarps = THREADS / 32;
  const int hd = heads * HEAD_DIM;
  float* qs = reinterpret_cast<float*>(smem);  // [nb, d]
  float* sc = qs + nb * HEAD_DIM;              // [nb, K]
  float* part = sc + (size_t)nb * K;           // [2, nb, d]

  for (int e = tid; e < nb * HEAD_DIM; e += THREADS) {
    const int i = e / HEAD_DIM, t = e % HEAD_DIM;
    qs[e] = bf2f(q[((size_t)b * nb + i) * hd + h * HEAD_DIM + t]);
  }
  __syncthreads();

  // pass 1: scores, one key per thread
  const bf16* kbase = kv + (size_t)b * K * 2 * hd + h * HEAD_DIM;
  const float* brow = bias + (size_t)h * K;
  const float* mrow = mask + (size_t)b * nb * K;
  for (int k = tid; k < K; k += THREADS) {
    const bf16* kr = kbase + (size_t)k * 2 * hd;
    float s[MAX_NB];
#pragma unroll
    for (int i = 0; i < MAX_NB; ++i) s[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < HEAD_DIM / 8; ++c) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * 8);
      const bf16* k8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float kval = bf2f(k8[u]);
#pragma unroll
        for (int i = 0; i < MAX_NB; ++i)
          if (i < nb) s[i] += qs[i * HEAD_DIM + c * 8 + u] * kval;
      }
    }
#pragma unroll
    for (int i = 0; i < MAX_NB; ++i)
      if (i < nb) sc[(size_t)i * K + k] = (s[i] + brow[k]) + mrow[(size_t)i * K + k];
  }
  __syncthreads();

  // row max, exp, row sum (one warp per query row)
  for (int i = warp; i < nb; i += nwarps) {
    float* row = sc + (size_t)i * K;
    float mx = -3.0e38f;
    for (int k = lane; k < K; k += 32) mx = fmaxf(mx, row[k]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float e = expf(row[k] - mx);
      row[k] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_out[((size_t)b * nb + i) * heads + h] = mx;
      l_out[((size_t)b * nb + i) * heads + h] = sum;
    }
  }
  __syncthreads();

  // pass 2: acc = bf16(e) @ v; thread (half, t) sums keys half, half+2, ...
  const int t = tid % HEAD_DIM, half = tid / HEAD_DIM;
  const bf16* vbase = kbase + hd;
  float a[MAX_NB];
#pragma unroll
  for (int i = 0; i < MAX_NB; ++i) a[i] = 0.0f;
  for (int k = half; k < K; k += 2) {
    const float vval = bf2f(vbase[(size_t)k * 2 * hd + t]);
#pragma unroll
    for (int i = 0; i < MAX_NB; ++i)
      if (i < nb) a[i] += round_bf16(sc[(size_t)i * K + k]) * vval;
  }
#pragma unroll
  for (int i = 0; i < MAX_NB; ++i)
    if (i < nb) part[(half * nb + i) * HEAD_DIM + t] = a[i];
  __syncthreads();
  for (int e = tid; e < nb * HEAD_DIM; e += THREADS) {
    const int i = e / HEAD_DIM, tt = e % HEAD_DIM;
    acc[((size_t)b * nb + i) * hd + h * HEAD_DIM + tt] =
        part[e] + part[nb * HEAD_DIM + e];
  }
}

// Eight cache values of one key or value row as f32: 16 bytes of bf16
// (common.cuh) or 8 bytes of int8 (exact in bf16, so the int8 product is
// that of the Pallas body's int8 -> bf16 cast).
using ::load8;
__device__ __forceinline__ void load8(const int8_t* p, float (&out)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int u = 0; u < 8; ++u) out[u] = static_cast<float>(v[u]);
}

__device__ __forceinline__ float to_f32(bf16 v) { return bf2f(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

// The normalised read over the written cache (own column live), for a bf16
// cache (T = bf16, kvs unused) or an int8 one with per-(row, head) scales
// kvs [B, 2h, K] (rows 0..h-1 the K scales, h..2h-1 the V scales):
//   s[i, k] = ((q . k) * sk[k] + bias[h, k]) + mask[b, i, k]   (no sk: bf16)
//   p[i, k] = bf16((exp(s - max) / sum) * sv[k])                (no sv: bf16)
//   ctx[i]  = bf16(sum_k p[i, k] * v[b, k, h])
// the rounding points of pallas_beam_attn's two kernel bodies. Same block
// shape and passes as the partials kernel above.
template <typename T>
__global__ void __launch_bounds__(THREADS)
beam_attn_kernel(const bf16* __restrict__ q, const T* __restrict__ kv,
                 const float* __restrict__ kvs, const float* __restrict__ mask,
                 const float* __restrict__ bias, bf16* __restrict__ ctx, int nb,
                 int K, int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nwarps = THREADS / 32;
  const int hd = heads * HEAD_DIM;
  float* qs = reinterpret_cast<float*>(smem);  // [nb, d]
  float* sc = qs + nb * HEAD_DIM;              // [nb, K]
  float* part = sc + (size_t)nb * K;           // [2, nb, d]
  const float* sk = kvs ? kvs + ((size_t)b * 2 * heads + h) * K : nullptr;
  const float* sv = kvs ? sk + (size_t)heads * K : nullptr;

  for (int e = tid; e < nb * HEAD_DIM; e += THREADS) {
    const int i = e / HEAD_DIM, t = e % HEAD_DIM;
    qs[e] = bf2f(q[((size_t)b * nb + i) * hd + h * HEAD_DIM + t]);
  }
  __syncthreads();

  // pass 1: scores, one key per thread
  const T* kbase = kv + (size_t)b * K * 2 * hd + h * HEAD_DIM;
  const float* brow = bias + (size_t)h * K;
  const float* mrow = mask + (size_t)b * nb * K;
  for (int k = tid; k < K; k += THREADS) {
    const T* kr = kbase + (size_t)k * 2 * hd;
    float s[MAX_NB];
#pragma unroll
    for (int i = 0; i < MAX_NB; ++i) s[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < HEAD_DIM / 8; ++c) {
      float k8[8];
      load8(kr + c * 8, k8);
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int i = 0; i < MAX_NB; ++i)
          if (i < nb) s[i] += qs[i * HEAD_DIM + c * 8 + u] * k8[u];
    }
    const float kscale = sk ? sk[k] : 1.0f;
#pragma unroll
    for (int i = 0; i < MAX_NB; ++i)
      if (i < nb)
        sc[(size_t)i * K + k] =
            ((sk ? s[i] * kscale : s[i]) + brow[k]) + mrow[(size_t)i * K + k];
  }
  __syncthreads();

  // softmax over each query row (one warp per row): p rounded to bf16
  for (int i = warp; i < nb; i += nwarps) {
    float* row = sc + (size_t)i * K;
    float mx = -3.0e38f;
    for (int k = lane; k < K; k += 32) mx = fmaxf(mx, row[k]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float e = expf(row[k] - mx);
      row[k] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int k = lane; k < K; k += 32) {
      const float p = row[k] / sum;
      row[k] = round_bf16(sv ? p * sv[k] : p);
    }
  }
  __syncthreads();

  // pass 2: ctx = p @ v; thread (half, t) sums keys half, half+2, ...
  const int t = tid % HEAD_DIM, half = tid / HEAD_DIM;
  const T* vbase = kbase + hd;
  float a[MAX_NB];
#pragma unroll
  for (int i = 0; i < MAX_NB; ++i) a[i] = 0.0f;
  for (int k = half; k < K; k += 2) {
    const float vval = to_f32(vbase[(size_t)k * 2 * hd + t]);
#pragma unroll
    for (int i = 0; i < MAX_NB; ++i)
      if (i < nb) a[i] += sc[(size_t)i * K + k] * vval;
  }
#pragma unroll
  for (int i = 0; i < MAX_NB; ++i)
    if (i < nb) part[(half * nb + i) * HEAD_DIM + t] = a[i];
  __syncthreads();
  for (int e = tid; e < nb * HEAD_DIM; e += THREADS) {
    const int i = e / HEAD_DIM, tt = e % HEAD_DIM;
    ctx[((size_t)b * nb + i) * hd + h * HEAD_DIM + tt] =
        f2bf(part[e] + part[nb * HEAD_DIM + e]);
  }
}

template <typename T>
int launch_beam_attn(const void* q, const void* kv, const void* kvs,
                     const void* mask, const void* bias, void* ctx, int B, int nb,
                     int K, int heads, int head_dim, void* stream) {
  if (B <= 0 || nb <= 0 || nb > MAX_NB || K <= 0 || heads <= 0 ||
      head_dim != HEAD_DIM)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      ((size_t)nb * HEAD_DIM + (size_t)nb * K + 2 * (size_t)nb * HEAD_DIM) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(beam_attn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  beam_attn_kernel<T><<<dim3(heads, B), THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(kv),
      static_cast<const float*>(kvs), static_cast<const float*>(mask),
      static_cast<const float*>(bias), static_cast<bf16*>(ctx), nb, K, heads);
  return launch_status();
}

}  // namespace

// Replaces pallas_beam_attn.beam_decode_attention. q [B, nb, h*64] bf16;
// kv [B, K, 2*h*64] bf16; mask [B, nb, K] f32; bias [h, K] f32
// -> ctx [B, nb, h*64] bf16.
MMDX_EXPORT int mmdx_beam_attn(const void* q, const void* kv, const void* mask,
                               const void* bias, void* ctx, int B, int nb, int K,
                               int heads, int head_dim, void* stream) {
  return launch_beam_attn<bf16>(q, kv, nullptr, mask, bias, ctx, B, nb, K, heads,
                                head_dim, stream);
}

// Replaces pallas_beam_attn.beam_decode_attention_int8. As mmdx_beam_attn
// with kv [B, K, 2*h*64] int8 and kvs [B, 2h, K] f32 dequant scales.
MMDX_EXPORT int mmdx_beam_attn_int8(const void* q, const void* kv, const void* kvs,
                                    const void* mask, const void* bias, void* ctx,
                                    int B, int nb, int K, int heads, int head_dim,
                                    void* stream) {
  if (kvs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_beam_attn<int8_t>(q, kv, kvs, mask, bias, ctx, B, nb, K, heads,
                                  head_dim, stream);
}

// q [B, nb, h*64] bf16; kv [B, K, 2*h*64] bf16; mask [B, nb, K] f32;
// bias [h, K] f32 -> acc [B, nb, h*64] f32, m and l [B, nb, h] f32.
MMDX_EXPORT int mmdx_beam_attn_partial(const void* q, const void* kv,
                                       const void* mask, const void* bias,
                                       void* acc, void* m, void* l, int B,
                                       int nb, int K, int heads, int head_dim,
                                       void* stream) {
  if (B <= 0 || nb <= 0 || nb > MAX_NB || K <= 0 || heads <= 0 ||
      head_dim != HEAD_DIM)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      ((size_t)nb * HEAD_DIM + (size_t)nb * K + 2 * (size_t)nb * HEAD_DIM) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(beam_attn_partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  beam_attn_partial_kernel<<<dim3(heads, B), THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kv),
      static_cast<const float*>(mask), static_cast<const float*>(bias),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
      nb, K, heads);
  return launch_status();
}
