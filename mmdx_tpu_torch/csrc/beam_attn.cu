// Beam self-attention over the flat physical KV cache (ops/beam_attn.py):
// the softmax partials over the old cache (replaces
// mmdx_tpu/ops/pallas_beam_attn.py:beam_decode_attention_partial), and the
// normalised read over the written cache, bf16 or int8 (replaces
// beam_decode_attention and beam_decode_attention_int8; below the partials).
//
// For one (sample b, head h) and each of the nb beam queries i:
//   s[i, k] = (q[b, i, h] . k[b, k, h] + bias[h, k]) + mask[b, i, k]
// The cache is [B, K, 2*h*d] bf16 (or int8), position-major, with head h's
// k in columns h*d .. h*d+d-1 and its v at +h*d.
//
// What bounds them on the H100: bytes. Every step reads the whole cache once
// per layer (K rows x 2 x 128 bytes per head) for only nb query rows, far
// below the tensor cores' break-even, so the products run on the CUDA cores
// in f32. At the greedy and beam shapes (B=4 nb=1 K=181, B=8 nb=4 K=724)
// the cache is 1.5 and 11.9 MB: 0.4-3.6 us at 3.35 TB/s, so what a design
// must beat is latency, and a grid of one block per (sample, head), 32-64
// blocks on 132 SMs, each walking its keys one thread per key, cannot.
//
// The partials kernel (K3), over the OLD cache,
//   m[i] = max_k s[i, k],  l[i] = sum_k exp(s - m),
//   acc[i] = sum_k bf16(exp(s[i, k] - m[i])) * v[b, k, h]
// (the caller composes the current token's own column, models/t5.py), is
// that first design: one block per (sample, head); pass 1 gives each thread a key (one 128-byte head slice with
// 16-byte loads) and keeps the nb x K scores in shared memory; pass 2
// streams the v rows with consecutive threads on consecutive columns.
//
// The normalised read splits each (sample, head) over the keys of a thread-
// block cluster of 8 (below): 8x the blocks, 8 lanes to a key row with one
// 16-byte load each, and the softmax statistics and partial products merged
// through distributed shared memory within one launch.
//
// Neither computes a cross-sample score: the TPU kernel packs several
// samples into one block-diagonal score matrix; here a block owns one
// sample. Masks are additive -1e9, never -inf: with every column masked (the
// first decode step) the scores are all about -1e9, m is finite, and the
// caller's exp(m - m_own) underflows to exactly 0. No row is special-cased.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

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

// The normalised read over the written cache (own column live), for a bf16
// cache (T = bf16, kvs unused) or an int8 one with per-(row, head) scales
// kvs [B, 2h, K] (rows 0..h-1 the K scales, h..2h-1 the V scales):
//   s[i, k] = ((q . k) * sk[k] + bias[h, k]) + mask[b, i, k]   (no sk: bf16)
//   p[i, k] = bf16((exp(s - max) / sum) * sv[k])                (no sv: bf16)
//   ctx[i]  = bf16(sum_k p[i, k] * v[b, k, h])
// the rounding points of pallas_beam_attn's two kernel bodies.
//
// A cluster of CLUSTER blocks owns one (sample, head); block (rank r) owns
// the contiguous keys [r*chunk, (r+1)*chunk) of chunk = ceil(K / CLUSTER),
// possibly none when K < CLUSTER. The cluster's blocks exchange their
// statistics through distributed shared memory, so nothing goes to device
// memory between the phases:
//   0. the chunk's k and v slices are copied to shared memory with cp.async,
//      all in flight at once (the v copies land while phases 1-2 run);
//   1. chunk scores (8 lanes to a key row, 16 bytes each, a 3-step shuffle
//      sum; a warp covers 4 keys a step), the chunk max; the ranks' maxima
//      give the global max m (an empty chunk gives -3e38);
//   2. exp(s - m) and the chunk sums; the ranks' sums, added in rank order
//      by every block alike, give the sum; p as above;
//   3. the chunk's f32 partial p . v (8 lanes to a v row, 8 columns a
//      lane), each column's partial sent to the rank that owns the column;
//      rank r adds the ranks' partials of its own 64 / CLUSTER output
//      columns in rank order and writes them in bf16.
constexpr int CLUSTER = 8;      // the portable cluster size
constexpr int RD_THREADS = 128;
constexpr int RD_WARPS = RD_THREADS / 32;
constexpr int KEY_SLOTS = RD_THREADS / 8;  // key rows in flight per block step
constexpr int COLS_PER_RANK = HEAD_DIM / CLUSTER;
constexpr float EMPTY_MAX = -3.0e38f;

// bytes of one head's k (or v) slice of a cache row
template <typename T>
__host__ __device__ constexpr int row_bytes() { return HEAD_DIM * static_cast<int>(sizeof(T)); }

template <typename T>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(RD_THREADS)
beam_attn_kernel(const bf16* __restrict__ q, const T* __restrict__ kv,
                 const float* __restrict__ kvs, const float* __restrict__ mask,
                 const float* __restrict__ bias, bf16* __restrict__ ctx, int nb,
                 int K, int heads) {
  constexpr int RB = row_bytes<T>(), PIECES = RB / 16;  // 16-byte copies per slice
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float cmax[MAX_NB], csum[MAX_NB], gmax[MAX_NB], gsum[MAX_NB];
  __shared__ float recv[CLUSTER][MAX_NB][COLS_PER_RANK];  // the ranks' partials of my columns
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane % 8, slot = tid / 8;  // 8 dims of the head; the key slot
  const int hd = heads * HEAD_DIM;
  const int chunk = (K + CLUSTER - 1) / CLUSTER;
  const int k_lo = min(K, rank * chunk), nk = min(K, k_lo + chunk) - k_lo;
  unsigned char* sk_rows = smem;                    // [chunk][RB] the chunk's k slices
  unsigned char* sv_rows = smem + (size_t)chunk * RB;  // [chunk][RB] its v slices
  float* sc = reinterpret_cast<float*>(smem + 2 * (size_t)chunk * RB);  // [nb][chunk]
  float* smask = sc + (size_t)nb * chunk;           // [nb][chunk] the chunk's mask
  float* sbias = smask + (size_t)nb * chunk;        // [chunk] its bias
  float* sks = sbias + chunk;                       // [chunk] its K scales (int8)
  float* svs = sks + chunk;                         // [chunk] its V scales (int8)
  float* wpart = svs + chunk;                       // [RD_WARPS][nb][64]
  const bool int8_cache = kvs != nullptr;

  // every k slice of the chunk, then every v slice, in flight at once
  const unsigned char* base = reinterpret_cast<const unsigned char*>(
      kv + ((size_t)b * K + k_lo) * 2 * hd + h * HEAD_DIM);
  const size_t row_stride = 2 * (size_t)hd * sizeof(T), v_off = (size_t)hd * sizeof(T);
  for (int c = tid; c < nk * PIECES; c += RD_THREADS)
    cp_async16(sk_rows + c * 16, base + (c / PIECES) * row_stride + (c % PIECES) * 16);
  cp_async_commit();
  for (int c = tid; c < nk * PIECES; c += RD_THREADS)
    cp_async16(sv_rows + c * 16, base + (c / PIECES) * row_stride + v_off + (c % PIECES) * 16);
  cp_async_commit();
  // the chunk's bias, mask and scales, read while the copies fly
  for (int e = tid; e < nb * nk; e += RD_THREADS)
    smask[(e / nk) * chunk + e % nk] = mask[((size_t)b * nb + e / nk) * K + k_lo + e % nk];
  for (int k = tid; k < nk; k += RD_THREADS) {
    sbias[k] = bias[(size_t)h * K + k_lo + k];
    if (int8_cache) {
      sks[k] = kvs[((size_t)b * 2 * heads + h) * K + k_lo + k];
      svs[k] = kvs[((size_t)b * 2 * heads + heads + h) * K + k_lo + k];
    }
  }

  // phase 1: scores of the chunk's keys, 8 lanes to a key
  float qr[MAX_NB][8];
#pragma unroll
  for (int i = 0; i < MAX_NB; ++i)
    if (i < nb) load8(q + ((size_t)b * nb + i) * hd + h * HEAD_DIM + sub * 8, qr[i]);
  cp_async_wait<1>();  // the k slices landed
  __syncthreads();
  for (int base_k = 0; base_k < nk; base_k += KEY_SLOTS) {  // uniform trip count: shuffles
    const int kl = base_k + slot;
    const bool ok = kl < nk;
    float k8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (ok) load8(reinterpret_cast<const T*>(sk_rows + kl * RB) + sub * 8, k8);
    float s[MAX_NB];
#pragma unroll
    for (int i = 0; i < MAX_NB; ++i) {
      s[i] = 0.0f;
      if (i < nb) {  // nb is uniform: the whole warp shuffles
#pragma unroll
        for (int u = 0; u < 8; ++u) s[i] += qr[i][u] * k8[u];
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
      }
    }
    if (ok && sub == 0) {
#pragma unroll
      for (int i = 0; i < MAX_NB; ++i)
        if (i < nb)
          sc[i * chunk + kl] =
              ((int8_cache ? s[i] * sks[kl] : s[i]) + sbias[kl]) + smask[i * chunk + kl];
    }
  }
  __syncthreads();
  for (int i = warp; i < nb; i += RD_WARPS) {
    float mx = EMPTY_MAX;
    for (int k = lane; k < nk; k += 32) mx = fmaxf(mx, sc[i * chunk + k]);
    mx = warp_max(mx);
    if (lane == 0) cmax[i] = mx;
  }
  cluster.sync();
  if (tid < nb) {
    float mx = EMPTY_MAX;
    for (int r = 0; r < CLUSTER; ++r) mx = fmaxf(mx, cluster.map_shared_rank(cmax, r)[tid]);
    gmax[tid] = mx;
  }
  __syncthreads();

  // phase 2: exp(s - m), the chunk sums, the cluster's sum, p
  for (int i = warp; i < nb; i += RD_WARPS) {
    float sum = 0.0f;
    for (int k = lane; k < nk; k += 32) {
      const float e = expf(sc[i * chunk + k] - gmax[i]);
      sc[i * chunk + k] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) csum[i] = sum;
  }
  cluster.sync();
  if (tid < nb) {
    float sum = 0.0f;
    for (int r = 0; r < CLUSTER; ++r) sum += cluster.map_shared_rank(csum, r)[tid];
    gsum[tid] = sum;
  }
  __syncthreads();
  for (int e = tid; e < nb * nk; e += RD_THREADS) {
    const int i = e / nk, k = e % nk;
    const float pv = sc[i * chunk + k] / gsum[i];
    sc[i * chunk + k] = round_bf16(int8_cache ? pv * svs[k] : pv);
  }
  __syncthreads();

  // phase 3: the chunk's partial p . v, 8 lanes to a v row
  float a[MAX_NB][8];
#pragma unroll
  for (int i = 0; i < MAX_NB; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) a[i][u] = 0.0f;
  cp_async_wait<0>();  // the v slices landed
  __syncthreads();
  for (int kl = slot; kl < nk; kl += KEY_SLOTS) {
    float v8[8];
    load8(reinterpret_cast<const T*>(sv_rows + kl * RB) + sub * 8, v8);
#pragma unroll
    for (int i = 0; i < MAX_NB; ++i)
      if (i < nb) {
        const float pv = sc[i * chunk + kl];
#pragma unroll
        for (int u = 0; u < 8; ++u) a[i][u] += pv * v8[u];
      }
  }
#pragma unroll
  for (int i = 0; i < MAX_NB; ++i)
    if (i < nb) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {  // the warp's 4 key slots
        a[i][u] += __shfl_xor_sync(0xffffffffu, a[i][u], 8);
        a[i][u] += __shfl_xor_sync(0xffffffffu, a[i][u], 16);
      }
      if (lane < 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) wpart[(warp * nb + i) * HEAD_DIM + sub * 8 + u] = a[i][u];
      }
    }
  __syncthreads();
  // the block's partial of column c goes to rank c / COLS_PER_RANK
  for (int e = tid; e < nb * HEAD_DIM; e += RD_THREADS) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < RD_WARPS; ++w) sum += wpart[w * nb * HEAD_DIM + e];
    const int i = e / HEAD_DIM, c = e % HEAD_DIM;
    cluster.map_shared_rank(&recv[0][0][0], c / COLS_PER_RANK)
        [(rank * MAX_NB + i) * COLS_PER_RANK + c % COLS_PER_RANK] = sum;
  }
  cluster.sync();  // every partial delivered; from here on only local reads
  for (int e = tid; e < nb * COLS_PER_RANK; e += RD_THREADS) {
    const int i = e / COLS_PER_RANK, c = e % COLS_PER_RANK;
    float sum = 0.0f;
    for (int r = 0; r < CLUSTER; ++r) sum += recv[r][i][c];
    ctx[((size_t)b * nb + i) * hd + h * HEAD_DIM + rank * COLS_PER_RANK + c] = f2bf(sum);
  }
}

template <typename T>
int launch_beam_attn(const void* q, const void* kv, const void* kvs,
                     const void* mask, const void* bias, void* ctx, int B, int nb,
                     int K, int heads, int head_dim, void* stream) {
  if (B <= 0 || nb <= 0 || nb > MAX_NB || K <= 0 || heads <= 0 || heads > 65535 ||
      B > 65535 || head_dim != HEAD_DIM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = (K + CLUSTER - 1) / CLUSTER;
  const size_t smem = 2 * (size_t)chunk * row_bytes<T>() +
      ((2 * (size_t)nb + 3) * chunk + RD_WARPS * (size_t)nb * HEAD_DIM) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(beam_attn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  beam_attn_kernel<T><<<dim3(CLUSTER, heads, B), RD_THREADS, smem,
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
