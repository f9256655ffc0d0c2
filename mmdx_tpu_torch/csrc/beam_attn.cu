// Beam self-attention over the flat physical KV cache (ops/beam_attn.py):
// the normalised read over the written cache, bf16 or int8 (replaces
// mmdx_tpu/ops/pallas_beam_attn.py:beam_decode_attention and
// beam_decode_attention_int8), and the softmax partials over the old cache
// (replaces beam_decode_attention_partial). One cluster body serves all
// three.
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
// A thread-block cluster of R blocks (R = 1, 2, 4 or 8, chosen by the
// wrapper from the grid's size, ops/beam_attn.cluster_ranks) owns one
// (sample, head); block (rank r) owns the contiguous keys [r*chunk,
// (r+1)*chunk) of chunk = ceil(K / R), possibly none when K < R. The
// cluster's blocks exchange their statistics through distributed shared
// memory, so nothing goes to device memory between the phases:
//   0. the chunk's k and v slices are copied to shared memory with cp.async,
//      all in flight at once (the v copies land while phases 1-2 run);
//   1. chunk scores, the chunk max; the ranks' maxima give the global max m
//      (an empty chunk gives -3e38). The reads give a key 8 lanes, 16 bytes
//      each, and a 3-step shuffle sum (a warp covers 4 keys a step); the
//      partials give a key one thread and sum its 64 products in order,
//      the plain version's order, since their bf16(e) feeds an f32 output;
//   2. e = exp(s - m) with the global m and the chunk sums; the ranks' sums,
//      added in rank order by every block alike, give the sum l; then the
//      weights of the product with v: the normalised read's
//      p = bf16((e / l) * sv) (sv: the int8 cache's V scales, else 1), the
//      partials' bf16(e) (not e / l: the Pallas partial body's rounding
//      point, which a rank's own max would not give);
//   3. the chunk's f32 partial weights . v (8 lanes to a v row, 8 columns a
//      lane), each column's partial sent to the rank that owns the column;
//      rank r adds the ranks' partials of its own 64 / R output columns in
//      rank order and writes them: bf16 ctx for the reads, f32 acc (with m
//      and l, from rank 0) for the partials.
// The partials (K3) then leave to the caller the current token's own
// column (models/t5.py composes it with m and l).
//
// Neither computes a cross-sample score: the TPU kernel packs several
// samples into one block-diagonal score matrix; here a cluster owns one
// sample. Masks are additive -1e9, never -inf: with every column masked (the
// first decode step) the scores are all about -1e9, m is finite, and the
// caller's exp(m - m_own) underflows to exactly 0. No row is special-cased.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_NB = 8;
constexpr int HEAD_DIM = 64;
constexpr int MAX_RANKS = 8;    // the portable cluster size
constexpr int RD_THREADS = 128;
constexpr int RD_WARPS = RD_THREADS / 32;
constexpr int KEY_SLOTS = RD_THREADS / 8;  // key rows in flight per block step
constexpr float EMPTY_MAX = -3.0e38f;

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

// bytes of one head's k (or v) slice of a cache row
template <typename T>
__host__ __device__ constexpr int row_bytes() { return HEAD_DIM * static_cast<int>(sizeof(T)); }
// the stride of the k slices in shared memory: the partials give a key a
// thread, so their rows are padded by 16 bytes, and the 16-byte loads of 8
// neighbouring threads fall on distinct banks
template <typename T, bool PARTIAL>
__host__ __device__ constexpr int k_row_stride() { return row_bytes<T>() + (PARTIAL ? 16 : 0); }

// The cluster body. Reads (PARTIAL false), for a bf16 cache (T = bf16, kvs
// unused) or an int8 one with per-(row, head) scales kvs [B, 2h, K] (rows
// 0..h-1 the K scales, h..2h-1 the V scales):
//   s[i, k] = ((q . k) * sk[k] + bias[h, k]) + mask[b, i, k]   (no sk: bf16)
//   p[i, k] = bf16((exp(s - max) / sum) * sv[k])                (no sv: bf16)
//   ctx[i]  = bf16(sum_k p[i, k] * v[b, k, h])   -> out bf16 [B, nb, h*64]
// the rounding points of pallas_beam_attn's two kernel bodies. Partials
// (PARTIAL true, bf16 cache): acc[i] = sum_k bf16(exp(s - m)) * v -> out f32
// [B, nb, h*64], and m, l [B, nb, h].
template <typename T, bool PARTIAL, int RANKS>
__device__ __forceinline__ void cluster_read(const bf16* __restrict__ q,
                                             const T* __restrict__ kv,
                                             const float* __restrict__ kvs,
                                             const float* __restrict__ mask,
                                             const float* __restrict__ bias, void* out,
                                             float* m_out, float* l_out, int nb, int K,
                                             int heads) {
  constexpr int RB = row_bytes<T>(), PIECES = RB / 16;  // 16-byte copies per slice
  constexpr int KRS = k_row_stride<T, PARTIAL>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float cmax[MAX_NB], csum[MAX_NB], gmax[MAX_NB], gsum[MAX_NB];
  // [ranks][MAX_NB][64 / ranks]: the ranks' partials of my columns
  __shared__ float recv[MAX_NB * HEAD_DIM];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int ranks = RANKS, cols = HEAD_DIM / RANKS;  // output columns each rank owns
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane % 8, slot = tid / 8;  // 8 dims of the head; the key slot
  const int hd = heads * HEAD_DIM;
  const int chunk = (K + ranks - 1) / ranks;
  const int k_lo = min(K, rank * chunk), nk = min(K, k_lo + chunk) - k_lo;
  unsigned char* sk_rows = smem;                    // [chunk][KRS] the chunk's k slices
  unsigned char* sv_rows = smem + (size_t)chunk * KRS;  // [chunk][RB] its v slices
  float* sc = reinterpret_cast<float*>(sv_rows + (size_t)chunk * RB);  // [nb][chunk]
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
    cp_async16(sk_rows + (c / PIECES) * KRS + (c % PIECES) * 16,
               base + (c / PIECES) * row_stride + (c % PIECES) * 16);
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

  // phase 1: scores of the chunk's keys
  if constexpr (PARTIAL) {
    // one key a thread, each score an f32 FMA chain over the 64 dims in
    // order (q from shared memory): the order of the plain version's f32
    // product, so e = exp(s - m) and its bf16 rounding agree with it, and
    // acc, an f32 output, differs only by the order of its sums
    __shared__ float qs[MAX_NB * HEAD_DIM];
    for (int e = tid; e < nb * HEAD_DIM; e += RD_THREADS)
      qs[e] = bf2f(q[((size_t)b * nb + e / HEAD_DIM) * hd + h * HEAD_DIM + e % HEAD_DIM]);
    cp_async_wait<1>();  // the k slices landed
    __syncthreads();
    for (int kl = tid; kl < nk; kl += RD_THREADS) {
      uint4 kraw[HEAD_DIM / 8];  // the key's 64 bf16 values, packed
#pragma unroll
      for (int c = 0; c < HEAD_DIM / 8; ++c)
        kraw[c] = *reinterpret_cast<const uint4*>(sk_rows + kl * KRS + c * 16);
      for (int i = 0; i < nb; ++i) {
        const float* qi = qs + i * HEAD_DIM;
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < HEAD_DIM / 8; ++c) {
          const unsigned w[4] = {kraw[c].x, kraw[c].y, kraw[c].z, kraw[c].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            s += qi[c * 8 + 2 * u] * __uint_as_float(w[u] << 16);
            s += qi[c * 8 + 2 * u + 1] * __uint_as_float(w[u] & 0xffff0000u);
          }
        }
        sc[i * chunk + kl] = (s + sbias[kl]) + smask[i * chunk + kl];
      }
    }
  } else {
    // 8 lanes to a key, 16 bytes each, a 3-step shuffle sum
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
      if (ok) load8(reinterpret_cast<const T*>(sk_rows + kl * KRS) + sub * 8, k8);
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
    for (int r = 0; r < ranks; ++r) mx = fmaxf(mx, cluster.map_shared_rank(cmax, r)[tid]);
    gmax[tid] = mx;
  }
  __syncthreads();

  // phase 2: exp(s - m), the chunk sums, the cluster's sum, the weights
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
    for (int r = 0; r < ranks; ++r) sum += cluster.map_shared_rank(csum, r)[tid];
    gsum[tid] = sum;
    if (PARTIAL && rank == 0) {
      m_out[((size_t)b * nb + tid) * heads + h] = gmax[tid];
      l_out[((size_t)b * nb + tid) * heads + h] = sum;
    }
  }
  __syncthreads();
  for (int e = tid; e < nb * nk; e += RD_THREADS) {
    const int i = e / nk, k = e % nk;
    float w = sc[i * chunk + k];
    if (!PARTIAL) {
      w /= gsum[i];
      if (int8_cache) w *= svs[k];
    }
    sc[i * chunk + k] = round_bf16(w);
  }
  __syncthreads();

  // phase 3: the chunk's partial weights . v, 8 lanes to a v row
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
  // the block's partial of column c goes to rank c / cols
  for (int e = tid; e < nb * HEAD_DIM; e += RD_THREADS) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < RD_WARPS; ++w) sum += wpart[w * nb * HEAD_DIM + e];
    const int i = e / HEAD_DIM, c = e % HEAD_DIM;
    cluster.map_shared_rank(recv, c / cols)[(rank * MAX_NB + i) * cols + c % cols] = sum;
  }
  cluster.sync();  // every partial delivered; from here on only local reads
  for (int e = tid; e < nb * cols; e += RD_THREADS) {
    const int i = e / cols, c = e % cols;
    float sum = 0.0f;
    for (int r = 0; r < ranks; ++r) sum += recv[(r * MAX_NB + i) * cols + c];
    const size_t o = ((size_t)b * nb + i) * hd + h * HEAD_DIM + rank * cols + c;
    if (PARTIAL)
      static_cast<float*>(out)[o] = sum;
    else
      static_cast<bf16*>(out)[o] = f2bf(sum);
  }
}

// the normalised reads (rows 5 and 7), on clusters of RANKS blocks
template <typename T, int RANKS>
__global__ void __launch_bounds__(RD_THREADS)
beam_attn_kernel(const bf16* __restrict__ q, const T* __restrict__ kv,
                 const float* __restrict__ kvs, const float* __restrict__ mask,
                 const float* __restrict__ bias, bf16* __restrict__ ctx, int nb, int K,
                 int heads) {
  cluster_read<T, false, RANKS>(q, kv, kvs, mask, bias, ctx, nullptr, nullptr, nb, K, heads);
}

// the partials (K3; a name of its own, so a profile tells it from the reads)
template <int RANKS>
__global__ void __launch_bounds__(RD_THREADS)
beam_partial_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                    const float* __restrict__ mask, const float* __restrict__ bias,
                    float* __restrict__ acc, float* __restrict__ m, float* __restrict__ l,
                    int nb, int K, int heads) {
  cluster_read<bf16, true, RANKS>(q, kv, nullptr, mask, bias, acc, m, l, nb, K, heads);
}

// f(std::integral_constant<int, ranks>) for ranks 1, 2, 4 or 8
template <typename F>
int by_ranks(int ranks, F f) {
  switch (ranks) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case MAX_RANKS: return f(std::integral_constant<int, MAX_RANKS>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch ``kernel`` on clusters of ``ranks`` blocks, one cluster per
// (sample, head), with the dynamic shared memory of a chunk of the keys.
template <typename T, bool PARTIAL, typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int B, int nb, int K, int heads, int head_dim, int ranks,
                   void* stream, Args... args) {
  if (B <= 0 || nb <= 0 || nb > MAX_NB || K <= 0 || heads <= 0 || heads > 65535 ||
      B > 65535 || head_dim != HEAD_DIM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = (K + ranks - 1) / ranks;
  const size_t smem = (size_t)chunk * (k_row_stride<T, PARTIAL>() + row_bytes<T>()) +
      ((2 * (size_t)nb + 3) * chunk + RD_WARPS * (size_t)nb * HEAD_DIM) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, heads, B);
  cfg.blockDim = dim3(RD_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_status();
}

}  // namespace

// Replaces pallas_beam_attn.beam_decode_attention. q [B, nb, h*64] bf16;
// kv [B, K, 2*h*64] bf16; mask [B, nb, K] f32; bias [h, K] f32
// -> ctx [B, nb, h*64] bf16. ranks: blocks per cluster, 1, 2, 4 or 8.
MMDX_EXPORT int mmdx_beam_attn(const void* q, const void* kv, const void* mask,
                               const void* bias, void* ctx, int B, int nb, int K,
                               int heads, int head_dim, int ranks, void* stream) {
  return by_ranks(ranks, [&](auto r) {
    return launch_cluster<bf16, false>(
        beam_attn_kernel<bf16, decltype(r)::value>, B, nb, K, heads, head_dim, ranks, stream,
        static_cast<const bf16*>(q), static_cast<const bf16*>(kv),
        static_cast<const float*>(nullptr), static_cast<const float*>(mask),
        static_cast<const float*>(bias), static_cast<bf16*>(ctx), nb, K, heads);
  });
}

// Replaces pallas_beam_attn.beam_decode_attention_int8. As mmdx_beam_attn
// with kv [B, K, 2*h*64] int8 and kvs [B, 2h, K] f32 dequant scales.
MMDX_EXPORT int mmdx_beam_attn_int8(const void* q, const void* kv, const void* kvs,
                                    const void* mask, const void* bias, void* ctx,
                                    int B, int nb, int K, int heads, int head_dim,
                                    int ranks, void* stream) {
  if (kvs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return by_ranks(ranks, [&](auto r) {
    return launch_cluster<int8_t, false>(
        beam_attn_kernel<int8_t, decltype(r)::value>, B, nb, K, heads, head_dim, ranks, stream,
        static_cast<const bf16*>(q), static_cast<const int8_t*>(kv),
        static_cast<const float*>(kvs), static_cast<const float*>(mask),
        static_cast<const float*>(bias), static_cast<bf16*>(ctx), nb, K, heads);
  });
}

// Replaces pallas_beam_attn.beam_decode_attention_partial. q [B, nb, h*64]
// bf16; kv [B, K, 2*h*64] bf16; mask [B, nb, K] f32; bias [h, K] f32
// -> acc [B, nb, h*64] f32, m and l [B, nb, h] f32.
MMDX_EXPORT int mmdx_beam_attn_partial(const void* q, const void* kv, const void* mask,
                                       const void* bias, void* acc, void* m, void* l, int B,
                                       int nb, int K, int heads, int head_dim, int ranks,
                                       void* stream) {
  return by_ranks(ranks, [&](auto r) {
    return launch_cluster<bf16, true>(
        beam_partial_kernel<decltype(r)::value>, B, nb, K, heads, head_dim, ranks, stream,
        static_cast<const bf16*>(q), static_cast<const bf16*>(kv),
        static_cast<const float*>(mask), static_cast<const float*>(bias),
        static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), nb, K, heads);
  });
}
