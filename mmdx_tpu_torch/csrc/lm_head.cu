// Streamed tied lm head with the decode step's selection statistics
// (ops/lm_head.py). Replaces mmdx_tpu/ops/pallas_lm_head.py:lm_head_greedy
// (greedy: masked per-chunk max and earliest argmax, no logits) and
// lm_head_stats (beam: logits, per-chunk raw max and sum of exponentials,
// masked per-chunk max; a second small launch merges the partials into the
// row max m and L = log sum exp(x - m)).
//
// logits[n, v] = hidden[n, :] . emb[v, :], hidden [N, D] and emb [V, D]
// bf16, f32 accumulation on the tensor cores (nvcuda::wmma, 16x16x16 bf16).
// One block per 128-column vocab chunk (V % 128 == 0; 251 blocks at the
// T5 vocabulary): the block copies its chunk of emb [128, D] into shared
// memory ONCE, then walks the rows in tiles of 32, so emb is read from
// device memory exactly once per call and hidden (N x D, from L2) once per
// chunk. Each tile's [32, 128] f32 scores are staged in shared memory for
// the epilogue, one warp per row: the masked chunk max (mask byte != 0 ->
// -inf) and the earliest offset that attains it (a fully masked chunk gives
// offset 0, as the dense argmax over -inf does), and for the stats the raw
// logits, the chunk's raw max and its sum of exp(x - max).
//
// Bounded by bytes at decode batch sizes: the emb read (32128 x 512 bf16 =
// 32.9 MB, ~10 us at 3.35 TB/s) dominates every other byte and the products
// (2 N V D operations) stay below the tensor cores' break-even up to N of a
// few hundred rows. The TPU kernel carried m and L across a sequential vocab
// grid; blocks here run in no order, so they write per-chunk partials and
// mmdx_lm_head_stats merges them in a second launch.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int CHUNK = 128;
constexpr int RT = 32;  // rows per tile
constexpr int THREADS = 256;
constexpr int LDC = CHUNK + 4;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ int warp_min_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t smem_bytes(int D) {
  return (size_t)(CHUNK + RT) * (D + 8) * sizeof(bf16) + (size_t)RT * LDC * sizeof(float);
}

// Copy `rows` rows of D bf16 from src (row stride D) into dst (stride LD);
// rows at or past `valid` read as zero.
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int rows,
                                          int valid, int D, int LD) {
  const int per_row = D / 8;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * per_row; e += THREADS) {
    const int r = e / per_row, c = (e % per_row) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

template <bool STATS>
__global__ void __launch_bounds__(THREADS)
lm_head_kernel(const bf16* __restrict__ hidden, const bf16* __restrict__ emb,
               const uint8_t* __restrict__ mask, float* __restrict__ logits,
               float* __restrict__ cmax, int* __restrict__ carg,
               float* __restrict__ pmax, float* __restrict__ psum, int N, int V,
               int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LD = D + 8;
  bf16* Es = reinterpret_cast<bf16*>(smem);  // [CHUNK, LD]: this chunk's emb rows
  bf16* Hs = Es + CHUNK * LD;                // [RT, LD]: a tile of hidden rows
  float* Cs = reinterpret_cast<float*>(Hs + RT * LD);  // [RT, LDC] scores
  const int chunk = blockIdx.x, C = V / CHUNK, col0 = chunk * CHUNK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % 2, wc = warp / 2;  // warp tile: 16 rows x 32 columns

  copy_rows(Es, emb + (size_t)col0 * D, CHUNK, CHUNK, D, LD);
  for (int row0 = 0; row0 < N; row0 += RT) {
    __syncthreads();  // the previous tile's epilogue is done with Hs and Cs
    copy_rows(Hs, hidden + (size_t)row0 * D, RT, N - row0, D, LD);
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
    for (int k = 0; k < D; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Hs + wr * 16 * LD + k, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // emb rows are the product's columns: a column-major B fragment
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, Es + (wc * 32 + j * 16) * LD + k, LD);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + wr * 16 * LDC + wc * 32 + j * 16, acc[j], LDC,
                              wmma::mem_row_major);
    __syncthreads();

    for (int r = warp; r < RT; r += THREADS / 32) {
      const int n = row0 + r;
      if (n >= N) break;  // warp-uniform
      const float* crow = Cs + r * LDC;
      const uint8_t* mrow = mask + (size_t)n * V + col0;
      float x[4], xm[4];
      float mmax = neg_inf();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = lane + 32 * u;
        x[u] = crow[c];
        xm[u] = mrow[c] ? neg_inf() : x[u];
        mmax = fmaxf(mmax, xm[u]);
      }
      mmax = warp_max(mmax);
      const size_t o = (size_t)n * C + chunk;
      if (STATS) {
        float rmax = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
        rmax = warp_max(rmax);
        float se = 0.0f;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          logits[(size_t)n * V + col0 + lane + 32 * u] = x[u];
          se += expf(x[u] - rmax);
        }
        se = warp_sum(se);
        if (lane == 0) {
          cmax[o] = mmax;
          pmax[o] = rmax;
          psum[o] = se;
        }
      } else {
        int arg = CHUNK;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (xm[u] == mmax) arg = min(arg, lane + 32 * u);
        arg = warp_min_int(arg);
        if (lane == 0) {
          cmax[o] = mmax;
          carg[o] = min(arg, CHUNK - 1);
        }
      }
    }
  }
}

// m[n] = max_c pmax[n, c]; L[n] = log(sum_c psum[n, c] * exp(pmax[n, c] - m[n])).
__global__ void lm_head_merge_kernel(const float* __restrict__ pmax,
                                     const float* __restrict__ psum,
                                     float* __restrict__ m, float* __restrict__ L,
                                     int N, int C) {
  const int n = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (n >= N) return;
  const float* pm = pmax + (size_t)n * C;
  const float* ps = psum + (size_t)n * C;
  float mx = neg_inf();
  for (int c = lane; c < C; c += 32) mx = fmaxf(mx, pm[c]);
  mx = warp_max(mx);
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += ps[c] * expf(pm[c] - mx);
  s = warp_sum(s);
  if (lane == 0) {
    m[n] = mx;
    L[n] = logf(s);
  }
}

template <bool STATS>
int launch_lm_head(const void* hidden, const void* emb, const void* mask,
                   void* logits, void* cmax, void* carg, void* pmax, void* psum,
                   int N, int V, int D, cudaStream_t stream) {
  if (N <= 0 || V <= 0 || V % CHUNK != 0 || D <= 0 || D % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(lm_head_kernel<STATS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lm_head_kernel<STATS><<<V / CHUNK, THREADS, smem, stream>>>(
      static_cast<const bf16*>(hidden), static_cast<const bf16*>(emb),
      static_cast<const uint8_t*>(mask), static_cast<float*>(logits),
      static_cast<float*>(cmax), static_cast<int*>(carg), static_cast<float*>(pmax),
      static_cast<float*>(psum), N, V, D);
  return launch_status();
}

}  // namespace

// hidden [N, D] bf16 (head scale applied); emb [V, D] bf16; mask [N, V]
// bool (nonzero = banned) -> cmax [N, V/128] f32, carg [N, V/128] int32.
MMDX_EXPORT int mmdx_lm_head_greedy(const void* hidden, const void* emb,
                                    const void* mask, void* cmax, void* carg, int N,
                                    int V, int D, void* stream) {
  return launch_lm_head<false>(hidden, emb, mask, nullptr, cmax, carg, nullptr,
                               nullptr, N, V, D, static_cast<cudaStream_t>(stream));
}

// As mmdx_lm_head_greedy -> logits [N, V] f32, cmax [N, V/128] f32 (masked),
// m and L [N] f32 (raw logits), with pmax, psum [N, V/128] f32 scratch.
MMDX_EXPORT int mmdx_lm_head_stats(const void* hidden, const void* emb,
                                   const void* mask, void* logits, void* cmax,
                                   void* pmax, void* psum, void* m, void* L, int N,
                                   int V, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_lm_head<true>(hidden, emb, mask, logits, cmax, nullptr, pmax,
                                       psum, N, V, D, s);
  if (err != 0) return err;
  const int rows_per_block = 4;
  lm_head_merge_kernel<<<(N + rows_per_block - 1) / rows_per_block,
                         32 * rows_per_block, 0, s>>>(
      static_cast<const float*>(pmax), static_cast<const float*>(psum),
      static_cast<float*>(m), static_cast<float*>(L), N, V / CHUNK);
  return launch_status();
}
