// Tiled bf16 GEMM with fused epilogues, plus the LayerNorm the fused BERT
// blocks end with. Shared by the BERT kernels (ops/bert_attn.py,
// ops/fused_ffn.py); each of them is a short sequence of launches of the
// entry points below. The EPI_BF16, EPI_RELU_BF16 and EPI_RESID_BF16
// epilogues have no caller since the T5 half step became one kernel
// (csrc/t5_cross_ffn.cu); they stay because taking their cases out of the
// switch changes the code emitted for the others and slowed K2 on an H100
// (scripts/bench_decode_kernels.py, its K2 lines).
//
// GEMM: C[M, N] = A[M, K] @ B[K, N], A and B row-major bf16 (B is the flax
// [in, out] kernel layout), f32 accumulation on the tensor cores through
// nvcuda::wmma (mma.sync, 16x16x16 bf16 fragments). A 64x64 output tile per
// block of 4 warps, each warp 32x32; K advances 32 at a time through shared
// memory with 16-byte loads. Rows past M read as zero and are not written.
// N must be a multiple of 64 and K of 32 (the wrappers check). No
// double-buffering, TMA or wgmma yet: correct and simple first.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

enum Epilogue : int {
  EPI_BF16 = 0,            // bf16(acc)
  EPI_BIAS_BF16 = 1,       // bf16(acc + bias)
  EPI_BIAS_GELU_BF16 = 2,  // bf16(gelu_erf(acc + bias))
  EPI_BIAS_RESID_F32 = 3,  // f32((acc + bias) + resid)
  EPI_RELU_BF16 = 4,       // bf16(max(bf16(acc), 0))
  EPI_RESID_BF16 = 5,      // bf16(resid + bf16(acc))
};

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int LDA = BK + 8;  // bf16 elements; rows stay 16-byte aligned
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;  // f32 staging tile for the epilogue
constexpr int SMEM_AB = (BM * LDA + BK * LDB) * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM_BYTES = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;

__global__ void __launch_bounds__(THREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 const bf16* __restrict__ bias, const bf16* __restrict__ resid,
                 void* __restrict__ C, int M, int N, int K, int epi) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      const int gr = row0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gr < M) v = *reinterpret_cast<const uint4*>(A + (size_t)gr * K + k0 + cc);
      *reinterpret_cast<uint4*>(As + r * LDA + cc) = v;
    }
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + r * LDB + cc) =
          *reinterpret_cast<const uint4*>(B + (size_t)(k0 + r) * N + col0 + cc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= M) continue;
    const float v = Cs[r * LDC + c];
    const size_t o = (size_t)gr * N + gc;
    bf16* cb = reinterpret_cast<bf16*>(C);
    switch (epi) {
      case EPI_BF16:
        cb[o] = f2bf(v);
        break;
      case EPI_BIAS_BF16:
        cb[o] = f2bf(v + bf2f(bias[gc]));
        break;
      case EPI_BIAS_GELU_BF16: {
        const float u = v + bf2f(bias[gc]);
        cb[o] = f2bf(0.5f * u * (1.0f + erff(u * 0.70710678118654752f)));
        break;
      }
      case EPI_BIAS_RESID_F32:
        reinterpret_cast<float*>(C)[o] = (v + bf2f(bias[gc])) + bf2f(resid[o]);
        break;
      case EPI_RELU_BF16:
        cb[o] = f2bf(fmaxf(round_bf16(v), 0.0f));
        break;
      case EPI_RESID_BF16:
        cb[o] = f2bf(bf2f(resid[o]) + round_bf16(v));
        break;
    }
  }
}

// LayerNorm over rows of an f32 [M, H] tensor -> bf16, one warp per row,
// f32 statistics (two passes over the row, which stays in L1).
__global__ void layernorm_f32_bf16_kernel(const float* __restrict__ y,
                                          const bf16* __restrict__ gamma,
                                          const bf16* __restrict__ beta,
                                          bf16* __restrict__ out, int M, int H,
                                          float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* yr = y + (size_t)row * H;
  float s = 0.0f;
  for (int c = lane; c < H; c += 32) s += yr[c];
  const float mean = warp_sum(s) / H;
  float s2 = 0.0f;
  for (int c = lane; c < H; c += 32) {
    const float d = yr[c] - mean;
    s2 += d * d;
  }
  const float r = rsqrtf(warp_sum(s2) / H + eps);
  bf16* orow = out + (size_t)row * H;
  for (int c = lane; c < H; c += 32)
    orow[c] = f2bf((yr[c] - mean) * r * bf2f(gamma[c]) + bf2f(beta[c]));
}

}  // namespace

MMDX_EXPORT int mmdx_gemm_bf16(const void* A, const void* B, const void* bias,
                               const void* resid, void* C, int M, int N, int K,
                               int epi, void* stream) {
  if (M <= 0 || N % BN != 0 || K % BK != 0 || epi < 0 || epi > EPI_RESID_BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(B),
      static_cast<const bf16*>(bias), static_cast<const bf16*>(resid), C, M, N,
      K, epi);
  return launch_status();
}

MMDX_EXPORT int mmdx_layernorm_f32_bf16(const void* y, const void* gamma,
                                        const void* beta, void* out, int M,
                                        int H, float eps, void* stream) {
  if (M <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = 4;
  layernorm_f32_bf16_kernel<<<(M + rows_per_block - 1) / rows_per_block,
                              32 * rows_per_block, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<bf16*>(out), M, H, eps);
  return launch_status();
}
