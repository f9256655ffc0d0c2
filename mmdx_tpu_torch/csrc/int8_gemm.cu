// Int8 tensor-core GEMM with fused f32 epilogues, and the per-row int8
// quantizer of the W8A8 text blocks.
//
// Replaces mmdx_tpu/ops/pallas_int8_gemm.py (int8_gemm_requant,
// int8_gemm_res_requant, int8_gemm_dual_requant): s8 [M, K] x s8 [K, N] -> s32
// on the tensor cores, then one f32 epilogue per output element. The same
// core is the projection engine of the W8A8 BERT blocks
// (pallas_ffn.fused_ffn_ln_int8, pallas_bert_attn._kernel_int8), with
// dequantizing epilogues (per-row activation scale x per-column weight scale).
//
// Tiling: a 64x64 output tile per block of 4 warps, each warp 32x32 through
// nvcuda::wmma (mma.sync, 16x16x16 s8 fragments, s32 accumulators); K advances
// 64 at a time through shared memory with 16-byte loads. wmma wants every
// fragment pointer 32-byte aligned, and one s8 k-step is only 16 bytes, so
// shared memory holds each tile as 16-byte-wide slabs ([slab][row][16]): every
// fragment then starts on a 256-byte boundary. Rows past M and k past K read
// as zero (the ragged stage-4 M = 49 B). K must be a multiple of 16: the int8
// tower stores its weights and emits its im2col columns zero-padded to that
// (the 7x7 stem's 147 -> 160). N must be a multiple of 64. The M tiles run on
// grid.x, whose limit is 2^31 - 1 blocks: the gray stem at B = 512 has
// M = 112 * 112 * 512 = 6,422,528 rows, 100,352 tiles, past grid.y's 65,535.
//
// What bounds it: at the tower's 1x1 shapes (K = 64-2048) the arithmetic
// intensity is N*K/(N+K) ops per byte, 50-500, near the card's int8 ridge
// (~590 ops/byte), so both the int8 tensor-core rate and the bytes matter.
// The design takes the simple route first: no cp.async/TMA pipelining and no
// wgmma, so each block waits on its loads; the epilogue writes int8 (a
// quarter of the f32 bytes) and never materialises the s32 accumulator.
//
// Numerics: the epilogue is written with __fmul_rn/__fadd_rn/__fdiv_rn and
// rintf (ties to even, as jnp.round), so nvcc cannot contract a multiply-add
// into an FMA and move a rounding: the int8 outputs equal the plain PyTorch
// version's bit for bit.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

enum Int8Epilogue : int {
  // requantizing epilogues (image tower), s8 output
  I8_REQUANT = 0,      // clip(rint(relu?(acc*alpha + bias) / s_out))
  I8_RES_REQUANT = 1,  // ... ((acc*alpha + bias) + f32(res)*rs) ...
  I8_DUAL_REQUANT = 2, // ... ((acc*alpha + bias) + (acc2*alpha2 + bias2)) ...
  // dequantizing epilogues (W8A8 text blocks), sc = row_scale[r] * alpha[c]
  I8_DQ_BF16 = 3,            // bf16(acc*sc + bias)
  I8_DQ_GELU_F32 = 4,        // f32(gelu_tanh(acc*sc + bias))
  I8_DQ_BIAS_RESID_F32 = 5,  // f32((acc*sc + bias) + resid)
  I8_DQ_RESID_BIAS_F32 = 6,  // f32((resid + acc*sc) + bias)
};

constexpr int BM = 64, BN = 64, BK = 64, THREADS = 128;
constexpr int KS = 16;            // bytes of one s8 k-step, the slab width
constexpr int A_BYTES = BM * BK;  // [BK/KS][BM][KS]
constexpr int B_BYTES = BK * BN;  // [BN/KS][BK][KS]
constexpr int LDC = BN + 4;       // s32 staging tile for the epilogue
constexpr int C_BYTES = BM * LDC * 4;
constexpr int SMEM_BYTES =
    (A_BYTES + B_BYTES) > 2 * C_BYTES ? (A_BYTES + B_BYTES) : 2 * C_BYTES;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> AccFrag;

struct Int8Params {
  const int8_t* A;
  const int8_t* B;
  int K;
  const int8_t* A2;  // second product (dual epilogue) or null
  const int8_t* B2;
  int K2;
  const float* alpha;      // [N]: in_scale * w_scale, or the weight scales
  const void* bias;        // requant: f32 [N] or [bias_rows, N]; dequant: bf16 [N]
  int bias_rows;           // 0: per-column bias; P: row r reads row r % P
  const float* alpha2;     // [N]
  const float* bias2;      // [N]
  const int8_t* res;       // s8 [M, N] residual, or null
  float rs;                // its scale
  const float* row_scale;  // [M] per-row activation scales (dequant)
  const bf16* resid;       // bf16 [M, N] residual (dequant)
  float s_out;
  int relu;
  void* C;
  int M, N, epi;
};

// acc += A[row0:row0+64, :K] @ B[:K, col0:col0+64] for this block's tile.
__device__ __forceinline__ void mma_tile(const int8_t* __restrict__ A,
                                         const int8_t* __restrict__ B, int M,
                                         int N, int K, int row0, int col0,
                                         unsigned char* smem,
                                         AccFrag (&acc)[2][2]) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + A_BYTES;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * (BK / KS); c += THREADS) {
      const int r = c / (BK / KS), s = c % (BK / KS);
      const int gr = row0 + r, gk = k0 + s * KS;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gr < M && gk < K)
        v = *reinterpret_cast<const uint4*>(A + (size_t)gr * K + gk);
      *reinterpret_cast<uint4*>(As + (s * BM + r) * KS) = v;
    }
    for (int c = tid; c < BK * (BN / KS); c += THREADS) {
      const int r = c / (BN / KS), s = c % (BN / KS);
      const int gk = k0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gk < K)
        v = *reinterpret_cast<const uint4*>(B + (size_t)gk * N + col0 + s * KS);
      *reinterpret_cast<uint4*>(Bs + (s * BK + r) * KS) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / KS; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            a[i], reinterpret_cast<const signed char*>(As) + (kk * BM + wm * 32 + i * 16) * KS,
            KS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            b[j], reinterpret_cast<const signed char*>(Bs) + ((wn * 2 + j) * BK + kk * KS) * KS,
            KS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void stage(int* Cs, AccFrag (&acc)[2][2]) {
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
}

// torch/HF "gelu_new" (pallas_ffn._gelu_tanh), in its evaluation order
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float t = tanhf(__fmul_rn(0.7978845608028654f, __fadd_rn(x, x3)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, t));
}

__device__ __forceinline__ int8_t requant(float y, float s_out) {
  const float q = rintf(__fdiv_rn(y, s_out));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
}

// kDequant selects the epilogue family at compile time: the image tower's
// requantizing epilogues (K5) or the text blocks' dequantizing ones (K6, K7),
// which also tells the two uses apart in a profile.
template <bool kDequant>
__global__ void __launch_bounds__(THREADS) int8_gemm_kernel(Int8Params p) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  int* Cs = reinterpret_cast<int*>(smem);
  int* Cs2 = Cs + BM * LDC;

  AccFrag acc[2][2];
  mma_tile(p.A, p.B, p.M, p.N, p.K, row0, col0, smem, acc);
  if (!kDequant && p.epi == I8_DUAL_REQUANT) {
    AccFrag acc2[2][2];
    mma_tile(p.A2, p.B2, p.M, p.N, p.K2, row0, col0, smem, acc2);
    stage(Cs2, acc2);
  }
  stage(Cs, acc);
  __syncthreads();

  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= p.M) continue;
    const float v = __int2float_rn(Cs[r * LDC + c]);
    const size_t o = (size_t)gr * p.N + gc;
    if (!kDequant) {
      const float* bias = static_cast<const float*>(p.bias);
      const float b = p.bias_rows > 0
                          ? bias[(size_t)(gr % p.bias_rows) * p.N + gc]
                          : bias[gc];
      float y = __fadd_rn(__fmul_rn(v, p.alpha[gc]), b);
      if (p.epi == I8_RES_REQUANT)
        y = __fadd_rn(y, __fmul_rn(static_cast<float>(p.res[o]), p.rs));
      if (p.epi == I8_DUAL_REQUANT) {
        const float v2 = __int2float_rn(Cs2[r * LDC + c]);
        y = __fadd_rn(y, __fadd_rn(__fmul_rn(v2, p.alpha2[gc]), p.bias2[gc]));
      }
      if (p.relu) y = fmaxf(y, 0.0f);
      static_cast<int8_t*>(p.C)[o] = requant(y, p.s_out);
      continue;
    }
    const float sc = __fmul_rn(p.row_scale[gr], p.alpha[gc]);
    const float b = bf2f(static_cast<const bf16*>(p.bias)[gc]);
    const float y = __fmul_rn(v, sc);
    float* cf = static_cast<float*>(p.C);
    switch (p.epi) {
      case I8_DQ_BF16:
        static_cast<bf16*>(p.C)[o] = f2bf(__fadd_rn(y, b));
        break;
      case I8_DQ_GELU_F32:
        cf[o] = gelu_tanh(__fadd_rn(y, b));
        break;
      case I8_DQ_BIAS_RESID_F32:
        cf[o] = __fadd_rn(__fadd_rn(y, b), bf2f(p.resid[o]));
        break;
      case I8_DQ_RESID_BIAS_F32:
        cf[o] = __fadd_rn(__fadd_rn(bf2f(p.resid[o]), y), b);
        break;
    }
  }
}

// Per-row symmetric int8 quantization (pallas_ffn._quant_rows): one warp per
// row, s = max(amax, 1e-12) / 127, q = clip(rint(x / s), -127, 127).
template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) { return bf2f(v); }

template <typename T>
__global__ void quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                  float* __restrict__ scale, int M, int H) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + (size_t)row * H;
  float amax = 0.0f;
  for (int c = lane; c < H; c += 32) amax = fmaxf(amax, fabsf(to_f32(xr[c])));
  amax = warp_max(amax);
  const float s = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  int8_t* qr = q + (size_t)row * H;
  for (int c = lane; c < H; c += 32) qr[c] = requant(to_f32(xr[c]), s);
  if (lane == 0) scale[row] = s;
}

int launch(const Int8Params& p, void* stream) {
  if (p.M <= 0 || p.N % BN != 0 || p.K <= 0 || p.K % KS != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.epi == I8_DUAL_REQUANT && (p.K2 <= 0 || p.K2 % KS != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.M + BM - 1) / BM, p.N / BN);
  if (p.epi >= I8_DQ_BF16)
    int8_gemm_kernel<true><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  else
    int8_gemm_kernel<false><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return launch_status();
}

template <typename T>
int launch_quant_rows(const void* x, void* q, void* scale, int M, int H, void* stream) {
  if (M <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = 4;
  quant_rows_kernel<T><<<(M + rows_per_block - 1) / rows_per_block,
                         32 * rows_per_block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), M, H);
  return launch_status();
}

}  // namespace

// Image-tower form: s8 out = requant(relu?(acc*alpha + bias [+ res*rs]
// [+ acc2*alpha2 + bias2]) / s_out). res non-null selects the residual
// epilogue, A2 non-null the dual one.
MMDX_EXPORT int mmdx_int8_gemm_requant(const void* A, const void* B, const void* alpha,
                                       const void* bias, int bias_rows, const void* res,
                                       float rs, const void* A2, const void* B2,
                                       const void* alpha2, const void* bias2, int K2,
                                       float s_out, int relu, void* C, int M, int N,
                                       int K, void* stream) {
  Int8Params p{};
  p.A = static_cast<const int8_t*>(A);
  p.B = static_cast<const int8_t*>(B);
  p.K = K;
  p.A2 = static_cast<const int8_t*>(A2);
  p.B2 = static_cast<const int8_t*>(B2);
  p.K2 = K2;
  p.alpha = static_cast<const float*>(alpha);
  p.bias = bias;
  p.bias_rows = bias_rows;
  p.alpha2 = static_cast<const float*>(alpha2);
  p.bias2 = static_cast<const float*>(bias2);
  p.res = static_cast<const int8_t*>(res);
  p.rs = rs;
  p.s_out = s_out;
  p.relu = relu;
  p.C = C;
  p.M = M;
  p.N = N;
  p.epi = A2 ? I8_DUAL_REQUANT : (res ? I8_RES_REQUANT : I8_REQUANT);
  if (bias_rows < 0 || (bias_rows > 0 && p.epi != I8_REQUANT))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(p, stream);
}

// Text-block form: out = epilogue(acc * (row_scale[r] * col_scale[c]), bias,
// resid), epi = 0 bf16, 1 tanh-GELU f32, 2 (+bias)+resid f32, 3 (resid+)+bias
// f32.
MMDX_EXPORT int mmdx_int8_gemm_dequant(const void* A, const void* B,
                                       const void* row_scale, const void* col_scale,
                                       const void* bias, const void* resid, void* C,
                                       int M, int N, int K, int epi, void* stream) {
  if (epi < 0 || epi > I8_DQ_RESID_BIAS_F32 - I8_DQ_BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  Int8Params p{};
  p.A = static_cast<const int8_t*>(A);
  p.B = static_cast<const int8_t*>(B);
  p.K = K;
  p.alpha = static_cast<const float*>(col_scale);
  p.bias = bias;
  p.row_scale = static_cast<const float*>(row_scale);
  p.resid = static_cast<const bf16*>(resid);
  p.C = C;
  p.M = M;
  p.N = N;
  p.epi = I8_DQ_BF16 + epi;
  return launch(p, stream);
}

// x [M, H] bf16 or f32 -> q s8 [M, H], scale f32 [M]
MMDX_EXPORT int mmdx_quant_rows_bf16(const void* x, void* q, void* scale, int M, int H,
                                     void* stream) {
  return launch_quant_rows<bf16>(x, q, scale, M, H, stream);
}

MMDX_EXPORT int mmdx_quant_rows_f32(const void* x, void* q, void* scale, int M, int H,
                                    void* stream) {
  return launch_quant_rows<float>(x, q, scale, M, H, stream);
}
