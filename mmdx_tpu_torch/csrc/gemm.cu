// The bf16 GEMM under the fused BERT blocks (ops/bert_attn.py K1,
// ops/fused_ffn.py K2), and the LayerNorm each of those blocks ends with.
//
// Replaces the projections of mmdx_tpu/ops/pallas_bert_attn.py:_kernel and
// mmdx_tpu/ops/pallas_ffn.py:_ffn_kernel, which the TPU ran on the MXU from
// VMEM-resident weights: C[M, N] = epi(A[M, K] @ B[K, N]), A row-major bf16,
// B the flax [in, out] kernel layout (row-major [K, N]), f32 accumulation.
//
// What bounds it on the H100: at the classify rows (M = 3072, B=32 L=96)
// the four products of one layer are 44 GFLOP against ~40 MB, far above the
// card's ~295 FLOP/byte, so the tensor cores bound it (45 us at 989
// TFLOP/s); at one request's rows (M <= 384) the 14 MB of bf16 weights do
// (4 us at 3.35 TB/s), and only a grid that keeps every SM streaming its
// slab of weights comes near that.
//
// Design (sm_90a): warpgroup MMAs (wgmma.mma_async m64nBNk16, bf16 -> f32)
// fed by the Tensor Memory Accelerator. A block is BM/64 consumer
// warpgroups, each owning 64 rows of the BM x BN output tile in registers,
// and one producer warp, one thread of which issues the TMA copies of each
// K step's A tile [BM x 64] and B tile [64 x BN] (cp.async.bulk.tensor.2d,
// 128-byte swizzle) into a ring of `stages` shared-memory stages with
// full/empty mbarriers. A is read K-major; B stays in its [K, N] layout and
// is read MN-major through wgmma's transpose-B bit, so no weight is copied
// or transposed. Each consumer keeps one wgmma group in flight and frees a
// stage as soon as the group that read it retires. The epilogue stages the
// tile in shared memory over the drained ring and writes it in coalesced
// 16-byte chunks. Two blocks fit an SM (<= 96 KB of stages, <= 112
// registers a thread, the whole unified L1 as shared memory), so one
// block's fill and epilogue can overlap the other's MMAs. No setmaxnreg:
// 64 accumulators a thread fit the registers every thread gets.
//
// The tile plan (BM, BN, stages, K splits) comes from ops/gemm.py:gemm_plan:
// 128 x 128 tiles where they fill the SMs, else 64-row tiles, 64 columns
// wide if that is what fills them, and the two N = 768 products split over
// K when their tiles alone leave SMs idle. Rows past M load as zeros (TMA's out-of-bounds fill) and
// are not stored.
//
// Epilogues are template parameters, with the Pallas bodies' rounding
// points: bf16(acc + b); bf16(gelu_erf(acc + b)) with erff; f32((acc + b) +
// resid); and an f32 split-K partial [split, M, N] without bias, which the
// LayerNorm kernel below sums in split order, then adds bias and residual,
// so split-K is deterministic and needs no atomics.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"  // mbarriers, TMA, wgmma descriptors, cuTensorMapEncodeTiled

namespace {

enum Epilogue : int {
  EPI_BIAS_BF16 = 1,       // bf16(acc + bias)
  EPI_BIAS_GELU_BF16 = 2,  // bf16(gelu_erf(acc + bias))
  EPI_BIAS_RESID_F32 = 3,  // f32((acc + bias) + resid)
  EPI_PARTIAL_F32 = 4,     // f32(acc) into split blockIdx.z of [splits, M, N]
};

constexpr int BK = 64;               // one 128-byte swizzle row of bf16
constexpr int BOX = 64 * BK * 2;     // one 64 x 64 bf16 TMA box, 8 KB
constexpr size_t MAX_SMEM = 232448;  // a block's dynamic shared memory on sm_90

// B is read MN-major (wgmma_desc in hopper.cuh covers the K-major A): each
// 64-column box holds 64 K rows of 128 bytes; 8-row K groups are 1024
// bytes apart (SBO), 64-column boxes BOX bytes apart (LBO); a K step is 16
// rows. The MMAs (hopper.cuh) take it with the transpose-B bit set.
template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) wgmma_bf16_m64n64<1>(d, da, db);
  else wgmma_bf16_m64n128<1>(d, da, db);
}

// the ring of stages, or the epilogue's staging tile (f32 rows padded by
// 16 bytes) where that is larger
__host__ __device__ constexpr int ring_bytes(int bm, int bn, int stages) {
  return stages * (bm + bn) * BK * 2 > bm * (bn * 4 + 16) ? stages * (bm + bn) * BK * 2
                                                           : bm * (bn * 4 + 16);
}

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// the GEMM
// ---------------------------------------------------------------------------
// grid (N / BN, ceil(M / BM), splits); `steps` K steps of 64 per split.
// Thread t of consumer warpgroup c holds, for each 8-column group j, the
// accumulators 4j..4j+3 at rows 64c + 16(t/32) + (t%32)/4 (+8 for the last
// two) and columns 8j + 2(t%4) (+1): the wgmma m64nNk16 f32 layout.
template <int BM, int BN, int EPI>
__global__ void __launch_bounds__(BM / 64 * 128 + 32, 2)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, const bf16* __restrict__ bias,
                  const bf16* __restrict__ resid, void* __restrict__ C, int M, int N, int steps,
                  int stages) {
  constexpr int A_BYTES = BM * BK * 2, STAGE = A_BYTES + BN * BK * 2;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern is a function of the address: stages start on 1 KB
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring_bytes(BM, BN, stages));
  uint64_t* empty = full + stages;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, k0 = blockIdx.z * steps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], BM / 64);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == BM / 64) {  // the producer warp: one thread keeps the ring full
    if (t == 0) {
      int s = 0;
      unsigned phase = 0;
      for (int i = 0; i < steps; ++i) {
        mbar_wait(&empty[s], phase ^ 1);  // round 0 passes: the ring starts empty
        unsigned char* st = smem + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        const int kc = (k0 + i) * BK;
        tma_load_2d(st, &map_a, kc, m0, &full[s]);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(st + A_BYTES + c * BOX, &map_b, n0 + c * 64, kc, &full[s]);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. + 64 of the tile
  const int cw = wg;
  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.0f;
  int s = 0, prev = 0;
  unsigned phase = 0;
  for (int i = 0; i < steps; ++i) {
    mbar_wait(&full[s], phase);
    const unsigned char* a = smem + s * STAGE + cw * 64 * (BK * 2);
    const unsigned char* b = smem + s * STAGE + A_BYTES;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_tile<BN>(acc, wgmma_desc(a + kk * 32, 16, 1024),
                     wgmma_desc(b + kk * 16 * (BK * 2), BOX, 1024));
    wgmma_commit();
    fence_operands(acc);
    wgmma_wait<1>();  // the previous step's group retired: free its stage
    if (i > 0 && t == 0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // Epilogue through shared memory: the fragments, plus bias (and GELU,
  // rounded to bf16 for the bf16 outputs), go to a staging tile over the
  // drained ring, then each warpgroup writes its 64 rows in 16-byte chunks,
  // consecutive threads on consecutive chunks of a row (adding the residual
  // there). Stores straight from the fragments (8 rows x 16 bytes a warp
  // instruction) took ~40% of the kernel's time at M = 3072.
  using OutT = typename std::conditional<EPI == EPI_BIAS_BF16 || EPI == EPI_BIAS_GELU_BF16,
                                         bf16, float>::type;
  constexpr int PITCH = BN * (int)sizeof(OutT) + 16;  // bytes; the pad spreads rows over banks
  named_barrier(1, BM / 64 * 128);  // every consumer's MMAs have read the ring
  unsigned char* stage_rows = smem + cw * 64 * PITCH;
  const int frag_row = (t / 32) * 16 + (t % 32) / 4, frag_col = (t % 4) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = frag_col + j * 8;
    float b0 = 0.0f, b1 = 0.0f;
    if constexpr (EPI != EPI_PARTIAL_F32) {
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + n0 + col);
      b0 = __low2float(bb);
      b1 = __high2float(bb);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
      OutT* dst = reinterpret_cast<OutT*>(stage_rows + (frag_row + 8 * h) * PITCH) + col;
      if constexpr (EPI == EPI_BIAS_GELU_BF16) {
        v0 = gelu_erf(v0);
        v1 = gelu_erf(v1);
      }
      if constexpr (sizeof(OutT) == 2)
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    }
  }
  named_barrier(2 + cw, 128);  // this warpgroup's rows are staged
  constexpr int CHUNKS = BN * (int)sizeof(OutT) / 16;  // 16-byte chunks a row
  OutT* out = static_cast<OutT*>(C) + (EPI == EPI_PARTIAL_F32 ? (size_t)blockIdx.z * M * N : 0);
  for (int c = t; c < 64 * CHUNKS; c += 128) {
    const int r = c / CHUNKS, row = m0 + cw * 64 + r;
    if (row >= M) break;  // rows are in order: the rest lie past M too
    const int col = (c % CHUNKS) * (16 / (int)sizeof(OutT));
    uint4 v = *reinterpret_cast<const uint4*>(stage_rows + r * PITCH + (c % CHUNKS) * 16);
    const size_t o = (size_t)row * N + n0 + col;
    if constexpr (EPI == EPI_BIAS_RESID_F32) {  // (acc + b) + resid
      float rr[4];
      load4(resid + o, rr);
      float* f = reinterpret_cast<float*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] += rr[e];
    }
    *reinterpret_cast<uint4*>(out + o) = v;
  }
}

// LayerNorm over rows of f32 [M, H] -> bf16, one warp per row, f32
// statistics in two passes over the row, which stays in registers: lane l
// holds columns 4l..4l+3 of each 128-column chunk (H % 128 == 0, H <= 1024),
// so every load of a row is in flight at once. With bias != nullptr, y
// holds `splits` f32 partials [splits, M, H] of the product: the row is
// ((p_0 + p_1 + ... in split order) + bias) + resid.
constexpr int LN_MAX_CHUNKS = 8;

__global__ void layernorm_f32_bf16_kernel(const float* __restrict__ y, int splits,
                                          const bf16* __restrict__ bias,
                                          const bf16* __restrict__ resid,
                                          const bf16* __restrict__ gamma,
                                          const bf16* __restrict__ beta, bf16* __restrict__ out,
                                          int M, int H, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const int col = (threadIdx.x % 32) * 4, chunks = H / 128;
  const size_t base = (size_t)row * H + col, split_stride = (size_t)M * H;
  float v[LN_MAX_CHUNKS][4];
#pragma unroll
  for (int c = 0; c < LN_MAX_CHUNKS; ++c)
    if (c < chunks) load4(y + base + c * 128, v[c]);
  for (int p = 1; p < splits; ++p) {
#pragma unroll
    for (int c = 0; c < LN_MAX_CHUNKS; ++c) {
      if (c >= chunks) continue;
      float u[4];
      load4(y + p * split_stride + base + c * 128, u);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[c][e] += u[e];
    }
  }
  if (bias != nullptr) {
#pragma unroll
    for (int c = 0; c < LN_MAX_CHUNKS; ++c) {
      if (c >= chunks) continue;
      float b[4], r[4];
      load4(bias + col + c * 128, b);
      load4(resid + base + c * 128, r);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[c][e] = (v[c][e] + b[e]) + r[e];
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < LN_MAX_CHUNKS; ++c)
    if (c < chunks) s += (v[c][0] + v[c][1]) + (v[c][2] + v[c][3]);
  const float mean = warp_sum(s) / H;
  float s2 = 0.0f;
#pragma unroll
  for (int c = 0; c < LN_MAX_CHUNKS; ++c)
    if (c < chunks)
#pragma unroll
      for (int e = 0; e < 4; ++e) s2 += (v[c][e] - mean) * (v[c][e] - mean);
  const float rs = rsqrtf(warp_sum(s2) / H + eps);
#pragma unroll
  for (int c = 0; c < LN_MAX_CHUNKS; ++c) {
    if (c >= chunks) continue;
    float g[4], b[4];
    load4(gamma + col + c * 128, g);
    load4(beta + col + c * 128, b);
    uint2 o;
    o.x = pack_bf16((v[c][0] - mean) * rs * g[0] + b[0], (v[c][1] - mean) * rs * g[1] + b[1]);
    o.y = pack_bf16((v[c][2] - mean) * rs * g[2] + b[2], (v[c][3] - mean) * rs * g[3] + b[3]);
    *reinterpret_cast<uint2*>(out + base + c * 128) = o;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// a row-major bf16 [rows, cols] matrix read in boxes of [box_rows, 64]
// columns, 128-byte swizzle, zeros past its edges
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  return make_map_2d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rows, cols, box_rows, 64);
}

constexpr size_t smem_bytes(int bm, int bn, int stages) {
  return ring_bytes(bm, bn, stages) + 1024 + 2 * stages * sizeof(uint64_t);
}

template <int BM, int BN, int EPI>
int launch_gemm(const CUtensorMap& ma, const CUtensorMap& mb, const void* bias, const void* resid,
                void* C, int M, int N, int steps, int stages, int splits, cudaStream_t stream) {
  static size_t configured = 0;  // the dynamic shared memory the kernel may take
  const size_t smem = smem_bytes(BM, BN, stages);
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_wgmma_kernel<BM, BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    // the whole unified L1 as shared memory, so two blocks' rings fit an SM
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gemm_wgmma_kernel<BM, BN, EPI>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  gemm_wgmma_kernel<BM, BN, EPI><<<grid, BM / 64 * 128 + 32, smem, stream>>>(
      ma, mb, static_cast<const bf16*>(bias), static_cast<const bf16*>(resid), C, M, N, steps,
      stages);
  return launch_status();
}

template <int BM, int BN>
int launch_epi(int epi, const CUtensorMap& ma, const CUtensorMap& mb, const void* bias,
               const void* resid, void* C, int M, int N, int steps, int stages, int splits,
               cudaStream_t s) {
  switch (epi) {
    case EPI_BIAS_BF16:
      return launch_gemm<BM, BN, EPI_BIAS_BF16>(ma, mb, bias, resid, C, M, N, steps, stages, splits, s);
    case EPI_BIAS_GELU_BF16:
      return launch_gemm<BM, BN, EPI_BIAS_GELU_BF16>(ma, mb, bias, resid, C, M, N, steps, stages,
                                                     splits, s);
    case EPI_BIAS_RESID_F32:
      return launch_gemm<BM, BN, EPI_BIAS_RESID_F32>(ma, mb, bias, resid, C, M, N, steps, stages,
                                                     splits, s);
    default:
      return launch_gemm<BM, BN, EPI_PARTIAL_F32>(ma, mb, bias, resid, C, M, N, steps, stages,
                                                  splits, s);
  }
}

}  // namespace

// C = epi(A[M, K] @ B[K, N]) on the plan (bm, bn, stages, splits) of
// ops/gemm.py:gemm_plan. bm 64 or 128, bn 64 or 128 dividing N, K a
// multiple of 64 * splits, stages >= 2 (the ring's depth), splits > 1 only with EPI_PARTIAL_F32 (C is then
// f32 [splits, M, N]); A, B, C, bias and resid 16-byte aligned.
MMDX_EXPORT int mmdx_gemm_bf16(const void* A, const void* B, const void* bias, const void* resid,
                               void* C, int M, int N, int K, int epi, int bm, int bn, int stages,
                               int splits, void* stream) {
  if (M <= 0 || (bm != 64 && bm != 128) || (bn != 64 && bn != 128) || N <= 0 || N % bn != 0 ||
      splits < 1 || K <= 0 || K % (BK * splits) != 0 || stages < 2 ||
      smem_bytes(bm, bn, stages) > MAX_SMEM ||
      epi < EPI_BIAS_BF16 || epi > EPI_PARTIAL_F32 || (splits > 1 && epi != EPI_PARTIAL_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  if (!make_map(&ma, A, M, K, bm) || !make_map(&mb, B, K, N, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int steps = K / BK / splits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 64)
    return bn == 64 ? launch_epi<64, 64>(epi, ma, mb, bias, resid, C, M, N, steps, stages, splits, s)
                    : launch_epi<64, 128>(epi, ma, mb, bias, resid, C, M, N, steps, stages, splits, s);
  return bn == 64 ? launch_epi<128, 64>(epi, ma, mb, bias, resid, C, M, N, steps, stages, splits, s)
                  : launch_epi<128, 128>(epi, ma, mb, bias, resid, C, M, N, steps, stages, splits, s);
}

// out = bf16(LayerNorm(y)) over rows of H (a multiple of 128, at most
// 1024); y f32 [M, H], or with bias (and
// resid, both bf16) the `splits` partials [splits, M, H] of a product whose
// row is summed in split order, then plus bias, then plus resid.
MMDX_EXPORT int mmdx_layernorm_f32_bf16(const void* y, int splits, const void* bias,
                                        const void* resid, const void* gamma, const void* beta,
                                        void* out, int M, int H, float eps, void* stream) {
  if (M <= 0 || H <= 0 || H % 128 != 0 || H > 128 * LN_MAX_CHUNKS || splits < 1 ||
      (bias == nullptr && splits != 1) || ((bias == nullptr) != (resid == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = 4;
  layernorm_f32_bf16_kernel<<<(M + rows_per_block - 1) / rows_per_block, 32 * rows_per_block, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), splits, static_cast<const bf16*>(bias),
      static_cast<const bf16*>(resid), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<bf16*>(out), M, H, eps);
  return launch_status();
}
