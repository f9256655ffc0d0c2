// Int8 GEMM with fused f32 epilogues, and the per-row int8 quantizer of the
// W8A8 text blocks.
//
// Replaces mmdx_tpu/ops/pallas_int8_gemm.py (int8_gemm_requant,
// int8_gemm_res_requant, int8_gemm_dual_requant; the kernel bodies and
// _finish at :52-91): s8 A [M, K] x s8 B -> exact s32, then one f32
// epilogue per output element. The same core is the projection engine of
// the W8A8 BERT blocks (pallas_ffn._ffn_kernel_int8 :79-112,
// pallas_bert_attn._kernel_int8 :83-135), with dequantizing epilogues
// (per-row activation scale x per-column weight scale).
//
// What bounds it on the H100: the image tower's convs are tall and narrow
// (M = 12,544 B rows, N = 64-2048, K = 64-4608): at N = 64 the arithmetic
// intensity is under 64 ops per byte, far below the card's int8 ridge
// (~590 ops/byte), so their bytes bound them (the gray stem at B = 512
// moves 822 MB: 0.245 ms at 3.35 TB/s); the text projections at the
// classify rows (M = 3072) and the tower's last stage are above it, so the
// int8 tensor-core rate bounds them (2 x 3072 x 768 x 3072 ops: 7.3 us at
// 1,979 TOP/s).
//
// Design (sm_90a): warpgroup MMAs (wgmma.mma_async m64nBNk32, s8 x s8 ->
// s32) fed by the Tensor Memory Accelerator, the skeleton of csrc/gemm.cu
// (primitives in hopper.cuh). A block is BM/64 consumer warpgroups, each
// owning 64 rows of the BM x BN output tile as s32 registers, and one
// producer warp, one thread of which issues each K step's TMA copies of the
// A box [BM x 128] and the B box [BN x 128] (cp.async.bulk.tensor.2d,
// 128-byte swizzle) into a ring of `stages` stages with full/empty
// mbarriers. Both operands are K-major: wgmma has no transpose bit for
// 8-bit types, so the weights are stored [N, K] (K contiguous), laid out
// once where they are quantized or imported, and the B descriptor of each
// weight is encoded once and kept beside it (mmdx_int8_weight_map); only
// A's is encoded per call. One 128-byte swizzle row holds 128 s8 values,
// four k32 MMA steps; the descriptor advances 32 bytes per step (SBO 1024
// bytes between 8-row groups, as for bf16). K need not fill the last box:
// the tensor map's K extent is the real K, TMA fills the rest (and rows
// past M) with zeros, and k32 steps wholly past K are skipped. K must be a
// multiple of 16, TMA's 16-byte stride rule: the int8 tower stores its
// weights and emits its im2col columns zero-padded to that (the 7x7 stem's
// 147 -> 160, the gray stem's 49 -> 64). N must be a multiple of BN.
//
// The dual epilogue runs its two products as two passes over one ring:
// the producer streams the first product's K steps, then the second's, and
// the consumers accumulate them into two register tiles.
//
// Epilogue: each warpgroup stages its s32 tile in shared memory over the
// drained ring (rows padded by 16 bytes), then each thread takes 16-byte
// output chunks of a row (16 s8, 8 bf16 or 4 f32 values), consecutive
// threads on consecutive chunks: the epilogue's vectors (alpha, bias, the
// residual) are read in 16-byte loads and the output written in 16-byte
// stores. The M tiles run on grid.x, whose limit is 2^31 - 1 blocks: the
// gray stem at B = 512 has M = 6,422,528 rows, past grid.y's 65,535 tiles.
// The tile plan (BM, BN, stages) comes from ops/int8_gemm.py:int8_gemm_plan.
//
// Numerics: the s32 sums are exact in any order, and the epilogue is
// written with __fmul_rn/__fadd_rn and rintf (ties to even, as jnp.round),
// so nvcc cannot contract a multiply-add into an FMA and move a rounding;
// the requant's rint(y / s_out) takes the true division's bits at the
// price of a multiply (requant_fast): the int8 outputs equal the plain
// PyTorch version's bit for bit, and so do the dequantizing epilogues but
// tanh-GELU's (tanhf).
#include <cstring>

#include "common.cuh"
#include "hopper.cuh"  // mbarriers, TMA, wgmma descriptors, cuTensorMapEncodeTiled

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

// kernel families: the requantizing epilogues (one product, optional s8
// residual), the dual one (two products), the dequantizing ones
enum Family : int { F_REQUANT = 0, F_DUAL = 1, F_DEQUANT = 2 };

constexpr int BK = 128;              // one 128-byte swizzle row of s8: four k32 steps
constexpr size_t MAX_SMEM = 232448;  // a block's dynamic shared memory on sm_90

struct Int8Params {
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
  int M, N, K, K2, epi, stages;
};

__host__ __device__ constexpr int stage_bytes(int bm, int bn) { return (bm + bn) * BK; }
__host__ __device__ constexpr int pitch_bytes(int bn) { return bn * 4 + 16; }
// the ring of stages, or the epilogue's s32 staging tiles (one per
// product) where those are larger
__host__ __device__ constexpr int ring_bytes(int bm, int bn, int stages, int products) {
  return stages * stage_bytes(bm, bn) > products * bm * pitch_bytes(bn)
             ? stages * stage_bytes(bm, bn)
             : products * bm * pitch_bytes(bn);
}
constexpr size_t smem_bytes(int bm, int bn, int stages, int products) {
  return ring_bytes(bm, bn, stages, products) + 1024 + 2 * stages * sizeof(uint64_t);
}

// d += A (64 x 32, K-major) * B (32 x BN, K-major), s32
__device__ __forceinline__ void wgmma_s8_m64n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_m64n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) wgmma_s8_m64n64(d, da, db);
  else wgmma_s8_m64n128(d, da, db);
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

// requant(y, s_out) with inv = __frcp_rn(s_out), bit for bit, without a
// true division but near a tie. t = RN(y * RN(1/s)) lies within 3 ulps of
// y / s, and so of RN(y / s); below |t| = 256 that is under 2^-14, so rint
// can round the two apart only where t lies within 2^-12 of a
// half-integer (|t - rint(t)| > 0.5 - 2^-12, t - rint(t) exact): there the
// true division decides. At |t| >= 256 both clip to +-127 (t = inf
// included: t - rint(t) is NaN). The division's correctly rounded sequence
// cost half of the stems' time (scripts/ablate_gemm.py --int8); the slow
// branch is taken by ~1 in 2^11 values.
__device__ __forceinline__ int8_t requant_fast(float y, float s_out, float inv) {
  const float t = __fmul_rn(y, inv);
  float q = rintf(t);
  if (fabsf(__fsub_rn(t, q)) > 0.5f - 0x1p-12f) q = rintf(__fdiv_rn(y, s_out));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
}

// Thread t of a consumer warpgroup holds, for each 8-column group j, the
// accumulators 4j..4j+3 at rows 16(t/32) + (t%32)/4 (+8 for the last two)
// and columns 8j + 2(t%4) (+1): the wgmma m64nNk32 s32 layout. Stage them
// as s32 rows of pitch_bytes(BN).
template <int BN>
__device__ __forceinline__ void stage_acc(unsigned char* rows, const int (&acc)[BN / 2], int t) {
  const int frag_row = (t / 32) * 16 + (t % 32) / 4, frag_col = (t % 4) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<int2*>(rows + (frag_row + 8 * h) * pitch_bytes(BN) +
                               (frag_col + 8 * j) * 4) =
          make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

template <int N>
__device__ __forceinline__ void load_s32(const unsigned char* p, float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const int4 u = *reinterpret_cast<const int4*>(p + 16 * q);
    v[4 * q] = __int2float_rn(u.x);
    v[4 * q + 1] = __int2float_rn(u.y);
    v[4 * q + 2] = __int2float_rn(u.z);
    v[4 * q + 3] = __int2float_rn(u.w);
  }
}
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 u = *reinterpret_cast<const float4*>(p + 4 * q);
    v[4 * q] = u.x;
    v[4 * q + 1] = u.y;
    v[4 * q + 2] = u.z;
    v[4 * q + 3] = u.w;
  }
}

// The epilogue of one consumer warpgroup over its 64 staged rows
// (row0 = the first), in 16-byte output chunks.
template <int BN, int FAMILY>
__device__ __forceinline__ void epilogue(const Int8Params& p, const unsigned char* rows,
                                         const unsigned char* rows2, int row0, int n0, int t) {
  constexpr int PITCH = pitch_bytes(BN);
  if constexpr (FAMILY != F_DEQUANT) {
    constexpr int CH = BN / 16;  // 16 s8 outputs a chunk
    const float* bias = static_cast<const float*>(p.bias);
    const float inv = __frcp_rn(p.s_out);
    for (int c = t; c < 64 * CH; c += 128) {
      const int r = c / CH, row = row0 + r;
      if (row >= p.M) break;  // rows are in order: the rest lie past M too
      const int col = (c % CH) * 16, gc = n0 + col;
      const size_t o = (size_t)row * p.N + gc;
      float v[16], a[16], b[16], y[16];
      load_s32(rows + r * PITCH + col * 4, v);
      load_f32(p.alpha + gc, a);
      load_f32(bias + (p.bias_rows > 0 ? (size_t)(row % p.bias_rows) * p.N : 0) + gc, b);
#pragma unroll
      for (int e = 0; e < 16; ++e) y[e] = __fadd_rn(__fmul_rn(v[e], a[e]), b[e]);
      if (p.res != nullptr) {
        const uint4 rr = *reinterpret_cast<const uint4*>(p.res + o);
        const int8_t* rv = reinterpret_cast<const int8_t*>(&rr);
#pragma unroll
        for (int e = 0; e < 16; ++e)
          y[e] = __fadd_rn(y[e], __fmul_rn(static_cast<float>(rv[e]), p.rs));
      }
      if constexpr (FAMILY == F_DUAL) {
        load_s32(rows2 + r * PITCH + col * 4, v);
        load_f32(p.alpha2 + gc, a);
        load_f32(p.bias2 + gc, b);
#pragma unroll
        for (int e = 0; e < 16; ++e) y[e] = __fadd_rn(y[e], __fadd_rn(__fmul_rn(v[e], a[e]), b[e]));
      }
      uint4 out;
      int8_t* ov = reinterpret_cast<int8_t*>(&out);
#pragma unroll
      for (int e = 0; e < 16; ++e)
        ov[e] = requant_fast(p.relu ? fmaxf(y[e], 0.0f) : y[e], p.s_out, inv);
      *reinterpret_cast<uint4*>(static_cast<int8_t*>(p.C) + o) = out;
    }
  } else if (p.epi == I8_DQ_BF16) {
    constexpr int CH = BN / 8;  // 8 bf16 outputs a chunk
    const bf16* bias = static_cast<const bf16*>(p.bias);
    for (int c = t; c < 64 * CH; c += 128) {
      const int r = c / CH, row = row0 + r;
      if (row >= p.M) break;
      const int col = (c % CH) * 8, gc = n0 + col;
      float v[8], a[8], b[8];
      load_s32(rows + r * PITCH + col * 4, v);
      load_f32(p.alpha + gc, a);
      load8(bias + gc, b);
      const float rsc = p.row_scale[row];
      uint4 out;
      bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int e = 0; e < 8; ++e) ov[e] = f2bf(__fadd_rn(__fmul_rn(v[e], __fmul_rn(rsc, a[e])), b[e]));
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.C) + (size_t)row * p.N + gc) = out;
    }
  } else {
    constexpr int CH = BN / 4;  // 4 f32 outputs a chunk
    const bf16* bias = static_cast<const bf16*>(p.bias);
    for (int c = t; c < 64 * CH; c += 128) {
      const int r = c / CH, row = row0 + r;
      if (row >= p.M) break;
      const int col = (c % CH) * 4, gc = n0 + col;
      const size_t o = (size_t)row * p.N + gc;
      float v[4], a[4], b[4], rr[4] = {0.0f, 0.0f, 0.0f, 0.0f}, y[4];
      load_s32(rows + r * PITCH + col * 4, v);
      load_f32(p.alpha + gc, a);
      load4(bias + gc, b);
      if (p.epi != I8_DQ_GELU_F32) load4(p.resid + o, rr);
      const float rsc = p.row_scale[row];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float u = __fmul_rn(v[e], __fmul_rn(rsc, a[e]));
        y[e] = p.epi == I8_DQ_GELU_F32        ? gelu_tanh(__fadd_rn(u, b[e]))
               : p.epi == I8_DQ_BIAS_RESID_F32 ? __fadd_rn(__fadd_rn(u, b[e]), rr[e])
                                               : __fadd_rn(__fadd_rn(rr[e], u), b[e]);
      }
      *reinterpret_cast<float4*>(static_cast<float*>(p.C) + o) = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

// grid (ceil(M / BM), N / BN); ceil(K / 128) K steps (+ ceil(K2 / 128) for
// the dual product's second pass)
template <int BM, int BN, int FAMILY>
__device__ __forceinline__ void int8_gemm_body(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                               const CUtensorMap* map_a2,
                                               const CUtensorMap* map_b2, const Int8Params& p) {
  constexpr bool kDual = FAMILY == F_DUAL;
  constexpr int A_BYTES = BM * BK, STAGE = stage_bytes(BM, BN), PITCH = pitch_bytes(BN);
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern is a function of the address: stages start on 1 KB
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stages = p.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring_bytes(BM, BN, stages, kDual ? 2 : 1));
  uint64_t* empty = full + stages;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int steps1 = (p.K + BK - 1) / BK;
  const int steps = steps1 + (kDual ? (p.K2 + BK - 1) / BK : 0);

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
        const bool second = kDual && i >= steps1;
        const int kc = (second ? i - steps1 : i) * BK;
        tma_load_2d(st, second ? map_a2 : map_a, kc, m0, &full[s]);
        tma_load_2d(st + A_BYTES, second ? map_b2 : map_b, kc, n0, &full[s]);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. + 64 of the tile
  int acc[BN / 2], acc2[kDual ? BN / 2 : 1];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0;
#pragma unroll
  for (int e = 0; e < (kDual ? BN / 2 : 1); ++e) acc2[e] = 0;
  int s = 0, prev = 0;
  unsigned phase = 0;
  for (int i = 0; i < steps; ++i) {
    mbar_wait(&full[s], phase);
    const unsigned char* a = smem + s * STAGE + wg * 64 * BK;
    const unsigned char* b = smem + s * STAGE + A_BYTES;
    const bool second = kDual && i >= steps1;
    const int kc = (second ? i - steps1 : i) * BK;
    // the k32 steps that hold real K (the rest of the box is TMA's zeros)
    const int kslices = min(BK / 32, ((second ? p.K2 : p.K) - kc + 31) / 32);
    fence_operands(acc);
    if constexpr (kDual) fence_operands(acc2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      if (kk < kslices) {
        const uint64_t da = wgmma_desc(a + kk * 32, 16, 1024);
        const uint64_t db = wgmma_desc(b + kk * 32, 16, 1024);
        if constexpr (kDual) {
          if (second) wgmma_s8<BN>(acc2, da, db);
          else wgmma_s8<BN>(acc, da, db);
        } else {
          wgmma_s8<BN>(acc, da, db);
        }
      }
    }
    wgmma_commit();
    fence_operands(acc);
    if constexpr (kDual) fence_operands(acc2);
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
  if constexpr (kDual) fence_operands(acc2);

  named_barrier(1, BM / 64 * 128);  // every consumer's MMAs have read the ring
  unsigned char* rows = smem + wg * 64 * PITCH;
  unsigned char* rows2 = smem + BM * PITCH + wg * 64 * PITCH;
  stage_acc<BN>(rows, acc, t);
  if constexpr (kDual) stage_acc<BN>(rows2, acc2, t);
  named_barrier(2 + wg, 128);  // this warpgroup's rows are staged
  epilogue<BN, FAMILY>(p, rows, rows2, m0 + wg * 64, n0, t);
}

// kDual selects the two-product epilogue; the kernel names tell the image
// tower's requantizing GEMM (K5) from the text blocks' dequantizing one
// (K6, K7) in a profile.
template <int BM, int BN, bool kDual>
__global__ void __launch_bounds__(BM / 64 * 128 + 32, 2)
int8_gemm_requant_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b,
                         const __grid_constant__ CUtensorMap map_a2,
                         const __grid_constant__ CUtensorMap map_b2, const Int8Params p) {
  int8_gemm_body<BM, BN, kDual ? F_DUAL : F_REQUANT>(&map_a, &map_b, &map_a2, &map_b2, p);
}

template <int BM, int BN>
__global__ void __launch_bounds__(BM / 64 * 128 + 32, 2)
int8_gemm_dequant_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b, const Int8Params p) {
  int8_gemm_body<BM, BN, F_DEQUANT>(&map_a, &map_b, nullptr, nullptr, p);
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <int BM, int BN, int FAMILY>
int launch_tile(const CUtensorMap& ma, const CUtensorMap& mb, const CUtensorMap& ma2,
                const CUtensorMap& mb2, const Int8Params& p, cudaStream_t stream) {
  static size_t configured = 0;  // the dynamic shared memory the kernel may take
  const size_t smem = smem_bytes(BM, BN, p.stages, FAMILY == F_DUAL ? 2 : 1);
  if (smem > configured) {
    cudaError_t err;
    if constexpr (FAMILY == F_DEQUANT) {
      err = cudaFuncSetAttribute(int8_gemm_dequant_kernel<BM, BN>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      // the whole unified L1 as shared memory, so two blocks' rings fit an SM
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(int8_gemm_dequant_kernel<BM, BN>,
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    } else {
      err = cudaFuncSetAttribute(int8_gemm_requant_kernel<BM, BN, FAMILY == F_DUAL>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(int8_gemm_requant_kernel<BM, BN, FAMILY == F_DUAL>,
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const dim3 grid((p.M + BM - 1) / BM, p.N / BN);
  const int threads = BM / 64 * 128 + 32;
  if constexpr (FAMILY == F_DEQUANT)
    int8_gemm_dequant_kernel<BM, BN><<<grid, threads, smem, stream>>>(ma, mb, p);
  else
    int8_gemm_requant_kernel<BM, BN, FAMILY == F_DUAL><<<grid, threads, smem, stream>>>(
        ma, mb, ma2, mb2, p);
  return launch_status();
}

template <int FAMILY>
int launch_plan(int bm, int bn, const CUtensorMap& ma, const CUtensorMap& mb,
                const CUtensorMap& ma2, const CUtensorMap& mb2, const Int8Params& p,
                cudaStream_t s) {
  if constexpr (FAMILY == F_DUAL) {  // two s32 tiles: 64 columns keep them in registers
    return bm == 64 ? launch_tile<64, 64, F_DUAL>(ma, mb, ma2, mb2, p, s)
                    : launch_tile<128, 64, F_DUAL>(ma, mb, ma2, mb2, p, s);
  } else if (bm == 64) {
    return bn == 64 ? launch_tile<64, 64, FAMILY>(ma, mb, ma2, mb2, p, s)
                    : launch_tile<64, 128, FAMILY>(ma, mb, ma2, mb2, p, s);
  } else {
    return bn == 64 ? launch_tile<128, 64, FAMILY>(ma, mb, ma2, mb2, p, s)
                    : launch_tile<128, 128, FAMILY>(ma, mb, ma2, mb2, p, s);
  }
}

// the plan (bm, bn, stages) of ops/int8_gemm.py:int8_gemm_plan on an
// [M, K] x [N, K] product
bool plan_ok(int M, int N, int K, int bm, int bn, int stages, int products) {
  return M > 0 && N > 0 && K > 0 && K % 16 == 0 && (bm == 64 || bm == 128) &&
         (bn == 64 || bn == 128) && N % bn == 0 && stages >= 2 &&
         smem_bytes(bm, bn, stages, products) <= MAX_SMEM;
}

// an s8 row-major [rows, K] operand in boxes of [box_rows, 128]
bool s8_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  return make_map_2d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows, K, box_rows, BK);
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

// The B operand's TMA descriptor: a K-major s8 weight [N, K] (K a multiple
// of 16, 16-byte aligned) read in boxes of [bn rows, 128], written to `map`
// (a CUtensorMap, 128 bytes), which the caller keeps beside the weight and
// passes to every launch whose plan has this bn.
MMDX_EXPORT int mmdx_int8_weight_map(const void* B, int N, int K, int bn, void* map) {
  if (N <= 0 || K <= 0 || K % 16 != 0 || (bn != 64 && bn != 128) || N % bn != 0 ||
      map == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m;
  if (!s8_map(&m, B, N, K, bn)) return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(map, &m, sizeof m);
  return 0;
}

// Image-tower form: s8 out = requant(relu?(acc*alpha + bias [+ res*rs]
// [+ acc2*alpha2 + bias2]) / s_out), acc = A [M, K] @ B^T for the weight
// [N, K] whose descriptor is map_b. res non-null selects the residual
// epilogue, A2 (with map_b2, K2) the dual one.
MMDX_EXPORT int mmdx_int8_gemm_requant(const void* A, const void* map_b, const void* alpha,
                                       const void* bias, int bias_rows, const void* res,
                                       float rs, const void* A2, const void* map_b2,
                                       const void* alpha2, const void* bias2, int K2,
                                       float s_out, int relu, void* C, int M, int N, int K,
                                       int bm, int bn, int stages, void* stream) {
  Int8Params p{};
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
  p.K = K;
  p.K2 = K2;
  p.stages = stages;
  p.epi = A2 ? I8_DUAL_REQUANT : (res ? I8_RES_REQUANT : I8_REQUANT);
  const int products = A2 ? 2 : 1;
  // requant_fast takes a normal positive output scale (its reciprocal finite)
  if (!(s_out >= 1.17549435e-38f) || bias_rows < 0 || (bias_rows > 0 && p.epi != I8_REQUANT) || map_b == nullptr ||
      !plan_ok(M, N, K, bm, bn, stages, products) ||
      (A2 && (K2 <= 0 || K2 % 16 != 0 || bn != 64 || map_b2 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb, ma2, mb2;
  if (!s8_map(&ma, A, M, K, bm)) return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(&mb, map_b, sizeof mb);
  ma2 = ma;
  mb2 = mb;
  if (A2) {
    if (!s8_map(&ma2, A2, M, K2, bm)) return static_cast<int>(cudaErrorInvalidValue);
    std::memcpy(&mb2, map_b2, sizeof mb2);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return A2 ? launch_plan<F_DUAL>(bm, bn, ma, mb, ma2, mb2, p, s)
            : launch_plan<F_REQUANT>(bm, bn, ma, mb, ma2, mb2, p, s);
}

// Text-block form: out = epilogue(acc * (row_scale[r] * col_scale[c]), bias,
// resid), epi = 0 bf16, 1 tanh-GELU f32, 2 (+bias)+resid f32, 3 (resid+)+bias
// f32; acc = A [M, K] @ B^T for the weight [N, K] whose descriptor is map_b.
MMDX_EXPORT int mmdx_int8_gemm_dequant(const void* A, const void* map_b,
                                       const void* row_scale, const void* col_scale,
                                       const void* bias, const void* resid, void* C,
                                       int M, int N, int K, int epi, int bm, int bn,
                                       int stages, void* stream) {
  if (epi < 0 || epi > I8_DQ_RESID_BIAS_F32 - I8_DQ_BF16 || map_b == nullptr ||
      !plan_ok(M, N, K, bm, bn, stages, 1) ||
      (resid == nullptr && epi + I8_DQ_BF16 >= I8_DQ_BIAS_RESID_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  Int8Params p{};
  p.alpha = static_cast<const float*>(col_scale);
  p.bias = bias;
  p.row_scale = static_cast<const float*>(row_scale);
  p.resid = static_cast<const bf16*>(resid);
  p.C = C;
  p.M = M;
  p.N = N;
  p.K = K;
  p.stages = stages;
  p.epi = I8_DQ_BF16 + epi;
  CUtensorMap ma, mb;
  if (!s8_map(&ma, A, M, K, bm)) return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(&mb, map_b, sizeof mb);
  return launch_plan<F_DEQUANT>(bm, bn, ma, mb, ma, mb, p, static_cast<cudaStream_t>(stream));
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
