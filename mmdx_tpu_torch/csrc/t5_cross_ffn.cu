// The T5 decoder's cross-attention + FFN half step (ops/t5_step.py) as ONE
// launch a layer. Replaces mmdx_tpu/ops/pallas_t5_step.py:cross_ffn_block:
//   y   = RMSNorm(hidden; cross_ln)          q = bf16(y . Wq)
//   p   = bf16(softmax_k(q_h . ck[n, k, h] + enc_bias[n, k]))   (no 1/sqrt(d))
//   ctx = bf16(sum_k p . cv[n, k, h])         x = bf16(hidden + bf16(ctx . Wo_c))
//   y2  = RMSNorm(x; ffn_ln)                  hmid = max(bf16(y2 . Wi), 0)
//   out = bf16(x + bf16(hmid . Wo_f))
// with the rounding points of the plain version (ops/t5_step.py); RMSNorm
// keeps T5's quirk: f32 mean of squares, the normalised value rounded to
// bf16 BEFORE the f32 scale multiply, the product rounded again.
//
// What bounds it on the H100: latency. At N = B*nb = 4-128 rows a layer
// reads 5.2 MB of bf16 weights (1.6 us at 3.35 TB/s) for 2.6 GFLOP at most
// (N = 128), so a design must stream the weights with the whole card and
// pay few serial steps. The TPU kernel runs the chain as one program with
// every intermediate in VMEM; a GEMM per launch would give each product
// only 8-32 blocks of 64 columns, and seven launches a layer.
//
// Design: a persistent cooperative kernel, one block of 8 warps per SM,
// nine phases separated by eight grid barriers (cooperative_groups
// grid.sync, about 1 us each on 132 SMs; launched with
// cudaLaunchAttributeCooperative, which also captures into a CUDA graph):
//   0  y = RMSNorm(hidden)   E  hmid partials of y . Wi
//   A  q partials of y . Wq  F  hmid = relu(bf16(sum))
//   B  q, attention          G  out partials of hmid . Wo_f
//   C  x partials            H  out = bf16(x + bf16(sum))
//   D  x, y = RMSNorm(x)
// Each product is cut into (64-column tile x K-split) work items, at most
// one per block, so every SM streams a share of the layer's weights
// (wq and wo_c 8 tiles x 16 splits of 32, wi 32 x 4 of 128, wo_f 8 x 16 of
// 128 on 132 SMs; the wrapper chooses the splits, ops/t5_step.split_counts).
// At entry every block issues cp.async copies of ALL of its weight tiles,
// one commit group per product, so the weights land while the first
// phases run; a phase waits only for its own group. An item stages its
// A slice (all rows, its K range; rows past N zero) in shared memory with
// every load in flight at once, and runs the tile products on the tensor
// cores (mma.sync m16n8k16 bf16, f32 accumulators, fragments by ldmatrix).
// Split-K is deterministic: each split writes its f32 partial to a
// workspace [splits, N, cols], and the next phase adds the partials in
// split order before the rounding point, so outputs do not change from run
// to run. The RMSNorms (phases 0 and D) run one block per row, the
// attention over the row's own K keys one warp per (row, head) inside the
// phase that reduces q. Every phase issues its loads before it uses them,
// so it waits about one L2 round trip; phase 0 also prefetches the cross
// K/V rows and the encoder bias into L2 for phase B. Data written by another block is read
// through L2 (ld.cg).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int TILE_N = 64;          // output columns of one work item
constexpr int LDW = TILE_N + 8;     // 144-byte smem rows: 8 ldmatrix rows hit distinct banks
constexpr int ROW_BLOCK = 128;      // rows of an A slice staged at once
constexpr int HEAD_DIM = 64;
constexpr int MAX_KEYS = 16;
constexpr int MAX_SPLITS = 16;      // K-splits of a product (ops/t5_step.SPLIT_CAP)
constexpr int STAGE_LOADS = 8;      // 16-byte loads a thread has in flight while staging

struct Gemm {
  const bf16* w;  // [K, cols] row-major (the flax [in, out] kernel layout)
  int K, cols, splits;
  int smem;       // element offset of this product's weight tile in shared memory
};

struct Params {
  const bf16* hidden;
  const float* cross_ln;
  const bf16* ck;
  const bf16* cv;
  const float* enc_bias;
  const float* ffn_ln;
  Gemm g[4];  // wq, wo_c, wi, wo_f
  bf16* y;    // [N, D] scratch: RMSNorm(hidden), then RMSNorm(x)
  bf16* ctx;  // [N, D] scratch
  bf16* x;    // [N, D] scratch
  bf16* hmid; // [N, F] scratch
  bf16* out;  // [N, D]
  float* ws;  // [splits, N, cols] f32 partials, reused by every product
  int N, D, F, KK, heads;
  float eps;
  int stage;  // element offset of the A-slice stage in shared memory
  int lda_s;  // its row stride (elements)
};

// split s of S covers K rows [lo(s), lo(s + 1)), multiples of 16, uneven
// by at most 16 (ops/t5_step.split_bounds)
__device__ __forceinline__ int split_lo(int K, int S, int s) { return 16 * (s * (K / 16) / S); }

// this block's work item of product g, or false: (column tile, split)
__device__ __forceinline__ bool item(const Gemm& g, int& tile, int& split) {
  const int tiles = g.cols / TILE_N;
  const int b = blockIdx.x;
  if (b >= tiles * g.splits) return false;
  tile = b % tiles;
  split = b / tiles;
  return true;
}

// every block's weight tiles, one commit group per product (empty groups
// too, so the group counts are the same in every thread)
__device__ void prefetch_weights(const Params& p, bf16* smem) {
  for (int gi = 0; gi < 4; ++gi) {
    const Gemm& g = p.g[gi];
    int tile, split;
    if (item(g, tile, split)) {
      const int lo = split_lo(g.K, g.splits, split);
      const int rows = split_lo(g.K, g.splits, split + 1) - lo;
      bf16* dst = smem + g.smem;
      const bf16* src = g.w + (size_t)lo * g.cols + tile * TILE_N;
      for (int c = threadIdx.x; c < rows * (TILE_N / 8); c += THREADS) {
        const int r = c / (TILE_N / 8), u = (c % (TILE_N / 8)) * 8;
        cp_async16(dst + r * LDW + u, src + (size_t)r * g.cols + u);
      }
    }
    cp_async_commit();
  }
}

// The block's item of product g: the f32 partial A[:, lo:hi] . W[lo:hi,
// tile] over all N rows into ws[split]. Rows go ROW_BLOCK at a time: the
// A slice is staged in shared memory, then warp w owns the tile's columns
// 16(w%4) .. +15 (two n8 tiles) and the 16-row tiles w/4, w/4 + 2, ...
__device__ void gemm_item(const Params& p, const Gemm& g, const bf16* A, const bf16* w_tile,
                          bf16* stage) {
  int tile, split;
  if (!item(g, tile, split)) return;
  const int lo = split_lo(g.K, g.splits, split);
  const int nks = (split_lo(g.K, g.splits, split + 1) - lo) / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cw = warp % 4, quad = lane / 4, t = lane % 4, mi = lane / 8;
  const int ppr = 2 * nks;  // 16-byte pieces of a staged row
  for (int rb = 0; rb < p.N; rb += ROW_BLOCK) {
    const int rtiles = (min(ROW_BLOCK, p.N - rb) + 15) / 16;
    const int total = rtiles * 16 * ppr;
    for (int e0 = threadIdx.x; e0 < total; e0 += THREADS * STAGE_LOADS) {
      uint4 v[STAGE_LOADS];
#pragma unroll
      for (int j = 0; j < STAGE_LOADS; ++j) {
        const int e = e0 + j * THREADS, r = rb + e / ppr;
        v[j] = make_uint4(0u, 0u, 0u, 0u);
        if (e < total && r < p.N)
          v[j] = __ldcg(reinterpret_cast<const uint4*>(A + (size_t)r * g.K + lo + (e % ppr) * 8));
      }
#pragma unroll
      for (int j = 0; j < STAGE_LOADS; ++j) {
        const int e = e0 + j * THREADS;
        if (e < total) *reinterpret_cast<uint4*>(stage + (e / ppr) * p.lda_s + (e % ppr) * 8) = v[j];
      }
    }
    __syncthreads();
    for (int rt = warp / 4; rt < rtiles; rt += WARPS / 4) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int ks = 0; ks < nks; ++ks) {
        unsigned af[4], bfr[4];
        ldsm_x4(af, stage + (rt * 16 + lane % 16) * p.lda_s + ks * 16 + (lane / 16) * 8);
        ldsm_x4_trans(bfr, w_tile + (ks * 16 + (mi & 1) * 8 + lane % 8) * LDW +
                               (2 * cw + (mi >> 1)) * 8);
        mma_bf16(acc[0], af, bfr[0], bfr[1]);
        mma_bf16(acc[1], af, bfr[2], bfr[3]);
      }
      const int r0 = rb + rt * 16 + quad, r1 = r0 + 8;
      float* dst = p.ws + (size_t)split * p.N * g.cols + tile * TILE_N + cw * 16 + 2 * t;
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        if (r0 < p.N)
          *reinterpret_cast<float2*>(dst + (size_t)r0 * g.cols + jn * 8) =
              make_float2(acc[jn][0], acc[jn][1]);
        if (r1 < p.N)
          *reinterpret_cast<float2*>(dst + (size_t)r1 * g.cols + jn * 8) =
              make_float2(acc[jn][2], acc[jn][3]);
      }
    }
    __syncthreads();  // the stage is refilled by the next row block
  }
}

// the split partials of two adjacent columns (r, c), c even: all loaded
// at once, then added in split order
__device__ __forceinline__ float2 sum_pair(const float* ws, int S, int N, int cols, int r, int c) {
  float2 v[MAX_SPLITS];
#pragma unroll
  for (int s = 0; s < MAX_SPLITS; ++s)
    if (s < S) v[s] = __ldcg(reinterpret_cast<const float2*>(ws + ((size_t)s * N + r) * cols + c));
  float2 a = make_float2(0.f, 0.f);
#pragma unroll
  for (int s = 0; s < MAX_SPLITS; ++s)
    if (s < S) {
      a.x += v[s].x;
      a.y += v[s].y;
    }
  return a;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}
__device__ __forceinline__ float2 bf2_load(const bf16* p) {
  return __bfloat1622float2(__ldcg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ void bf2_store(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the block's sum of v (every thread calls it), the warps' sums added in
// warp order
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += red[w];
  __syncthreads();
  return t;
}

// y[r] = RMSNorm(src[r]; ln) for the block's rows, one block per row: T5's
// quirk, the normalised value rounded to bf16 before the f32 scale. With
// ws, src = x is made first: x = bf16(hidden + bf16(sum of the partials)).
__device__ void rms_rows(const Params& p, const bf16* src, const float* ln, float* red,
                         const float* ws, int splits) {
  const int D = p.D;
  for (int r = blockIdx.x; r < p.N; r += gridDim.x) {
    float ss = 0.0f;
    for (int c = 2 * threadIdx.x; c < D; c += 2 * THREADS) {
      float2 v = bf2_load(src + (size_t)r * D + c);
      if (ws != nullptr) {
        const float2 a = sum_pair(ws, splits, p.N, D, r, c);
        v = make_float2(round_bf16(v.x + round_bf16(a.x)), round_bf16(v.y + round_bf16(a.y)));
        bf2_store(p.x + (size_t)r * D + c, v.x, v.y);
      }
      ss += v.x * v.x + v.y * v.y;
    }
    const float ri = rsqrtf(block_sum(ss, red) / D + p.eps);
    for (int c = 2 * threadIdx.x; c < D; c += 2 * THREADS) {  // this thread's own values
      const float2 v = bf2_load((ws != nullptr ? p.x : src) + (size_t)r * D + c);
      bf2_store(p.y + (size_t)r * D + c, ln[c] * round_bf16(v.x * ri),
                ln[c + 1] * round_bf16(v.y * ri));
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) t5_cross_ffn_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[WARPS];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* stage = smem + p.stage;
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x % 32;
  const int gwarp = blockIdx.x * WARPS + threadIdx.x / 32, nwarps = gridDim.x * WARPS;
  const int gtid = blockIdx.x * THREADS + threadIdx.x, nthreads = gridDim.x * THREADS;
  const int D = p.D;

  prefetch_weights(p, smem);

  // 0: y = RMSNorm(hidden); the cross K/V rows and the encoder bias into
  // L2 for phase B
  const size_t kv_lines = ((size_t)p.N * p.KK * D * sizeof(bf16) + 127) / 128;
  const size_t bias_lines = ((size_t)p.N * p.KK * sizeof(float) + 127) / 128;
  for (size_t l = gtid; l < kv_lines; l += nthreads) {
    prefetch_l2(reinterpret_cast<const char*>(p.ck) + 128 * l);
    prefetch_l2(reinterpret_cast<const char*>(p.cv) + 128 * l);
  }
  for (size_t l = gtid; l < bias_lines; l += nthreads)
    prefetch_l2(reinterpret_cast<const char*>(p.enc_bias) + 128 * l);
  rms_rows(p, p.hidden, p.cross_ln, red, nullptr, 0);
  grid.sync();

  // A: q partials of y . Wq
  cp_async_wait<3>();
  __syncthreads();
  gemm_item(p, p.g[0], p.y, smem + p.g[0].smem, stage);
  grid.sync();

  // B: q = bf16(sum of partials), then one warp per (row, head): softmax
  // over the row's own K keys, p and ctx rounded to bf16
  for (int wi = gwarp; wi < p.N * p.heads; wi += nwarps) {
    const int r = wi / p.heads, h = wi % p.heads;
    const int c = h * HEAD_DIM + 2 * lane;
    float2 kr[MAX_KEYS], vr[MAX_KEYS];
    float bias[MAX_KEYS];
#pragma unroll
    for (int k = 0; k < MAX_KEYS; ++k)
      if (k < p.KK) {
        kr[k] = bf2_load(p.ck + ((size_t)r * p.KK + k) * D + c);
        vr[k] = bf2_load(p.cv + ((size_t)r * p.KK + k) * D + c);
        bias[k] = p.enc_bias[(size_t)r * p.KK + k];
      }
    const float2 qa = sum_pair(p.ws, p.g[0].splits, p.N, D, r, c);
    const float q0 = round_bf16(qa.x), q1 = round_bf16(qa.y);
    float s[MAX_KEYS];
    float mx = -3.0e38f;
#pragma unroll
    for (int k = 0; k < MAX_KEYS; ++k)
      if (k < p.KK) {
        s[k] = warp_sum(q0 * kr[k].x + q1 * kr[k].y) + bias[k];
        mx = fmaxf(mx, s[k]);
      }
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < MAX_KEYS; ++k)
      if (k < p.KK) {
        s[k] = expf(s[k] - mx);
        sum += s[k];
      }
    float c0 = 0.0f, c1 = 0.0f;
#pragma unroll
    for (int k = 0; k < MAX_KEYS; ++k)
      if (k < p.KK) {
        const float pk = round_bf16(s[k] / sum);
        c0 += pk * vr[k].x;
        c1 += pk * vr[k].y;
      }
    bf2_store(p.ctx + (size_t)r * D + c, c0, c1);
  }
  grid.sync();

  // C: x partials of ctx . Wo_c
  cp_async_wait<2>();
  __syncthreads();
  gemm_item(p, p.g[1], p.ctx, smem + p.g[1].smem, stage);
  grid.sync();

  // D: x = bf16(hidden + bf16(sum)), y = RMSNorm(x)
  rms_rows(p, p.hidden, p.ffn_ln, red, p.ws, p.g[1].splits);
  grid.sync();

  // E: hmid partials of y . Wi
  cp_async_wait<1>();
  __syncthreads();
  gemm_item(p, p.g[2], p.y, smem + p.g[2].smem, stage);
  grid.sync();

  // F: hmid = max(bf16(sum), 0)
  for (int e = gtid; e < p.N * p.F / 2; e += nthreads) {
    const int r = e / (p.F / 2), c = 2 * (e % (p.F / 2));
    const float2 a = sum_pair(p.ws, p.g[2].splits, p.N, p.F, r, c);
    bf2_store(p.hmid + (size_t)r * p.F + c, fmaxf(round_bf16(a.x), 0.0f),
              fmaxf(round_bf16(a.y), 0.0f));
  }
  grid.sync();

  // G: out partials of hmid . Wo_f
  cp_async_wait<0>();
  __syncthreads();
  gemm_item(p, p.g[3], p.hmid, smem + p.g[3].smem, stage);
  grid.sync();

  // H: out = bf16(x + bf16(sum))
  for (int e = gtid; e < p.N * D / 2; e += nthreads) {
    const int r = e / (D / 2), c = 2 * (e % (D / 2));
    const float2 x = bf2_load(p.x + (size_t)r * D + c);
    const float2 a = sum_pair(p.ws, p.g[3].splits, p.N, D, r, c);
    bf2_store(p.out + (size_t)r * D + c, x.x + round_bf16(a.x), x.y + round_bf16(a.y));
  }
}

}  // namespace

// hidden [N, D] bf16; cross_ln, ffn_ln [D] f32; wq, wo_c [D, D], wi [D, F],
// wo_f [F, D] bf16; ck, cv [N, KK, D] bf16; enc_bias [N, KK] f32 -> out
// [N, D] bf16. scratch: y, ctx, x [N, D] and hmid [N, F] bf16; ws f32 of
// at least max(sq*D, so*D, si*F, sf*D) * N floats. blocks: the grid, every
// block co-resident (the cooperative launch fails otherwise); sq, so, si,
// sf: the K-splits of the four products, at most one item per block.
MMDX_EXPORT int mmdx_t5_cross_ffn(const void* hidden, const void* cross_ln, const void* wq,
                                  const void* wo_c, const void* ck, const void* cv,
                                  const void* enc_bias, const void* ffn_ln, const void* wi,
                                  const void* wo_f, void* y, void* ctx, void* x, void* hmid,
                                  void* out, void* ws, int N, int D, int F, int KK, int heads,
                                  float eps, int blocks, int sq, int so, int si, int sf,
                                  void* stream) {
  if (N <= 0 || D <= 0 || D % TILE_N || F <= 0 || F % TILE_N || heads <= 0 ||
      D != heads * HEAD_DIM || KK <= 0 || KK > MAX_KEYS || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.hidden = static_cast<const bf16*>(hidden);
  p.cross_ln = static_cast<const float*>(cross_ln);
  p.ck = static_cast<const bf16*>(ck);
  p.cv = static_cast<const bf16*>(cv);
  p.enc_bias = static_cast<const float*>(enc_bias);
  p.ffn_ln = static_cast<const float*>(ffn_ln);
  const void* w[4] = {wq, wo_c, wi, wo_f};
  const int ks[4] = {D, D, D, F}, cols[4] = {D, D, F, D}, splits[4] = {sq, so, si, sf};
  int off = 0, kmax = 0;
  for (int i = 0; i < 4; ++i) {
    const int units = ks[i] / 16;
    if (splits[i] <= 0 || splits[i] > units || splits[i] > MAX_SPLITS ||
        (cols[i] / TILE_N) * splits[i] > blocks)
      return static_cast<int>(cudaErrorInvalidValue);
    const int rows = 16 * ((units + splits[i] - 1) / splits[i]);  // the longest split's
    p.g[i] = Gemm{static_cast<const bf16*>(w[i]), ks[i], cols[i], splits[i], off};
    off += rows * LDW;
    kmax = rows > kmax ? rows : kmax;
  }
  p.y = static_cast<bf16*>(y);
  p.ctx = static_cast<bf16*>(ctx);
  p.x = static_cast<bf16*>(x);
  p.hmid = static_cast<bf16*>(hmid);
  p.out = static_cast<bf16*>(out);
  p.ws = static_cast<float*>(ws);
  p.N = N;
  p.D = D;
  p.F = F;
  p.KK = KK;
  p.heads = heads;
  p.eps = eps;
  p.stage = off;  // a multiple of 8 elements: 16-byte aligned
  p.lda_s = kmax + 8;  // rows 16 bytes off a multiple of 128: ldmatrix rows on distinct banks
  const size_t smem = ((size_t)off + (size_t)ROW_BLOCK * p.lda_s) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(t5_cross_ffn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, t5_cross_ffn_kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_status();
}
