// Blockwise online-softmax attention with an additive bias (ops/flash_attention.py).
//
// Replaces mmdx_tpu/ops/pallas_attention.py:flash_attention (_flash_kernel):
//   out = softmax(q * scale @ k^T + bias) @ v   over [B, H, L, 64]
// with the Pallas body's arithmetic: q converted to f32 and multiplied by
// scale, f32 scores plus the f32 bias, the running max and denominator in f32,
// the probabilities p kept in f32 and multiplied by v in f32, and acc / denom
// rounded to q's type at the end. Keys past Lk up to Lk_pad (the Pallas
// wrapper's padding of a ragged length to its key block) score exactly -1e9,
// as the padded zero keys with their -1e9 bias do there; the running max
// starts at -1e9 as in the Pallas body.
//
// Two bodies; the wrapper picks one by a stated rule (ops/flash_attention.py
// tensor_core_body). Both read q, k, v and out through their strides (head
// views of [B, L, H*64] projections) and the bias through its broadcast
// strides (a BERT key mask [B, 1, 1, L] is 4 bytes per key).
//
// What bounds it on the H100: at B=32, H=12, L=512 the bytes are ~100 MB
// (q, k, v, out in bf16, 0.030 ms at 3.35 TB/s) and the work 25.8 GFLOP
// (0.026 ms on the bf16 tensor cores, but 0.39 ms at the f32 FMA rate): the
// bound is within reach only with the products on the tensor cores.
//
// The tensor-core body (flash_attn_tc_kernel; bf16 operands, a power-of-two
// scale such as BERT's 1/8): one block of 8 warps per (128 query rows,
// sequence x head), or of 4 warps per 64 rows when the grid would
// otherwise hold fewer than two blocks an SM; 16 rows per warp. Every
// block re-reads its sequence's K and V from L2, so taller blocks read
// less. Q is loaded once into registers as
// mma.sync.m16n8k16 A fragments (ldmatrix); 64-key K and V tiles (and a
// key mask's 64 values) stream through a 2-stage shared ring of cp.async
// copies, tile t+1 in flight while tile t computes. q.k runs on the tensor cores: bf16 x bf16
// products are exact in f32 and the scale is a power of two, so the f32
// sums equal the Pallas body's (q * scale) @ k up to summation order. The
// online softmax runs on the accumulator fragments (the four lanes of a
// quad share a row), with the exp intrinsic (__expf, a few f32 ulps). The Pallas body keeps p in f32; here p = hi + lo with
// hi = bf16(p), lo = bf16(p - hi), and two mma's accumulate hi.v + lo.v in
// f32 (residual ~2^-17 |p|, far below an output ulp; one bf16 p would be
// ~2^-9 |p|). The score fragments are already the A fragments of the p.v
// product, so p never touches shared memory. On the card the tensor cores
// are not what bounds it: dropping either product from a build leaves its
// time where it is. The instruction stream around them does, so a full key
// tile under a key mask (every tile but a ragged last one) takes a path with
// no per-element tests or address arithmetic.
//
// The CUDA-core body (flash_attn_kernel<T>; f32 operands, or any other
// scale): one block of 256 threads per (64 query rows, sequence x head). The
// scaled Q tile, each 64-key K tile (both transposed, so a thread reads four
// rows or keys as one float4), the V tile and the probability tile live in
// shared memory as f32; each thread owns a 4x4 patch of the score and output
// tiles, and every product is an f32 FMA, so it runs at the f32 FMA rate
// (67 TFLOP/s), far above the bound.
#include "common.cuh"

namespace {

constexpr int FA_BQ = 64, FA_BK = 64, FA_D = 64, FA_THREADS = 256;
constexpr int FA_LD = FA_BQ + 4;  // padded row of the transposed tiles
constexpr float FA_NEG = -1e9f;

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* out;
  long long qs[3], ks[3], vs[3], os[3], bs[4];
  int H, Lq, Lk, Lk_pad;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(FA_THREADS) flash_attn_kernel(FlashParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qt = reinterpret_cast<float*>(smem);  // [D][FA_LD]: Qt[t][r] = q[r][t] * scale
  float* Kt = Qt + FA_D * FA_LD;               // [D][FA_LD]: Kt[t][j] = k[j][t]
  float* Pt = Kt + FA_D * FA_LD;               // [BK][FA_LD]: Pt[j][r] = p[r][j]
  float* Vs = Pt + FA_BK * FA_LD;              // [BK][D]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * FA_BQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* qb = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* kb = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const T* vb = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1];
  const float* biasb = p.bias + b * p.bs[0] + h * p.bs[1];

  // stage the scaled Q tile, transposed; lanes walk rows so the transposed
  // stores fall in distinct banks
  for (int c = tid; c < FA_BQ * (FA_D / 8); c += FA_THREADS) {
    const int r = c % FA_BQ, t0 = (c / FA_BQ) * 8;
    float v8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (q0 + r < p.Lq) load8(qb + (q0 + r) * p.qs[2] + t0, v8);
#pragma unroll
    for (int u = 0; u < 8; ++u) Qt[(t0 + u) * FA_LD + r] = v8[u] * p.scale;
  }

  float acc[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < p.Lk_pad; k0 += FA_BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < FA_BK * (FA_D / 8); c += FA_THREADS) {
      const int j = c % FA_BK, t0 = (c / FA_BK) * 8;
      float kv[8] = {0, 0, 0, 0, 0, 0, 0, 0}, vv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (k0 + j < p.Lk) {
        load8(kb + (k0 + j) * p.ks[2] + t0, kv);
        load8(vb + (k0 + j) * p.vs[2] + t0, vv);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        Kt[(t0 + u) * FA_LD + j] = kv[u];
        Vs[j * FA_D + t0 + u] = vv[u];
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int t = 0; t < FA_D; ++t) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + t * FA_LD + ty * 4);
      const float4 kk = *reinterpret_cast<const float4*>(Kt + t * FA_LD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, kvv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kvv[j], s[i][j]);
    }

    // bias, padded keys (-1e9) and keys past the padded length (excluded)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        if (col < p.Lk) {
          const float bv = row < p.Lq ? biasb[row * p.bs[2] + col * p.bs[3]] : 0.0f;
          s[i][j] += bv;
        } else {
          s[i][j] = col < p.Lk_pad ? FA_NEG : -__int_as_float(0x7f800000);  // -inf
        }
      }
    }

    // online softmax, the Pallas body's recurrence
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * FA_LD + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 8
    for (int jj = 0; jj < FA_BK; ++jj) {
      const float4 pp = *reinterpret_cast<const float4*>(Pt + jj * FA_LD + ty * 4);
      const float4 vv = *reinterpret_cast<const float4*>(Vs + jj * FA_D + tx * 4);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w}, vvv[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vvv[j], acc[i][j]);
    }
  }

  T* ob = static_cast<T*>(p.out) + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Lq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) store_f(ob + row * p.os[2] + tx * 4 + j, acc[i][j] / l[i]);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core body: bf16 q, k, v and a power-of-two scale.
// ---------------------------------------------------------------------------
constexpr int TC_LD = FA_D + 8;       // 144-byte smem rows: 8 ldmatrix rows hit distinct banks
constexpr int TC_TILE = FA_BK * TC_LD;

// an f32 pair as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi): the
// pair sums to x within 2^-17 |x|
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// WARPS warps of 16 query rows each share every K/V tile. Lane l of warp w
// owns query rows r0 = 16w + l/4 and r0 + 8 of the block's, and in each
// 8-wide n-tile of a score or output fragment the columns 2(l%4) and
// 2(l%4)+1 (the m16n8 accumulator layout). 128 registers a thread.
template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 16 / WARPS) flash_attn_tc_kernel(FlashParams p) {
  constexpr int THREADS = WARPS * 32, BQ = WARPS * 16;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // [BQ][TC_LD]
  bf16* Ks = Qs + BQ * TC_LD;                     // [2][FA_BK][TC_LD]
  bf16* Vs = Ks + 2 * TC_TILE;                    // [2][FA_BK][TC_LD]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * TC_TILE);  // [2][FA_BK] key-mask bias

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.vs[0] + h * p.vs[1];
  const float* biasb = p.bias + b * p.bs[0] + h * p.bs[1];
  const int n_tiles = (p.Lk_pad + FA_BK - 1) / FA_BK;
  // a bias that broadcasts over the query rows (a key mask) is one value
  // per key: it rides with the K/V tiles; any other is read per element
  const bool key_bias = p.bs[2] == 0;
  const long long bs3 = p.bs[3];

  // 16-byte chunks, 8 to a 128-byte row: consecutive threads on one row
  for (int c = tid; c < BQ * 8; c += THREADS) {
    const int r = c / 8, u = (c % 8) * 8;
    const bool ok = q0 + r < p.Lq;
    cp_async16(&Qs[r * TC_LD + u], qb + (ok ? q0 + r : 0) * p.qs[2] + u, ok);
  }
  auto load_tile = [&](int t, int stage) {
    for (int c = tid; c < FA_BK * 8; c += THREADS) {
      const int j = c / 8, u = (c % 8) * 8, key = t * FA_BK + j;
      const bool ok = key < p.Lk;
      const long long row = ok ? key : 0;
      cp_async16(&Ks[stage * TC_TILE + j * TC_LD + u], kb + row * p.ks[2] + u, ok);
      cp_async16(&Vs[stage * TC_TILE + j * TC_LD + u], vb + row * p.vs[2] + u, ok);
    }
    if (key_bias && tid < FA_BK) {
      const int key = t * FA_BK + tid;
      cp_async4(&Bs[stage * FA_BK + tid], biasb + (key < p.Lk ? key : 0) * bs3, key < p.Lk);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  const int g = lane / 4, cq = (lane % 4) * 2;  // fragment row and column pair
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  // the bias rows of the lane's two query rows (rows past Lq read row
  // Lq - 1: they are computed, never stored)
  const float* brow[2] = {biasb + min(rows[0], p.Lq - 1) * p.bs[2],
                          biasb + min(rows[1], p.Lq - 1) * p.bs[2]};
  unsigned qf[4][4];  // Q as A fragments, 4 steps of 16 head dims
  float acc[8][4], m[2] = {FA_NEG, FA_NEG}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1, k0 = t * FA_BK;
    if (t + 1 < n_tiles) load_tile(t + 1, stage ^ 1);  // in flight while tile t computes
    cp_async_commit();
    cp_async_wait<1>();  // tile t landed; t + 1 may be in flight
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int mi = lane / 8;
        ldsm_x4(qf[ks], &Qs[(warp * 16 + (mi & 1) * 8 + lane % 8) * TC_LD + ks * 16 + (mi >> 1) * 8]);
      }
    }
    const bf16* Kt = Ks + stage * TC_TILE;
    const bf16* Vt = Vs + stage * TC_TILE;

    // s = q . k on the tensor cores: exact bf16 products summed in f32
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        unsigned kf[4];
        ldsm_x4(kf, &Kt[(j * 8 + lane % 8) * TC_LD + kp * 32 + (lane / 8) * 8]);
        mma_bf16(s[j], qf[2 * kp], kf[0], kf[1]);
        mma_bf16(s[j], qf[2 * kp + 1], kf[2], kf[3]);
      }
    }

    // times the power-of-two scale (exact), plus the bias; padded keys
    // (-1e9) and keys past the padded length (excluded)
    const float* bt = Bs + stage * FA_BK;
    if (key_bias && k0 + FA_BK <= p.Lk) {  // every key real: no per-element tests
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(bt + j * 8 + cq);
        s[j][0] = s[j][0] * p.scale + bb.x;
        s[j][1] = s[j][1] * p.scale + bb.y;
        s[j][2] = s[j][2] * p.scale + bb.x;
        s[j][3] = s[j][3] * p.scale + bb.y;
      }
    } else {
      auto bias_at = [&](int r, int c) { return key_bias ? bt[c - k0] : brow[r][c * bs3]; };
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + j * 8 + cq;
        if (col + 1 < p.Lk) {
          const float b0 = bias_at(0, col), b1 = bias_at(0, col + 1);
          s[j][0] = s[j][0] * p.scale + b0;
          s[j][1] = s[j][1] * p.scale + b1;
          s[j][2] = s[j][2] * p.scale + (key_bias ? b0 : bias_at(1, col));
          s[j][3] = s[j][3] * p.scale + (key_bias ? b1 : bias_at(1, col + 1));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = col + (e & 1);
            s[j][e] = c < p.Lk ? s[j][e] * p.scale + bias_at(e / 2, c)
                    : c < p.Lk_pad ? FA_NEG : -__int_as_float(0x7f800000);  // -inf
          }
        }
      }
    }

    // online softmax in registers, the Pallas body's recurrence; the four
    // lanes of a quad share a row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = FA_NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = __expf(s[j][e] - m_new);
          rs += s[j][e];
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      const float corr = __expf(m[r] - m_new);
      l[r] = l[r] * corr + rs;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }

    // acc += p . v with p = hi + lo in bf16: the score fragments of two
    // n-tiles are the A fragment of one 16-key step, so p stays in registers
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      unsigned ph[4], pl[4];
      split_bf16(s[2 * ks][0], s[2 * ks][1], ph[0], pl[0]);
      split_bf16(s[2 * ks][2], s[2 * ks][3], ph[1], pl[1]);
      split_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int jd = 0; jd < 8; jd += 2) {
        const int mi = lane / 8;
        unsigned vf[4];
        ldsm_x4_trans(vf, &Vt[(ks * 16 + (mi & 1) * 8 + lane % 8) * TC_LD + (jd + (mi >> 1)) * 8]);
        mma_bf16(acc[jd], ph, vf[0], vf[1]);
        mma_bf16(acc[jd], pl, vf[0], vf[1]);
        mma_bf16(acc[jd + 1], ph, vf[2], vf[3]);
        mma_bf16(acc[jd + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

  bf16* ob = static_cast<bf16*>(p.out) + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.Lq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + rows[r] * p.os[2] + j * 8 + cq) =
          __floats2bfloat162_rn(acc[j][2 * r] / l[r], acc[j][2 * r + 1] / l[r]);
  }
}

template <int WARPS>
int launch_flash_tc_warps(const FlashParams& p, int B, void* stream) {
  const size_t smem =
      (size_t)(WARPS * 16 + 4 * FA_BK) * TC_LD * sizeof(bf16) + 2 * FA_BK * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_tc_kernel<WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Lq + WARPS * 16 - 1) / (WARPS * 16), B * p.H);
  flash_attn_tc_kernel<WARPS><<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return launch_status();
}

// 128 query rows a block (8 warps) halve the K/V tiles' reads from L2 for
// each query row; 64 (4 warps) where that would leave fewer blocks than
// two for each SM (132 on the H100) to hide their latency.
int launch_flash_tc(const FlashParams& p, int B, void* stream) {
  const long long wide = (long long)((p.Lq + 127) / 128) * B * p.H;
  return wide >= 2 * 132 ? launch_flash_tc_warps<8>(p, B, stream)
                         : launch_flash_tc_warps<4>(p, B, stream);
}

template <typename T>
int launch_flash(const FlashParams& p, int B, void* stream) {
  const size_t smem = (size_t)(2 * FA_D * FA_LD + FA_BK * FA_LD + FA_BK * FA_D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Lq + FA_BQ - 1) / FA_BQ, B * p.H);
  flash_attn_kernel<T><<<grid, FA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return launch_status();
}

}  // namespace

// q/k/v/out [B, H, L, 64] through their (b, h, l) strides in elements, the
// last dim contiguous; bias f32 through its (b, h, q, k) strides (0 where it
// broadcasts). Lk_pad >= Lk: keys in [Lk, Lk_pad) score -1e9. is_bf16: the
// type of q, k, v and out (bf16, else f32).
MMDX_EXPORT int mmdx_flash_attn(const void* q, const void* k, const void* v,
                                const void* bias, void* out,
                                long long qs0, long long qs1, long long qs2,
                                long long ks0, long long ks1, long long ks2,
                                long long vs0, long long vs1, long long vs2,
                                long long bs0, long long bs1, long long bs2,
                                long long bs3, long long os0, long long os1,
                                long long os2, int B, int H, int Lq, int Lk,
                                int Lk_pad, float scale, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || Lk_pad < Lk)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p{q, k, v, static_cast<const float*>(bias), out,
                {qs0, qs1, qs2}, {ks0, ks1, ks2}, {vs0, vs1, vs2}, {os0, os1, os2},
                {bs0, bs1, bs2, bs3}, H, Lq, Lk, Lk_pad, scale};
  return is_bf16 ? launch_flash<bf16>(p, B, stream) : launch_flash<float>(p, B, stream);
}

// The tensor-core body: bf16 q, k, v, out and a power-of-two scale (the
// caller's rule, ops/flash_attention.py); arguments as mmdx_flash_attn.
MMDX_EXPORT int mmdx_flash_attn_tc(const void* q, const void* k, const void* v,
                                   const void* bias, void* out,
                                   long long qs0, long long qs1, long long qs2,
                                   long long ks0, long long ks1, long long ks2,
                                   long long vs0, long long vs1, long long vs2,
                                   long long bs0, long long bs1, long long bs2,
                                   long long bs3, long long os0, long long os1,
                                   long long os2, int B, int H, int Lq, int Lk,
                                   int Lk_pad, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || Lk_pad < Lk)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p{q, k, v, static_cast<const float*>(bias), out,
                {qs0, qs1, qs2}, {ks0, ks1, ks2}, {vs0, vs1, vs2}, {os0, os1, os2},
                {bs0, bs1, bs2, bs3}, H, Lq, Lk, Lk_pad, scale};
  return launch_flash_tc(p, B, stream);
}
