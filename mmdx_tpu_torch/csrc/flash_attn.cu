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
// Design: one block of 256 threads per (64 query rows, sequence x head).
// The scaled Q tile, each 64-key K tile (both transposed, so a thread reads
// four rows or keys as one float4), the V tile and the probability tile live
// in shared memory as f32; each thread owns a 4x4 patch of the 64x64 score
// tile and of the 64x64 output tile, and the 16 threads of a row group share
// the row statistics through warp shuffles. Operands are read through their
// strides: q, k, v and out may be head-interleaved views of [B, L, H*64]
// projections, and the bias is read through its broadcast strides (a BERT
// key mask [B, 1, 1, L] is 4 bytes per key, never [B, H, L, L]).
//
// What bounds it on the H100: at B=32, H=12, L=512 the work is 25.8 GFLOP
// and the bytes are ~100 MB (q, k, v, out in bf16): about 0.03 ms at the
// card's peaks. The design keeps every product in f32 on the CUDA cores,
// because rounding p to bf16 for the tensor cores would move the result, so
// it runs at the f32 FMA rate, far above that bound; a tensor-core version
// (bf16 q.k with the power-of-two BERT scale, split-bf16 p.v) is later work.
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
