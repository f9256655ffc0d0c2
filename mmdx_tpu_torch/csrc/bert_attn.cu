// Attention core of the fused BERT attention block (ops/bert_attn.py):
// ctx = softmax(Q K^T * scale + kmask) V for one (sequence, head, query
// tile) per block, on the tensor cores.
//
// Replaces the score/softmax/context part of
// mmdx_tpu/ops/pallas_bert_attn.py:_kernel (and of _kernel_int8). The TPU
// kernel packs several sequences into one block-diagonal [R, R] score
// matrix to get MXU-shaped tiles; here each block owns one sequence and one
// head, so no score is computed that the softmax would then mask away.
//
// What bounds it on the H100: almost nothing. At B=32, L=96, 12 heads it is
// 0.9 GFLOP on the tensor cores (1 us) and reads ~14 MB of qkv (4 us at
// 3.35 TB/s); latency and the instruction stream decide its time, so the
// grid has to fill the SMs and every product runs as an mma.
//
// Design: grid (heads, sequences, query tiles of `qt` rows, 16 to 64 picked
// by ops/bert_attn.py:query_tile so that the grid fills the SMs); one warp
// per 16 query rows. The block's Q rows and the sequence's K and V (L <= 128
// keys, padded to a multiple of 16 with zeros) and key mask come into
// shared memory by cp.async. Each warp keeps its Q rows as mma.sync
// m16n8k16 A fragments (ldmatrix) and computes its 16 x L score tile in f32
// registers against K (ldmatrix), adds scale and key mask in f32, takes the
// row max and row sum across the four lanes of a quad (shuffles), and forms
// p = bf16(exp(s - max) / sum), the Pallas body's one rounding point. The
// score fragments are then the A fragments of p.V (V through
// ldmatrix.trans), accumulated in f32: the bf16 x bf16 products are exact in
// f32, so only the summation order differs from the plain version. Keys
// past L are excluded (probability exactly 0). The context is written as
// bf16 (mmdx_bert_attn, K1) or f32 (mmdx_bert_attn_f32, the W8A8 block K7,
// which quantizes it per row next).
#include "common.cuh"

namespace {

constexpr int D = 64;            // head width
constexpr int LD = D + 8;        // 144-byte smem rows: 8 ldmatrix rows hit distinct banks
constexpr int MAX_L = 128;

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Lane l of warp w owns query rows q0 + 16w + l/4 and + 8, and in each
// 8-wide n-tile of a score or context fragment the columns 2(l%4), +1.
template <typename OutT>
__global__ void __launch_bounds__(128)
bert_attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ kmask,
                 OutT* __restrict__ ctx, int L, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qt = blockDim.x / 2;  // 16 rows a warp
  const int h = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * qt;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lp = (L + 15) & ~15;  // keys padded to the 16-key mma step
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [qt][LD]
  bf16* Ks = Qs + qt * LD;                   // [lp][LD]
  bf16* Vs = Ks + lp * LD;                   // [lp][LD]
  float* Ms = reinterpret_cast<float*>(Vs + lp * LD);  // [lp] key mask

  const size_t ld = 3 * (size_t)H;
  const bf16* base = qkv + (size_t)b * L * ld + (size_t)h * D;
  for (int c = tid; c < qt * 8; c += blockDim.x) {
    const int r = c / 8, u = (c % 8) * 8;
    const bool ok = q0 + r < L;
    cp_async16(&Qs[r * LD + u], base + (ok ? q0 + r : 0) * ld + u, ok);
  }
  for (int c = tid; c < lp * 8; c += blockDim.x) {
    const int j = c / 8, u = (c % 8) * 8;
    const bool ok = j < L;
    const bf16* row = base + (ok ? j : 0) * ld + u;
    cp_async16(&Ks[j * LD + u], row + H, ok);
    cp_async16(&Vs[j * LD + u], row + 2 * H, ok);
  }
  for (int j = tid; j < lp; j += blockDim.x)
    cp_async4(&Ms[j], kmask + (size_t)b * L + (j < L ? j : 0), j < L);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (q0 + warp * 16 >= L) return;  // a warp whose rows all lie past L

  const int kb = lp / 16, g = lane / 4, cq = (lane % 4) * 2, mi = lane / 8;
  unsigned qf[4][4];  // Q as A fragments, 4 steps of 16 head dims
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm_x4(qf[ks], &Qs[(warp * 16 + (mi & 1) * 8 + lane % 8) * LD + ks * 16 + (mi >> 1) * 8]);

  // s = q . k: exact bf16 products summed in f32; times scale, plus the mask
  float s[2 * MAX_L / 16][4];
#pragma unroll
  for (int j = 0; j < 2 * MAX_L / 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    if (j < 2 * kb) {
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        unsigned kf[4];
        ldsm_x4(kf, &Ks[(j * 8 + lane % 8) * LD + kp * 32 + (lane / 8) * 8]);
        mma_bf16(s[j], qf[2 * kp], kf[0], kf[1]);
        mma_bf16(s[j], qf[2 * kp + 1], kf[2], kf[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + cq + (e & 1);
        s[j][e] = c < L ? s[j][e] * scale + Ms[c] : -__int_as_float(0x7f800000);  // -inf
      }
    }
  }

  // softmax per row: the four lanes of a quad share a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -__int_as_float(0x7f800000);
#pragma unroll
    for (int j = 0; j < 2 * MAX_L / 16; ++j)
      if (j < 2 * kb) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * MAX_L / 16; ++j)
      if (j < 2 * kb) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = expf(s[j][e] - mx);
          sum += s[j][e];
        }
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
    for (int j = 0; j < 2 * MAX_L / 16; ++j)
      if (j < 2 * kb) {
        s[j][2 * r] = s[j][2 * r] / sum;
        s[j][2 * r + 1] = s[j][2 * r + 1] / sum;
      }
  }

  // ctx = bf16(p) . v: two score n-tiles are the A fragment of one 16-key step
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < MAX_L / 16; ++ks) {
    if (ks >= kb) break;
    const unsigned pa[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                            pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                            pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                            pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
    for (int jd = 0; jd < D / 8; jd += 2) {
      unsigned vf[4];
      ldsm_x4_trans(vf, &Vs[(ks * 16 + (mi & 1) * 8 + lane % 8) * LD + (jd + (mi >> 1)) * 8]);
      mma_bf16(acc[jd], pa, vf[0], vf[1]);
      mma_bf16(acc[jd + 1], pa, vf[2], vf[3]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= L) continue;
    OutT* out = ctx + ((size_t)b * L + row) * H + (size_t)h * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store_pair(out + j * 8, acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

template <typename OutT>
int launch_bert_attn(const void* qkv, const void* kmask, void* ctx, int B, int L, int H,
                     int heads, int qt, float scale, void* stream) {
  if (B <= 0 || L <= 0 || L > MAX_L || heads <= 0 || H != heads * D || qt < 16 || qt > 64 ||
      qt % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lp = (L + 15) & ~15;
  const size_t smem = (size_t)(qt + 2 * lp) * LD * sizeof(bf16) + (size_t)lp * sizeof(float);
  const dim3 grid(heads, B, (L + qt - 1) / qt);
  bert_attn_kernel<OutT><<<grid, qt * 2, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(kmask), static_cast<OutT*>(ctx),
      L, H, scale);
  return launch_status();
}

}  // namespace

// qkv [B*L, 3H] bf16 (q|k|v column blocks, head-major in each, heads of
// 64), kmask [B*L] f32 additive (0 / -1e9), ctx [B*L, H] bf16; L <= 128,
// query tiles of qt rows (a multiple of 16, at most 64).
MMDX_EXPORT int mmdx_bert_attn(const void* qkv, const void* kmask, void* ctx, int B, int L, int H,
                               int heads, int qt, float scale, void* stream) {
  return launch_bert_attn<bf16>(qkv, kmask, ctx, B, L, H, heads, qt, scale, stream);
}

// The same with an f32 context [B*L, H] (the W8A8 block, _kernel_int8).
MMDX_EXPORT int mmdx_bert_attn_f32(const void* qkv, const void* kmask, void* ctx, int B, int L,
                                   int H, int heads, int qt, float scale, void* stream) {
  return launch_bert_attn<float>(qkv, kmask, ctx, B, L, H, heads, qt, scale, stream);
}
