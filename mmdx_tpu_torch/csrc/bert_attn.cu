// Attention core of the fused BERT attention block (ops/bert_attn.py):
// ctx = softmax(Q K^T * scale + kmask) V for one (sequence, head) per block.
//
// Replaces the score/softmax/context part of
// mmdx_tpu/ops/pallas_bert_attn.py:_kernel. The TPU kernel packs several
// sequences into one block-diagonal [R, R] score matrix to get MXU-shaped
// tiles; here each block owns exactly one sequence and one head, so no score
// is computed that the softmax would then mask away.
//
// qkv is the bf16 [B*L, 3H] output of the merged projection (q|k|v column
// blocks, head-major within each). Q, K^T and V of the (sequence, head) are
// staged in shared memory (K transposed so a warp's lanes read consecutive
// keys); each warp takes query rows in turn, keeps its f32 score row in
// shared memory, and writes its context row. Numerics follow the Pallas
// body: f32 scores and softmax, probabilities rounded to bf16 before the
// product with V, f32 accumulation, and a bf16 context (_kernel) or an f32
// one (_kernel_int8, which quantizes the f32 context per row next).
#include "common.cuh"

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ void store_ctx(bf16* p, float v) { *p = f2bf(v); }
__device__ __forceinline__ void store_ctx(float* p, float v) { *p = v; }

template <typename OutT>
__global__ void __launch_bounds__(WARPS * 32)
bert_attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ kmask,
                 OutT* __restrict__ ctx, int L, int H, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [L, d]
  bf16* Kt = Qs + L * d;                     // [d, L]
  bf16* Vs = Kt + L * d;                     // [L, d]
  float* srow = reinterpret_cast<float*>(Vs + L * d) + warp * L;  // [WARPS, L]

  const size_t ld = 3 * (size_t)H;
  const bf16* base = qkv + (size_t)b * L * ld + (size_t)h * d;
  const int chunks = d / 8;
  for (int c = tid; c < L * chunks; c += blockDim.x) {
    const int r = c / chunks, t0 = (c % chunks) * 8;
    const bf16* row = base + (size_t)r * ld + t0;
    *reinterpret_cast<uint4*>(Qs + r * d + t0) = *reinterpret_cast<const uint4*>(row);
    *reinterpret_cast<uint4*>(Vs + r * d + t0) =
        *reinterpret_cast<const uint4*>(row + 2 * H);
    uint4 kv = *reinterpret_cast<const uint4*>(row + H);
    const bf16* k8 = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
    for (int u = 0; u < 8; ++u) Kt[(t0 + u) * L + r] = k8[u];
  }
  __syncthreads();

  const float* km = kmask + (size_t)b * L;
  for (int i = warp; i < L; i += WARPS) {
    const bf16* q = Qs + i * d;
    float mx = -3.0e38f;
    for (int j = lane; j < L; j += 32) {
      float s = 0.0f;
      for (int t = 0; t < d; ++t) s += bf2f(q[t]) * bf2f(Kt[t * L + j]);
      s = s * scale + km[j];
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(srow[j] - mx);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32) srow[j] = round_bf16(srow[j] / sum);
    __syncwarp();
    OutT* out = ctx + ((size_t)b * L + i) * H + (size_t)h * d;
    for (int t = lane; t < d; t += 32) {
      float a = 0.0f;
      for (int j = 0; j < L; ++j) a += srow[j] * bf2f(Vs[j * d + t]);
      store_ctx(out + t, a);
    }
    __syncwarp();
  }
}

template <typename OutT>
int launch_bert_attn(const void* qkv, const void* kmask, void* ctx, int B, int L,
                     int H, int heads, float scale, void* stream) {
  if (B <= 0 || L <= 0 || heads <= 0 || H % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = H / heads;
  if (d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)3 * L * d * sizeof(bf16) + (size_t)WARPS * L * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bert_attn_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bert_attn_kernel<OutT><<<dim3(heads, B), WARPS * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(kmask),
      static_cast<OutT*>(ctx), L, H, d, scale);
  return launch_status();
}

}  // namespace

// qkv [B*L, 3H] bf16, kmask [B*L] f32 additive (0 / -1e9), ctx [B*L, H] bf16.
MMDX_EXPORT int mmdx_bert_attn(const void* qkv, const void* kmask, void* ctx,
                               int B, int L, int H, int heads, float scale,
                               void* stream) {
  return launch_bert_attn<bf16>(qkv, kmask, ctx, B, L, H, heads, scale, stream);
}

// The same with an f32 context [B*L, H] (the W8A8 block, _kernel_int8).
MMDX_EXPORT int mmdx_bert_attn_f32(const void* qkv, const void* kmask, void* ctx,
                                   int B, int L, int H, int heads, float scale,
                                   void* stream) {
  return launch_bert_attn<float>(qkv, kmask, ctx, B, L, H, heads, scale, stream);
}
