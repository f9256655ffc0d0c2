// Cross-attention core of the T5 decoder half-step (ops/t5_step.py):
// for each row n (one beam of one sample) and head h,
//   s[k]   = q[n, h] . ck[n, k, h] + enc_bias[n, k]      (no 1/sqrt(d): T5)
//   p      = bf16(softmax(s))
//   ctx[n, h] = bf16(sum_k p[k] * cv[n, k, h])
// over the row's own K conditioning tokens (K = 4 in serving).
//
// Replaces the per-head score/softmax/context loop of
// mmdx_tpu/ops/pallas_t5_step.py:_kernel, which packs all rows into one
// block-diagonal [N, N*K] score matrix per head to give the MXU a matmul;
// here one warp owns one (row, head) and reads only that row's K keys, so
// the N-fold masked work is gone. Bounded by latency, not bytes or FLOPs:
// the whole input is N * K * 2 KB.
#include "common.cuh"

namespace {

constexpr int MAX_KEYS = 16;

__global__ void t5_cross_attn_kernel(const bf16* __restrict__ q,
                                     const bf16* __restrict__ ck,
                                     const bf16* __restrict__ cv,
                                     const float* __restrict__ enc_bias,
                                     bf16* __restrict__ ctx, int N, int KK,
                                     int heads, int d) {
  const int gw = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (gw >= N * heads) return;
  const int n = gw / heads, h = gw % heads;
  const int D = heads * d;
  const bf16* qr = q + (size_t)n * D + h * d;
  float s[MAX_KEYS];
  float mx = -3.0e38f;
  for (int k = 0; k < KK; ++k) {
    const bf16* kr = ck + ((size_t)n * KK + k) * D + h * d;
    float part = 0.0f;
    for (int t = lane; t < d; t += 32) part += bf2f(qr[t]) * bf2f(kr[t]);
    s[k] = warp_sum(part) + enc_bias[(size_t)n * KK + k];
    mx = fmaxf(mx, s[k]);
  }
  float sum = 0.0f;
  for (int k = 0; k < KK; ++k) {
    s[k] = expf(s[k] - mx);
    sum += s[k];
  }
  for (int k = 0; k < KK; ++k) s[k] = round_bf16(s[k] / sum);
  bf16* out = ctx + (size_t)n * D + h * d;
  for (int t = lane; t < d; t += 32) {
    float a = 0.0f;
    for (int k = 0; k < KK; ++k)
      a += s[k] * bf2f(cv[((size_t)n * KK + k) * D + h * d + t]);
    out[t] = f2bf(a);
  }
}

}  // namespace

// q [N, h*d] bf16; ck, cv [N, KK, h*d] bf16; enc_bias [N, KK] f32;
// ctx [N, h*d] bf16.
MMDX_EXPORT int mmdx_t5_cross_attn(const void* q, const void* ck, const void* cv,
                                   const void* enc_bias, void* ctx, int N,
                                   int KK, int heads, int d, void* stream) {
  if (N <= 0 || KK <= 0 || KK > MAX_KEYS || heads <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps_per_block = 4;
  const int blocks = (N * heads + warps_per_block - 1) / warps_per_block;
  t5_cross_attn_kernel<<<blocks, 32 * warps_per_block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(ck),
      static_cast<const bf16*>(cv), static_cast<const float*>(enc_bias),
      static_cast<bf16*>(ctx), N, KK, heads, d);
  return launch_status();
}
