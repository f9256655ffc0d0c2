// Fused int8 stride-1 identity bottleneck (ops/int8_bottleneck.py).
//
// Replaces mmdx_tpu/ops/pallas_int8_bottleneck.py:fused_bottleneck_int8
// (_kernel): for NHWC s8 x [B, H, W, C] and folded requant vectors,
//   a1  = q(relu(x @ w1 * k1 + b1))                     [.., M]
//   a2  = q(relu(conv3x3_same(a1) @ w2flat * k2 + b2))  [.., M], K = 9M
//   out = q(relu(a2 @ w3 * k3 + b3 + x * kx))           [.., C]
// with q(y) = s8(clip(rint(y), -127, 127)) (round half to even, as
// jnp.round), every product an exact s32 sum, each f32 step in the Pallas
// body's order through __fmul_rn/__fadd_rn so that nvcc cannot contract a
// multiply-add into an FMA: the s8 outputs equal the plain version's bit for
// bit. The TPU kernel's width-padded layout and its g images per program
// are sublane fixes; here the layout is plain NHWC.
//
// Design: the implicit GEMM of csrc/implicit_gemm.cuh on the tensor cores
// (mma.sync m16n8k32 s8 -> s32): a block per (image, band of TR output
// rows) runs conv1 over the band and its halo rows into the zero-bordered
// a1 tile, conv2 as nine shifted views of that tile (no im2col), and conv3
// with the identity shortcut and the final requant; a1 and a2 never leave
// the SM, x is read for conv1 and the shortcut, the output written once.
// The weights are the qparams' K-major GEMM operands ("wk" [co, K]), read
// in place and streamed through a cp.async ring.
//
// What bounds it on the H100: at stage 1 (56x56, C 256, M 64) and B=32 the
// block is 14.8 GOP of int8 products against 51 MB of s8 input and output:
// 0.015 ms of bytes, 0.0075 ms of int8 tensor-core operations, so bytes.
// The halo rows' conv1 ((TR+2)/TR of it) and the weights read from L2 once
// per band and pass of rows come on top.
#include "implicit_gemm.cuh"

// x, out s8 [B, H, W, C]; w1 [M][ld1], w2 [M][ld2] (K = 9M, (ky, kx, ci)
// order), w3 [C][ld3]: s8, K-major (K contiguous in each row); k1, b1, k2,
// b2 f32 [M]; k3, b3 f32 [C]; kx f32; TR output rows per block. C and M
// multiples of 64.
MMDX_EXPORT int mmdx_int8_bottleneck(const void* x, const void* w1, long long ld1,
                                     const void* k1, const void* b1, const void* w2,
                                     long long ld2, const void* k2, const void* b2,
                                     const void* w3, long long ld3, const void* k3,
                                     const void* b3, float kx, void* out, int B, int H, int W,
                                     int C, int M, int TR, void* stream) {
  ig::Params p{};
  p.x = x;
  p.w1 = w1;
  p.w2 = w2;
  p.w3 = w3;
  p.ld1 = ld1;
  p.ld2 = ld2;
  p.ld3 = ld3;
  p.k1 = static_cast<const float*>(k1);
  p.b1 = static_cast<const float*>(b1);
  p.k2 = static_cast<const float*>(k2);
  p.b2 = static_cast<const float*>(b2);
  p.k3 = static_cast<const float*>(k3);
  p.b3 = static_cast<const float*>(b3);
  p.kx = kx;
  p.out = out;
  p.H = H;
  p.W = W;
  p.Cin = C;
  p.M = M;
  p.Cout = C;
  p.TR = TR;
  if (!ig::takes(p, B, 1, false)) return static_cast<int>(cudaErrorInvalidValue);
  return ig::launch<ig::S8, false>(p, B, stream);
}
