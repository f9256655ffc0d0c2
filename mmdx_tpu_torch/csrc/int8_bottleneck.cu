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
// Design: one block of 256 threads per (image, band of TR output rows); all
// three convs run in the block. conv1 is recomputed for the band and its
// two halo rows into a zero-bordered shared tile a1 [(TR+2)][(W+2)][M] (the
// border is the 3x3 conv's SAME padding); conv2 is an implicit GEMM over
// the nine taps of that tile into a2 [TR*W][M] in shared memory; conv3, the
// identity shortcut and the final requant read a2 and write the band's
// outputs. x is read from device memory for conv1 and the shortcut, and the
// block's output is written once: a1 and a2 never leave the SM. Each thread
// owns 4 pixels x 4 output channels and accumulates with __dp4a over four
// input channels at a time; the four weight words of a 4x4 s8 patch are
// transposed in registers (__byte_perm) so the weights keep their [K, N]
// layout.
//
// What bounds it on the H100: at stage 1 (56x56, C 256, M 64) and B=32 the
// block is 14.8 GOP of int8 products against 51 MB of s8 input and output:
// 0.015 ms of bytes, 0.0075 ms of int8 tensor-core operations. This version
// runs the products on the CUDA cores (dp4a), a fraction of the tensor-core
// rate, so it is bound by operations far above that floor; a wmma/wgmma
// implicit GEMM is the later step.
#include "common.cuh"

namespace {

constexpr int IB_THREADS = 256;

struct Int8BlockParams {
  const int8_t* x;
  const int8_t* w1;
  const float* k1;
  const float* b1;
  const int8_t* w2;
  const float* k2;
  const float* b2;
  const int8_t* w3;
  const float* k3;
  const float* b3;
  float kx;
  int8_t* out;
  int H, W, C, M, TR;
};

__device__ __forceinline__ int8_t requant(float y) {
  const float r = rintf(y);
  return static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
}

// relu(acc * k + b), in the Pallas body's order
__device__ __forceinline__ float epi(int acc, float k, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), k), b), 0.0f);
}

// rows r0..r3 hold w[k+i][n0..n0+3]; -> col[j] = (w[k][n0+j], .., w[k+3][n0+j])
__device__ __forceinline__ void transpose4x4(const int (&r)[4], int (&col)[4]) {
  const int t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const int t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410);
  col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410);
  col[3] = __byte_perm(t1, t3, 0x7632);
}

// acc[p][j] += a_p[k..k+3] . w[k..k+3][n0+j] for one k quad
__device__ __forceinline__ void mac_quad(const int (&a)[4], const int8_t* __restrict__ w,
                                         int ldw, int n0, int (&acc)[4][4]) {
  int rows[4], col[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rows[i] = __ldg(reinterpret_cast<const int*>(w + i * ldw + n0));
  transpose4x4(rows, col);
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = __dp4a(a[p], col[j], acc[p][j]);
}

__global__ void __launch_bounds__(IB_THREADS) int8_bottleneck_kernel(Int8BlockParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, W = p.W, C = p.C, M = p.M, TR = p.TR;
  const int Wp = W + 2;
  int8_t* a1 = reinterpret_cast<int8_t*>(smem);  // [(TR+2)][Wp][M], zero border
  int8_t* a2 = a1 + (size_t)(TR + 2) * Wp * M;    // [TR*W][M]
  const int b = blockIdx.y, r0 = blockIdx.x * TR;
  const int tid = threadIdx.x;
  const int8_t* xb = p.x + (size_t)b * H * W * C;

  const int a1_words = (TR + 2) * Wp * M / 4;
  for (int i = tid; i < a1_words; i += IB_THREADS) reinterpret_cast<int*>(a1)[i] = 0;
  __syncthreads();

  // ---- conv1 over the band and its halo rows -> a1 ----
  const int nq1 = M / 4;
  const int px1 = (TR + 2) * W;
  for (int item = tid; item < ((px1 + 3) / 4) * nq1; item += IB_THREADS) {
    const int n0 = (item % nq1) * 4, g = (item / nq1) * 4;
    int acc[4][4] = {};
    const int8_t* xr[4];
    bool live[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pix = min(g + q, px1 - 1);
      const int row = r0 - 1 + pix / W;
      live[q] = g + q < px1 && row >= 0 && row < H;
      xr[q] = xb + ((size_t)min(max(row, 0), H - 1) * W + pix % W) * C;
    }
    for (int k = 0; k < C; k += 4) {
      int a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = *reinterpret_cast<const int*>(xr[q] + k);
      mac_quad(a, p.w1 + (size_t)k * M, M, n0, acc);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!live[q]) continue;  // rows outside the image stay zero
      const int pix = g + q, rr = pix / W, c = pix % W;
      int8_t* dst = a1 + ((size_t)rr * Wp + c + 1) * M + n0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[j] = requant(epi(acc[q][j], p.k1[n0 + j], p.b1[n0 + j]));
    }
  }
  __syncthreads();

  // ---- conv2: the nine taps of a1 as one K = 9M product -> a2 ----
  const int rows_here = min(TR, H - r0);
  const int px2 = rows_here * W;
  for (int item = tid; item < ((px2 + 3) / 4) * nq1; item += IB_THREADS) {
    const int n0 = (item % nq1) * 4, g = (item / nq1) * 4;
    int acc[4][4] = {};
    int base[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pix = min(g + q, px2 - 1);
      base[q] = ((pix / W) * Wp + pix % W) * M;  // tap (0, 0) of the halo tile
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int off = ((tap / 3) * Wp + tap % 3) * M;
      const int8_t* wt = p.w2 + (size_t)tap * M * M;
      for (int k = 0; k < M; k += 4) {
        int a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q] = *reinterpret_cast<const int*>(a1 + base[q] + off + k);
        mac_quad(a, wt + (size_t)k * M, M, n0, acc);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (g + q >= px2) continue;
      int8_t* dst = a2 + (size_t)(g + q) * M + n0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[j] = requant(epi(acc[q][j], p.k2[n0 + j], p.b2[n0 + j]));
    }
  }
  __syncthreads();

  // ---- conv3 + identity shortcut + final requant -> out ----
  const int nq3 = C / 4;
  for (int item = tid; item < ((px2 + 3) / 4) * nq3; item += IB_THREADS) {
    const int n0 = (item % nq3) * 4, g = (item / nq3) * 4;
    int acc[4][4] = {};
    int src[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) src[q] = min(g + q, px2 - 1) * M;
    for (int k = 0; k < M; k += 4) {
      int a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = *reinterpret_cast<const int*>(a2 + src[q] + k);
      mac_quad(a, p.w3 + (size_t)k * C, C, n0, acc);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (g + q >= px2) continue;
      const size_t o = ((size_t)b * H * W + (size_t)r0 * W + g + q) * C + n0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[q][j]), p.k3[n0 + j]), p.b3[n0 + j]);
        y = __fadd_rn(y, __fmul_rn(static_cast<float>(p.x[o + j]), p.kx));
        p.out[o + j] = requant(fmaxf(y, 0.0f));
      }
    }
  }
}

}  // namespace

// x, out s8 [B, H, W, C]; w1 s8 [C, M]; w2 s8 [9M, M] (ky, kx, ci tap-major);
// w3 s8 [M, C]; k1, b1, k2, b2 f32 [M]; k3, b3 f32 [C]; kx f32; TR output
// rows per block. C and M multiples of 4.
MMDX_EXPORT int mmdx_int8_bottleneck(const void* x, const void* w1, const void* k1,
                                     const void* b1, const void* w2, const void* k2,
                                     const void* b2, const void* w3, const void* k3,
                                     const void* b3, float kx, void* out, int B, int H,
                                     int W, int C, int M, int TR, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || TR <= 0 || C % 4 || M % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)(TR + 2) * (W + 2) * M + (size_t)TR * W * M;
  cudaError_t err = cudaFuncSetAttribute(
      int8_bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Int8BlockParams p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1),
                    static_cast<const float*>(k1), static_cast<const float*>(b1),
                    static_cast<const int8_t*>(w2), static_cast<const float*>(k2),
                    static_cast<const float*>(b2), static_cast<const int8_t*>(w3),
                    static_cast<const float*>(k3), static_cast<const float*>(b3), kx,
                    static_cast<int8_t*>(out), H, W, C, M, TR};
  const dim3 grid((H + TR - 1) / TR, B);
  int8_bottleneck_kernel<<<grid, IB_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return launch_status();
}
