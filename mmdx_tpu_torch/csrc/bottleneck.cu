// Fused stride-1 ResNet bottleneck with folded BatchNorm (ops/bottleneck.py).
//
// Replaces mmdx_tpu/ops/pallas_bottleneck.py:fused_bottleneck: for NHWC x
// [B, H, W, Cin] in bf16 or f32 (T),
//   x1  = T(relu(x @ w1 + b1))                                   [.., M]
//   acc = b2 + sum over the nine taps of (tap(x1) @ w2[tap])     f32
//   x2  = T(relu(acc))                                           [.., M]
//   out = T(relu(x2 @ w3 + b3 + shortcut))                       [.., Cout]
// shortcut = x (identity, Cin == Cout) or x @ wp + bp (projection), with the
// Pallas body's rounding points: every product summed in f32 (each tap's
// product summed on its own, then added to acc), the biases f32, x1 and x2
// rounded to T, zero padding at the image edges.
//
// bf16 (mmdx_bottleneck_tc): the implicit GEMM of csrc/implicit_gemm.cuh on
// the tensor cores (mma.sync m16n8k16, f32 accumulators, a second set for
// the tap being summed and for the projection), weights K-major and streamed
// through a cp.async ring. What bounds it on the H100: at stage 1 block 0
// (56x56, Cin 64, M 64, Cout 256, projection) and B=32 the block is ~15
// GFLOP against ~51 MB of bf16 input and output: 0.015 ms of bytes and of
// bf16 tensor-core operations each; the halo rows' conv1 (TR+2 rows for TR)
// and the weights read from L2 once per band and pass of rows add to that.
//
// f32 (mmdx_bottleneck, kept from the first port): TF32 would change the
// numbers, so it stays on the CUDA cores. One block of 256 threads per
// (image, band of TR output rows); conv1 is recomputed for the band and its
// two halo rows into a zero-bordered shared tile x1 [(TR+2)][(W+2)][M]; conv2
// reads the nine taps of that tile into x2 [TR*W][M]; conv3 and the shortcut
// read x2 and x and write the band's outputs once. Each thread owns 4 pixels
// x 4 output channels and accumulates with f32 FMAs over eight input
// channels at a time; it is bound by the f32 rate (67 TFLOP/s).
#include "common.cuh"
#include "implicit_gemm.cuh"

namespace {

constexpr int BN_THREADS = 256;

struct BlockParams {
  const void* x;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  const void* w3;
  const float* b3;
  const void* wp;  // null: identity shortcut
  const float* bp;
  void* out;
  int H, W, Cin, M, Cout, TR;
};

// acc[q][j] += sum_{u<8} a[q][u] * w[(k+u)*ldw + n0 + j]
template <typename T>
__device__ __forceinline__ void mac8(const float (&a)[4][8], const T* __restrict__ w,
                                     int ldw, int n0, float (&acc)[4][4]) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float wv[4];
    load4(w + (size_t)u * ldw + n0, wv);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][j] = fmaf(a[q][u], wv[j], acc[q][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(BN_THREADS) bottleneck_kernel(BlockParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, W = p.W, Cin = p.Cin, M = p.M, Cout = p.Cout, TR = p.TR;
  const int Wp = W + 2;
  T* x1 = reinterpret_cast<T*>(smem);      // [(TR+2)][Wp][M], zero border
  T* x2 = x1 + (size_t)(TR + 2) * Wp * M;  // [TR*W][M]
  const int b = blockIdx.y, r0 = blockIdx.x * TR;
  const int tid = threadIdx.x;
  const T* xb = static_cast<const T*>(p.x) + (size_t)b * H * W * Cin;
  const T* w1 = static_cast<const T*>(p.w1);
  const T* w2 = static_cast<const T*>(p.w2);
  const T* w3 = static_cast<const T*>(p.w3);
  const T* wp = static_cast<const T*>(p.wp);

  const int x1_words = (TR + 2) * Wp * M * (int)sizeof(T) / 4;
  for (int i = tid; i < x1_words; i += BN_THREADS) reinterpret_cast<int*>(x1)[i] = 0;
  __syncthreads();

  // ---- conv1 over the band and its halo rows -> x1 ----
  const int nq1 = M / 4;
  const int px1 = (TR + 2) * W;
  for (int item = tid; item < ((px1 + 3) / 4) * nq1; item += BN_THREADS) {
    const int n0 = (item % nq1) * 4, g = (item / nq1) * 4;
    float acc[4][4] = {};
    const T* xr[4];
    bool live[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pix = min(g + q, px1 - 1);
      const int row = r0 - 1 + pix / W;
      live[q] = g + q < px1 && row >= 0 && row < H;
      xr[q] = xb + ((size_t)min(max(row, 0), H - 1) * W + pix % W) * Cin;
    }
    for (int k = 0; k < Cin; k += 8) {
      float a[4][8];
#pragma unroll
      for (int q = 0; q < 4; ++q) load8(xr[q] + k, a[q]);
      mac8(a, w1 + (size_t)k * M, M, n0, acc);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!live[q]) continue;  // rows outside the image stay zero
      const int pix = g + q, rr = pix / W, c = pix % W;
      T* dst = x1 + ((size_t)rr * Wp + c + 1) * M + n0;
#pragma unroll
      for (int j = 0; j < 4; ++j) store_f(dst + j, fmaxf(acc[q][j] + p.b1[n0 + j], 0.0f));
    }
  }
  __syncthreads();

  // ---- conv2: acc = b2, plus each tap's own f32 sum -> x2 ----
  const int rows_here = min(TR, H - r0);
  const int px2 = rows_here * W;
  for (int item = tid; item < ((px2 + 3) / 4) * nq1; item += BN_THREADS) {
    const int n0 = (item % nq1) * 4, g = (item / nq1) * 4;
    float acc[4][4];
    int base[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pix = min(g + q, px2 - 1);
      base[q] = ((pix / W) * Wp + pix % W) * M;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][j] = p.b2[n0 + j];
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int off = ((tap / 3) * Wp + tap % 3) * M;
      const T* wt = w2 + (size_t)tap * M * M;
      float t[4][4] = {};
      for (int k = 0; k < M; k += 8) {
        float a[4][8];
#pragma unroll
        for (int q = 0; q < 4; ++q) load8(x1 + base[q] + off + k, a[q]);
        mac8(a, wt + (size_t)k * M, M, n0, t);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[q][j] += t[q][j];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (g + q >= px2) continue;
      T* dst = x2 + (size_t)(g + q) * M + n0;
#pragma unroll
      for (int j = 0; j < 4; ++j) store_f(dst + j, fmaxf(acc[q][j], 0.0f));
    }
  }
  __syncthreads();

  // ---- conv3 + shortcut + ReLU -> out ----
  const int nq3 = Cout / 4;
  T* out = static_cast<T*>(p.out);
  for (int item = tid; item < ((px2 + 3) / 4) * nq3; item += BN_THREADS) {
    const int n0 = (item % nq3) * 4, g = (item / nq3) * 4;
    float y[4][4] = {}, sc[4][4] = {};
    const T* xr[4];
    int src[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pix = min(g + q, px2 - 1);
      src[q] = pix * M;
      xr[q] = xb + ((size_t)r0 * W + pix) * Cin;
    }
    for (int k = 0; k < M; k += 8) {
      float a[4][8];
#pragma unroll
      for (int q = 0; q < 4; ++q) load8(x2 + src[q] + k, a[q]);
      mac8(a, w3 + (size_t)k * Cout, Cout, n0, y);
    }
    if (wp != nullptr) {
      for (int k = 0; k < Cin; k += 8) {
        float a[4][8];
#pragma unroll
        for (int q = 0; q < 4; ++q) load8(xr[q] + k, a[q]);
        mac8(a, wp + (size_t)k * Cout, Cout, n0, sc);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (g + q >= px2) continue;
      float xs[4];
      load4(xr[q] + n0, xs);  // identity shortcut (Cin == Cout)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float yy = y[q][j] + p.b3[n0 + j];
        const float s = wp != nullptr ? sc[q][j] + p.bp[n0 + j] : xs[j];
        store_f(out + ((size_t)b * H * W + (size_t)r0 * W + g + q) * Cout + n0 + j,
               fmaxf(yy + s, 0.0f));
      }
    }
  }
}

template <typename T>
int launch_bottleneck(const BlockParams& p, int B, void* stream) {
  const size_t smem =
      ((size_t)(p.TR + 2) * (p.W + 2) * p.M + (size_t)p.TR * p.W * p.M) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.H + p.TR - 1) / p.TR, B);
  bottleneck_kernel<T><<<grid, BN_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return launch_status();
}

}  // namespace

// x, out [B, H, W, Cin|Cout] f32; w1 [Cin, M], w2 [3, 3, M, M] (HWIO), w3
// [M, Cout], wp [Cin, Cout] or null, all f32 row-major; b1, b2 [M], b3, bp
// [Cout] f32; TR output rows per block. Cin, M, Cout multiples of 8; with wp
// null, Cin == Cout.
MMDX_EXPORT int mmdx_bottleneck(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* w3,
                                const void* b3, const void* wp, const void* bp, void* out,
                                int B, int H, int W, int Cin, int M, int Cout, int TR,
                                void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || TR <= 0 || Cin % 8 || M % 8 || Cout % 8 ||
      (wp == nullptr && Cin != Cout))
    return static_cast<int>(cudaErrorInvalidValue);
  BlockParams p{x, w1, static_cast<const float*>(b1), w2, static_cast<const float*>(b2),
                w3, static_cast<const float*>(b3), wp, static_cast<const float*>(bp), out,
                H, W, Cin, M, Cout, TR};
  return launch_bottleneck<float>(p, B, stream);
}

// x, out [B, H, W, Cin|Cout] bf16; w1 [M][ld1], w2 [M][ld2] (K = 9M in (ky,
// kx, ci) order), w3 [Cout][ld3], wp [Cout][ldp] or null: bf16, K-major (K
// contiguous in each row); b1, b2 [M], b3, bp [Cout] f32; TR output rows per
// block. Cin, M, Cout multiples of 64; with wp null, Cin == Cout.
MMDX_EXPORT int mmdx_bottleneck_tc(const void* x, const void* w1, long long ld1,
                                   const void* b1, const void* w2, long long ld2,
                                   const void* b2, const void* w3, long long ld3,
                                   const void* b3, const void* wp, long long ldp,
                                   const void* bp, void* out, int B, int H, int W, int Cin,
                                   int M, int Cout, int TR, void* stream) {
  ig::Params p{};
  p.x = x;
  p.w1 = w1;
  p.w2 = w2;
  p.w3 = w3;
  p.wp = wp;
  p.ld1 = ld1;
  p.ld2 = ld2;
  p.ld3 = ld3;
  p.ldp = ldp;
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.b3 = static_cast<const float*>(b3);
  p.bp = static_cast<const float*>(bp);
  p.out = out;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.M = M;
  p.Cout = Cout;
  p.TR = TR;
  const bool proj = wp != nullptr;
  if (!ig::takes(p, B, 2, proj)) return static_cast<int>(cudaErrorInvalidValue);
  return proj ? ig::launch<ig::Bf16, true>(p, B, stream)
              : ig::launch<ig::Bf16, false>(p, B, stream);
}
