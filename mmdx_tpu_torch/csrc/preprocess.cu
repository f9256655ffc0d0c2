// Fused image preprocessing: u8 -> resize -> center crop -> normalize
// (ops/preprocess.py preprocess_batch_fused).
//
// Replaces mmdx_tpu/ops/pallas_preprocess.py:preprocess_batch_pallas
// (_preproc_kernel): per image and output channel,
//   tmp = kh @ f32(img)                 [crop, W]
//   out = (tmp @ kw^T) * scale - shift  [crop, crop]
// with kh [crop, H] and kw [crop, W] the fused resize + crop matrices of
// ops/resize.py; a 1-channel image feeds its plane to all three outputs.
// Products are f32 FMAs on the CUDA cores (no TF32); the epilogue is a
// multiply then a subtract (__fmul_rn, __fsub_rn), as the Pallas body.
//
// Design: one block of 256 threads per (band of TRo output rows, output
// channel, image). The [TRo, W] slice of tmp, which the XLA path writes to
// device memory between its two passes, stays in shared memory (a whole
// [224, W] f32 plane does not fit the 227 KB a block may use at W = 512).
// Each row of kh and kw is a narrow band of nonzero coefficients (the
// bilinear filter's support); the wrapper passes each row's [lo, hi) and the
// sums run over that band only. The skipped terms are exact zeros, so each
// value is the dense product's sum of the same nonzero terms.
//
// What bounds it on the H100: bytes. At B=32 and 512x512x3 u8 inputs it reads
// 25 MB and writes 19 MB of f32 (~0.013 ms at 3.35 TB/s); the banded sums are
// a few hundred MFLOP of f32 FMAs. The image bytes are read with 1-byte
// loads, three times for a gray image, and tmp is recomputed per output
// channel.
#include "common.cuh"

namespace {

constexpr int PP_THREADS = 256;

struct PreprocParams {
  const uint8_t* img;
  const float* kh;
  const float* kw;
  const int* hlo;
  const int* hhi;
  const int* wlo;
  const int* whi;
  const float* scale;
  const float* shift;
  float* out;
  int H, W, C, crop, TRo, w0, w1;
};

__global__ void __launch_bounds__(PP_THREADS) preprocess_kernel(PreprocParams p) {
  extern __shared__ __align__(16) float tmp[];  // [TRo][w1 - w0]
  const int r0 = blockIdx.x * p.TRo, c = blockIdx.y, b = blockIdx.z;
  const int cin = p.C == 1 ? 0 : c;
  const int rows = min(p.TRo, p.crop - r0), span = p.w1 - p.w0;
  const uint8_t* img = p.img + (size_t)b * p.H * p.W * p.C + cin;

  for (int i = 0; i < rows; ++i) {
    const int r = r0 + i, lo = p.hlo[r], hi = p.hhi[r];
    const float* khr = p.kh + (size_t)r * p.H;
    for (int w = p.w0 + threadIdx.x; w < p.w1; w += PP_THREADS) {
      float s = 0.0f;
      for (int h = lo; h < hi; ++h)
        s = fmaf(khr[h], static_cast<float>(img[((size_t)h * p.W + w) * p.C]), s);
      tmp[i * span + w - p.w0] = s;
    }
  }
  __syncthreads();

  const float sc = p.scale[c], sh = p.shift[c];
  for (int e = threadIdx.x; e < rows * p.crop; e += PP_THREADS) {
    const int i = e / p.crop, o = e % p.crop;
    const float* kwr = p.kw + (size_t)o * p.W;
    float s = 0.0f;
    for (int w = p.wlo[o]; w < p.whi[o]; ++w) s = fmaf(tmp[i * span + w - p.w0], kwr[w], s);
    p.out[(((size_t)b * p.crop + r0 + i) * p.crop + o) * 3 + c] =
        __fsub_rn(__fmul_rn(s, sc), sh);
  }
}

}  // namespace

// img u8 [B, H, W, C] (C 1 or 3); kh f32 [crop, H]; kw f32 [crop, W]; the
// nonzero band [lo, hi) of each row of kh (hlo, hhi) and kw (wlo, whi), int32
// [crop]; w0, w1 the columns any kw band reads; scale, shift f32 [3]; out f32
// [B, crop, crop, 3]; TRo output rows per block.
MMDX_EXPORT int mmdx_preprocess(const void* img, const void* kh, const void* kw,
                                const void* hlo, const void* hhi, const void* wlo,
                                const void* whi, const void* scale, const void* shift,
                                void* out, int B, int H, int W, int C, int crop, int TRo,
                                int w0, int w1, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || crop <= 0 || TRo <= 0 || (C != 1 && C != 3) ||
      w0 < 0 || w1 < w0 || w1 > W)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)TRo * (w1 - w0) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      preprocess_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  PreprocParams p{static_cast<const uint8_t*>(img), static_cast<const float*>(kh),
                  static_cast<const float*>(kw), static_cast<const int*>(hlo),
                  static_cast<const int*>(hhi), static_cast<const int*>(wlo),
                  static_cast<const int*>(whi), static_cast<const float*>(scale),
                  static_cast<const float*>(shift), static_cast<float*>(out),
                  H, W, C, crop, TRo, w0, w1};
  const dim3 grid((crop + TRo - 1) / TRo, 3, B);
  preprocess_kernel<<<grid, PP_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return launch_status();
}
