// Fused image preprocessing: u8 -> resize -> center crop -> normalize
// (ops/preprocess.py preprocess_batch_fused).
//
// Replaces mmdx_tpu/ops/pallas_preprocess.py:preprocess_batch_pallas
// (_preproc_kernel): per image and output channel,
//   tmp = kh @ f32(img)                 [crop, W]
//   out = (tmp @ kw^T) * scale - shift  [crop, crop]
// with kh [crop, H] and kw [crop, W] the fused resize + crop matrices of
// ops/resize.py; a 1-channel image feeds its plane to all three outputs.
// The kernel writes out_dtype (f32 or bf16) itself, as the Pallas kernel
// does.
//
// What bounds it on the H100: bytes. Each row of kh and kw holds 2-5
// nonzero taps at 512 -> 256 (at most 9 at a 4x downscale), so the work is
// a few FMAs per output and dense tensor-core products would spend almost
// all of theirs on zeros. At B=32, 512x512x3 u8 in and f32 out the
// function needs 19.4 MB in (the 450 x 450 pixels the taps touch) and
// 19.3 MB out: 11.6 us at 3.35 TB/s. The design moves each byte once
// (apart from the columns outside the taps of the whole rows it stages)
// and keeps the instructions per output few:
//
// * kh and kw come as tap tables (ops/preprocess.py tap_tables): per row a
//   start column and T coefficients, zero-padded to the widest row, built
//   once on the host and cached on the device. Each sum is an fmaf chain
//   from 0 over the row's taps in increasing index order: the terms of the
//   dense product that are not exact zeros, in order, plus exact-zero
//   terms, which leave an FMA chain unchanged.
// * Work items are (band of TRo output rows, image), all channels at once:
//   a 1-channel image is row- and column-summed once and its three outputs
//   take each channel's scale and shift. A persistent grid of three or
//   four blocks an SM walks the items; a block stages the next item's input
//   rows (the whole NHWC rows its kh taps touch, contiguous in memory) into
//   the other of two buffers with 16-byte cp.async copies while it sums the
//   current one.
// * The row pass writes the band's [TRo, span x C] f32 slice (span: the
//   columns any kw row reads) to shared memory: a thread sums four
//   consecutive bytes of a slice row at once (one 32-bit load a tap where
//   the NHWC rows are 4-byte aligned, the bytes made exact floats by a byte
//   permute and a subtract) and stores the four sums in one 16-byte store,
//   two such quads in flight a thread.
// * The column pass gives a thread one output pixel, its kw taps in
//   registers, over every row of the band; its outputs go in out_dtype into
//   the consumed staging buffer, and the band's rows of output, contiguous
//   in memory, leave in 16-byte stores.
// * TRo is sized from the input width (ops/preprocess.py preprocess_plan):
//   the kernel is built for three and for four blocks an SM (four: at most
//   64 registers a thread), and the plan takes the one whose blocks fit the
//   tallest bands (TRo <= 8), four on a tie: at 512x512x3 four blocks of
//   TRo = 4 (a 22 KB slice, two 15 KB staging buffers), 1792 items over 528
//   blocks at B=32; at 512x512 gray three blocks of TRo = 8.
#include "common.cuh"

namespace {

constexpr int PP_THREADS = 256;
constexpr int PP_LANES = 2;  // row-pass quads a thread sums at once
constexpr int PP_MAX_TAPS = 16;  // ops/preprocess.py MAX_TAPS

struct PreprocParams {
  const uint8_t* img;
  const int* hstart;   // [crop]
  const float* hcoef;  // [crop, Th]
  const int* wstart;   // [crop]
  const float* wcoef;  // [crop, Tw]
  void* out;
  long long img_bytes;
  int B, H, W, C, crop, Th, Tw, w0, span, TRo, bands, io_off, io_bytes;
  float scale[3], shift[3];
};

// Byte k of v as an exact f32 in two ALU operations: 2^23 + byte as bits
// (one byte permute), less 2^23.
__device__ __forceinline__ float byte_to_f32(uint32_t v, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 + k)), 8388608.0f);
}

// The lanes' flat indexes f = tid + l * PP_THREADS + k * PP_LANES * PP_THREADS
// as (row, position in the row) pairs, advanced without divisions.
struct Lanes {
  int i[PP_LANES], q[PP_LANES];
  __device__ __forceinline__ Lanes(int tid, int len) {
#pragma unroll
    for (int l = 0; l < PP_LANES; ++l) {
      i[l] = (tid + l * PP_THREADS) / len;
      q[l] = (tid + l * PP_THREADS) - i[l] * len;
    }
  }
  __device__ __forceinline__ void next(int len) {
#pragma unroll
    for (int l = 0; l < PP_LANES; ++l) {
      q[l] += PP_LANES * PP_THREADS;
      while (q[l] >= len) { q[l] -= len; ++i[l]; }
    }
  }
};

// Four consecutive bytes of a staged row, little-endian: one 32-bit load
// where the rows are 4-byte aligned.
template <bool kWords>
__device__ __forceinline__ uint32_t load_word(const unsigned char* x) {
  if constexpr (kWords) {
    return *reinterpret_cast<const uint32_t*>(x);
  } else {
    return x[0] | x[1] << 8 | x[2] << 16 | static_cast<uint32_t>(x[3]) << 24;
  }
}

// The row pass over one band: a lane sums four consecutive bytes of a slice
// row, tmp[i][4q .. 4q + 3] = sum_t hc[i][t] * in[(hs[i] + t) * row_bytes +
// 4q ..], and stores the four sums in one 16-byte store.
template <bool kWords>
__device__ __forceinline__ void row_pass(const unsigned char* in, const float* hc,
                                         const int* hs, float* tmp, int rows, int quads,
                                         int pitch, int row_bytes, int Th) {
  for (Lanes ln(threadIdx.x, quads); ln.i[0] < rows; ln.next(quads)) {
    const unsigned char* src[PP_LANES];
    const float* cf[PP_LANES];
    float s[PP_LANES][4];
#pragma unroll
    for (int l = 0; l < PP_LANES; ++l) {
      const int i = min(ln.i[l], rows - 1);
      src[l] = in + hs[i] * row_bytes + 4 * ln.q[l];
      cf[l] = hc + i * Th;
#pragma unroll
      for (int k = 0; k < 4; ++k) s[l][k] = 0.0f;
    }
    for (int t = 0; t < Th; ++t) {
#pragma unroll
      for (int l = 0; l < PP_LANES; ++l) {
        const uint32_t v = load_word<kWords>(src[l] + t * row_bytes);
        const float c = cf[l][t];
#pragma unroll
        for (int k = 0; k < 4; ++k) s[l][k] = fmaf(c, byte_to_f32(v, k), s[l][k]);
      }
    }
#pragma unroll
    for (int l = 0; l < PP_LANES; ++l)
      if (ln.i[l] < rows)
        *reinterpret_cast<float4*>(tmp + ln.i[l] * pitch + 4 * ln.q[l]) =
            make_float4(s[l][0], s[l][1], s[l][2], s[l][3]);
  }
}

struct Band {
  int b, r0, rows;
};

__device__ __forceinline__ Band band_of(const PreprocParams& p, int item) {
  Band band;
  band.b = item / p.bands;
  band.r0 = (item - band.b * p.bands) * p.TRo;
  band.rows = min(p.TRo, p.crop - band.r0);
  return band;
}

// Issue the cp.async copies of a band's input rows (the whole NHWC rows its
// kh taps touch, contiguous in memory) into buf and stage its kh taps into
// hc, hs (starts relative to the first staged row). -> the offset in buf of
// the first staged row.
__device__ __forceinline__ int stage_band(const PreprocParams& p, const Band& band,
                                          unsigned char* buf, float* hc, int* hs) {
  const int tid = threadIdx.x;
  int hr0 = p.H, hr1 = 0;
  for (int i = 0; i < band.rows; ++i) {
    const int s = __ldg(p.hstart + band.r0 + i);
    hr0 = min(hr0, s);
    hr1 = max(hr1, s + p.Th);
  }
  const long long row_bytes = (long long)p.W * p.C;
  const long long g0 = ((long long)band.b * p.H + hr0) * row_bytes;
  const long long g1 = ((long long)band.b * p.H + hr1) * row_bytes;  // <= img_bytes
  const long long a0 = g0 & ~15LL;
  const int chunks = static_cast<int>((g1 - a0 + 15) >> 4);
  for (int k = tid; k < chunks; k += PP_THREADS) {
    const long long g = a0 + 16LL * k;
    if (g + 16 <= p.img_bytes) {
      cp_async16(buf + 16 * k, p.img + g);
    } else {  // the tensor's last bytes, short of a 16-byte vector
      for (int j = 0; j < 16 && g + j < p.img_bytes; ++j) buf[16 * k + j] = p.img[g + j];
    }
  }
  for (int k = tid; k < band.rows * p.Th; k += PP_THREADS)
    hc[k] = __ldg(p.hcoef + band.r0 * p.Th + k);
  for (int k = tid; k < band.rows; k += PP_THREADS) hs[k] = __ldg(p.hstart + band.r0 + k) - hr0;
  return static_cast<int>(g0 - a0);
}

// A persistent block walks the (band, image) items blockIdx.x, + gridDim.x,
// ...: while it sums one band, the next band's rows land in the other of
// two staging buffers.
template <typename OutT, int kBlocks>
__global__ void __launch_bounds__(PP_THREADS, kBlocks) preprocess_kernel(PreprocParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, C = p.C, row_bytes = p.W * C;
  // one row of the slice: span x C values in quads of four, pitch floats
  const int quads = (p.span * C + 3) / 4, pitch = 4 * quads;
  const int orow = p.crop * 3, th = p.TRo * p.Th;
  float* tmp = reinterpret_cast<float*>(smem);                  // [TRo][pitch]
  float* wcoef = tmp + p.TRo * pitch;                           // [crop][Tw]
  int* wstart = reinterpret_cast<int*>(wcoef + p.crop * p.Tw);  // [crop]
  float* hcoef = reinterpret_cast<float*>(wstart + p.crop);     // [2][TRo][Th]
  int* hstart = reinterpret_cast<int*>(hcoef + 2 * th);         // [2][TRo]
  unsigned char* io = smem + p.io_off;  // [2][io_bytes]: staged rows, then output

  for (int k = tid; k < p.crop * p.Tw; k += PP_THREADS) wcoef[k] = __ldg(p.wcoef + k);
  for (int k = tid; k < p.crop; k += PP_THREADS) wstart[k] = __ldg(p.wstart + k) - p.w0;
  const int items = p.B * p.bands;
  int item = blockIdx.x;
  int off = stage_band(p, band_of(p, item), io, hcoef, hstart);
  cp_async_commit();
  for (int cur = 0; item < items; item += static_cast<int>(gridDim.x), cur ^= 1) {
    const Band band = band_of(p, item);
    const int rows = band.rows;
    unsigned char* buf = io + cur * p.io_bytes;
    const int next = item + static_cast<int>(gridDim.x);
    int next_off = 0;
    if (next < items)
      next_off = stage_band(p, band_of(p, next), io + (cur ^ 1) * p.io_bytes,
                            hcoef + (cur ^ 1) * th, hstart + (cur ^ 1) * p.TRo);
    cp_async_commit();
    cp_async_wait<1>();  // this band's rows have landed
    __syncthreads();

    // row pass: tmp[i][j*C + c] = sum_t hcoef[i][t] * img[hstart[i] + t][w0 + j][c]
    {
      const unsigned char* in = buf + off + p.w0 * C;
      const float* hc = hcoef + cur * th;
      const int* hs = hstart + cur * p.TRo;
      if (row_bytes % 4 == 0)
        row_pass<true>(in, hc, hs, tmp, rows, quads, pitch, row_bytes, p.Th);
      else
        row_pass<false>(in, hc, hs, tmp, rows, quads, pitch, row_bytes, p.Th);
    }
    __syncthreads();

    // column pass into the staged rows' space, ostage[i][o*3 + c]: a thread
    // keeps pixel o's kw taps in registers and sums its channels (one sum
    // for a 1-channel slice) in every row of the band
    OutT* ostage = reinterpret_cast<OutT*>(buf);
    for (int o = tid; o < p.crop; o += PP_THREADS) {
      const float* col = tmp + wstart[o] * C;
      float wc[PP_MAX_TAPS];
#pragma unroll
      for (int t = 0; t < PP_MAX_TAPS; ++t) wc[t] = t < p.Tw ? wcoef[o * p.Tw + t] : 0.0f;
      for (int i = 0; i < rows; ++i) {
        const float* src = col + i * pitch;
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
        if (C == 3) {
#pragma unroll
          for (int t = 0; t < PP_MAX_TAPS; ++t) {
            if (t == p.Tw) break;
            s0 = fmaf(src[3 * t], wc[t], s0);
            s1 = fmaf(src[3 * t + 1], wc[t], s1);
            s2 = fmaf(src[3 * t + 2], wc[t], s2);
          }
        } else {
#pragma unroll
          for (int t = 0; t < PP_MAX_TAPS; ++t) {
            if (t == p.Tw) break;
            s0 = fmaf(src[t], wc[t], s0);
          }
          s1 = s2 = s0;
        }
        OutT* dst = ostage + i * orow + 3 * o;
        store_f(dst, __fsub_rn(__fmul_rn(s0, p.scale[0]), p.shift[0]));
        store_f(dst + 1, __fsub_rn(__fmul_rn(s1, p.scale[1]), p.shift[1]));
        store_f(dst + 2, __fsub_rn(__fmul_rn(s2, p.scale[2]), p.shift[2]));
      }
    }
    __syncthreads();

    // the band's rows of output are contiguous: 16-byte stores
    const int vecs = rows * orow * static_cast<int>(sizeof(OutT)) / 16;
    uint4* dst = reinterpret_cast<uint4*>(static_cast<OutT*>(p.out) +
                                          ((long long)band.b * p.crop + band.r0) * orow);
    const uint4* src = reinterpret_cast<const uint4*>(ostage);
    for (int k = tid; k < vecs; k += PP_THREADS) dst[k] = src[k];
    __syncthreads();  // before this buffer takes the band after next
    off = next_off;
  }
}

// the most dynamic shared memory a plan gives a block of kBlocks an SM
// (ops/preprocess.py smem_per_block: 228 KB an SM, 1 KB reserved a block)
constexpr int max_smem(int blocks) { return 228 * 1024 / blocks - 1024; }

// Sets the kernel's attributes once per instantiation, at the most shared
// memory any plan asks for, so that a launch makes no attribute call.
template <typename OutT, int kBlocks>
cudaError_t configure(int smem) {
  static const cudaError_t configured = [] {
    cudaError_t err = cudaFuncSetAttribute(preprocess_kernel<OutT, kBlocks>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           max_smem(kBlocks));
    // three or four blocks an SM need the most shared memory the SM can give
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(preprocess_kernel<OutT, kBlocks>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    return err;
  }();
  return smem > max_smem(kBlocks) ? cudaErrorInvalidValue : configured;
}

template <typename OutT, int kBlocks>
cudaError_t launch(const PreprocParams& p, int grid, int smem, cudaStream_t stream) {
  cudaError_t err = configure<OutT, kBlocks>(smem);
  if (err != cudaSuccess) return err;
  preprocess_kernel<OutT, kBlocks><<<grid, PP_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename OutT, int kBlocks>
cudaError_t occupancy(int smem, int* blocks) {
  cudaError_t err = configure<OutT, kBlocks>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, preprocess_kernel<OutT, kBlocks>, PP_THREADS, smem);
}

}  // namespace

// img u8 [B, H, W, C] (C 1 or 3, 16-byte aligned); the tap tables of kh
// (hstart int32 [crop], hcoef f32 [crop, Th]) and kw (wstart, wcoef [crop,
// Tw]); w0, span: the columns [w0, w0 + span) any kw row reads; out [B,
// crop, crop, 3] f32 or, with out_bf16, bf16 (crop % 8 == 0); TRo output
// rows a band; grid persistent blocks, sized for blocks (3 or 4) an SM;
// io_off, io_bytes, smem: the shared memory layout of ops/preprocess.py
// preprocess_plan; scale, shift: the f32 normalize.
MMDX_EXPORT int mmdx_preprocess(const void* img, const void* hstart, const void* hcoef,
                                const void* wstart, const void* wcoef, void* out, int B,
                                int H, int W, int C, int crop, int Th, int Tw, int w0,
                                int span, int TRo, int blocks, int grid, int io_off,
                                int io_bytes, int smem, int out_bf16, float sc0, float sc1,
                                float sc2, float sh0, float sh1, float sh2, void* stream) {
  const int bands = TRo > 0 ? (crop + TRo - 1) / TRo : 0;
  if (B <= 0 || H <= 0 || W <= 0 || crop <= 0 || crop % 8 || TRo <= 0 || Th <= 0 ||
      Tw <= 0 || Tw > PP_MAX_TAPS || (C != 1 && C != 3) || w0 < 0 || span <= 0 ||
      w0 + span > W || (blocks != 3 && blocks != 4) || grid <= 0 || grid > B * bands ||
      io_off % 16 || io_bytes % 16 || smem < io_off + 2 * io_bytes ||
      reinterpret_cast<uintptr_t>(img) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  PreprocParams p{static_cast<const uint8_t*>(img), static_cast<const int*>(hstart),
                  static_cast<const float*>(hcoef), static_cast<const int*>(wstart),
                  static_cast<const float*>(wcoef), out, (long long)B * H * W * C,
                  B, H, W, C, crop, Th, Tw, w0, span, TRo, bands, io_off, io_bytes,
                  {sc0, sc1, sc2}, {sh0, sh1, sh2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_bf16)
    err = blocks == 3 ? launch<bf16, 3>(p, grid, smem, s) : launch<bf16, 4>(p, grid, smem, s);
  else
    err = blocks == 3 ? launch<float, 3>(p, grid, smem, s) : launch<float, 4>(p, grid, smem, s);
  return static_cast<int>(err);
}

// How many blocks of the kernel built for blocks (3 or 4) an SM an SM holds
// at once with smem bytes of dynamic shared memory (the occupancy
// calculator), into *held.
MMDX_EXPORT int mmdx_preprocess_blocks_per_sm(int smem, int out_bf16, int blocks, void* held) {
  if (blocks != 3 && blocks != 4) return static_cast<int>(cudaErrorInvalidValue);
  int* n = static_cast<int*>(held);
  cudaError_t err;
  if (out_bf16)
    err = blocks == 3 ? occupancy<bf16, 3>(smem, n) : occupancy<bf16, 4>(smem, n);
  else
    err = blocks == 3 ? occupancy<float, 3>(smem, n) : occupancy<float, 4>(smem, n);
  return static_cast<int>(err);
}
