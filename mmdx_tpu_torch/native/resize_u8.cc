// Bit-exact Pillow BILINEAR (antialias) uint8 resize — serving hot path.
//
// The serving request handler resizes every upload shorter-side->256 before
// it crosses the host->device boundary (reference preprocessing stage 1,
// reference backend/ml/pipelines/training_pipeline.py:112-119). PIL costs
// ~1.4 ms per 512x512 image on the serving host; under closed-loop load the
// whole released cohort re-traverses the handler serially on one core, so
// this sits directly on the serving cycle. This implementation replicates
// Pillow's separable fixed-point resample (src/libImaging/Resample.c,
// precompute_coeffs + normalize_coeffs_8bpc + clip8) exactly — same int
// coefficients, same uint8 rounding between the horizontal and vertical
// passes — and is verified bit-for-bit against both PIL and the Python
// replica ops/resize.resize_u8_exact (tests/test_native_resize.py).
#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow 8bpc fixed point (22)
constexpr int64_t kHalf = int64_t{1} << (kPrecisionBits - 1);

struct Coeffs {
  std::vector<int> xmin;   // first input tap per output index
  std::vector<int> count;  // taps per output index
  std::vector<int64_t> w;  // fixed-point weights, kmax per output index
  int kmax = 0;
};

// Pillow precompute_coeffs + normalize_coeffs_8bpc for the triangle filter.
Coeffs make_coeffs(int in_size, int out_size) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // bilinear support == 1.0
  const double ss = 1.0 / filterscale;

  Coeffs c;
  c.kmax = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.xmin.resize(out_size);
  c.count.resize(out_size);
  c.w.assign(static_cast<size_t>(out_size) * c.kmax, 0);
  std::vector<double> wf(c.kmax);

  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int n = xmax - xmin;
    double tot = 0.0;
    for (int i = 0; i < n; ++i) {
      const double x = (i + xmin - center + 0.5) * ss;
      const double ax = std::fabs(x);
      wf[i] = ax < 1.0 ? 1.0 - ax : 0.0;
      tot += wf[i];
    }
    if (tot != 0.0) {
      for (int i = 0; i < n; ++i) wf[i] /= tot;
    }
    c.xmin[xx] = xmin;
    c.count[xx] = n;
    int64_t* row = &c.w[static_cast<size_t>(xx) * c.kmax];
    for (int i = 0; i < n; ++i) {
      const double scaled = wf[i] * (1 << kPrecisionBits);
      // Pillow: round half away from zero via trunc(x +/- 0.5)
      row[i] = static_cast<int64_t>(
          scaled < 0 ? std::ceil(scaled - 0.5) : std::floor(scaled + 0.5));
    }
  }
  return c;
}

inline uint8_t clip8(int64_t acc) {
  constexpr int64_t hi = int64_t{255} << kPrecisionBits;
  if (acc <= 0) return 0;
  if (acc >= (int64_t{1} << (kPrecisionBits + 8))) return 255;
  if (acc >= hi) return static_cast<uint8_t>(hi >> kPrecisionBits);
  return static_cast<uint8_t>(acc >> kPrecisionBits);
}

// One separable pass along the width of [rows, in_w, ch] -> [rows, out_w, ch].
void pass_horizontal(const uint8_t* src, int rows, int in_w, int ch,
                     uint8_t* dst, int out_w, const Coeffs& c) {
  for (int r = 0; r < rows; ++r) {
    const uint8_t* srow = src + static_cast<size_t>(r) * in_w * ch;
    uint8_t* drow = dst + static_cast<size_t>(r) * out_w * ch;
    for (int x = 0; x < out_w; ++x) {
      const int64_t* w = &c.w[static_cast<size_t>(x) * c.kmax];
      const uint8_t* s = srow + static_cast<size_t>(c.xmin[x]) * ch;
      for (int k = 0; k < ch; ++k) {
        int64_t acc = kHalf;
        const uint8_t* sp = s + k;
        for (int i = 0; i < c.count[x]; ++i) acc += w[i] * sp[i * ch];
        drow[static_cast<size_t>(x) * ch + k] = clip8(acc);
      }
    }
  }
}

// Vertical pass of [in_h, cols*ch] -> [out_h, cols*ch] (contiguous rows).
// Tap-outer loop over contiguous int32 accumulators so the compiler can
// vectorize the element axis (the weights fit int32: |w| <= ~2^22, and
// w * 255 sums stay well under 2^31 for the normalized triangle filter).
void pass_vertical(const uint8_t* src, int in_h, int row_elems,
                   uint8_t* dst, int out_h, const Coeffs& c) {
  std::vector<int32_t> acc(row_elems);
  for (int y = 0; y < out_h; ++y) {
    const int64_t* w = &c.w[static_cast<size_t>(y) * c.kmax];
    const uint8_t* s0 = src + static_cast<size_t>(c.xmin[y]) * row_elems;
    uint8_t* drow = dst + static_cast<size_t>(y) * row_elems;
    const int n = c.count[y];
    std::fill(acc.begin(), acc.end(), static_cast<int32_t>(kHalf));
    for (int i = 0; i < n; ++i) {
      const int32_t wi = static_cast<int32_t>(w[i]);
      const uint8_t* srow = s0 + static_cast<size_t>(i) * row_elems;
      int32_t* a = acc.data();
      for (int e = 0; e < row_elems; ++e) a[e] += wi * srow[e];
    }
    for (int e = 0; e < row_elems; ++e) drow[e] = clip8(acc[e]);
  }
}

}  // namespace

extern "C" {

// src: uint8 [h, w, ch] (ch 1..4); dst: uint8 [out_h, out_w, ch].
// Horizontal pass first with a uint8 intermediate, then vertical —
// exactly PIL.Image.resize((out_w, out_h), BILINEAR). Returns 0 on success.
int mmdx_resize_u8(const uint8_t* src, int h, int w, int ch,
                   uint8_t* dst, int out_h, int out_w) {
  if (h <= 0 || w <= 0 || ch <= 0 || ch > 4 || out_h <= 0 || out_w <= 0)
    return 1;
  const uint8_t* cur = src;
  std::vector<uint8_t> tmp;
  if (w != out_w) {
    const Coeffs cw = make_coeffs(w, out_w);
    if (h != out_h) {
      tmp.resize(static_cast<size_t>(h) * out_w * ch);
      pass_horizontal(cur, h, w, ch, tmp.data(), out_w, cw);
      cur = tmp.data();
    } else {
      pass_horizontal(cur, h, w, ch, dst, out_w, cw);
      return 0;
    }
  }
  if (h != out_h) {
    const Coeffs chc = make_coeffs(h, out_h);
    pass_vertical(cur, h, out_w * ch, dst, out_h, chc);
    return 0;
  }
  std::memcpy(dst, cur, static_cast<size_t>(out_h) * out_w * ch);
  return 0;
}

}  // extern "C"
