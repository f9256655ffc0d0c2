// The fused stride-1 bottleneck as one implicit GEMM on the tensor cores:
// the skeleton shared by row 12 in bf16 (csrc/bottleneck.cu) and row 13 in
// s8 (csrc/int8_bottleneck.cu), and their epilogues.
//
// A block of 256 threads (8 warps) owns one (image, band of TR output rows)
// and runs the block's three convs as GEMMs whose rows are pixels:
//   conv1  rows: the band and its two halo rows ((TR+2)*W pixels), K = Cin,
//          N = M, A streamed from x; out: the a1 tile in shared memory,
//          [(TR+2)][(W+2)] pixels with a zero border (the 3x3 conv's SAME
//          padding) and zero rows where the halo leaves the image (conv1 of
//          a zero row is relu(b1), not zero, so the mask is on a1, not x);
//   conv2  rows: the band's TR*W pixels, K = 9M: tap t reads the a1 tile
//          shifted by (t/3, t%3), each lane handing ldmatrix its own pixel's
//          row address, so no im2col is formed anywhere; out: the a2 tile;
//          a ring stage holds 3 of its weight slices where N = M is 64 wide;
//   conv3  rows: the band, K = M, A the a2 tile (and for the projection
//          shortcut K = Cin more from x, into a second accumulator); the
//          epilogue adds the shortcut and writes the band's outputs once.
// Every product is mma.sync (m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32): both
// take A and B fragments of the same byte layout, 32 bytes of K a step, so
// one loader and one ldmatrix walk serve both types. A warp owns 32 rows x
// 64 columns; with N a multiple of 128 the 8 warps stand 4 x 2 over 128 rows
// x 128 columns (WN = 2), else 8 x 1 over 256 rows x 64 columns.
//
// The weights are K-major ([N][ld], K contiguous: row 13's qparams "wk", row
// 12's laid out once by models/resnet.py) and stream through a cp.async ring
// (4 stages in s8, 3 in bf16, whose tiles leave no room for a fourth) in
// 64-byte K slices together with conv1's x rows; the a1 / a2 tiles and the
// ring's slots are padded 16 bytes a row so that the 8 row addresses of an
// ldmatrix phase fall in 8 distinct bank groups. Rows past the band, and
// halo rows outside the image, load as zeros (cp.async with src-size 0);
// m16 tiles wholly past the band skip their MMAs. Each 32-byte k-step loads
// all its fragments before its 16 MMAs.
//
// Epilogues load their per-channel vectors (and conv3 its shortcut: in s8
// a tile of x that came through the ring with the pass's last K slice, in
// bf16 read-only loads of x) before any store. conv3 packs each warp's
// 32 x 64 outputs into staging rows in the (then dead) a1 tile and writes
// them 16 bytes a lane, a row's 64 columns contiguous. (Written element by
// element, with vector loads between the stores, the epilogues cost about
// half the kernel.)
//
// Shared memory: a1 (TR+2)(W+2)(M*es+16), at least the staging's 8 x 32
// rows of 64*es+16, + a2 TR*W*(M*es+16) + the ring's stages;
// ops/bottleneck.py:tc_smem_bytes computes the same, and its plan picks TR
// (tc_plan). The ring is cp.async rather than TMA: every slot is a plain
// strided copy and TMA would need a descriptor per weight and per x. What
// bounds it on the H100: bytes (0.008-0.031 ms at the route shapes, B=32);
// what holds it is that loads, MMAs and epilogues take turns in one block of
// 8 warps an SM, beside the halo rows' conv1 ((TR+2)/TR of it), passes of
// rows that end part-filled, and the weights read from L2 once per band and
// pass (a 2-block cluster multicasting them is untried).
#pragma once

#include "common.cuh"

namespace ig {

constexpr int THREADS = 256;              // 8 warps
// cp.async ring depth: 4 stages in s8, 3 in bf16, whose tiles leave room
// for no more at its band heights
__host__ __device__ constexpr int stages_of(int es) { return es == 1 ? 4 : 3; }
constexpr int KS = 64;                    // bytes of K in one ring stage: two MMA k-steps
constexpr int SLOT_PITCH = KS + 16;       // a ring slot's padded row pitch
constexpr int WARP_ROWS = 32;             // two m16 tiles
constexpr int WARP_COLS = 64;             // eight n8 tiles

// conv3's output staging: a warp's 32 rows x 64 columns, rows padded
template <int ES>
constexpr int STAGE_PITCH = WARP_COLS * ES + 16;

__host__ __device__ constexpr int wn_of(int n) { return n % 128 == 0 ? 2 : 1; }
__host__ __device__ constexpr int group_rows(int wn) { return 8 / wn * WARP_ROWS; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// s8 stages conv3's identity shortcut (a pass's x rows, a chunk's columns)
// through the ring's A slot with the pass's last K slice
__host__ __device__ constexpr bool stages_x(int es, bool proj) { return es == 1 && !proj; }
__host__ __device__ constexpr int x_pitch(int wn, int es) { return wn * WARP_COLS * es + 16; }

// the ring's slots: A (x rows) holds the most rows a pass of conv1 (or the
// projection) takes, and in s8 conv3's x tile; B the most weight rows a
// pass covers
__host__ __device__ inline int slot_a_bytes(int M, int Cout, bool proj, int es) {
  const int a1 = group_rows(wn_of(M)) * SLOT_PITCH;
  const int ap = proj ? group_rows(wn_of(Cout)) * SLOT_PITCH : 0;
  const int ax = stages_x(es, proj) ? group_rows(wn_of(Cout)) * x_pitch(wn_of(Cout), es) : 0;
  return a1 > ap ? (a1 > ax ? a1 : ax) : (ap > ax ? ap : ax);
}
__host__ __device__ inline int slot_b_bytes(int M, int Cout) {
  const int w = wn_of(M) > wn_of(Cout) ? wn_of(M) : wn_of(Cout);
  return w * WARP_COLS * SLOT_PITCH;
}
// the a1 tile, which conv3's output staging (8 warps' rows) reuses
__host__ __device__ inline int a1_bytes(int W, int M, int TR, int es) {
  const int tile = (TR + 2) * (W + 2) * (M * es + 16);
  const int stage = THREADS / 32 * WARP_ROWS * (WARP_COLS * es + 16);
  return tile > stage ? tile : stage;
}
inline size_t smem_bytes(int W, int M, int Cout, int TR, int es, bool proj) {
  const size_t pitch = (size_t)M * es + 16;
  return (size_t)a1_bytes(W, M, TR, es) + (size_t)TR * W * pitch +
         (size_t)stages_of(es) * (slot_a_bytes(M, Cout, proj, es) + slot_b_bytes(M, Cout));
}

struct Params {
  const void* x;          // [B, H, W, Cin]
  const void* w1;         // [M][ld1], K = Cin
  const void* w2;         // [M][ld2], K = 9M in (ky, kx, ci) order
  const void* w3;         // [Cout][ld3], K = M
  const void* wp;         // [Cout][ldp], K = Cin; null: identity shortcut
  long long ld1, ld2, ld3, ldp;  // row pitches in elements
  const float *k1, *b1, *k2, *b2, *k3, *b3, *bp;  // k*: s8 requant multipliers
  float kx;               // s8: the shortcut's fold
  void* out;              // [B, H, W, Cout]
  int H, W, Cin, M, Cout, TR;
};

// ldmatrix without a memory clobber, so the compiler may schedule around it;
// what it reads is ordered by the ring's cp.async wait and the barriers,
// which it does not cross (both are volatile)
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---------------------------------------------------------------------------
// the two element types: the MMA and the epilogues at the Pallas bodies'
// rounding points (pallas_bottleneck.py:68-118, pallas_int8_bottleneck.py:50-124).
// An epilogue takes a column pair's two per-channel vectors (ka, kb), loaded
// for all of a thread's columns before its stores, and returns the pair's
// two output elements packed (bf16x2, or s8x2 in the low 16 bits).
// ---------------------------------------------------------------------------
__device__ __forceinline__ float2 ld2(const float* v, int n) {
  return *reinterpret_cast<const float2*>(v + n);
}

struct Bf16 {
  using Acc = float;
  static constexpr int ES = 2;
  static constexpr bool kTapAcc = true;  // each tap summed on its own, then added
  static __device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
    mma_bf16(d, a, b0, b1);
  }
  static __device__ __forceinline__ float init2(const Params& p, int n) { return p.b2[n]; }
  static __device__ __forceinline__ void store(unsigned char* dst, unsigned v) {
    *reinterpret_cast<unsigned*>(dst) = v;
  }
  static __device__ __forceinline__ unsigned load(const unsigned char* src) {
    return __ldg(reinterpret_cast<const unsigned*>(src));
  }
  static __device__ __forceinline__ unsigned load_smem(const unsigned char* src) {
    return *reinterpret_cast<const unsigned*>(src);
  }
  // x1 = bf16(relu(acc + b1)); kb = b1
  static __device__ __forceinline__ void vecs1(const Params& p, int n, float2& ka, float2& kb) {
    kb = ld2(p.b1, n);
  }
  static __device__ __forceinline__ unsigned out1(float v0, float v1, float2, float2 kb) {
    return pack_bf16(fmaxf(v0 + kb.x, 0.0f), fmaxf(v1 + kb.y, 0.0f));
  }
  // x2 = bf16(relu(b2 + sum of the taps)): b2 is the sum's start
  static __device__ __forceinline__ void vecs2(const Params&, int, float2&, float2&) {}
  static __device__ __forceinline__ unsigned out2(float v0, float v1, float2, float2) {
    return pack_bf16(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
  }
  // out = bf16(relu((acc + b3) + shortcut)), shortcut = x or (accp + bp);
  // ka = b3, kb = bp
  static __device__ __forceinline__ void vecs3(const Params& p, int n, float2& ka, float2& kb) {
    ka = ld2(p.b3, n);
    if (p.wp != nullptr) kb = ld2(p.bp, n);
  }
  static __device__ __forceinline__ unsigned out3(float v0, float v1, float s0, float s1,
                                                  unsigned xs, float2 ka, float2 kb,
                                                  const Params& p) {
    float sc0, sc1;
    if (p.wp != nullptr) {
      sc0 = s0 + kb.x;
      sc1 = s1 + kb.y;
    } else {
      __nv_bfloat162 xv;
      *reinterpret_cast<unsigned*>(&xv) = xs;
      sc0 = __low2float(xv);
      sc1 = __high2float(xv);
    }
    return pack_bf16(fmaxf((v0 + ka.x) + sc0, 0.0f), fmaxf((v1 + ka.y) + sc1, 0.0f));
  }
};

struct S8 {
  using Acc = int;
  static constexpr int ES = 1;
  static constexpr bool kTapAcc = false;  // exact s32 sums: any order
  static __device__ __forceinline__ void mma(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ int init2(const Params&, int) { return 0; }
  static __device__ __forceinline__ void store(unsigned char* dst, unsigned v) {
    *reinterpret_cast<unsigned short*>(dst) = static_cast<unsigned short>(v);
  }
  static __device__ __forceinline__ unsigned load(const unsigned char* src) {
    return __ldg(reinterpret_cast<const unsigned short*>(src));
  }
  static __device__ __forceinline__ unsigned load_smem(const unsigned char* src) {
    return *reinterpret_cast<const unsigned short*>(src);
  }
  // q(y) = s8(clip(rint(y), -127, 127)) for y >= 0 (every y here follows a
  // ReLU): round half to even, then at most 127
  static __device__ __forceinline__ unsigned q(float y) {
    return static_cast<unsigned>(min(__float2int_rn(y), 127));
  }
  static __device__ __forceinline__ float epi(int acc, float k, float b) {
    return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), k), b), 0.0f);
  }
  static __device__ __forceinline__ unsigned qq(float y0, float y1) { return q(y0) | q(y1) << 8; }
  // ka = k*, kb = b* of each conv
  static __device__ __forceinline__ void vecs1(const Params& p, int n, float2& ka, float2& kb) {
    ka = ld2(p.k1, n);
    kb = ld2(p.b1, n);
  }
  static __device__ __forceinline__ unsigned out1(int v0, int v1, float2 ka, float2 kb) {
    return qq(epi(v0, ka.x, kb.x), epi(v1, ka.y, kb.y));
  }
  static __device__ __forceinline__ void vecs2(const Params& p, int n, float2& ka, float2& kb) {
    ka = ld2(p.k2, n);
    kb = ld2(p.b2, n);
  }
  static __device__ __forceinline__ unsigned out2(int v0, int v1, float2 ka, float2 kb) {
    return qq(epi(v0, ka.x, kb.x), epi(v1, ka.y, kb.y));
  }
  static __device__ __forceinline__ void vecs3(const Params& p, int n, float2& ka, float2& kb) {
    ka = ld2(p.k3, n);
    kb = ld2(p.b3, n);
  }
  // out = q(relu(acc * k3 + b3 + x * kx))
  static __device__ __forceinline__ float y3(int v, float k, float b, int x, float kx) {
    return fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(__int2float_rn(v), k), b),
                           __fmul_rn(static_cast<float>(x), kx)), 0.0f);
  }
  static __device__ __forceinline__ unsigned out3(int v0, int v1, int, int, unsigned xs, float2 ka,
                                                  float2 kb, const Params& p) {
    const int x0 = static_cast<int8_t>(xs & 0xFF), x1 = static_cast<int8_t>((xs >> 8) & 0xFF);
    return qq(y3(v0, ka.x, kb.x, x0, p.kx), y3(v1, ka.y, kb.y, x1, p.kx));
  }
};

struct Band {
  unsigned char *a1, *a2, *ring;
  const unsigned char* xb;  // this image's x
  int pitch;                // a1 / a2 row pitch in bytes
  int slot_a, slot_b;       // ring slot sizes
  int b, r0, rows;          // image, first output row, output rows in this band
};

__device__ __forceinline__ unsigned char* slot_of(const Band& bd, int s) {
  return bd.ring + s * (bd.slot_a + bd.slot_b);
}

// B slice: weight rows n0 .. n0+ROWS-1, K bytes kb .. kb+63
template <int ROWS>
__device__ __forceinline__ void load_b(unsigned char* slot, const void* w, size_t ld_bytes,
                                       int n0, int kb) {
  const unsigned char* base = static_cast<const unsigned char*>(w);
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * 4; i += THREADS) {
    const int n = i >> 2, part = i & 3;
    cp_async16(slot + n * SLOT_PITCH + part * 16,
               base + (size_t)(n0 + n) * ld_bytes + kb + part * 16);
  }
}

// A slice: x at band pixels p0 .. p0+ROWS-1 (pixel p lies on image row
// first_row + p / W), K bytes kb .. kb+63; zeros past P or outside the image
template <int ROWS>
__device__ __forceinline__ void load_a(unsigned char* slot, const Band& bd, int row_bytes,
                                       int H, int W, int first_row, int p0, int P, int kb) {
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * 4; i += THREADS) {
    const int r = i >> 2, part = i & 3, pix = p0 + r;
    const int row = first_row + pix / W;
    const bool ok = pix < P && row >= 0 && row < H;
    const unsigned char* src =
        ok ? bd.xb + ((size_t)row * W + pix % W) * row_bytes + kb + part * 16 : bd.xb;
    cp_async16(slot + r * SLOT_PITCH + part * 16, src, ok);
  }
}

// conv3's s8 shortcut tile: x at band pixels p0 .. p0+ROWS-1 (image rows
// from the band's first), ROW_BYTES channels from channel c0, rows of
// x_pitch; zeros past P
template <int ROWS, int ROW_BYTES>
__device__ __forceinline__ void load_x(unsigned char* slot, const Params& p, const Band& bd,
                                       int p0, int P, int c0) {
  const unsigned char* xb = bd.xb + (size_t)bd.r0 * p.W * p.Cin + c0;  // s8: 1 byte a channel
  constexpr int PARTS = ROW_BYTES / 16;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * PARTS; i += THREADS) {
    const int r = i / PARTS, part = i % PARTS, pix = p0 + r;
    const bool ok = pix < P;
    cp_async16(slot + r * (ROW_BYTES + 16) + part * 16,
               ok ? xb + (size_t)pix * p.Cin + part * 16 : bd.xb, ok);
  }
}

// acc[mt][nt] += one 64-byte K slice: A rows at the lane's addresses a0 (m16
// tile 0) and a1 (tile 1, skipped unless live1), B from the slot at address
// b (the lane's row and half already added). Each 32-byte k-step loads all
// its fragments before its MMAs, so one ldmatrix latency covers 16 MMAs.
template <class E>
__device__ __forceinline__ void mma_slice(typename E::Acc (&acc)[2][8][4], unsigned a0,
                                          unsigned a1, bool live1, unsigned b) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    unsigned fa0[4], fa1[4] = {0, 0, 0, 0}, fb[4][4];
    ldsm4(fa0, a0 + kk * 32);
    if (live1) ldsm4(fa1, a1 + kk * 32);
#pragma unroll
    for (int j = 0; j < 4; ++j) ldsm4(fb[j], b + j * 16 * SLOT_PITCH + kk * 32);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      E::mma(acc[0][2 * j], fa0, fb[j][0], fb[j][1]);
      E::mma(acc[0][2 * j + 1], fa0, fb[j][2], fb[j][3]);
    }
    if (live1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        E::mma(acc[1][2 * j], fa1, fb[j][0], fb[j][1]);
        E::mma(acc[1][2 * j + 1], fa1, fb[j][2], fb[j][3]);
      }
    }
  }
}

template <class Acc>
__device__ __forceinline__ void zero(Acc (&acc)[2][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
}

// the lane's offset into a B slot: row (lane % 8) + 8 (lane / 16) of the
// warp's 64, K half (lane / 8) % 2
__device__ __forceinline__ int b_lane(int wn) {
  const int lane = threadIdx.x & 31;
  return (wn * WARP_COLS + (lane & 7) + 8 * (lane >> 4)) * SLOT_PITCH + 16 * ((lane >> 3) & 1);
}

// the ring: NS-1 slices in flight, one barrier a slice; issue(step, slot)
// starts a slice's copies, compute(step, slot) consumes it
template <int NS, class Issue, class Compute>
__device__ __forceinline__ void pipeline(int total, Issue&& issue, Compute&& compute) {
  constexpr int STAGES = NS;
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) issue(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int step = 0; step < total; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // the slice landed for every thread; the slot issued next is free
    const int next = step + STAGES - 1;
    if (next < total) issue(next, next % STAGES);
    cp_async_commit();
    compute(step, step % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();  // the phase's outputs are visible, the ring is free
}

// a phase's walk over (pass of rows g, column chunk ch, K slice ks), in
// that nesting, as counters (no division a step)
struct Walk {
  int g = 0, ch = 0, ks = 0;
  __device__ __forceinline__ void next(int kn, int chunks) {
    if (++ks == kn) {
      ks = 0;
      if (++ch == chunks) {
        ch = 0;
        ++g;
      }
    }
  }
};

// the per-channel vectors of the thread's 8 column pairs (of 16 columns
// n0 + 8 nt + {0, 1})
#define IG_VECS(fn, nb)                                      \
  float2 ka[8], kb[8];                                       \
  _Pragma("unroll") for (int nt = 0; nt < 8; ++nt) {         \
    ka[nt] = kb[nt] = make_float2(0.0f, 0.0f);               \
    E::fn(p, (nb) + nt * 8, ka[nt], kb[nt]);                 \
  }

// conv1 over the band and its halo rows -> a1
template <class E, int WN>
__device__ __forceinline__ void conv1(const Params& p, const Band& bd) {
  using Acc = typename E::Acc;
  constexpr int ES = E::ES, GROUP = group_rows(WN);
  const int W = p.W, P = (bd.rows + 2) * W;
  const int chunks = p.M / (WARP_COLS * WN), kn = p.Cin * ES / KS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp % WN, wm = warp / WN;
  Acc acc[2][8][4];
  Walk in, at;
  pipeline<stages_of(ES)>(
      cdiv(P, GROUP) * chunks * kn,
      [&](int, int s) {
        unsigned char* slot = slot_of(bd, s);
        load_a<GROUP>(slot, bd, p.Cin * ES, p.H, W, bd.r0 - 1, in.g * GROUP, P, in.ks * KS);
        load_b<WARP_COLS * WN>(slot + bd.slot_a, p.w1, (size_t)p.ld1 * ES,
                               in.ch * WARP_COLS * WN, in.ks * KS);
        in.next(kn, chunks);
      },
      [&](int, int s) {
        if (at.ks == 0) zero(acc);
        const int row0 = at.g * GROUP + wm * WARP_ROWS;
        if (row0 < P) {
          const unsigned slot = smem_addr(slot_of(bd, s));
          const unsigned a = slot + (wm * WARP_ROWS + (lane & 15)) * SLOT_PITCH + 16 * (lane >> 4);
          mma_slice<E>(acc, a, a + 16 * SLOT_PITCH, row0 + 16 < P, slot + bd.slot_a + b_lane(wn));
        }
        if (at.ks == kn - 1) {
          const int nb = at.ch * WARP_COLS * WN + wn * WARP_COLS + 2 * (lane & 3);
          IG_VECS(vecs1, nb)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int pix = row0 + mt * 16 + (lane >> 2) + 8 * h;
              if (pix >= P) continue;
              const int tr = pix / W, row = bd.r0 - 1 + tr;
              const bool live = row >= 0 && row < p.H;
              unsigned char* dst = bd.a1 + (tr * (W + 2) + pix - tr * W + 1) * bd.pitch + nb * ES;
#pragma unroll
              for (int nt = 0; nt < 8; ++nt)
                E::store(dst + nt * 8 * ES,
                         live ? E::out1(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1], ka[nt], kb[nt])
                              : 0u);
            }
        }
        at.next(kn, chunks);
      });
}

// conv2: the nine taps of a1 -> a2. Its A is the resident tile, so a ring
// stage holds only weight slices: with WN = 1 three a step (conv1's A slot
// of 256 rows alone holds four; 9M is a multiple of 3 slices), one barrier
// for three taps' slices at M = 64; with WN = 2 one (two a step measured
// slower there on an H100)
template <class E, int WN>
__device__ __forceinline__ void conv2(const Params& p, const Band& bd) {
  using Acc = typename E::Acc;
  constexpr int ES = E::ES, GROUP = group_rows(WN), SPS = WN == 1 ? 3 : 1;
  constexpr int BSLICE = WARP_COLS * WN * SLOT_PITCH;  // one slice's weight rows
  const int W = p.W, P = bd.rows * W;
  const int chunks = p.M / (WARP_COLS * WN), spt = p.M * ES / KS, kn = 9 * spt;
  const int kq = kn / SPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp % WN, wm = warp / WN;
  Acc tot[2][8][4], tap[2][8][4];
  Walk in, at;
  unsigned a0 = 0, a1 = 0;  // the lane's two pixels' tap-(0, 0) rows in a1, this pass
  int t = 0, kin = 0;       // the tap and its slice
  pipeline<stages_of(ES)>(
      cdiv(P, GROUP) * chunks * kq,
      [&](int, int s) {
#pragma unroll
        for (int j = 0; j < SPS; ++j)
          load_b<WARP_COLS * WN>(slot_of(bd, s) + j * BSLICE, p.w2, (size_t)p.ld2 * ES,
                                 in.ch * WARP_COLS * WN, (in.ks * SPS + j) * KS);
        in.next(kq, chunks);
      },
      [&](int, int s) {
        const int row0 = at.g * GROUP + wm * WARP_ROWS;
        const int nb = at.ch * WARP_COLS * WN + wn * WARP_COLS + 2 * (lane & 3);
        if (at.ks == 0) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
              for (int i = 0; i < 4; ++i) tot[mt][nt][i] = E::init2(p, nb + nt * 8 + (i & 1));
          // the lane's pixel in each m16 tile (clamped inside the band)
          const int p0 = min(row0 + (lane & 15), P - 1), p1 = min(row0 + 16 + (lane & 15), P - 1);
          const unsigned base = smem_addr(bd.a1) + 16 * (lane >> 4);
          a0 = base + (p0 + 2 * (p0 / W)) * bd.pitch;
          a1 = base + (p1 + 2 * (p1 / W)) * bd.pitch;
          t = kin = 0;
        }
        const unsigned b = smem_addr(slot_of(bd, s)) + b_lane(wn);
#pragma unroll
        for (int j = 0; j < SPS; ++j) {
          if (E::kTapAcc && kin == 0) zero(tap);
          if (row0 < P) {
            const int toff = ((t / 3) * (W + 2) + t % 3) * bd.pitch + kin * KS;
            if constexpr (E::kTapAcc)
              mma_slice<E>(tap, a0 + toff, a1 + toff, row0 + 16 < P, b + j * BSLICE);
            else
              mma_slice<E>(tot, a0 + toff, a1 + toff, row0 + 16 < P, b + j * BSLICE);
          }
          if (++kin == spt) {
            kin = 0;
            ++t;
            if constexpr (E::kTapAcc) {
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                  for (int i = 0; i < 4; ++i) tot[mt][nt][i] += tap[mt][nt][i];
            }
          }
        }
        if (at.ks == kq - 1) {
          IG_VECS(vecs2, nb)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int pix = row0 + mt * 16 + (lane >> 2) + 8 * h;
              if (pix >= P) continue;
              unsigned char* a2row = bd.a2 + pix * bd.pitch + nb * ES;
#pragma unroll
              for (int nt = 0; nt < 8; ++nt)
                E::store(a2row + nt * 8 * ES,
                         E::out2(tot[mt][nt][2 * h], tot[mt][nt][2 * h + 1], ka[nt], kb[nt]));
            }
        }
        at.next(kq, chunks);
      });
}

// conv3 (+ the projection) + shortcut -> out
template <class E, int WN, bool PROJ>
__device__ __forceinline__ void conv3(const Params& p, const Band& bd) {
  using Acc = typename E::Acc;
  constexpr int ES = E::ES, GROUP = group_rows(WN);
  const int W = p.W, P = bd.rows * W;
  const int chunks = p.Cout / (WARP_COLS * WN), k3 = p.M * ES / KS;
  const int kn = k3 + (PROJ ? p.Cin * ES / KS : 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp % WN, wm = warp / WN;
  Acc acc[2][8][4], accp[2][8][4];
  Walk in, at;
  pipeline<stages_of(ES)>(
      cdiv(P, GROUP) * chunks * kn,
      [&](int, int s) {
        unsigned char* slot = slot_of(bd, s);
        if (!PROJ || in.ks < k3) {
          load_b<WARP_COLS * WN>(slot + bd.slot_a, p.w3, (size_t)p.ld3 * ES,
                                 in.ch * WARP_COLS * WN, in.ks * KS);
          if constexpr (stages_x(ES, PROJ)) {
            if (in.ks == kn - 1)
              load_x<GROUP, WN * WARP_COLS>(slot, p, bd, in.g * GROUP, P, in.ch * WARP_COLS * WN);
          }
        } else {
          load_a<GROUP>(slot, bd, p.Cin * ES, p.H, W, bd.r0, in.g * GROUP, P, (in.ks - k3) * KS);
          load_b<WARP_COLS * WN>(slot + bd.slot_a, p.wp, (size_t)p.ldp * ES,
                                 in.ch * WARP_COLS * WN, (in.ks - k3) * KS);
        }
        in.next(kn, chunks);
      },
      [&](int, int s) {
        const int ks = at.ks;
        const int row0 = at.g * GROUP + wm * WARP_ROWS;
        if (ks == 0) {
          zero(acc);
          if constexpr (PROJ) zero(accp);
        }
        if (row0 < P) {
          const unsigned slot = smem_addr(slot_of(bd, s));
          const unsigned b = slot + bd.slot_a + b_lane(wn);
          if (!PROJ || ks < k3) {
            const int p0 = min(row0 + (lane & 15), P - 1), p1 = min(row0 + 16 + (lane & 15), P - 1);
            const unsigned base = smem_addr(bd.a2) + ks * KS + 16 * (lane >> 4);
            mma_slice<E>(acc, base + p0 * bd.pitch, base + p1 * bd.pitch, row0 + 16 < P, b);
          } else {
            const unsigned a =
                slot + (wm * WARP_ROWS + (lane & 15)) * SLOT_PITCH + 16 * (lane >> 4);
            mma_slice<E>(accp, a, a + 16 * SLOT_PITCH, row0 + 16 < P, b);
          }
        }
        if (ks == kn - 1) {
          const int nb = at.ch * WARP_COLS * WN + wn * WARP_COLS + 2 * (lane & 3);
          IG_VECS(vecs3, nb)
          // the shortcuts of this lane's four rows, loaded before any store;
          // the packed outputs go to the warp's staging rows (the a1 tile is
          // free now), then out in 16-byte chunks, each row's 64 columns
          // contiguous
          const size_t q0 = ((size_t)bd.b * p.H + bd.r0) * W;
          unsigned xs[2][2][8];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int pix = min(row0 + mt * 16 + (lane >> 2) + 8 * h, P - 1);
              const unsigned char* xrow =
                  stages_x(ES, PROJ)
                      ? slot_of(bd, s) + (pix - at.g * GROUP) * x_pitch(WN, ES) +
                            (wn * WARP_COLS + 2 * (lane & 3)) * ES
                      : static_cast<const unsigned char*>(p.x) + ((q0 + pix) * p.Cin + nb) * ES;
#pragma unroll
              for (int nt = 0; nt < 8; ++nt)
                xs[mt][h][nt] = PROJ ? 0u
                                : stages_x(ES, PROJ) ? E::load_smem(xrow + nt * 8 * ES)
                                                     : E::load(xrow + nt * 8 * ES);
            }
          unsigned char* stage = bd.a1 + warp * WARP_ROWS * STAGE_PITCH<ES>;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = mt * 16 + (lane >> 2) + 8 * h;
#pragma unroll
              for (int nt = 0; nt < 8; ++nt) {
                Acc s0 = 0, s1 = 0;
                if constexpr (PROJ) {
                  s0 = accp[mt][nt][2 * h];
                  s1 = accp[mt][nt][2 * h + 1];
                }
                E::store(stage + r * STAGE_PITCH<ES> + (nt * 8 + 2 * (lane & 3)) * ES,
                         E::out3(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1], s0, s1,
                                 xs[mt][h][nt], ka[nt], kb[nt], p));
              }
            }
          __syncwarp();
          constexpr int CHUNKS = WARP_COLS * ES / 16;  // 16-byte chunks of a row
          unsigned char* out = static_cast<unsigned char*>(p.out) +
                               (q0 * p.Cout + at.ch * WARP_COLS * WN + wn * WARP_COLS) * ES;
#pragma unroll
          for (int i = lane; i < WARP_ROWS * CHUNKS; i += 32) {
            const int r = i / CHUNKS, c = i % CHUNKS;
            if (row0 + r < P)
              *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * p.Cout * ES + c * 16) =
                  *reinterpret_cast<const uint4*>(stage + r * STAGE_PITCH<ES> + c * 16);
          }
          __syncwarp();  // the staging rows are read before the next chunk writes them
        }
        at.next(kn, chunks);
      });
}
#undef IG_VECS

template <class E, bool PROJ>
__global__ void __launch_bounds__(THREADS, 1) bottleneck_tc_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ES = E::ES;
  Band bd;
  bd.pitch = p.M * ES + 16;
  bd.slot_a = slot_a_bytes(p.M, p.Cout, PROJ, ES);
  bd.slot_b = slot_b_bytes(p.M, p.Cout);
  bd.b = blockIdx.y;
  bd.r0 = blockIdx.x * p.TR;
  bd.rows = min(p.TR, p.H - bd.r0);
  bd.a1 = smem;
  bd.a2 = bd.a1 + a1_bytes(p.W, p.M, p.TR, ES);
  bd.ring = bd.a2 + (size_t)p.TR * p.W * bd.pitch;
  bd.xb = static_cast<const unsigned char*>(p.x) + (size_t)bd.b * p.H * p.W * p.Cin * ES;
  // the left and right border columns of a1 (SAME padding); conv1 writes
  // every other a1 pixel the band reads, zero where the halo leaves the image
  const int per = bd.pitch / 16;
  for (int i = threadIdx.x; i < (bd.rows + 2) * 2 * per; i += THREADS) {
    const int rc = i / per, tr = rc >> 1, col = (rc & 1) ? p.W + 1 : 0;
    *reinterpret_cast<uint4*>(bd.a1 + (tr * (p.W + 2) + col) * bd.pitch + (i % per) * 16) =
        make_uint4(0, 0, 0, 0);
  }
  if (wn_of(p.M) == 2) {
    conv1<E, 2>(p, bd);
    conv2<E, 2>(p, bd);
  } else {
    conv1<E, 1>(p, bd);
    conv2<E, 1>(p, bd);
  }
  if (wn_of(p.Cout) == 2)
    conv3<E, 2, PROJ>(p, bd);
  else
    conv3<E, 1, PROJ>(p, bd);
}

// launch one band per (blockIdx.x, image); 0 or the launch's cudaError_t
template <class E, bool PROJ>
int launch(const Params& p, int B, void* stream) {
  const size_t smem = smem_bytes(p.W, p.M, p.Cout, p.TR, E::ES, PROJ);
  cudaError_t err = cudaFuncSetAttribute(bottleneck_tc_kernel<E, PROJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(p.H, p.TR), B);
  bottleneck_tc_kernel<E, PROJ>
      <<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return launch_status();
}

// the shapes the kernel takes: channels in 64s (64-byte K slices of s8, 64-
// column chunks), 16-byte aligned weight rows, K-major weights whose rows
// hold their K, a band that fits shared memory
inline bool takes(const Params& p, int B, int es, bool proj) {
  const bool widths = p.Cin % 64 == 0 && p.M % 64 == 0 && p.Cout % 64 == 0;
  const bool rows = p.ld1 >= p.Cin && p.ld2 >= 9LL * p.M && p.ld3 >= p.M &&
                    (!proj || p.ldp >= p.Cin) && (p.ld1 * es) % 16 == 0 &&
                    (p.ld2 * es) % 16 == 0 && (p.ld3 * es) % 16 == 0 &&
                    (!proj || (p.ldp * es) % 16 == 0);
  return B > 0 && p.H > 0 && p.W > 0 && p.TR > 0 && widths && rows &&
         (proj || p.Cin == p.Cout) && smem_bytes(p.W, p.M, p.Cout, p.TR, es, proj) <= 232448;
}

}  // namespace ig
