// Streamed tied lm head with the decode step's selection statistics
// (ops/lm_head.py). Replaces mmdx_tpu/ops/pallas_lm_head.py:lm_head_greedy
// (greedy: the masked max of each 128-column vocab chunk and the earliest
// offset attaining it, no logits) and lm_head_stats (beam: the f32 logits,
// their row max m and L = log sum exp(x - m) over the RAW logits, and the
// masked chunk max).
//
// logits[n, v] = hidden[n, :] . emb[v, :], hidden [N, D] and emb [V, D]
// bf16, f32 accumulation.
//
// What bounds it on the H100: bytes. The emb read (32128 x 512 bf16 = 32.9
// MB), the mask (N x V bytes) and, for the stats, the f32 logits written
// once (16.4 MB at N = 128): 10.5 us at N = 64 and 16.0 us at N = 128 at
// 3.35 TB/s. The products (2 N V D = 4.2 GFLOP at N = 128, 4.3 us on the
// bf16 tensor cores) stay under that line up to several hundred rows.
//
// Design (sm_90a, the skeleton of csrc/gemm.cu, primitives in hopper.cuh):
// one CTA per 128-column chunk (251 at the T5 vocabulary). One producer
// warp streams, through a ring of mbarrier stages, the chunk's emb rows in
// boxes of [128 rows, 64] (16 KB, the 128-byte swizzle) beside the
// matching [64 x WGS rows, 64] box of hidden (TMA zero-fills rows past N),
// and one or two consumer warpgroups each run m64n128k16 wgmma on 64 rows
// over D (8 boxes, 32 k16 steps at D = 512). emb [V, D] is already K-major
// for B: no transpose bit, no copy of the weight, and its TMA descriptor is
// encoded once per weight (mmdx_lm_head_emb_map). Both consumer warpgroups
// read each emb stage, so emb is read once up to N = 128; past that the
// CTA walks row groups of 64 x WGS rows and reads its chunk again. The
// ring holds 96 KB (4 stages of 24 KB with one warpgroup, 3 of 32 KB with
// two), so two CTAs fit an SM and the 251 CTAs run as one wave on 264
// slots with 96-128 KB of emb in flight per SM.
//
// After a row group's last K box the producer loads the group's mask tile
// ([64 x WGS rows, 128] bytes, 128-byte swizzle) through the ring like any
// other box, so it lands behind the last emb boxes and under the MMAs.
// The epilogue works on the accumulator registers: in the m64n128 fragment
// a thread holds two rows x 32 columns and a row's 128 columns lie in one
// quad of lanes, so the chunk max, the earliest argmax (the pair carried;
// on equal values the lower column), the raw max and sum of exp(x - max)
// are a thread-local pass and two shfl_xor steps (the exponentials by
// __expf, rows past N skipped). Greedy writes cmax and carg and touches no
// shared memory after the MMAs but the mask tile; the stats write their
// logits straight from the fragments (a warp store is 8 rows x 32 bytes:
// whole sectors). Those 16.4 MB at N = 128 leave every CTA at once, in
// 512-byte row pieces 128.5 KB apart, and drain at ~1.4 TB/s
// (scripts/ablate_gemm.py --lm-head): they hold the stats at about half of
// their byte bound.
//
// One launch for the stats: each CTA writes its chunk's partials (raw max,
// sum of exp) to a workspace, fences, and takes a ticket from a counter;
// the last R CTAs to be counted (R = 8, or one row a warp) wait until every
// CTA is, then merge the rows in shares, one row a warp, lanes over the
// chunks in a fixed order: two launches give the same bits, whichever CTA
// finishes last. The counter only grows (launch e hands out tickets e C ..
// e C + C - 1), so it needs no reset and the launch captures into a CUDA
// graph; the logits stores are issued after the ticket's atomic and
// overlap the merge. A merge through per-group counters (the last CTA of
// each group of chunks, then of the groups) costs 6-7 us of dependent L2
// round trips at the end of the launch; this one costs 1-2.
#include <cstring>

#include "common.cuh"
#include "hopper.cuh"  // mbarriers, TMA, wgmma descriptors and MMAs, cuTensorMapEncodeTiled

namespace {

constexpr int CHUNK = 128;               // vocab columns per CTA: one m64n128 tile
constexpr int BK = 64;                   // one 128-byte swizzle row of bf16: four k16 MMAs
constexpr int EMB_BOX = CHUNK * BK * 2;  // 16 KB
constexpr int HID_BOX = 64 * BK * 2;     // 8 KB per consumer warpgroup
constexpr size_t MAX_SMEM = 232448;      // a block's dynamic shared memory on sm_90

__host__ __device__ constexpr int stage_bytes(int wgs) { return EMB_BOX + wgs * HID_BOX; }
constexpr size_t smem_bytes(int wgs, int stages) {
  return (size_t)stages * stage_bytes(wgs) + 1024 + 2 * stages * sizeof(uint64_t);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct LmHeadArgs {
  float* cmax;    // [N, C] masked chunk max
  int* carg;      // [N, C] (greedy) earliest offset attaining it
  float* logits;  // [N, V] (stats)
  float* m;       // [N] (stats) row max of the raw logits
  float* L;       // [N] (stats) log sum exp(x - m)
  float* pmax;    // [N, C] (stats) chunk max of the raw logits
  float* psum;    // [N, C] (stats) chunk sum of exp(x - pmax)
  unsigned long long* count;  // (stats) CTAs counted over all launches
  int N, V, ksteps, groups, stages;
};

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The mask tile [rows, 128] bytes in its 128-byte swizzle: the bytes of
// columns c and c + 1 (c even) of row r, as the low and high byte.
__device__ __forceinline__ unsigned mask_pair(const unsigned char* tile, int r, int c) {
  return *reinterpret_cast<const unsigned short*>(tile + r * CHUNK +
                                                  ((((c >> 4) ^ (r & 7)) << 4) | (c & 15)));
}

// The epilogue of one consumer warpgroup for its 64 rows from row0: thread
// t holds, for each 8-column group j, accumulators 4j..4j+3 at rows
// 16(t/32) + (t%32)/4 (+8 for the last two, h = 1) and columns 8j + 2(t%4)
// (+1).
template <bool STATS>
__device__ __forceinline__ void epilogue(const float (&acc)[64], const unsigned char* tile,
                                         const LmHeadArgs& p, int row0, int chunk, int t) {
  const int C = p.V / CHUNK, q = t % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (t / 32) * 16 + (t % 32) / 4 + 8 * h, n = row0 + r;
    if constexpr (!STATS) {
      // earliest column attaining the masked max: columns ascend in the
      // thread; across the quad, equal values keep the lower column
      float best = neg_inf();
      int col = CHUNK;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const unsigned banned = mask_pair(tile, r, 8 * j + 2 * q);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = (banned >> (8 * e)) & 0xffu ? neg_inf() : acc[4 * j + 2 * h + e];
          if (v > best || col == CHUNK) {
            best = v;
            col = 8 * j + 2 * q + e;
          }
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oc = __shfl_xor_sync(0xffffffffu, col, o);
        if (ob > best || (ob == best && oc < col)) {
          best = ob;
          col = oc;
        }
      }
      if (q == 0 && n < p.N) {
        p.cmax[(size_t)n * C + chunk] = best;
        p.carg[(size_t)n * C + chunk] = col;
      }
    } else {
      float rmax = neg_inf(), mmax = neg_inf();
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const unsigned banned = mask_pair(tile, r, 8 * j + 2 * q);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = acc[4 * j + 2 * h + e];
          rmax = fmaxf(rmax, x);
          if (!((banned >> (8 * e)) & 0xffu)) mmax = fmaxf(mmax, x);
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
        mmax = fmaxf(mmax, __shfl_xor_sync(0xffffffffu, mmax, o));
      }
      // columns in order in the thread, then (t0 + t1) + (t2 + t3) over the
      // quad: every lane ends with the same bits (rows past N skip the sum)
      float se = 0.0f;
      if (n < p.N)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) se += __expf(acc[4 * j + 2 * h + e] - rmax);
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) se += __shfl_xor_sync(0xffffffffu, se, o);
      if (q == 0 && n < p.N) {
        const size_t o = (size_t)n * C + chunk;
        p.cmax[o] = mmax;
        p.pmax[o] = rmax;
        p.psum[o] = se;
      }
    }
  }
  if constexpr (STATS) __threadfence();  // the partials are visible before the CTA is counted
}

// The stats' logits of one consumer warpgroup's 64 rows, straight from the
// fragments: a warp store is 8 rows x 32 bytes, whole sectors.
__device__ __forceinline__ void store_logits(const float (&acc)[64], const LmHeadArgs& p,
                                             int row0, int chunk, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = row0 + (t / 32) * 16 + (t % 32) / 4 + 8 * h;
    if (n < p.N) {
      float* out = p.logits + (size_t)n * p.V + chunk * CHUNK + 2 * (t % 4);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// m[n] = max_c pmax[n, c] and L[n] = log sum_c psum[n, c] exp(pmax[n, c] -
// m[n]) for the rows n = first, first + step, ... by the warps of a merging
// CTA, one row a warp: lane l takes chunks l, l + 32, ... in order (loaded
// at once up to MERGE_LANE_MAX a lane: one round trip to L2, __ldcg for
// other CTAs' writes), then an xor butterfly over the lanes. The order of
// every sum is fixed, so the bits do not depend on which CTA merges a row.
constexpr int MERGE_LANE_MAX = 8;  // chunks a lane holds in registers: V <= 32768

__device__ __forceinline__ void merge_rows(const LmHeadArgs& p, int first, int step) {
  const int C = p.V / CHUNK, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int n = first + step * (threadIdx.x / 32); n < p.N; n += step * warps) {
    const float* pm = p.pmax + (size_t)n * C;
    const float* ps = p.psum + (size_t)n * C;
    float mx = neg_inf(), s = 0.0f;
    if (C <= 32 * MERGE_LANE_MAX) {
      float vm[MERGE_LANE_MAX], vs[MERGE_LANE_MAX];
#pragma unroll
      for (int i = 0; i < MERGE_LANE_MAX; ++i) {
        const int c = lane + 32 * i;
        vm[i] = c < C ? __ldcg(pm + c) : neg_inf();
        vs[i] = c < C ? __ldcg(ps + c) : 0.0f;
        mx = fmaxf(mx, vm[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
#pragma unroll
      for (int i = 0; i < MERGE_LANE_MAX; ++i)
        if (lane + 32 * i < C) s += vs[i] * expf(vm[i] - mx);
    } else {
      for (int c = lane; c < C; c += 32) mx = fmaxf(mx, __ldcg(pm + c));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      for (int c = lane; c < C; c += 32) s += __ldcg(ps + c) * expf(__ldcg(pm + c) - mx);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      p.m[n] = mx;
      p.L[n] = logf(s);
    }
  }
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* ptr) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(ptr) : "memory");
  return v;
}

// grid: one CTA per 128-column chunk; WGS consumer warpgroups + 1 producer warp
template <int WGS, bool STATS>
__global__ void __launch_bounds__(WGS * 128 + 32, 2)
lm_head_kernel(const __grid_constant__ CUtensorMap map_h, const __grid_constant__ CUtensorMap map_e,
               const __grid_constant__ CUtensorMap map_m, const LmHeadArgs p) {
  constexpr int STAGE = stage_bytes(WGS), RG = 64 * WGS;
  extern __shared__ unsigned char smem_raw[];
  __shared__ unsigned long long ticket;  // (stats) this CTA's place in the merge count
  // the swizzle pattern is a function of the address: stages start on 1 KB
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * STAGE);
  uint64_t* empty = full + p.stages;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int chunk = blockIdx.x, col0 = chunk * CHUNK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int s = 0;
  unsigned phase = 0;
  auto advance = [&]() {
    if (++s == p.stages) {
      s = 0;
      phase ^= 1;
    }
  };
  if (wg == WGS) {  // the producer warp: one thread keeps the ring full
    if (t == 0) {
      prefetch_map(&map_e);
      prefetch_map(&map_h);
      prefetch_map(&map_m);
      for (int g = 0; g < p.groups; ++g) {
        for (int k = 0; k <= p.ksteps; ++k) {  // k == ksteps: the group's mask tile
          mbar_wait(&empty[s], phase ^ 1);      // round 0 passes: the ring starts empty
          unsigned char* st = smem + s * STAGE;
          if (k < p.ksteps) {
            mbar_expect_tx(&full[s], STAGE);
            tma_load_2d(st, &map_e, k * BK, col0, &full[s]);
            tma_load_2d(st + EMB_BOX, &map_h, k * BK, g * RG, &full[s]);
          } else {
            mbar_expect_tx(&full[s], RG * CHUNK);
            tma_load_2d(st, &map_m, col0, g * RG, &full[s]);
          }
          advance();
        }
      }
    }
  } else {  // consumers: warpgroup wg owns rows 64 wg .. + 64 of each row group
    for (int g = 0; g < p.groups; ++g) {
      float acc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
      int prev = 0;
      for (int k = 0; k < p.ksteps; ++k) {
        mbar_wait(&full[s], phase);
        const unsigned char* b = smem + s * STAGE;
        const unsigned char* a = b + EMB_BOX + wg * HID_BOX;
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_bf16_m64n128<0>(acc, wgmma_desc(a + kk * 32, 16, 1024),
                                wgmma_desc(b + kk * 32, 16, 1024));
        wgmma_commit();
        fence_operands(acc);
        wgmma_wait<1>();  // the previous step's group retired: free its stage
        if (k > 0 && t == 0) mbar_arrive(&empty[prev]);
        prev = s;
        advance();
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (t == 0) mbar_arrive(&empty[prev]);
      mbar_wait(&full[s], phase);  // the group's mask tile
      epilogue<STATS>(acc, smem + s * STAGE + wg * 64 * CHUNK, p, g * RG + wg * 64, chunk, t);
      named_barrier(1 + wg, 128);  // this warpgroup is done with the mask tile
      if (t == 0) mbar_arrive(&empty[s]);
      advance();
      if constexpr (STATS) {
        if (g == p.groups - 1) {  // every partial of the CTA is written: take a ticket
          named_barrier(3, WGS * 128);
          if (threadIdx.x == 0) {
            ticket = atomicAdd(p.count, 1ull);
            __threadfence();
          }
        }
        // the 64 KB of logits go out after the ticket's atomic, not before it
        store_logits(acc, p, g * RG + wg * 64, chunk, t);
      }
    }
  }
  if constexpr (STATS) {
    // One launch: each CTA takes a ticket from a counter that only grows
    // (launch e hands out e C .. e C + C - 1, so it needs no reset and
    // captures into a CUDA graph); the last R CTAs of the launch merge the
    // rows, each a share, once every CTA is counted. A merging CTA waits
    // only for CTAs that are already running or can start: R is far below
    // the CTAs an SM array holds.
    const int C = gridDim.x, warps = blockDim.x / 32;
    const int R = min(C, max(8, (p.N + warps - 1) / warps));
    __syncthreads();
    const int k = (int)(ticket % C) - (C - R);  // this CTA's share of the merge, if >= 0
    if (k < 0) return;
    if (threadIdx.x == 0) {
      const unsigned long long all = (ticket / C + 1) * C;
      long long start = 0;
      while (load_acquire(p.count) < all) {
        __nanosleep(32);
        if (start == 0) start = clock64();
        else if (clock64() - start > 20000000000ll) __trap();
      }
    }
    __syncthreads();
    merge_rows(p, k, R);
  }
}

template <int WGS, bool STATS>
int launch(const CUtensorMap& mh, const CUtensorMap& me, const CUtensorMap& mm,
           const LmHeadArgs& p, cudaStream_t stream) {
  static size_t configured = 0;  // the dynamic shared memory the kernel may take
  const size_t smem = smem_bytes(WGS, p.stages);
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        lm_head_kernel<WGS, STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    // the whole unified L1 as shared memory, so two CTAs' rings fit an SM
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(lm_head_kernel<WGS, STATS>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  lm_head_kernel<WGS, STATS><<<p.V / CHUNK, WGS * 128 + 32, smem, stream>>>(mh, me, mm, p);
  return launch_status();
}

// the plan of ops/lm_head.py:lm_head_plan: 1 or 2 consumer warpgroups,
// row groups of 64 x wgs rows covering N, and a ring of >= 2 stages
template <bool STATS>
int lm_head(const void* hidden, const void* emb_map, const void* mask, LmHeadArgs& p, int D,
            int wgs, int stages, cudaStream_t stream) {
  if (p.N <= 0 || p.V <= 0 || p.V % CHUNK != 0 || D <= 0 || D % BK != 0 ||
      (wgs != 1 && wgs != 2) || stages < 2 || smem_bytes(wgs, stages) > MAX_SMEM ||
      emb_map == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  p.ksteps = D / BK;
  p.groups = (p.N + 64 * wgs - 1) / (64 * wgs);
  p.stages = stages;
  CUtensorMap mh, me, mm;
  if (!make_map_2d(&mh, hidden, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.N, D, 64 * wgs, BK) ||
      !make_map_2d(&mm, mask, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.N, p.V, 64 * wgs, CHUNK))
    return static_cast<int>(cudaErrorInvalidValue);
  memcpy(&me, emb_map, sizeof me);
  return wgs == 1 ? launch<1, STATS>(mh, me, mm, p, stream)
                  : launch<2, STATS>(mh, me, mm, p, stream);
}

}  // namespace

// The TMA descriptor of emb [V, D] bf16 (V % 128 == 0, D % 64 == 0,
// 16-byte aligned) in boxes of [128 rows, 64], written to `map` (a
// CUtensorMap, 128 bytes), which the caller keeps beside the weight.
MMDX_EXPORT int mmdx_lm_head_emb_map(const void* emb, int V, int D, void* map) {
  if (V <= 0 || V % CHUNK != 0 || D <= 0 || D % BK != 0 || map == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m;
  if (!make_map_2d(&m, emb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, V, D, CHUNK, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  memcpy(map, &m, sizeof m);
  return 0;
}

// hidden [N, D] bf16 (head scale applied); emb's descriptor; mask [N, V]
// bool (nonzero = banned) -> cmax [N, V/128] f32, carg [N, V/128] int32.
MMDX_EXPORT int mmdx_lm_head_greedy(const void* hidden, const void* emb_map, const void* mask,
                                    void* cmax, void* carg, int N, int V, int D, int wgs,
                                    int stages, void* stream) {
  LmHeadArgs p{};
  p.cmax = static_cast<float*>(cmax);
  p.carg = static_cast<int*>(carg);
  p.N = N;
  p.V = V;
  return lm_head<false>(hidden, emb_map, mask, p, D, wgs, stages,
                        static_cast<cudaStream_t>(stream));
}

// As mmdx_lm_head_greedy -> logits [N, V] f32, cmax [N, V/128] f32 (masked),
// m and L [N] f32 (raw logits); ws: the workspace of ops/lm_head.py, the
// partials pmax and psum [N, C] f32 (C = V / 128) and then a u64 counter,
// zeroed once when it is made and never reset (8 N C + 8 bytes).
MMDX_EXPORT int mmdx_lm_head_stats(const void* hidden, const void* emb_map, const void* mask,
                                   void* logits, void* cmax, void* m, void* L, void* ws, int N,
                                   int V, int D, int wgs, int stages, void* stream) {
  if (ws == nullptr || V <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t nc = (size_t)N * (V / CHUNK);
  LmHeadArgs p{};
  p.cmax = static_cast<float*>(cmax);
  p.logits = static_cast<float*>(logits);
  p.m = static_cast<float*>(m);
  p.L = static_cast<float*>(L);
  p.pmax = static_cast<float*>(ws);
  p.psum = p.pmax + nc;
  p.count = reinterpret_cast<unsigned long long*>(p.psum + nc);
  p.N = N;
  p.V = V;
  return lm_head<true>(hidden, emb_map, mask, p, D, wgs, stages,
                       static_cast<cudaStream_t>(stream));
}
