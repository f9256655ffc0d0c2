// Shared helpers for the port's Hopper kernels (sm_90a).
//
// Every entry point is a plain C function (extern "C") that enqueues one
// kernel on the caller's stream and returns the cudaError_t of the launch, so
// the Python side binds it with ctypes (mmdx_tpu_torch/_build.py) and raises
// on a refused launch. Nothing here allocates or synchronises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define MMDX_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }
// round an f32 value through bf16 (the Pallas kernels' .astype(bf16) points)
__device__ __forceinline__ float round_bf16(float v) { return bf2f(f2bf(v)); }

// Eight or four consecutive bf16 or f32 values (16-byte or 8-byte aligned
// for bf16, 16-byte for f32) as f32, and one f32 value stored as T.
__device__ __forceinline__ void load8(const bf16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* b = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = bf2f(b[i]);
}
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&o)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const bf16* b = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = bf2f(b[i]);
}
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = f2bf(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 (or 4) bytes global -> shared without registers (cp.async), zero-filled
// when !valid; cp_async_wait<N>: all but the newest N committed groups landed
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mma.sync.m16n8k16 on bf16 with f32 accumulators, and its fragment loads
// from shared memory (ldmatrix; .trans for a row-major [k][n] B operand)
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

static inline int launch_status() { return static_cast<int>(cudaGetLastError()); }
