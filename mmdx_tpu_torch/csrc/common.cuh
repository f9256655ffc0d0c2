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

static inline int launch_status() { return static_cast<int>(cudaGetLastError()); }
