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

static inline int launch_status() { return static_cast<int>(cudaGetLastError()); }
