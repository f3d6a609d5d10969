// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library is a plain-C shared object loaded with ctypes
// (sdm_tpu_torch/kernels/_build.py). Element types travel as an int code:
// 0 = float32, 1 = bfloat16. Arithmetic is always fp32; values are widened on
// load and rounded once on store.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define SDM_F32 0
#define SDM_BF16 1

typedef __nv_bfloat16 bf16;

// Whether a pointer is 16-byte aligned, as TMA, bulk copies and vector
// stores need.
static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A shared-memory pointer as the 32-bit address PTX takes.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Two adjacent values of an accumulator fragment, stored as one pair.
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float sdm_load(const void* p, long long i, int dt) {
  return dt == SDM_F32 ? static_cast<const float*>(p)[i]
                       : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ float sdm_to_float(float v) { return v; }
__device__ __forceinline__ float sdm_to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T sdm_from_float(float v);
template <> __device__ __forceinline__ float sdm_from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 sdm_from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an fp32 value to T's precision and widen it back (the astype(T) of
// the JAX reference, kept in an fp32 register).
template <typename T> __device__ __forceinline__ float sdm_round(float v) {
  return sdm_to_float(sdm_from_float<T>(v));
}

// 8 consecutive elements <-> 8 floats; the pointer must be 16-byte aligned.
__device__ __forceinline__ void sdm_load8(const float* p, float v[8]) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void sdm_load8(const __nv_bfloat16* p, float v[8]) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void sdm_store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void sdm_store8(__nv_bfloat16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Sum over the whole block; every thread gets the result. `red` holds one
// float per warp (at most 32 warps).
__device__ __forceinline__ float sdm_block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

#define SDM_EXPORT extern "C" __attribute__((visibility("default")))

SDM_EXPORT const char* sdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
