// Building blocks shared by the row-wise kernels for Hopper (sm_90a):
// layer_norm.cu (B6), gelu.cu (B7) and softmax.cu (B8).
//
//   * element types: f32, bf16 and fp16, converted to and from f32 by the
//     intrinsics only (the build defines __CUDA_NO_*_CONVERSIONS__);
//   * warp and block reductions of f32 sums and maxima (shuffles, then one
//     shared slot per warp);
//   * the dtype codes the Python wrappers pass (0 f32, 1 bf16, 2 fp16).
//
// Everything is in an anonymous namespace: each source that includes this
// header gets its own copy, and only the sources' extern "C" functions are
// exported.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);           // round to nearest even
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);               // round to nearest even
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Every thread of the block returns the block-wide sum (max). blockDim.x is
// a multiple of 32, at most 1024; `red` holds 32 floats. The trailing
// barrier makes `red` reusable by the next call.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  float r = 0.f;
  for (int w = 0; w < nw; ++w) r += red[w];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  float r = -FLT_MAX;
  for (int w = 0; w < nw; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

// Threads for one block per row of `d` elements: about four elements a
// thread, a multiple of 32, between 32 and 1024.
inline int row_threads(long long d) {
  long long t = (d + 3) / 4;
  t = (t + 31) / 32 * 32;
  if (t < 32) t = 32;
  if (t > 1024) t = 1024;
  return (int)t;
}

}  // namespace
