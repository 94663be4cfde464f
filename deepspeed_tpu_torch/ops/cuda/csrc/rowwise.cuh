// Building blocks shared by the row-wise kernels for Hopper (sm_90a):
// layer_norm.cu (B6), gelu.cu (B7) and softmax.cu (B8).
//
//   * element types: f32, bf16 and fp16, converted to and from f32 by the
//     intrinsics only (the build defines __CUDA_NO_*_CONVERSIONS__);
//   * warp and block reductions of f32 sums and maxima (shuffles, then one
//     shared slot per warp);
//   * the register layout of the kernels (the LayerNorm forward and dx, the
//     softmax forward) that hold a row in registers: `Pack`s of V elements, read and written with
//     16-byte accesses where V = 16 / sizeof(T), and the row-group index
//     of each pack;
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

// Every thread of the block returns the block-wide sum (max), each adding
// the warps' partials in the same order. blockDim.x is a multiple of 32,
// at most 1024. `slots` (32 floats) serves this one call: with a fresh
// array for each reduction no trailing barrier is needed.
__device__ __forceinline__ float block_sum_once(float v, float* slots) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  float r = 0.f;
  for (int w = 0; w < nw; ++w) r += slots[w];
  return r;
}

__device__ __forceinline__ float block_max_once(float v, float* slots) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  float r = -FLT_MAX;
  for (int w = 0; w < nw; ++w) r = fmaxf(r, slots[w]);
  return r;
}

// The same with `red` reusable by the next call (a trailing barrier).
__device__ __forceinline__ float block_sum(float v, float* red) {
  const float r = block_sum_once(v, red);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const float r = block_max_once(v, red);
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------------------
// A row in registers. The threads that share a row (a "row group": one warp,
// or every thread of a block) hold it as packs of V neighbouring elements:
// thread `rank` of a group of `size` holds packs j = 0 .. NV-1 at element
// (j * size + rank) * V, so each warp-wide access covers 32 neighbouring
// packs (512 bytes at V = 16 / sizeof(T)). V is 16 / sizeof(T) when the row
// width is a multiple of it and every pointer is 16-byte aligned (one
// 16-byte load or store a pack), else 1 (predicated scalar accesses).
// ---------------------------------------------------------------------------

template <typename T>
constexpr int kVec16 = 16 / (int)sizeof(T);   // elements of a 16-byte pack

constexpr int kRowElems = 32;                  // most elements a thread holds
constexpr int kWarpRowMax = 32 * kRowElems;    // widest row a warp holds
constexpr int kWarpRows = 4;                   // rows (warps) of a warp-row block
constexpr int kWarpRowMinBlocks = 8;           // 32 warps an SM: <= 64 registers
constexpr int kBlockRowWarps = 16;             // most warps of a block-row block
constexpr int kBlockRowMax = kBlockRowWarps * kWarpRowMax;  // widest row held
constexpr int kBlockRowMinBlocks = 2;          // 32 warps an SM at 16 a block

// Elements each lane holds of a row of d <= kWarpRowMax in one warp.
inline int warp_row_elems(int d) { return d <= 256 ? 8 : d <= 512 ? 16 : 32; }

// Threads of a block that holds a row of kWarpRowMax < d <= kBlockRowMax,
// kRowElems elements each.
inline int block_row_threads(int d) {
  return 32 * ((d + kWarpRowMax - 1) / kWarpRowMax);
}

template <typename T, int V>
struct alignas(V * sizeof(T) >= 16 ? 16 : V * sizeof(T)) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* __restrict__ p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* __restrict__ p,
                                           const Pack<T, V>& a) {
  *reinterpret_cast<Pack<T, V>*>(p) = a;
}

// First element of pack j of thread `rank` in a row group of `size`.
template <int V>
__device__ __forceinline__ int pack_col(int j, int rank, int size) {
  return (j * size + rank) * V;
}

// Sum (max) over a row group: the warp's shuffles, or the block's with
// `slots` (32 floats, used by this one call).
template <bool kBlock>
__device__ __forceinline__ float row_sum(float v, float* slots) {
  if constexpr (kBlock) return block_sum_once(v, slots);
  else return warp_sum(v);
}

// Two sums over a row group in one reduction: the warp's shuffles, or the
// block's with `slots` (64 floats, used by this one call: one barrier).
template <bool kBlock>
__device__ __forceinline__ void row_sum2(float& a, float& b, float* slots) {
  a = warp_sum(a);
  b = warp_sum(b);
  if constexpr (kBlock) {
    if ((threadIdx.x & 31) == 0) {
      slots[threadIdx.x >> 5] = a;
      slots[32 + (threadIdx.x >> 5)] = b;
    }
    __syncthreads();
    const int nw = blockDim.x >> 5;
    a = b = 0.f;
    for (int w = 0; w < nw; ++w) {
      a += slots[w];
      b += slots[32 + w];
    }
  }
}

template <bool kBlock>
__device__ __forceinline__ float row_max(float v, float* slots) {
  if constexpr (kBlock) return block_max_once(v, slots);
  else return warp_max(v);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
