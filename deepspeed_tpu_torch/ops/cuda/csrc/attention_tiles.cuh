// Tile building blocks of the attention kernels for Hopper (sm_90a),
// shared by sparse_attention.cu and flash_attention.cu (their 16-bit
// kernels are wgmma kernels on hopper.cuh, which includes this header):
//
//   * the tile size, the mask value, strides and the 16-bit types with
//     their packing, the quad reductions of an accumulator row;
//   * f32: CUDA-core FMAs over rows split among neighbouring threads (the
//     f32 flash and sparse kernels);
//   * launch helpers (dynamic shared memory opt-in, strides, typed pointers,
//     the dtype / head-dim dispatch).
//
// Everything is in an anonymous namespace: each source that includes this
// header gets its own copy, and only the sources' extern "C" functions are
// exported.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;           // rows of a query tile and of a key tile
constexpr float kNegInf = -1e30f;   // the TPU kernels' initial running max
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, s, h;                // in elements; channel stride is 1
};

// ===========================================================================
// bf16 / fp16
// ===========================================================================
using bf16 = __nv_bfloat16;
using f16 = __half;

// two floats rounded to T (round to nearest even), packed lo | hi << 16
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack<bf16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack<f16>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// max / sum over the 4 lanes of a quad (the threads that share an
// accumulator row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// ===========================================================================
// f32: CUDA-core FMAs
// ===========================================================================
constexpr int kFwdGroup = 16;       // keys scored per softmax rescale
constexpr int kBwdGroup = 8;        // keys (dq) / query rows (dk, dv) per step

// How a row of D channels is split over threads: each owns CH channels,
// and the threads of a row are a power of two (the shuffle sums). The
// forward takes 32; the backward kernels hold three or four row vectors, so
// they take 16 up to D = 64 (registers limit them). D = 96 takes 24 in both
// and D = 80 20 (4 threads a row).
template <int D, int CH>
struct Split {
  static constexpr int kD = D;
  static constexpr int kCh = CH;
  static constexpr int kTpr = D / CH;       // threads per row
  static constexpr int kChunks = CH / 4;    // 4-channel chunks per thread
  static constexpr int kThreads = kRows * kTpr;
};
template <int D>
using FwdSplit = Split<D, (D == 96 ? 24 : D == 80 ? 20 : 32)>;
template <int D>
using BwdSplit =
    Split<D, (D == 96 ? 24 : D == 80 ? 20 : D <= 64 ? 16 : 32)>;

// first channel of chunk i of the thread that is part `part` of its row
template <class SP>
__device__ __forceinline__ int chan(int part, int i) {
  return 4 * (part + SP::kTpr * i);
}

// This thread's channels of a row into registers (zeros past S).
template <class SP>
__device__ __forceinline__ void load_row(const float* base, Strides st, int b,
                                         int s, int h, int S, int part,
                                         float* out) {
#pragma unroll
  for (int i = 0; i < SP::kChunks; ++i) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S)
      x = *reinterpret_cast<const float4*>(
          base + b * st.b + s * st.s + h * st.h + chan<SP>(part, i));
    out[4 * i] = x.x; out[4 * i + 1] = x.y;
    out[4 * i + 2] = x.z; out[4 * i + 3] = x.w;
  }
}

template <class SP>
__device__ __forceinline__ void store_row(float* base, int b, int s, int h,
                                          int S, int H, int part,
                                          const float* v) {
  float* p = base + (((long long)b * S + s) * H + h) * SP::kD;
#pragma unroll
  for (int i = 0; i < SP::kChunks; ++i)
    *reinterpret_cast<float4*>(p + chan<SP>(part, i)) =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// Rows r0 .. r0+kRows-1 of one head into shared memory [kRows][D], zeros
// past S.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* base,
                                          Strides st, int b, int h, int r0,
                                          int S) {
  constexpr int kPerRow = D / 4;
  for (int idx = threadIdx.x; idx < kRows * kPerRow; idx += blockDim.x) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      x = *reinterpret_cast<const float4*>(
          base + b * st.b + (long long)(r0 + r) * st.s + h * st.h + c);
    *reinterpret_cast<float4*>(dst + r * D + c) = x;
  }
}

// this thread's part of dot(row registers, staged row)
template <class SP>
__device__ __forceinline__ float part_dot(const float* reg, const float* row,
                                          int part) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < SP::kChunks; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(row + chan<SP>(part, i));
    acc = fmaf(reg[4 * i], x.x, acc);
    acc = fmaf(reg[4 * i + 1], x.y, acc);
    acc = fmaf(reg[4 * i + 2], x.z, acc);
    acc = fmaf(reg[4 * i + 3], x.w, acc);
  }
  return acc;
}

// reg += w * staged row (this thread's channels)
template <class SP>
__device__ __forceinline__ void axpy_row(float* reg, float w, const float* row,
                                         int part) {
#pragma unroll
  for (int i = 0; i < SP::kChunks; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(row + chan<SP>(part, i));
    reg[4 * i] = fmaf(w, x.x, reg[4 * i]);
    reg[4 * i + 1] = fmaf(w, x.y, reg[4 * i + 1]);
    reg[4 * i + 2] = fmaf(w, x.z, reg[4 * i + 2]);
    reg[4 * i + 3] = fmaf(w, x.w, reg[4 * i + 3]);
  }
}

// sum over the TPR neighbouring lanes that share a row
template <int TPR, int N>
__device__ __forceinline__ void row_sum(float* v) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) {
#pragma unroll
    for (int u = 0; u < N; ++u) v[u] += __shfl_xor_sync(kFull, v[u], o);
  }
}

// ===========================================================================
// Launch helpers
// ===========================================================================
// Launch `kernel` on `stream` (dynamic shared memory above 48 KB is opted
// into first); returns the launch's error.
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

dim3 grid_of(int B, int S, int H) {
  return dim3((S + kRows - 1) / kRows, H, B);
}

// f32 shared memory: `tiles` [kRows][D] tiles plus `stats` f32 rows
template <int D>
constexpr size_t f32_smem(int tiles, int stats) {
  return (tiles * kRows * D + stats * kRows) * sizeof(float);
}

// One launcher per kernel and element type T (bf16 / fp16: tensor cores,
// float: CUDA cores); the pointers arrive untyped from the C interface.
template <typename T>
const T* as(const void* p) { return static_cast<const T*>(p); }
template <typename T>
T* as(void* p) { return static_cast<T*>(p); }

// The element types of the C interfaces: 0 = float32, 1 = bfloat16,
// 2 = float16; the head dims: 32, 64, 96, 128, and 80 with kWith80 (the
// flash and sparse kernels; decode has its own dispatch).
// Calls F<T, D, causal>::run(args...) for the runtime dtype / D / causal.
template <template <typename, int, bool> class F, bool kWith80 = false,
          typename... Args>
cudaError_t dispatch(int dtype, int d, int causal, Args... args) {
#define DSTORCH_ATTENTION_CASE(T, D)                                  \
  if (d == D)                                                         \
    return causal ? F<T, D, true>::run(args...)                       \
                  : F<T, D, false>::run(args...);
#define DSTORCH_ATTENTION_DTYPE(T)                                    \
  DSTORCH_ATTENTION_CASE(T, 32)                                       \
  DSTORCH_ATTENTION_CASE(T, 64)                                       \
  DSTORCH_ATTENTION_CASE(T, 96)                                       \
  DSTORCH_ATTENTION_CASE(T, 128)                                      \
  if constexpr (kWith80) {                                            \
    DSTORCH_ATTENTION_CASE(T, 80)                                     \
  }
  if (dtype == 0) {
    DSTORCH_ATTENTION_DTYPE(float)
  } else if (dtype == 1) {
    DSTORCH_ATTENTION_DTYPE(bf16)
  } else if (dtype == 2) {
    DSTORCH_ATTENTION_DTYPE(f16)
  }
#undef DSTORCH_ATTENTION_DTYPE
#undef DSTORCH_ATTENTION_CASE
  return cudaErrorInvalidValue;
}

bool bad_shape(int B, int S, int H) { return B < 1 || S < 1 || H < 1; }

}  // namespace
