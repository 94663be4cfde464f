// Bias + tanh-GELU, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of deepspeed_tpu/ops/pallas/gelu.py (both run
// through `_run_rowwise`):
//   * bias_gelu_fwd_kernel <- `_fwd_kernel` (B7): y = gelu(x + bias)
//   * bias_gelu_bwd_kernel <- `_bwd_kernel` (B7): dx = gelu'(x + bias) dy
// with the TPU kernels' tanh approximation (the reference's gelu_kernels.cu):
//   gelu(u)  = 0.5 u (1 + t),  t = tanh(sqrt(2/pi) (u + 0.044715 u^3))
//   gelu'(u) = 0.5 (1 + t) + 0.5 u (1 - t^2) sqrt(2/pi) (1 + 3 0.044715 u^2)
// u = x + bias is formed in f32; tanhf is the accurate libdevice tanh, not
// tanh.approx.f32 (the build has no fast-math flag). Outputs are in x's
// type; dbias is the wrapper's f32 sum of the rounded dx, as in the TPU
// package (gelu.py:76-84).
//
// Bound: device-memory bytes (the forward reads x and writes y, the
// backward reads x and dy and writes dx; the [d] bias stays in L1/L2). A
// grid-stride elementwise loop over the flattened [n, d] tensor; the bias
// of element i is bias[i % d]. When d is a multiple of a 16-byte vector
// (4 f32, 8 bf16/fp16 elements) and the pointers are 16-byte aligned, each
// thread moves 16-byte vectors, whose elements share one row.
//
// Plain C interface (no PyTorch headers), bound with ctypes by
// deepspeed_tpu_torch/ops/cuda/gelu.py.

#include "rowwise.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;    // grid-stride beyond 16 blocks an SM
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kCoeff = 0.044715f;

__device__ __forceinline__ float gelu(float u) {
  const float t = tanhf(kSqrt2OverPi * (u + kCoeff * (u * u * u)));
  return 0.5f * u * (1.0f + t);
}

__device__ __forceinline__ float dgelu(float u) {
  const float t = tanhf(kSqrt2OverPi * (u + kCoeff * (u * u * u)));
  const float dt = (1.0f - t * t) * kSqrt2OverPi * (1.0f + 3.0f * kCoeff * u * u);
  return 0.5f * (1.0f + t) + 0.5f * u * dt;
}

// One 16-byte vector of T.
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T, typename B, bool kVector>
__global__ void __launch_bounds__(kThreads)
bias_gelu_fwd_kernel(const T* __restrict__ x, const B* __restrict__ bias,
                     T* __restrict__ y, long long total, int d) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (kVector) {
    constexpr int N = Vec<T>::N;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
    Vec<T>* yv = reinterpret_cast<Vec<T>*>(y);
    for (long long i = first; i < total / N; i += stride) {
      const Vec<T> a = xv[i];
      const int c = (int)((i * N) % d);
      Vec<T> out;
#pragma unroll
      for (int e = 0; e < N; ++e)
        out.v[e] = from_f32<T>(gelu(to_f32(a.v[e]) + to_f32(bias[c + e])));
      yv[i] = out;
    }
  } else {
    for (long long i = first; i < total; i += stride)
      y[i] = from_f32<T>(gelu(to_f32(x[i]) + to_f32(bias[i % d])));
  }
}

template <typename T, typename B, bool kVector>
__global__ void __launch_bounds__(kThreads)
bias_gelu_bwd_kernel(const T* __restrict__ x, const B* __restrict__ bias,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     long long total, int d) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (kVector) {
    constexpr int N = Vec<T>::N;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
    const Vec<T>* dyv = reinterpret_cast<const Vec<T>*>(dy);
    Vec<T>* dxv = reinterpret_cast<Vec<T>*>(dx);
    for (long long i = first; i < total / N; i += stride) {
      const Vec<T> a = xv[i], g = dyv[i];
      const int c = (int)((i * N) % d);
      Vec<T> out;
#pragma unroll
      for (int e = 0; e < N; ++e)
        out.v[e] = from_f32<T>(dgelu(to_f32(a.v[e]) + to_f32(bias[c + e]))
                               * to_f32(g.v[e]));
      dxv[i] = out;
    }
  } else {
    for (long long i = first; i < total; i += stride)
      dx[i] = from_f32<T>(dgelu(to_f32(x[i]) + to_f32(bias[i % d]))
                          * to_f32(dy[i]));
  }
}

inline int blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

// dy and dx null: the forward (x -> y in `out`); else the backward.
template <typename T, typename B>
int launch(const void* x, const void* bias, const void* dy, void* out,
           long long total, int d, int vector, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const B* bt = static_cast<const B*>(bias);
  T* ot = static_cast<T*>(out);
  const long long work = vector ? total / Vec<T>::N : total;
  const int blocks = blocks_for(work);
  if (dy == nullptr) {
    if (vector)
      bias_gelu_fwd_kernel<T, B, true><<<blocks, kThreads, 0, stream>>>(
          xt, bt, ot, total, d);
    else
      bias_gelu_fwd_kernel<T, B, false><<<blocks, kThreads, 0, stream>>>(
          xt, bt, ot, total, d);
  } else {
    const T* gt = static_cast<const T*>(dy);
    if (vector)
      bias_gelu_bwd_kernel<T, B, true><<<blocks, kThreads, 0, stream>>>(
          xt, bt, gt, ot, total, d);
    else
      bias_gelu_bwd_kernel<T, B, false><<<blocks, kThreads, 0, stream>>>(
          xt, bt, gt, ot, total, d);
  }
  return (int)cudaGetLastError();
}

int dispatch(const void* x, const void* bias, const void* dy, void* out,
             long long total, int d, int dtype, int bias_f32,
             void* stream) {
  if (total < 1 || d < 1 || total % d) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = dtype == kF32 ? 4 : 2;
  const int per_vec = 16 / elem;
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(x)
      | reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(out);
  const int vector = d % per_vec == 0 && addresses % 16 == 0;
  switch (dtype) {
    case kF32:
      return launch<float, float>(x, bias, dy, out, total, d, vector, s);
    case kBF16:
      return bias_f32
          ? launch<__nv_bfloat16, float>(x, bias, dy, out, total, d, vector,
                                         s)
          : launch<__nv_bfloat16, __nv_bfloat16>(x, bias, dy, out, total, d,
                                                 vector, s);
    case kF16:
      return bias_f32
          ? launch<__half, float>(x, bias, dy, out, total, d, vector, s)
          : launch<__half, __half>(x, bias, dy, out, total, d, vector, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: [total / d, d] of dtype (0 f32, 1 bf16, 2 fp16); bias [d] f32 when
// bias_f32, else x's type.
extern "C" int dstorch_bias_gelu_fwd(const void* x, const void* bias, void* y,
                                     long long total, int d, int dtype,
                                     int bias_f32, void* stream) {
  return dispatch(x, bias, nullptr, y, total, d, dtype, bias_f32, stream);
}

extern "C" int dstorch_bias_gelu_bwd(const void* x, const void* bias,
                                     const void* dy, void* dx,
                                     long long total, int d, int dtype,
                                     int bias_f32, void* stream) {
  if (dy == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(x, bias, dy, dx, total, d, dtype, bias_f32, stream);
}
