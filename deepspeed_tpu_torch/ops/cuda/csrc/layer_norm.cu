// Row LayerNorm, forward and input gradient, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of deepspeed_tpu/ops/pallas/layer_norm.py:
//   * layer_norm_fwd_kernel <- `_fwd_kernel` (B6), through `_ln_fwd`
//   * layer_norm_dx_kernel  <- `_dx_kernel`  (B6), through `_ln_bwd`
// They compute what the TPU kernels compute, in f32 whatever the element
// type, over rows of x [n, d]:
//   mean = sum(x) / d, var = sum((x - mean)^2) / d   (two passes, as the
//   TPU kernel), rstd = rsqrt(var + eps), y = (x - mean) rstd gamma + beta
//   dx = (w - mean(w) - xhat mean(w xhat)) rstd,  w = dy gamma,
//        xhat = (x - mean) rstd recomputed from the saved mean and rstd
// y and dx are written in x's type; mean and rstd are f32 [n]. x and dy
// are f32, bf16 or fp16; gamma and beta are f32 or x's type (flax keeps f32
// parameters under a bf16 body, the training engine casts its compute copy
// to bf16). dgamma and dbeta are torch reductions across rows in the
// wrapper, as they are XLA reductions outside Pallas in the TPU package.
//
// Bound: device-memory bytes (x, gamma, beta read once, y written once;
// the dx kernel reads x and dy and writes dx). One block per row, about
// four elements a thread (32-1024 threads), so any n and any d: a row
// wider than 4096 elements loops. The passes after the first re-read the
// row from L1/L2, not from device memory. f32 sums reduced with warp
// shuffles and one shared slot per warp. Vector loads and several rows per
// block for narrow rows are later work.
//
// Plain C interface (no PyTorch headers), bound with ctypes by
// deepspeed_tpu_torch/ops/cuda/layer_norm.py.

#include "rowwise.cuh"

namespace {

template <typename T, typename G>
__global__ void __launch_bounds__(1024)
layer_norm_fwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                      const G* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ mean_out,
                      float* __restrict__ rstd_out, int d, float eps) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) s += to_f32(xr[i]);
  const float mean = block_sum(s, red) / (float)d;
  float v = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float c = to_f32(xr[i]) - mean;
    v += c * c;
  }
  const float var = block_sum(v, red) / (float)d;
  const float rstd = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float xhat = (to_f32(xr[i]) - mean) * rstd;
    yr[i] = from_f32<T>(xhat * to_f32(gamma[i]) + to_f32(beta[i]));
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, typename G>
__global__ void __launch_bounds__(1024)
layer_norm_dx_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                     const float* __restrict__ mean_in,
                     const float* __restrict__ rstd_in,
                     const T* __restrict__ dy, T* __restrict__ dx, int d) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  const T* dyr = dy + row * d;
  T* dxr = dx + row * d;
  const float mean = mean_in[row], rstd = rstd_in[row];
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float xhat = (to_f32(xr[i]) - mean) * rstd;
    const float w = to_f32(dyr[i]) * to_f32(gamma[i]);
    s1 += w;
    s2 += w * xhat;
  }
  const float c1 = block_sum(s1, red) / (float)d;
  const float c2 = block_sum(s2, red) / (float)d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float xhat = (to_f32(xr[i]) - mean) * rstd;
    const float w = to_f32(dyr[i]) * to_f32(gamma[i]);
    dxr[i] = from_f32<T>((w - c1 - xhat * c2) * rstd);
  }
}

template <typename T, typename G>
int launch_fwd(const void* x, const void* gamma, const void* beta, void* y,
               float* mean, float* rstd, int n, int d, float eps,
               cudaStream_t stream) {
  layer_norm_fwd_kernel<T, G><<<n, row_threads(d), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const G*>(gamma),
      static_cast<const G*>(beta), static_cast<T*>(y), mean, rstd, d, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename G>
int launch_dx(const void* x, const void* gamma, const float* mean,
              const float* rstd, const void* dy, void* dx, int n, int d,
              cudaStream_t stream) {
  layer_norm_dx_kernel<T, G><<<n, row_threads(d), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const G*>(gamma), mean, rstd,
      static_cast<const T*>(dy), static_cast<T*>(dx), d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 fp16 (x, y, dy, dx); param_f32: gamma and beta
// are f32 (else x's type).
extern "C" int dstorch_layer_norm_fwd(const void* x, const void* gamma,
                                      const void* beta, void* y, float* mean,
                                      float* rstd, int n, int d, float eps,
                                      int dtype, int param_f32, void* stream) {
  if (n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_fwd<float, float>(x, gamma, beta, y, mean, rstd, n, d,
                                      eps, s);
    case kBF16:
      return param_f32
          ? launch_fwd<__nv_bfloat16, float>(x, gamma, beta, y, mean, rstd,
                                             n, d, eps, s)
          : launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, mean,
                                                     rstd, n, d, eps, s);
    case kF16:
      return param_f32
          ? launch_fwd<__half, float>(x, gamma, beta, y, mean, rstd, n, d,
                                      eps, s)
          : launch_fwd<__half, __half>(x, gamma, beta, y, mean, rstd, n, d,
                                       eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dstorch_layer_norm_dx(const void* x, const void* gamma,
                                     const float* mean, const float* rstd,
                                     const void* dy, void* dx, int n, int d,
                                     int dtype, int param_f32, void* stream) {
  if (n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_dx<float, float>(x, gamma, mean, rstd, dy, dx, n, d, s);
    case kBF16:
      return param_f32
          ? launch_dx<__nv_bfloat16, float>(x, gamma, mean, rstd, dy, dx, n,
                                            d, s)
          : launch_dx<__nv_bfloat16, __nv_bfloat16>(x, gamma, mean, rstd, dy,
                                                    dx, n, d, s);
    case kF16:
      return param_f32
          ? launch_dx<__half, float>(x, gamma, mean, rstd, dy, dx, n, d, s)
          : launch_dx<__half, __half>(x, gamma, mean, rstd, dy, dx, n, d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
