// Row LayerNorm, forward and input gradient, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of deepspeed_tpu/ops/pallas/layer_norm.py:
//   * layer_norm_fwd_*kernel <- `_fwd_kernel` (B6), through `_ln_fwd`
//   * layer_norm_dx_*kernel  <- `_dx_kernel`  (B6), through `_ln_bwd`
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
// the dx kernel reads x and dy and writes dx).
//
// The forward holds each row in registers (rowwise.cuh's packs): it reads
// the row from device memory once, takes the mean and then the variance of
// (x - mean) from those registers with shuffle sums, reads gamma and beta
// as packs and writes y once. Which shapes take which path:
//   * d <= 1024: layer_norm_fwd_kernel, one warp a row, 4 rows (warps) a
//     block, no shared memory; 8, 16 or 32 elements a lane for d <= 256,
//     <= 512, <= 1024;
//   * 1024 < d <= 16384: layer_norm_fwd_block_kernel, one block a row of
//     ceil(d / 1024) warps (<= 16), 32 elements a thread, one shared slot a
//     warp for each of the two sums;
//   * d > 16384: layer_norm_fwd_loop_kernel, one block a row looping over
//     it in three passes (the passes after the first re-read the row from
//     L1/L2).
// The first two read and write 16-byte packs (8 bf16 / fp16 or 4 f32
// elements a lane) when d is a multiple of the pack and x, y, gamma and
// beta are 16-byte aligned, else the same kernel at one element a pack
// (predicated scalar accesses). dx takes the same three paths
// (layer_norm_dx_kernel, layer_norm_dx_block_kernel,
// layer_norm_dx_loop_kernel) and the same packs (x, dy, dx and gamma
// aligned): the first two read the row's x and dy and gamma once into
// registers (at one element a pack dy and gamma are read again in the
// second pass: registers), take both f32 sums (w and w xhat) in one pass and one
// reduction (shuffles, then one shared slot a warp for each sum), and write
// dx once. Holding gamma as well as x and dy takes up to 96 registers a
// thread (f32), so the dx warp-row kernel runs 4 blocks an SM (16 warps,
// 128 registers) and the block-row kernel one 16-warp block. The loop
// kernel re-reads the row from L1/L2 in its second pass.
//
// Plain C interface (no PyTorch headers), bound with ctypes by
// deepspeed_tpu_torch/ops/cuda/layer_norm.py.

#include "rowwise.cuh"

namespace {

// dx holds x, dy and gamma: 16 warps an SM, at most 128 registers a thread
constexpr int kDxWarpRowMinBlocks = 4;

// The register forward of one row, held by a row group (one warp, or the
// block with `slots`: 64 floats) as E / V packs of V elements a thread.
template <typename T, typename G, int V, int E, bool kBlock>
__device__ __forceinline__ void layer_norm_regs_row(
    const T* __restrict__ xr, const G* __restrict__ gamma,
    const G* __restrict__ beta, T* __restrict__ yr,
    float* __restrict__ mean_out, float* __restrict__ rstd_out, int d,
    float eps, int rank, int size, float* slots) {
  constexpr int NV = E / V;
  Pack<T, V> a[NV];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = pack_col<V>(j, rank, size);
    if (c < d) {
      a[j] = load_pack<T, V>(xr + c);
#pragma unroll
      for (int e = 0; e < V; ++e) s += to_f32(a[j].v[e]);
    }
  }
  const float mean = row_sum<kBlock>(s, slots) / (float)d;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (pack_col<V>(j, rank, size) < d) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float c = to_f32(a[j].v[e]) - mean;
        q += c * c;
      }
    }
  }
  const float var =
      row_sum<kBlock>(q, kBlock ? slots + 32 : nullptr) / (float)d;
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = pack_col<V>(j, rank, size);
    if (c < d) {
      const Pack<G, V> g = load_pack<G, V>(gamma + c);
      const Pack<G, V> b = load_pack<G, V>(beta + c);
      Pack<T, V> o;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = (to_f32(a[j].v[e]) - mean) * rstd;
        o.v[e] = from_f32<T>(xhat * to_f32(g.v[e]) + to_f32(b.v[e]));
      }
      store_pack<T, V>(yr + c, o);
    }
  }
  if (rank == 0) {
    *mean_out = mean;
    *rstd_out = rstd;
  }
}

template <typename T, typename G, int V, int E>
__global__ void __launch_bounds__(32 * kWarpRows, kWarpRowMinBlocks)
layer_norm_fwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                      const G* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ rstd,
                      int n, int d, float eps) {
  const long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= n) return;                 // whole warps leave together
  layer_norm_regs_row<T, G, V, E, false>(
      x + row * d, gamma, beta, y + row * d, mean + row, rstd + row, d, eps,
      threadIdx.x & 31, 32, nullptr);
}

template <typename T, typename G, int V>
__global__ void __launch_bounds__(32 * kBlockRowWarps, kBlockRowMinBlocks)
layer_norm_fwd_block_kernel(const T* __restrict__ x,
                            const G* __restrict__ gamma,
                            const G* __restrict__ beta, T* __restrict__ y,
                            float* __restrict__ mean,
                            float* __restrict__ rstd, int d, float eps) {
  __shared__ float slots[64];
  const long long row = blockIdx.x;
  layer_norm_regs_row<T, G, V, kRowElems, true>(
      x + row * d, gamma, beta, y + row * d, mean + row, rstd + row, d, eps,
      threadIdx.x, blockDim.x, slots);
}

// Rows wider than kBlockRowMax: one block a row, looping over it.
template <typename T, typename G>
__global__ void __launch_bounds__(1024)
layer_norm_fwd_loop_kernel(const T* __restrict__ x,
                           const G* __restrict__ gamma,
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

// The register dx of one row, held by a row group (one warp, or the block
// with `slots`: 64 floats) as E / V packs of V elements a thread.
template <typename T, typename G, int V, int E, bool kBlock>
__device__ __forceinline__ void layer_norm_dx_regs_row(
    const T* __restrict__ xr, const G* __restrict__ gamma, float mean,
    float rstd, const T* __restrict__ dyr, T* __restrict__ dxr, int d,
    int rank, int size, float* slots) {
  constexpr int NV = E / V;
  // dy and gamma stay in registers beside x when the row is read in
  // 16-byte packs; at one element a pack (32 scalars of each, with their
  // addresses and predicates) they would spill, and are read again (from
  // L1) in the second pass instead
  constexpr bool kHold = V > 1;
  Pack<T, V> a[NV], dy[kHold ? NV : 1];
  Pack<G, V> g[kHold ? NV : 1];
  const auto dy_pack = [&](int j, int c) {
    if constexpr (kHold) return dy[j];
    else return load_pack<T, V>(dyr + c);
  };
  const auto gamma_pack = [&](int j, int c) {
    if constexpr (kHold) return g[j];
    else return load_pack<G, V>(gamma + c);
  };
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = pack_col<V>(j, rank, size);
    if (c < d) {
      a[j] = load_pack<T, V>(xr + c);
      if constexpr (kHold) {
        dy[j] = load_pack<T, V>(dyr + c);
        g[j] = load_pack<G, V>(gamma + c);
      }
    }
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = pack_col<V>(j, rank, size);
    if (c < d) {
      const Pack<T, V> dp = dy_pack(j, c);
      const Pack<G, V> gp = gamma_pack(j, c);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = (to_f32(a[j].v[e]) - mean) * rstd;
        const float w = to_f32(dp.v[e]) * to_f32(gp.v[e]);
        s1 += w;
        s2 += w * xhat;
      }
    }
  }
  row_sum2<kBlock>(s1, s2, slots);
  const float c1 = s1 / (float)d, c2 = s2 / (float)d;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = pack_col<V>(j, rank, size);
    if (c < d) {
      const Pack<T, V> dp = dy_pack(j, c);
      const Pack<G, V> gp = gamma_pack(j, c);
      Pack<T, V> o;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = (to_f32(a[j].v[e]) - mean) * rstd;
        const float w = to_f32(dp.v[e]) * to_f32(gp.v[e]);
        o.v[e] = from_f32<T>((w - c1 - xhat * c2) * rstd);
      }
      store_pack<T, V>(dxr + c, o);
    }
  }
}

template <typename T, typename G, int V, int E>
__global__ void __launch_bounds__(32 * kWarpRows, kDxWarpRowMinBlocks)
layer_norm_dx_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const T* __restrict__ dy, T* __restrict__ dx, int n,
                     int d) {
  const long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= n) return;                 // whole warps leave together
  layer_norm_dx_regs_row<T, G, V, E, false>(
      x + row * d, gamma, mean[row], rstd[row], dy + row * d, dx + row * d,
      d, threadIdx.x & 31, 32, nullptr);
}

template <typename T, typename G, int V>
__global__ void __launch_bounds__(32 * kBlockRowWarps, 1)
layer_norm_dx_block_kernel(const T* __restrict__ x,
                           const G* __restrict__ gamma,
                           const float* __restrict__ mean,
                           const float* __restrict__ rstd,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           int d) {
  __shared__ float slots[64];
  const long long row = blockIdx.x;
  layer_norm_dx_regs_row<T, G, V, kRowElems, true>(
      x + row * d, gamma, mean[row], rstd[row], dy + row * d, dx + row * d,
      d, threadIdx.x, blockDim.x, slots);
}

// Rows wider than kBlockRowMax: one block a row, looping over it.
template <typename T, typename G>
__global__ void __launch_bounds__(1024)
layer_norm_dx_loop_kernel(const T* __restrict__ x,
                          const G* __restrict__ gamma,
                          const float* __restrict__ mean_in,
                          const float* __restrict__ rstd_in,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          int d) {
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

struct FwdArgs {
  const void* x;
  const void* gamma;
  const void* beta;
  void* y;
  float* mean;
  float* rstd;
  int n, d;
  float eps;
};

template <typename T, typename G, int V, int E>
void fwd_warp(const FwdArgs& a, cudaStream_t stream) {
  layer_norm_fwd_kernel<T, G, V, E>
      <<<(a.n + kWarpRows - 1) / kWarpRows, 32 * kWarpRows, 0, stream>>>(
          static_cast<const T*>(a.x), static_cast<const G*>(a.gamma),
          static_cast<const G*>(a.beta), static_cast<T*>(a.y), a.mean,
          a.rstd, a.n, a.d, a.eps);
}

// The register kernels at packs of V elements (d <= kBlockRowMax).
template <typename T, typename G, int V>
void fwd_packs(const FwdArgs& a, cudaStream_t stream) {
  if (a.d > kWarpRowMax) {
    layer_norm_fwd_block_kernel<T, G, V>
        <<<a.n, block_row_threads(a.d), 0, stream>>>(
            static_cast<const T*>(a.x), static_cast<const G*>(a.gamma),
            static_cast<const G*>(a.beta), static_cast<T*>(a.y), a.mean,
            a.rstd, a.d, a.eps);
    return;
  }
  switch (warp_row_elems(a.d)) {
    case 8: fwd_warp<T, G, V, 8>(a, stream); break;
    case 16: fwd_warp<T, G, V, 16>(a, stream); break;
    default: fwd_warp<T, G, V, 32>(a, stream); break;
  }
}

template <typename T, typename G>
int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  if (a.d > kBlockRowMax)
    layer_norm_fwd_loop_kernel<T, G><<<a.n, row_threads(a.d), 0, stream>>>(
        static_cast<const T*>(a.x), static_cast<const G*>(a.gamma),
        static_cast<const G*>(a.beta), static_cast<T*>(a.y), a.mean, a.rstd,
        a.d, a.eps);
  else if (a.d % kVec16<T> == 0 && aligned16(a.x) && aligned16(a.y) &&
           aligned16(a.gamma) && aligned16(a.beta))
    fwd_packs<T, G, kVec16<T>>(a, stream);
  else
    fwd_packs<T, G, 1>(a, stream);
  return (int)cudaGetLastError();
}

struct DxArgs {
  const void* x;
  const void* gamma;
  const float* mean;
  const float* rstd;
  const void* dy;
  void* dx;
  int n, d;
};

template <typename T, typename G, int V, int E>
void dx_warp(const DxArgs& a, cudaStream_t stream) {
  layer_norm_dx_kernel<T, G, V, E>
      <<<(a.n + kWarpRows - 1) / kWarpRows, 32 * kWarpRows, 0, stream>>>(
          static_cast<const T*>(a.x), static_cast<const G*>(a.gamma), a.mean,
          a.rstd, static_cast<const T*>(a.dy), static_cast<T*>(a.dx), a.n,
          a.d);
}

// The register kernels at packs of V elements (d <= kBlockRowMax).
template <typename T, typename G, int V>
void dx_packs(const DxArgs& a, cudaStream_t stream) {
  if (a.d > kWarpRowMax) {
    layer_norm_dx_block_kernel<T, G, V>
        <<<a.n, block_row_threads(a.d), 0, stream>>>(
            static_cast<const T*>(a.x), static_cast<const G*>(a.gamma),
            a.mean, a.rstd, static_cast<const T*>(a.dy),
            static_cast<T*>(a.dx), a.d);
    return;
  }
  switch (warp_row_elems(a.d)) {
    case 8: dx_warp<T, G, V, 8>(a, stream); break;
    case 16: dx_warp<T, G, V, 16>(a, stream); break;
    default: dx_warp<T, G, V, 32>(a, stream); break;
  }
}

template <typename T, typename G>
int launch_dx(const DxArgs& a, cudaStream_t stream) {
  if (a.d > kBlockRowMax)
    layer_norm_dx_loop_kernel<T, G><<<a.n, row_threads(a.d), 0, stream>>>(
        static_cast<const T*>(a.x), static_cast<const G*>(a.gamma), a.mean,
        a.rstd, static_cast<const T*>(a.dy), static_cast<T*>(a.dx), a.d);
  else if (a.d % kVec16<T> == 0 && aligned16(a.x) && aligned16(a.dy) &&
           aligned16(a.dx) && aligned16(a.gamma))
    dx_packs<T, G, kVec16<T>>(a, stream);
  else
    dx_packs<T, G, 1>(a, stream);
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
  const FwdArgs a{x, gamma, beta, y, mean, rstd, n, d, eps};
  switch (dtype) {
    case kF32:
      return launch_fwd<float, float>(a, s);
    case kBF16:
      return param_f32 ? launch_fwd<__nv_bfloat16, float>(a, s)
                       : launch_fwd<__nv_bfloat16, __nv_bfloat16>(a, s);
    case kF16:
      return param_f32 ? launch_fwd<__half, float>(a, s)
                       : launch_fwd<__half, __half>(a, s);
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
  const DxArgs a{x, gamma, mean, rstd, dy, dx, n, d};
  switch (dtype) {
    case kF32:
      return launch_dx<float, float>(a, s);
    case kBF16:
      return param_f32 ? launch_dx<__nv_bfloat16, float>(a, s)
                       : launch_dx<__nv_bfloat16, __nv_bfloat16>(a, s);
    case kF16:
      return param_f32 ? launch_dx<__half, float>(a, s)
                       : launch_dx<__half, __half>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
