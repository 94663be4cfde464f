// Row softmax with an optional causal mask, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels of deepspeed_tpu/ops/pallas/softmax.py:
//   * softmax_fwd_*_kernel <- `_fwd_kernel` (B8), through `_softmax_fwd`
//   * softmax_bwd_*_kernel <- `_bwd_kernel` (B8), through `_softmax_bwd`
// over rows of x [n, s], the flattened [..., sq, s] score matrices:
//   causal: x[r, c] = -1e30 where c > r mod sq   (top-left aligned, as the
//           TPU kernel's row index modulo x.shape[-2], softmax.py:27-30)
//   y = exp(x - max) / sum(exp(x - max)),   dx = y (dy - sum(y dy))
// in f32 whatever the element type; y and dx in the input's type. The
// backward reads the saved (rounded) y, as `_softmax_bwd` saves y.
//
// Bound: device-memory bytes (the forward reads x and writes y, the
// backward reads y and dy and writes dx). Rows of up to 1024 elements take
// one warp each (8 rows a block), wider rows one block each (32-1024
// threads), so any s. The forward makes one pass for the running max and
// the rescaled sum (online softmax, f32) and a second for the output; the
// backward one for sum(y dy) and one for dx. The second pass re-reads the
// row from L1/L2. Keeping the row in registers is later work.
//
// Plain C interface (no PyTorch headers), bound with ctypes by
// deepspeed_tpu_torch/ops/cuda/softmax.py.

#include "rowwise.cuh"

namespace {

constexpr float kMaskValue = -1e30f;    // the TPU kernel's NEG_INF
constexpr int kWarpRowMax = 1024;       // widest row one warp takes
constexpr int kWarpRows = 8;            // rows (warps) of a warp-row block

// Reductions over the threads that share a row: one warp, or the block.
struct WarpRow {
  __device__ float sum(float v) const { return warp_sum(v); }
  __device__ float max(float v) const { return warp_max(v); }
};

struct BlockRow {
  float* red;
  __device__ float sum(float v) const { return block_sum(v, red); }
  __device__ float max(float v) const { return block_max(v, red); }
};

template <typename T, typename R>
__device__ __forceinline__ void softmax_row(const T* __restrict__ xr,
                                            T* __restrict__ yr, int s,
                                            int last_col, int idx, int width,
                                            const R& r) {
  float m = -FLT_MAX, l = 0.f;
  for (int c = idx; c < s; c += width) {
    const float v = c > last_col ? kMaskValue : to_f32(xr[c]);
    if (v > m) {
      l = l * expf(m - v) + 1.f;
      m = v;
    } else {
      l += expf(v - m);
    }
  }
  const float row_max = r.max(m);
  const float total = r.sum(l * expf(m - row_max));
  for (int c = idx; c < s; c += width) {
    const float v = c > last_col ? kMaskValue : to_f32(xr[c]);
    yr[c] = from_f32<T>(expf(v - row_max) / total);
  }
}

template <typename T, typename R>
__device__ __forceinline__ void softmax_bwd_row(const T* __restrict__ yr,
                                                const T* __restrict__ dyr,
                                                T* __restrict__ dxr, int s,
                                                int idx, int width,
                                                const R& r) {
  float dot = 0.f;
  for (int c = idx; c < s; c += width) dot += to_f32(yr[c]) * to_f32(dyr[c]);
  dot = r.sum(dot);
  for (int c = idx; c < s; c += width)
    dxr[c] = from_f32<T>(to_f32(yr[c]) * (to_f32(dyr[c]) - dot));
}

// The last unmasked column of a row: r mod sq when causal, else s - 1.
__device__ __forceinline__ int last_col(long long row, int s, int sq,
                                        int causal) {
  return causal ? (int)(row % sq) : s - 1;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpRows)
softmax_fwd_warp_kernel(const T* __restrict__ x, T* __restrict__ y, int n,
                        int s, int sq, int causal) {
  const long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= n) return;                 // whole warps leave together
  softmax_row(x + row * s, y + row * s, s, last_col(row, s, sq, causal),
              threadIdx.x & 31, 32, WarpRow{});
}

template <typename T>
__global__ void __launch_bounds__(1024)
softmax_fwd_block_kernel(const T* __restrict__ x, T* __restrict__ y, int s,
                         int sq, int causal) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  softmax_row(x + row * s, y + row * s, s, last_col(row, s, sq, causal),
              threadIdx.x, blockDim.x, BlockRow{red});
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpRows)
softmax_bwd_warp_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                        T* __restrict__ dx, int n, int s) {
  const long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= n) return;
  softmax_bwd_row(y + row * s, dy + row * s, dx + row * s, s,
                  threadIdx.x & 31, 32, WarpRow{});
}

template <typename T>
__global__ void __launch_bounds__(1024)
softmax_bwd_block_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                         T* __restrict__ dx, int s) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  softmax_bwd_row(y + row * s, dy + row * s, dx + row * s, s, threadIdx.x,
                  blockDim.x, BlockRow{red});
}

template <typename T>
int launch_fwd(const void* x, void* y, int n, int s, int sq, int causal,
               cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (s <= kWarpRowMax)
    softmax_fwd_warp_kernel<T><<<(n + kWarpRows - 1) / kWarpRows,
                                 32 * kWarpRows, 0, stream>>>(xt, yt, n, s,
                                                              sq, causal);
  else
    softmax_fwd_block_kernel<T><<<n, row_threads(s), 0, stream>>>(
        xt, yt, s, sq, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* y, const void* dy, void* dx, int n, int s,
               cudaStream_t stream) {
  const T* yt = static_cast<const T*>(y);
  const T* gt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if (s <= kWarpRowMax)
    softmax_bwd_warp_kernel<T><<<(n + kWarpRows - 1) / kWarpRows,
                                 32 * kWarpRows, 0, stream>>>(yt, gt, dxt, n,
                                                              s);
  else
    softmax_bwd_block_kernel<T><<<n, row_threads(s), 0, stream>>>(yt, gt,
                                                                  dxt, s);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [n, s] of dtype (0 f32, 1 bf16, 2 fp16); sq: rows of one score
// matrix (the causal row index is the row modulo sq).
extern "C" int dstorch_softmax_fwd(const void* x, void* y, int n, int s,
                                   int sq, int causal, int dtype,
                                   void* stream) {
  if (n < 1 || s < 1 || sq < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_fwd<float>(x, y, n, s, sq, causal, st);
    case kBF16: return launch_fwd<__nv_bfloat16>(x, y, n, s, sq, causal, st);
    case kF16: return launch_fwd<__half>(x, y, n, s, sq, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y, dy, dx: [n, s] of dtype.
extern "C" int dstorch_softmax_bwd(const void* y, const void* dy, void* dx,
                                   int n, int s, int dtype, void* stream) {
  if (n < 1 || s < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_bwd<float>(y, dy, dx, n, s, st);
    case kBF16: return launch_bwd<__nv_bfloat16>(y, dy, dx, n, s, st);
    case kF16: return launch_bwd<__half>(y, dy, dx, n, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
