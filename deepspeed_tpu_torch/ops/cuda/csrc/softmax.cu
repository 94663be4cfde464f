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
// backward reads y and dy and writes dx).
//
// The forward holds each row in registers (rowwise.cuh's packs), in f32:
// one read of the row from device memory, the causal mask applied in
// registers from the column index, the max by shuffles, p = exp(x - max)
// once per element kept in registers, the sum by shuffles, y = p (1 / sum)
// written once; no online rescaling and no data-dependent branch. Columns
// past s hold -inf, so they add exp(-inf) = 0. Which shapes take which
// path:
//   * s <= 1024: softmax_fwd_warp_kernel, one warp a row, 4 rows (warps) a
//     block, no shared memory; 8, 16 or 32 elements a lane for s <= 256,
//     <= 512, <= 1024;
//   * 1024 < s <= 16384: softmax_fwd_block_kernel, one block a row of
//     ceil(s / 1024) warps (<= 16), 32 elements a thread, one shared slot a
//     warp for each of the two reductions;
//   * s > 16384: softmax_fwd_loop_kernel, one block a row (32-1024
//     threads) looping over it: a pass for the running max and rescaled sum
//     (online softmax) and a second for the output, which re-reads the row
//     from L1/L2.
// The first two read and write 16-byte packs (8 bf16 / fp16 or 4 f32
// elements a lane) when s is a multiple of the pack and x and y are
// 16-byte aligned, else the same kernel at one element a pack (predicated
// scalar accesses). The backward takes one warp a row up to 1024 columns
// (8 rows a block), one block a wider row (32-1024 threads): a pass for
// sum(y dy) and a second for dx, which re-reads the row from L1/L2.
//
// Plain C interface (no PyTorch headers), bound with ctypes by
// deepspeed_tpu_torch/ops/cuda/softmax.py.

#include "rowwise.cuh"

namespace {

constexpr float kMaskValue = -1e30f;    // the TPU kernel's NEG_INF
constexpr int kBwdWarpRows = 8;         // rows (warps) of a backward block

// Reductions over the threads that share a row: one warp, or the block.
struct WarpRow {
  __device__ float sum(float v) const { return warp_sum(v); }
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
  const float top = r.max(m);
  const float total = r.sum(l * expf(m - top));
  for (int c = idx; c < s; c += width) {
    const float v = c > last_col ? kMaskValue : to_f32(xr[c]);
    yr[c] = from_f32<T>(expf(v - top) / total);
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

// The register forward of one row, held by a row group (one warp, or the
// block with `slots`: 64 floats) as NV packs of V elements a thread.
template <typename T, int V, int E, bool kBlock>
__device__ __forceinline__ void softmax_regs_row(const T* __restrict__ xr,
                                                 T* __restrict__ yr, int s,
                                                 int last, int rank, int size,
                                                 float* slots) {
  constexpr int NV = E / V;
  float f[NV][V];
  float m = -FLT_MAX;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = pack_col<V>(j, rank, size);
    if (c < s) {
      const Pack<T, V> a = load_pack<T, V>(xr + c);
#pragma unroll
      for (int e = 0; e < V; ++e)
        f[j][e] = c + e > last ? kMaskValue : to_f32(a.v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) f[j][e] = -INFINITY;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) m = fmaxf(m, f[j][e]);
  }
  m = row_max<kBlock>(m, slots);
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      f[j][e] = expf(f[j][e] - m);
      l += f[j][e];
    }
  }
  const float inv = 1.f / row_sum<kBlock>(l, kBlock ? slots + 32 : nullptr);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = pack_col<V>(j, rank, size);
    if (c < s) {
      Pack<T, V> o;
#pragma unroll
      for (int e = 0; e < V; ++e) o.v[e] = from_f32<T>(f[j][e] * inv);
      store_pack<T, V>(yr + c, o);
    }
  }
}

template <typename T, int V, int E>
__global__ void __launch_bounds__(32 * kWarpRows, kWarpRowMinBlocks)
softmax_fwd_warp_kernel(const T* __restrict__ x, T* __restrict__ y, int n,
                        int s, int sq, int causal) {
  const long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= n) return;                 // whole warps leave together
  softmax_regs_row<T, V, E, false>(x + row * s, y + row * s, s,
                                   last_col(row, s, sq, causal),
                                   threadIdx.x & 31, 32, nullptr);
}

template <typename T, int V>
__global__ void __launch_bounds__(32 * kBlockRowWarps, kBlockRowMinBlocks)
softmax_fwd_block_kernel(const T* __restrict__ x, T* __restrict__ y, int s,
                         int sq, int causal) {
  __shared__ float slots[64];
  const long long row = blockIdx.x;
  softmax_regs_row<T, V, kRowElems, true>(
      x + row * s, y + row * s, s, last_col(row, s, sq, causal), threadIdx.x,
      blockDim.x, slots);
}

// Rows wider than kBlockRowMax: one block a row, looping over it.
template <typename T>
__global__ void __launch_bounds__(1024)
softmax_fwd_loop_kernel(const T* __restrict__ x, T* __restrict__ y, int s,
                        int sq, int causal) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  softmax_row(x + row * s, y + row * s, s, last_col(row, s, sq, causal),
              threadIdx.x, blockDim.x, BlockRow{red});
}

template <typename T>
__global__ void __launch_bounds__(32 * kBwdWarpRows)
softmax_bwd_warp_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                        T* __restrict__ dx, int n, int s) {
  const long long row =
      (long long)blockIdx.x * kBwdWarpRows + (threadIdx.x >> 5);
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

// The register kernels at packs of V elements (s <= kBlockRowMax).
template <typename T, int V>
void launch_fwd_packs(const T* x, T* y, int n, int s, int sq, int causal,
                      cudaStream_t stream) {
  if (s > kWarpRowMax) {
    softmax_fwd_block_kernel<T, V><<<n, block_row_threads(s), 0, stream>>>(
        x, y, s, sq, causal);
    return;
  }
  const int blocks = (n + kWarpRows - 1) / kWarpRows;
  const int threads = 32 * kWarpRows;
  switch (warp_row_elems(s)) {
    case 8:
      softmax_fwd_warp_kernel<T, V, 8><<<blocks, threads, 0, stream>>>(
          x, y, n, s, sq, causal);
      break;
    case 16:
      softmax_fwd_warp_kernel<T, V, 16><<<blocks, threads, 0, stream>>>(
          x, y, n, s, sq, causal);
      break;
    default:
      softmax_fwd_warp_kernel<T, V, 32><<<blocks, threads, 0, stream>>>(
          x, y, n, s, sq, causal);
      break;
  }
}

template <typename T>
int launch_fwd(const void* x, void* y, int n, int s, int sq, int causal,
               cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (s > kBlockRowMax)
    softmax_fwd_loop_kernel<T><<<n, row_threads(s), 0, stream>>>(
        xt, yt, s, sq, causal);
  else if (s % kVec16<T> == 0 && aligned16(x) && aligned16(y))
    launch_fwd_packs<T, kVec16<T>>(xt, yt, n, s, sq, causal, stream);
  else
    launch_fwd_packs<T, 1>(xt, yt, n, s, sq, causal, stream);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* y, const void* dy, void* dx, int n, int s,
               cudaStream_t stream) {
  const T* yt = static_cast<const T*>(y);
  const T* gt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if (s <= kWarpRowMax)
    softmax_bwd_warp_kernel<T><<<(n + kBwdWarpRows - 1) / kBwdWarpRows,
                                 32 * kBwdWarpRows, 0, stream>>>(yt, gt, dxt,
                                                                 n, s);
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
