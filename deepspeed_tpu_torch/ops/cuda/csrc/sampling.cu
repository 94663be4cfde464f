// Sort-free sampling epilogue for Hopper (sm_90a): top-k / top-p filter and
// the draw, one kernel.
//
// Replaces the Pallas kernel `_sampling_kernel` in
// deepspeed_tpu/ops/pallas/sampling.py (wrappers `threshold_filter_logits`
// and `fused_sample`). Semantics are the TPU kernel's, row by row, on logits
// the wrapper has already divided by the temperature:
//   * order key: bitcast f32 -> i32, negatives reflected (INT32_MAX - bits,
//     wrapping for -0.0), strictly monotonic in the float order;
//   * top-k: 33-step bisection for the largest key t with
//     count(key >= t) >= k -- exactly the k-th largest value, ties kept;
//   * top-p: 33-step bisection for the largest key T whose strictly-above
//     mass sum(exp(x - max)) still reaches p * Z; the cut is the smallest
//     present key above T; masked logits become -1e10;
//   * draw: first-index argmax of the filtered row, or of row + gumbel.
// The filtered row is never stored between passes: each pass recomputes it
// from the input row and the thresholds found so far.
//
// Bound: device-memory bytes (one read of the [V] row, plus the gumbel row
// when sampling). One block of 1024 threads per row. The row is staged in
// shared memory when it fits (V = 50304 f32 is 201 KB of the 227 KB a block
// may use), so the 66 bisection passes read shared memory, not device
// memory; a larger vocabulary is read from device memory (L2) each pass.
//
// Plain C interface (no PyTorch headers), bound with ctypes by
// deepspeed_tpu_torch/ops/cuda/sampling.py.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kBisectIters = 33;        // > log2 of the int32 key range
constexpr float kNegCap = -1e10f;       // the reference's masked-logit value
constexpr int kMaxStageBytes = 220 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : (int)(0x7fffffffu - (unsigned)b);
}

__device__ __forceinline__ int mid_of(int lo, int hi) {
  return (lo >> 1) + (hi >> 1) + (lo & hi & 1);
}

struct MinI { __device__ int operator()(int a, int b) const { return min(a, b); } };
struct MaxI { __device__ int operator()(int a, int b) const { return max(a, b); } };
struct SumI { __device__ int operator()(int a, int b) const { return a + b; } };
struct MaxF { __device__ float operator()(float a, float b) const { return fmaxf(a, b); } };
struct SumF { __device__ float operator()(float a, float b) const { return a + b; } };

// Every thread returns the block-wide result. `red` holds kWarpsPerBlock
// entries; the trailing barrier makes it reusable by the next call.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = red[0];
#pragma unroll
  for (int w = 1; w < kWarpsPerBlock; ++w) r = op(r, red[w]);
  __syncthreads();
  return r;
}

struct Filter {
  int kth_k;   // top-k cut on the input's keys (INT_MIN: keep all)
  int kth_p;   // top-p cut on the top-k output's keys (INT_MIN: keep all)
  __device__ __forceinline__ float after_k(float x) const {
    return order_key(x) >= kth_k ? x : kNegCap;
  }
  __device__ __forceinline__ float after_p(float x) const {
    const float y = after_k(x);
    return order_key(y) >= kth_p ? y : kNegCap;
  }
};

__global__ void __launch_bounds__(kThreads)
sampling_kernel(const float* __restrict__ logits,   // [b, V]
                const float* __restrict__ gumbel,   // [b, V] or null
                float* __restrict__ out_logits,     // [b, V] or null
                int* __restrict__ out_tokens,       // [b] or null
                int V, int top_k, float top_p, int stage) {
  extern __shared__ float staged[];
  __shared__ int red_i[kWarpsPerBlock];
  __shared__ float red_f[kWarpsPerBlock];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* x = logits + (size_t)row * V;
  if (stage) {
    for (int i = tid; i < V; i += kThreads) staged[i] = x[i];
    __syncthreads();
    x = staged;
  }
  Filter f{INT_MIN, INT_MIN};

  if (top_k > 0 && top_k < V) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = tid; i < V; i += kThreads) {
      const int key = order_key(x[i]);
      lo = min(lo, key);
      hi = max(hi, key);
    }
    lo = block_reduce(lo, MinI(), red_i);
    hi = block_reduce(hi, MaxI(), red_i) + 1;
    for (int it = 0; it < kBisectIters; ++it) {
      const int mid = mid_of(lo, hi);
      int c = 0;
      for (int i = tid; i < V; i += kThreads) c += order_key(x[i]) >= mid;
      c = block_reduce(c, SumI(), red_i);
      if (c >= top_k) lo = mid; else hi = mid;
    }
    f.kth_k = lo;
  }

  if (top_p > 0.f && top_p < 1.f) {
    float mx = -INFINITY;
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = tid; i < V; i += kThreads) {
      const float y = f.after_k(x[i]);
      const int key = order_key(y);
      mx = fmaxf(mx, y);
      lo = min(lo, key);
      hi = max(hi, key);
    }
    mx = block_reduce(mx, MaxF(), red_f);
    lo = block_reduce(lo, MinI(), red_i) - 1;
    hi = block_reduce(hi, MaxI(), red_i);
    float z = 0.f;
    for (int i = tid; i < V; i += kThreads) z += expf(f.after_k(x[i]) - mx);
    const float pz = top_p * block_reduce(z, SumF(), red_f);
    for (int it = 0; it < kBisectIters; ++it) {
      const int mid = mid_of(lo, hi);
      float mass = 0.f;
      for (int i = tid; i < V; i += kThreads) {
        const float y = f.after_k(x[i]);
        if (order_key(y) > mid) mass += expf(y - mx);
      }
      mass = block_reduce(mass, SumF(), red_f);
      if (mass >= pz) lo = mid; else hi = mid;
    }
    int cut = INT_MAX;
    for (int i = tid; i < V; i += kThreads) {
      const int key = order_key(f.after_k(x[i]));
      if (key > lo) cut = min(cut, key);
    }
    f.kth_p = block_reduce(cut, MinI(), red_i);
  }

  if (out_logits != nullptr) {
    float* o = out_logits + (size_t)row * V;
    for (int i = tid; i < V; i += kThreads) o[i] = f.after_p(x[i]);
  }
  if (out_tokens != nullptr) {
    const float* g = gumbel != nullptr ? gumbel + (size_t)row * V : nullptr;
    float best = -INFINITY;
    int best_i = V;
    for (int i = tid; i < V; i += kThreads) {
      float y = f.after_p(x[i]);
      if (g != nullptr) y += g[i];
      if (y > best) { best = y; best_i = i; }   // ascending i: first index
    }
    // (max value, then lowest index) across the block
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, o);
      const int oi = __shfl_xor_sync(kFull, best_i, o);
      if (ob > best || (ob == best && oi < best_i)) { best = ob; best_i = oi; }
    }
    if ((tid & 31) == 0) { red_f[tid >> 5] = best; red_i[tid >> 5] = best_i; }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarpsPerBlock; ++w) {
        if (red_f[w] > best || (red_f[w] == best && red_i[w] < best_i)) {
          best = red_f[w];
          best_i = red_i[w];
        }
      }
      out_tokens[row] = best_i;
    }
  }
}

}  // namespace

// top_k <= 0: no top-k cut; top_p outside (0, 1): no top-p cut. Either
// output pointer may be null. Returns a cudaError_t (0 on success).
extern "C" int dstorch_sampling(const float* logits, const float* gumbel,
                                float* out_logits, int* out_tokens, int b,
                                int V, int top_k, float top_p, void* stream) {
  if (b < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const size_t stage_bytes = (size_t)V * sizeof(float);
  const int stage = stage_bytes <= (size_t)kMaxStageBytes;
  const size_t smem = stage ? stage_bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sampling_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sampling_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      logits, gumbel, out_logits, out_tokens, V, top_k, top_p, stage);
  return (int)cudaGetLastError();
}
