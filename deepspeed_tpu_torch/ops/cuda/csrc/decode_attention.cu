// Dense KV-cache decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_decode_kernel` in
// deepspeed_tpu/ops/pallas/decode_attention.py (wrapper `decode_attention`).
// Computes, for every (row, head) and each of s_q <= 8 query positions, the
// softmax attention over the row's own live cache prefix: query i of a row
// with fill f sees key positions p < f - (s_q - 1) + i. A query that sees no
// key returns zeros.
//
// Bound: device-memory bytes. A decode step reads each live K and V row once
// and does 4*d flops per (query, key) pair, far below the card's
// operations-per-byte balance. The design reads only the live prefix of each
// row (dead positions and other rows' prefixes are never fetched), once:
//   * one thread block per (row, head), kWarps warps; warp w walks key tiles
//     w, w + kWarps, ... of 32 positions each;
//   * scores: lane = key; each lane reads its key's d contiguous elements
//     with 16-byte loads and dots them with the queries held in shared memory;
//   * online softmax in f32 per warp (max / sum by warp shuffles);
//   * values: lane = channel; each key's d values are read coalesced and
//     weighted by that key's probability, broadcast from its score lane.
//     A tile's value rows are loaded kValBatch at a time, all in flight
//     before the first is used: one dependent load per key made the first
//     version of this kernel latency-bound (one HBM round trip per key);
//   * the warps' partial (max, sum, acc) merge in shared memory at the end.
// The TPU kernel's block-diagonal query matrix existed only to feed the MXU
// and has no counterpart here. Split-KV, TMA and wgmma are later work.
//
// Plain C interface (no PyTorch headers), bound with ctypes by
// deepspeed_tpu_torch/ops/cuda/decode_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kValBatch = 16;        // value rows in flight per lane
constexpr int kMaxSQ = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes -> 16 / sizeof(T) floats
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h2[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  }
};

// N consecutive elements (4, 8 or 16 bytes, or one element) -> floats
template <typename T, int N>
struct VecN {
  __device__ __forceinline__ static void load(const T* p, float* out) {
#pragma unroll
    for (int c = 0; c < N; ++c) out[c] = to_f(p[c]);
  }
};
template <>
struct VecN<float, 2> {
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
};
template <>
struct VecN<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* out) {
    Vec16<float>::load(p, out);
  }
};
template <>
struct VecN<__nv_bfloat16, 2> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = f.x; out[1] = f.y;
  }
};
template <>
struct VecN<__nv_bfloat16, 4> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h2[0]);
    const float2 b = __bfloat1622float2(h2[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q,       // [b, s_q, h, D]
                        const T* __restrict__ k,       // [b, S, h*D]
                        const T* __restrict__ v,       // [b, S, h*D]
                        const int* __restrict__ cache_len,  // [b]
                        T* __restrict__ out,           // [b, s_q, h, D]
                        int s_q, int h, int S, float scale) {
  constexpr int DPL = D / 32;                 // channels per lane (values)
  constexpr int VN = Vec16<T>::N;             // elements per 16-byte load
  __shared__ float q_s[kMaxSQ][D];
  __shared__ float m_s[kWarps][kMaxSQ];
  __shared__ float l_s[kWarps][kMaxSQ];
  __shared__ float acc_s[kWarps][kMaxSQ][D];

  const int head = blockIdx.x;
  const int row = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t hd = (size_t)h * D;

  for (int idx = threadIdx.x; idx < s_q * D; idx += blockDim.x) {
    const int i = idx / D, j = idx % D;
    q_s[i][j] = to_f(q[(((size_t)row * s_q + i) * h + head) * D + j]);
  }
  __syncthreads();

  const int fill = min(max(cache_len[row], 0), S);
  const int lim0 = fill - (s_q - 1);          // query i sees p < lim0 + i
  const T* kbase = k + (size_t)row * S * hd + (size_t)head * D;
  const T* vbase = v + (size_t)row * S * hd + (size_t)head * D;

  float m[kMaxSQ], l[kMaxSQ], acc[kMaxSQ][DPL];
#pragma unroll
  for (int i = 0; i < kMaxSQ; ++i) {
    m[i] = -FLT_MAX;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = warp * 32; t0 < fill; t0 += kWarps * 32) {
    const int pos = t0 + lane;
    float p[kMaxSQ];
#pragma unroll
    for (int i = 0; i < kMaxSQ; ++i) p[i] = 0.f;
    if (pos < fill) {                         // scores: lane = key
      const T* kr = kbase + (size_t)pos * hd;
#pragma unroll
      for (int e = 0; e < D; e += VN) {
        float kv[VN];
        Vec16<T>::load(kr + e, kv);
#pragma unroll
        for (int i = 0; i < kMaxSQ; ++i) {
          if (i < s_q) {
#pragma unroll
            for (int u = 0; u < VN; ++u) p[i] = fmaf(kv[u], q_s[i][e + u], p[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxSQ; ++i) {        // online softmax per query
      if (i < s_q) {
        const bool vis = pos < lim0 + i;
        const float sc = vis ? p[i] * scale : -FLT_MAX;
        const float m_new = fmaxf(m[i], warp_max(sc));
        const float e = vis ? expf(sc - m_new) : 0.f;
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + warp_sum(e);
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] *= corr;
        p[i] = e;
      }
    }
    const int nk = min(32, fill - t0);        // values: lane = channel
    for (int k0 = 0; k0 < nk; k0 += kValBatch) {
      float vv[kValBatch][DPL];
#pragma unroll
      for (int u = 0; u < kValBatch; ++u) {   // all loads first
        if (k0 + u < nk) {
          VecN<T, DPL>::load(vbase + (size_t)(t0 + k0 + u) * hd + lane * DPL,
                             vv[u]);
        } else {
#pragma unroll
          for (int c = 0; c < DPL; ++c) vv[u][c] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kValBatch; ++u) {   // p is 0 past the fill
#pragma unroll
        for (int i = 0; i < kMaxSQ; ++i) {
          if (i < s_q) {
            const float pk = __shfl_sync(kFull, p[i], k0 + u);
#pragma unroll
            for (int c = 0; c < DPL; ++c)
              acc[i][c] = fmaf(pk, vv[u][c], acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxSQ; ++i) {
    if (i < s_q) {
      if (lane == 0) {
        m_s[warp][i] = m[i];
        l_s[warp][i] = l[i];
      }
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc_s[warp][i][lane * DPL + c] = acc[i][c];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < s_q * D; idx += blockDim.x) {
    const int i = idx / D, j = idx % D;
    float M = -FLT_MAX;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w][i]);
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w][i] - M);
      L = fmaf(l_s[w][i], f, L);
      o = fmaf(acc_s[w][i][j], f, o);
    }
    out[(((size_t)row * s_q + i) * h + head) * D + j] =
        from_f<T>(L > 0.f ? o / L : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* cache_len, void* out, int b, int s_q, int h,
                   int d, int S, float scale, cudaStream_t stream) {
  const dim3 grid(h, b);
  const dim3 block(kWarps * 32);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (d) {
    case 32:
      decode_attention_kernel<T, 32><<<grid, block, 0, stream>>>(
          qt, kt, vt, cache_len, ot, s_q, h, S, scale);
      break;
    case 64:
      decode_attention_kernel<T, 64><<<grid, block, 0, stream>>>(
          qt, kt, vt, cache_len, ot, s_q, h, S, scale);
      break;
    case 96:
      decode_attention_kernel<T, 96><<<grid, block, 0, stream>>>(
          qt, kt, vt, cache_len, ot, s_q, h, S, scale);
      break;
    case 128:
      decode_attention_kernel<T, 128><<<grid, block, 0, stream>>>(
          qt, kt, vt, cache_len, ot, s_q, h, S, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int dstorch_decode_attention(const void* q, const void* k,
                                        const void* v, const int* cache_len,
                                        void* out, int b, int s_q, int h,
                                        int d, int S, float scale, int dtype,
                                        void* stream) {
  if (s_q < 1 || s_q > kMaxSQ || b < 1 || h < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, cache_len, out, b, s_q, h, d, S, scale,
                              st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, cache_len, out, b, s_q, h, d, S,
                                      scale, st);
  return (int)cudaErrorInvalidValue;
}
