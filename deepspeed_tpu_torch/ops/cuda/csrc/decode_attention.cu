// KV-cache decode attention for Hopper (sm_90a): dense (B2) and paged (B3),
// each over a bf16/fp16/f32 cache or an int8 cache with per-position
// scales.
//
// Replaces the Pallas kernels `_decode_kernel` (dense, wrapper
// `decode_attention`) and `_paged_decode_kernel` (paged, wrapper
// `paged_decode_attention`) in deepspeed_tpu/ops/pallas/decode_attention.py,
// both with their `quantized` branch. Computes, for every (row, head) and
// each of s_q <= 8 query positions, the softmax attention over the row's own
// live cache prefix: query i of a row with fill f sees key positions
// p < f - (s_q - 1) + i. A query that sees no key returns zeros.
//
// Where key position p of row r lives is the one thing the two layouts
// differ in, so the kernel is templated on it (`Rows`):
//   * dense: cache row r * S + p of a [b, S, h*d] cache;
//   * paged: row table[r][p / bs] * bs + p % bs of a [nb, bs, h*d] block
//     pool, the table entry clamped into [0, nb - 1] as the TPU kernel
//     clamps it (sentinel entries past a row's reservation lie past its
//     fill and are masked).
// Every line of the softmax and the value loop is shared, so over a table
// that lays a dense cache out in order the paged kernel's output is bitwise
// the dense kernel's.
//
// int8 cache (`TC = int8_t`): one f32 dequant multiplier per cache row
// ([b, S] dense, [nb, bs] paged). The kernel loads int8 (a 16-byte load
// carries 16 elements) and multiplies each element by its position's scale
// in f32 before the dot and before the value sum, as the TPU kernel does in
// VMEM; no dequantized cache is ever written. q and out stay
// bf16/fp16/f32.
//
// Bound: device-memory bytes. A decode step reads each live K and V row once
// and does 4*d flops per (query, key) pair, far below the card's
// operations-per-byte balance. The design reads only the live prefix of each
// row (dead positions and other rows' prefixes are never fetched), once:
//   * one thread block per (row, head), kWarps warps; warp w walks key tiles
//     w, w + kWarps, ... of 32 positions each;
//   * scores: lane = key; each lane resolves its key's cache row once per
//     tile (a table read for paged), reads the key's d contiguous elements
//     with 16-byte loads and dots them with the queries held in shared
//     memory;
//   * online softmax in f32 per warp (max / sum by warp shuffles);
//   * values: lane = channel; each key's d values are read coalesced and
//     weighted by that key's probability (and int8 scale), both broadcast
//     from the key's score lane by a shuffle, as is its cache row when that
//     came from a table read (the dense row is recomputed: broadcasting it
//     made the dense kernel 30% slower on the H100). A tile's value rows
//     are loaded kValBatch at a time, all in flight before the first is used:
//     one dependent load per key made the first version of this kernel
//     latency-bound (one HBM round trip per key);
//   * the warps' partial (max, sum, acc) merge in shared memory at the end.
// The TPU kernels' block-diagonal query matrix existed only to feed the MXU
// and has no counterpart here; nor has their double-buffered DMA of one
// block per row (the hardware keeps many loads in flight per warp).
// Split-KV, TMA and wgmma are later work.
//
// Plain C interface (no PyTorch headers), bound with ctypes by
// deepspeed_tpu_torch/ops/cuda/decode_attention.py.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kValBatch = 16;        // value rows in flight per lane
constexpr int kMaxSQ = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
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
template <>
struct Vec16<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __half* p, float* out) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __half2* h2 = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __half22float2(h2[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  }
};
template <>
struct Vec16<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const int8_t* p, float* out) {
    const int4 raw = *reinterpret_cast<const int4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 16; ++j) out[j] = static_cast<float>(c[j]);
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
template <>
struct VecN<__half, 2> {
  __device__ __forceinline__ static void load(const __half* p, float* out) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(p));
    out[0] = f.x; out[1] = f.y;
  }
};
template <>
struct VecN<__half, 4> {
  __device__ __forceinline__ static void load(const __half* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __half2* h2 = reinterpret_cast<const __half2*>(&raw);
    const float2 a = __half22float2(h2[0]);
    const float2 b = __half22float2(h2[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
};
template <>
struct VecN<int8_t, 2> {
  __device__ __forceinline__ static void load(const int8_t* p, float* out) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    out[0] = static_cast<float>(c.x); out[1] = static_cast<float>(c.y);
  }
};
template <>
struct VecN<int8_t, 4> {
  __device__ __forceinline__ static void load(const int8_t* p, float* out) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = static_cast<float>(c.x); out[1] = static_cast<float>(c.y);
    out[2] = static_cast<float>(c.z); out[3] = static_cast<float>(c.w);
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

// Cache row (in units of h*d elements) of key position `pos` of row `row`.
// kTable: the row comes from a table read, so the value loop takes it from
// the key's score lane (a shuffle) instead of recomputing it.
struct DenseRows {
  static constexpr bool kTable = false;
  int S;
  __device__ __forceinline__ int operator()(int row, int pos) const {
    return row * S + pos;
  }
};

struct PagedRows {
  static constexpr bool kTable = true;
  const int* tables;   // [b, T]
  int T, bs, nb;
  __device__ __forceinline__ int operator()(int row, int pos) const {
    const int e = min(max(tables[row * T + pos / bs], 0), nb - 1);
    return e * bs + pos % bs;
  }
};

template <typename T, typename TC, int D, typename Rows>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q,       // [b, s_q, h, D]
                        const TC* __restrict__ k,      // cache rows [*, h*D]
                        const TC* __restrict__ v,
                        const float* __restrict__ k_scale,  // [*] (int8)
                        const float* __restrict__ v_scale,
                        const int* __restrict__ cache_len,  // [b]
                        T* __restrict__ out,           // [b, s_q, h, D]
                        int s_q, int h, int S, float scale, Rows rows) {
  constexpr bool kInt8 = std::is_same<TC, int8_t>::value;
  constexpr int DPL = D / 32;                 // channels per lane (values)
  constexpr int VN = Vec16<TC>::N;            // elements per 16-byte load
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
  const TC* kbase = k + (size_t)head * D;
  const TC* vbase = v + (size_t)head * D;

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
    const int crow = pos < fill ? rows(row, pos) : 0;   // this lane's key
    float vsc = 1.f;
    float p[kMaxSQ];
#pragma unroll
    for (int i = 0; i < kMaxSQ; ++i) p[i] = 0.f;
    if (pos < fill) {                         // scores: lane = key
      const TC* kr = kbase + (size_t)crow * hd;
      float ksc = 1.f;
      if (kInt8) {
        ksc = k_scale[crow];
        vsc = v_scale[crow];
      }
#pragma unroll
      for (int e = 0; e < D; e += VN) {
        float kv[VN];
        Vec16<TC>::load(kr + e, kv);
        if (kInt8) {
#pragma unroll
          for (int u = 0; u < VN; ++u) kv[u] *= ksc;
        }
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
        int cr;
        if constexpr (Rows::kTable) {
          cr = __shfl_sync(kFull, crow, (k0 + u) & 31);
        } else {
          cr = rows(row, t0 + k0 + u);
        }
        if (k0 + u < nk) {
          VecN<TC, DPL>::load(vbase + (size_t)cr * hd + lane * DPL, vv[u]);
        } else {
#pragma unroll
          for (int c = 0; c < DPL; ++c) vv[u][c] = 0.f;
        }
      }
      if (kInt8) {
#pragma unroll
        for (int u = 0; u < kValBatch; ++u) {
          const float s = __shfl_sync(kFull, vsc, (k0 + u) & 31);
#pragma unroll
          for (int c = 0; c < DPL; ++c) vv[u][c] *= s;
        }
      }
#pragma unroll
      for (int u = 0; u < kValBatch; ++u) {   // p is 0 past the fill
#pragma unroll
        for (int i = 0; i < kMaxSQ; ++i) {
          if (i < s_q) {
            const float pk = __shfl_sync(kFull, p[i], (k0 + u) & 31);
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

template <typename T, typename TC, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const int* cache_len, void* out, int b, int s_q, int h,
                   int d, int S, float scale, Rows rows,
                   cudaStream_t stream) {
  const dim3 grid(h, b);
  const dim3 block(kWarps * 32);
  const T* qt = static_cast<const T*>(q);
  const TC* kt = static_cast<const TC*>(k);
  const TC* vt = static_cast<const TC*>(v);
  T* ot = static_cast<T*>(out);
  switch (d) {
#define DSTORCH_DECODE_CASE(D_)                                             \
  case D_:                                                                  \
    decode_attention_kernel<T, TC, D_, Rows><<<grid, block, 0, stream>>>(   \
        qt, kt, vt, k_scale, v_scale, cache_len, ot, s_q, h, S, scale,      \
        rows);                                                              \
    break;
    DSTORCH_DECODE_CASE(32)
    DSTORCH_DECODE_CASE(64)
    DSTORCH_DECODE_CASE(96)
    DSTORCH_DECODE_CASE(128)
#undef DSTORCH_DECODE_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename Rows>
int dispatch(const void* q, const void* k, const void* v, const void* k_scale,
             const void* v_scale, const int* cache_len, void* out, int b,
             int s_q, int h, int d, int S, float scale, int dtype, int int8,
             Rows rows, void* stream) {
  if (s_q < 1 || s_q > kMaxSQ || b < 1 || h < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (int8 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if (dtype == 0 && !int8)
    return (int)launch<float, float>(q, k, v, ks, vs, cache_len, out, b, s_q,
                                     h, d, S, scale, rows, st);
  if (dtype == 0)
    return (int)launch<float, int8_t>(q, k, v, ks, vs, cache_len, out, b, s_q,
                                      h, d, S, scale, rows, st);
  if (dtype == 1 && !int8)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, ks, vs, cache_len, out, b, s_q, h, d, S, scale, rows, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, int8_t>(
        q, k, v, ks, vs, cache_len, out, b, s_q, h, d, S, scale, rows, st);
  if (dtype == 2 && !int8)
    return (int)launch<__half, __half>(q, k, v, ks, vs, cache_len, out, b,
                                       s_q, h, d, S, scale, rows, st);
  if (dtype == 2)
    return (int)launch<__half, int8_t>(q, k, v, ks, vs, cache_len, out, b,
                                       s_q, h, d, S, scale, rows, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16, 2 = float16. int8: the
// cache is int8 with f32 scales k_scale / v_scale (else they are unused and
// may be null).
// Returns a cudaError_t (0 on success).
extern "C" int dstorch_decode_attention(const void* q, const void* k,
                                        const void* v, const void* k_scale,
                                        const void* v_scale,
                                        const int* cache_len, void* out, int b,
                                        int s_q, int h, int d, int S,
                                        float scale, int dtype, int int8,
                                        void* stream) {
  return dispatch(q, k, v, k_scale, v_scale, cache_len, out, b, s_q, h, d, S,
                  scale, dtype, int8, DenseRows{S}, stream);
}

// The paged layout: k/v pools [nb, bs, h*d] (scales [nb, bs]), tables
// [b, T] int32; S = T * bs.
extern "C" int dstorch_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const int* tables,
    const int* cache_len, void* out, int b, int s_q, int h, int d, int nb,
    int bs, int T, float scale, int dtype, int int8, void* stream) {
  if (nb < 1 || bs < 1 || T < 1) return (int)cudaErrorInvalidValue;
  return dispatch(q, k_pool, v_pool, k_scale, v_scale, cache_len, out, b, s_q,
                  h, d, T * bs, scale, dtype, int8, PagedRows{tables, T, bs, nb},
                  stream);
}
