// KV-cache decode attention for Hopper (sm_90a): dense (B2) and paged (B3),
// each over a bf16/fp16/f32 cache or an int8 cache with per-position
// scales.
//
// Replaces the Pallas kernels `_decode_kernel` (dense, wrapper
// `decode_attention`) and `_paged_decode_kernel` (paged, wrapper
// `paged_decode_attention`) in deepspeed_tpu/ops/pallas/decode_attention.py,
// both with their `quantized` branch. Computes, for every (row, head) and
// each of s_q <= 16 query positions, the softmax attention over the row's own
// live cache prefix: query i of a row with fill f (clamped into [0, S]) sees
// key positions p < f - (s_q - 1) + i. A query that sees no key returns
// exact zeros. Head dims 32, 64, 80, 96 and 128. s_q up to 8 covers a decode
// step and a speculative verify (k + 1); s_q 9-16 a fused chunked-prefill
// step (16 prompt tokens a lane; the wrapper cuts wider calls into pieces of
// at most 16 queries, each with its own fill, reading and writing its own
// columns of q and out in place through their row stride `q_stride`).
//
// Where key position p of row r lives is the one thing the two layouts
// differ in, so the kernel is templated on it (`Rows`):
//   * dense: cache row r * S + p of a [b, S, h*d] cache;
//   * paged: row table[r][p / bs] * bs + p % bs of a [nb, bs, h*d] block
//     pool, the table entry clamped into [0, nb - 1] as the TPU kernel
//     clamps it (sentinel entries past a row's reservation lie past its
//     fill and are never read).
// Only the producer warp asks `Rows`; everything after a key row lands in
// shared memory is shared, so over a table that lays a dense cache out in
// order the paged kernel's output is bitwise the dense kernel's.
//
// int8 cache (`TC = int8_t`): one f32 dequant multiplier per cache row
// ([b, S] dense, [nb, bs] paged). Keys and values are multiplied by their
// position's scale in f32 before the dot and before the value sum, as the
// TPU kernel does in VMEM; no dequantized cache is ever written. q and out
// stay bf16/fp16/f32.
//
// Bound: device-memory bytes. A key costs 4 * d * s_q flops against 4 * d
// bytes of bf16 K + V: at most 16 flops a byte, against the card's balance
// of about 295, so the work runs on CUDA cores (wgmma's 64-row tiles would
// waste most of a tile at s_q <= 16). The design keeps as many bytes in
// flight as the card can take:
//   * Split-KV over a thread-block cluster, one launch a call. The grid is
//     (h, b, C) with cluster dims (1, 1, C), C = min(8, ceil(S / kTile)),
//     chosen on the host from S only (never from the fills: no host read,
//     the call stays graph-capturable). A cluster owns one (row, head); its
//     C ranks cut the row's live tiles, ceil(f / kTile), into C contiguous
//     ranges of whole tiles (`split_range`). At the serving geometry (b 8,
//     h 12, S 1024) that is 768 blocks, and the longest row's 256 KB of K
//     and V is spread over 8 SMs instead of one.
//   * Asynchronous copies into a shared-memory ring. One producer warp
//     issues TMA loads of 2-D tensor maps over the cache seen as rows of
//     h * d elements (`key_map`, encoded on the host every call): a box is
//     box_rows key rows of this head (32 dense; gcd(bs, 32) paged, so a box
//     lies inside one block and costs one table read), K and V, completing
//     on the stage's `full` mbarrier (`expect_tx` of the stage's bytes). A
//     box is d + 16 bytes wide: each row lands padded by the next 16 bytes
//     of the cache row, which keeps the score reads free of bank
//     conflicts (below). The first design issued one cp.async.bulk per key
//     row (128 bytes at d = 64, bf16); with everything else the same, the
//     boxes (two requests a tile instead of 64) timed faster at the serving
//     geometry on the H100. The int8 scales travel beside the tile, with
//     plain loads. The ring holds 2-4 stages of a K and a V tile (kStages:
//     about 27 KB a block at d = 64, bf16), so the next tiles are in
//     flight while the consumers compute on this one.
//   * Four consumer warps share every tile: warp w owns its keys 8 w ..
//     8 w + 7, so a rank with one tile still runs four warps. Scores: four
//     lanes a key, each dotting a quarter of the key's row with the
//     queries, summed by two shuffles (lane = 8 g + key: the 8 lanes of a
//     16-byte load phase read 8 rows at one column, and the rows are
//     padded by 16 bytes in shared memory, so they hit distinct banks; a
//     quarter row is read in the widest of 16-, 8- and 4-byte chunks that
//     divides it: d 80 gives 20 channels a lane, 8-byte chunks in bf16).
//     Then an online softmax in f32 per warp over its keys (max and sum by
//     three shuffles), and the values with lane = channel (a key's row read
//     coalesced, its probabilities read from shared memory): d / 32
//     neighbouring channels a lane where 32 divides d, else channels lane,
//     lane + 32, ... below d (d 80: three for lanes 0-15, two for the
//     rest).
//   * The merge, in a fixed order that does not depend on the layout: each
//     block merges its four warps' (m, l, acc[s_q][d]) in warp order and
//     stores the result into rank 0's shared memory (distributed shared
//     memory, cluster.map_shared_rank); after a cluster barrier rank 0
//     merges the C states in rank order and writes the output, and the
//     other blocks leave as soon as they have stored (posted remote stores
//     and one barrier, where reading the states remotely took a round trip
//     and a second barrier). No workspace and no second kernel, and a
//     call's result is bitwise reproducible.
//
// What the design has to get right:
//   * Empty splits. A rank with no tile, a warp with no live key, or tiles
//     that query i cannot see (s_q > 1, small f) hold m = -inf and l = 0. Every
//     rescale factor is taken as 0 when its m is -inf (never
//     exp(-inf - -inf) = NaN), so a query no rank saw gets l = 0 and exact
//     zeros.
//   * Bitwise equality of B3 and B2: tile boundaries (multiples of kTile
//     positions, whatever bs is: a tile spans several blocks at bs = 8 and
//     part of one at bs = 32), the split into ranks, the arithmetic of a key
//     and the merge order all depend on the fill and the tile only.
//   * Ragged tails: a box is copied whole, so the keys of a box past the
//     row's fill arrive too (other rows' keys in the dense layout, zeros
//     past the cache's end, or the rest of a block in the paged one) and a
//     box wholly past it is not copied: no score or value loop reads a key
//     at or past the fill, and no copy leaves the tensor (TMA fills what
//     lies outside with zeros).
//   * Barrier phases: a parity wait cannot tell phase n from phase n + 2,
//     so no warp may run two phases ahead of a barrier. Every consumer warp
//     waits on every stage in order (the empty barrier counts the four),
//     and the producer waits on a stage's release before it refills it.
//   * Alignment: a tensor map needs a 16-byte-aligned base and row stride
//     and a box whose rows are a multiple of 16 bytes. The wrapper checks
//     16-byte alignment of every tensor; the row stride h * d * sizeof(TC),
//     a box row of d * sizeof(TC) + 16 bytes and the head's offset
//     head * d * sizeof(TC) are multiples of 16 for every d in {32, 64, 80,
//     96, 128} and every cache type, as are the ring's padded rows.
//   * Columns past d: a box from column head * d carries the next 16 bytes
//     of the cache row, which belong to the next head (or lie past the
//     row's end and arrive as zeros). The score chunks cover channels
//     [0, d) exactly and the value loop reads channel < d only, so those
//     bytes never reach a score or an output; d 80 is its own instance,
//     never d 96 over a padded row.
//   * Cluster scheduling: all C blocks of a cluster must be resident at
//     once on one GPC, so a block keeps its shared memory near 30 KB (at
//     d = 64, bf16: 7 blocks an SM, with the registers of kMinBlocks), and
//     several clusters fit per SM group; cudaOccupancyMaxActiveClusters
//     is asked once per instantiation and device, and a configuration that
//     could not launch returns an error instead of launching.
//   * A lost mbarrier phase traps after 10 s (`bar_wait`) instead of
//     hanging the card.
//   * The profiler's filter: chip_smoke.py counts device time of kernels
//     whose name contains "decode_attention_kernel"; this is the call's one
//     kernel.
//
// The C interface lives in decode_attention.cu (dense) and
// paged_decode_attention.cu (paged), one layout each, so nvcc compiles the
// two halves of the kernels' 300 instantiations in parallel. Plain C (no
// PyTorch headers), bound with ctypes by
// deepspeed_tpu_torch/ops/cuda/decode_attention.py.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>   // CUtensorMap and its enums (header only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <numeric>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;            // key positions a tile (a ring stage)
constexpr int kMaxSplit = 8;         // blocks a cluster (portable maximum)
constexpr int kConsumers = 4;        // consumer warps; + 1 producer warp
constexpr int kThreads = 32 * (kConsumers + 1);
constexpr int kRingBudget = 27648;   // bytes of ring a block aims at
constexpr int kMaxSQ = 16;
constexpr int kMinBlocks = 7;       // blocks an SM holds at kSQ <= 4
constexpr int kMinBlocks8 = 5;      // and at kSQ = 8
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

// 8 int8 (8 bytes, 8-byte aligned) -> floats: an int8 row of d = 32 or 96
// splits into chunks of 8 or 24 bytes
struct Vec8I8 {
  __device__ __forceinline__ static void load(const int8_t* p, float* out) {
    const int2 raw = *reinterpret_cast<const int2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = static_cast<float>(c[j]);
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

// N consecutive cache elements (N * sizeof(TC) = 4, 8 or 16 bytes, aligned
// to it) -> floats: the scores' chunk loads
template <typename TC, int N>
__device__ __forceinline__ void load_chunk(const TC* p, float* out) {
  if constexpr (N * sizeof(TC) == 16) {
    Vec16<TC>::load(p, out);
  } else if constexpr (std::is_same<TC, int8_t>::value && N == 8) {
    Vec8I8::load(p, out);
  } else {
    VecN<TC, N>::load(p, out);
  }
}

// the lane mapping of the scores: lane = kKeysPerWarp * g + kk scores key
// kk of its warp's kKeysPerWarp, chunk g of kGroup of the key's row
constexpr int kKeysPerWarp = kTile / kConsumers;   // 8
constexpr int kGroup = 32 / kKeysPerWarp;          // 4 lanes a key

// The value loop's channel c of a lane: DPL = d / 32 neighbours (lane * DPL
// + c) where 32 divides d, else strided (c * 32 + lane; at d 80 those of
// c = 2 past lane 15 lie past d and are skipped)
template <int D>
__device__ __forceinline__ int value_chan(int lane, int c) {
  return D % 32 != 0 ? c * 32 + lane : lane * (D / 32) + c;
}

// exp(m - M) as a rescale factor: 0 for a state that saw no key (m = -inf),
// so two empty states never give exp(-inf - -inf) = NaN
__device__ __forceinline__ float rescale(float m, float M) {
  return m == -INFINITY ? 0.f : expf(m - M);
}

// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers and bulk copies
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// expect `bytes` more of bulk-copy transactions in the current phase
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// until the barrier's phase of this parity has completed; a phase that
// never completes (a bug) traps after 10 s instead of hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (!done && (polls & 1023) == 1023) {
      if (t0 == 0) t0 = now_ns();
      else if (now_ns() - t0 > 10000000000ull) __trap();
    }
  }
}

// one box of a 2-D tensor map (columns from c, rows from r) into this
// block's shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c), "r"(r)
      : "memory");
}

// ---------------------------------------------------------------------------
// Layouts: the cache row (in units of h*d elements) of key position `pos`
// of row `row`
// ---------------------------------------------------------------------------
struct DenseRows {
  int S;
  __device__ __forceinline__ int operator()(int row, int pos) const {
    return row * S + pos;
  }
};

struct PagedRows {
  const int* tables;   // [b, T]
  int T, bs, nb;
  __device__ __forceinline__ int operator()(int row, int pos) const {
    const int e = min(max(tables[row * T + pos / bs], 0), nb - 1);
    return e * bs + pos % bs;
  }
};

// The tiles [begin, end) of a row with `n_tiles` live tiles that rank `r`
// of `C` owns: contiguous, whole tiles, together exactly [0, n_tiles)
// (ops/cuda/decode_attention.py:split_ranges is the same plan)
__device__ __forceinline__ void split_range(int n_tiles, int r, int C,
                                            int& begin, int& end) {
  begin = r * n_tiles / C;
  end = (r + 1) * n_tiles / C;
}

// The ring's geometry: kStages stages of a K and a V tile, each kTile rows
// of kStride bytes (a key row of d * sizeof(TC) bytes padded by 16)
template <typename TC, int D>
struct Ring {
  static constexpr bool kInt8 = std::is_same<TC, int8_t>::value;
  static constexpr int kRowBytes = D * (int)sizeof(TC);
  static constexpr int kStride = kRowBytes + 16;
  static constexpr int kTileBytes = kTile * kStride;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages =
      kRingBudget / kStageBytes < 2 ? 2
      : (kRingBudget / kStageBytes > 4 ? 4 : kRingBudget / kStageBytes);
  static constexpr int kBytes = kStages * kStageBytes;
  static_assert(kRowBytes % 16 == 0, "TMA rows are 16-byte multiples");
};

// Shared memory of one block, in bytes (every region 16-byte aligned):
//   ring    the Ring (or, where larger, the warps' states below)
//   scales  kStages x (k, v) x kTile f32 (int8 only)
//   q       kSQ x D f32 queries (rows past s_q zero)
//   p       kConsumers x kKeysPerWarp x kSQ f32: a tile's probabilities
//   part    kMaxSplit x kSQ x D f32: at rank 0, every rank's merged acc
//   pml     kMaxSplit x 2 x kSQ f32: at rank 0, every rank's (m, l)
//   bars    kStages full + kStages empty mbarriers
// After the loop the ring holds the warps' states (m, l, acc) for the
// block's merge: 2 x 4 x kSQ x 4 + 4 x kSQ x d x 4 bytes, within the ring's
// 2 x 2 x 32 x (d + 16) up to kSQ 8; at kSQ 16 an int8 ring (d + 16 bytes a
// row) is smaller than the states at d 96 and 128, and the region grows to
// hold them.
template <typename TC, int D, int kSQ>
struct Smem {
  using R = Ring<TC, D>;
  static constexpr int kStates = 2 * kConsumers * kSQ * 4
                                 + kConsumers * kSQ * D * 4;
  static constexpr int kScalesAt = R::kBytes > kStates ? R::kBytes : kStates;
  static constexpr int kQAt =
      kScalesAt + (R::kInt8 ? R::kStages * 2 * kTile * 4 : 0);
  static constexpr int kPAt = kQAt + kSQ * D * 4;
  static constexpr int kPartAt = kPAt + kConsumers * kKeysPerWarp * kSQ * 4;
  static constexpr int kPmlAt = kPartAt + kMaxSplit * kSQ * D * 4;
  static constexpr int kBarsAt = kPmlAt + kMaxSplit * 2 * kSQ * 4;
  static constexpr int kBytes = kBarsAt + 2 * R::kStages * 8;
  static_assert(kStates % 16 == 0, "regions stay 16-byte aligned");
};

// N (1, 2, 4 or 8) consecutive f32 of shared memory, 4 N-byte aligned
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (N == 1) {
    out[0] = p[0];
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x; out[1] = a.y;
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + k);
      out[k] = a.x; out[k + 1] = a.y; out[k + 2] = a.z; out[k + 3] = a.w;
    }
  }
}

// the halves of a cluster barrier (every thread of every block arrives)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {   // release
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {     // acquire
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// kSQ: the query count s_q rounded up to 1, 2, 4, 8 or 16 (`sq_bucket`); the
// per-query loops run to kSQ, so s_q = 1, the decode step, carries no
// code for queries it does not have (a loop to 8 with the absent queries
// predicated off still issues their instructions, and timed the s_q = 1
// call markedly slower on the H100). The
// absent queries of a bucket are zero rows: their arithmetic stays finite
// and no output reads it.
// Registers: up to kSQ = 4 a block fits kMinBlocks times on an SM, so the
// serving geometry's 768 blocks can all be resident at once (a cluster
// launch may leave a few SMs of a GPC unused); kSQ = 8 holds twice the
// per-query state and fits kMinBlocks8 times (both spill a few bytes at
// most head dims: chip_smoke.py phase 1 prints every instance's registers
// and local memory). kSQ = 16 (a fused prefill step) doubles the state
// again (acc alone is 16 x d / 32 floats a lane): two blocks an SM (168
// registers a thread on the H100) hold it without spilling only at d 32
// and, with a 16-bit or int8 cache, d 64; the other kSQ 16 instances take
// one block an SM and up to 255 registers, so none spills (phase 1 fails
// on a kSQ 16 instance with local memory).
template <typename TC, int D, int kSQ>
constexpr int min_blocks() {
  if constexpr (kSQ <= 4) return kMinBlocks;
  if constexpr (kSQ <= 8) return kMinBlocks8;
  return D <= 32 || (D == 64 && !std::is_same<TC, float>::value) ? 2 : 1;
}

template <typename T, typename TC, int D, int kSQ, typename Rows>
__global__ void __launch_bounds__(kThreads, (min_blocks<TC, D, kSQ>()))
decode_attention_kernel(const T* __restrict__ q,       // [b, q_stride, h, D]
                        // cache rows [*, h*D], boxes of D + 16 bytes x
                        // box_rows rows (`key_map`)
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const float* __restrict__ k_scale,  // [*] (int8)
                        const float* __restrict__ v_scale,
                        const int* __restrict__ cache_len,  // [b]
                        T* __restrict__ out,      // [b, q_stride, h, D]
                        int s_q, int q_stride, int h, int S, float scale,
                        int box_rows,
                        Rows rows) {
  using R = Ring<TC, D>;
  using L = Smem<TC, D, kSQ>;
  constexpr bool kInt8 = R::kInt8;
  constexpr int kStages = R::kStages;
  constexpr bool kStrided = D % 32 != 0;      // see value_chan
  constexpr int DPL = (D + 31) / 32;          // channels per lane (values)
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* sc_s = reinterpret_cast<float*>(smem + L::kScalesAt);
  float* q_s = reinterpret_cast<float*>(smem + L::kQAt);
  float* p_s = reinterpret_cast<float*>(smem + L::kPAt);
  float* part = reinterpret_cast<float*>(smem + L::kPartAt);
  float* pml = reinterpret_cast<float*>(smem + L::kPmlAt);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarsAt);
  uint64_t* empty = full + kStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int head = blockIdx.x;
  const int row = blockIdx.y;
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the first half of the barrier that, before the merge, tells every
  // block that all of the cluster has started (its shared memory exists)
  cluster_arrive_relaxed();

  const int fill = min(max(cache_len[row], 0), S);
  const int lim0 = fill - (s_q - 1);          // query i sees p < lim0 + i
  int t_begin, t_end;
  split_range((fill + kTile - 1) / kTile, rank, C, t_begin, t_end);
  const int n_mine = t_end - t_begin;         // this rank's tiles

  // The producer sets up the barriers and starts its copies at once; the
  // consumers stage the queries meanwhile and wait (named barrier 1) only
  // for the barriers' set-up.
  if (warp == kConsumers) {
    if (lane == 0) {
      for (int i = 0; i < kStages; ++i) {
        bar_init(&full[i], 32);               // the producer's 32 lanes
        bar_init(&empty[i], kConsumers);      // every consumer warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    asm volatile("bar.arrive 1, %0;\n" :: "n"(kThreads) : "memory");
  } else {
    for (int idx = threadIdx.x; idx < kSQ * D; idx += 32 * kConsumers) {
      const int i = idx / D, j = idx % D;
      q_s[idx] = i < s_q
          ? to_f(q[(((size_t)row * q_stride + i) * h + head) * D + j])
          : 0.f;
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(kThreads) : "memory");
  }

  float m[kSQ], l[kSQ], acc[kSQ][DPL];
#pragma unroll
  for (int i = 0; i < kSQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }

  if (warp == kConsumers) {
    // the producer: lane = box of the tile (box_rows keys, which the
    // layout keeps contiguous), and lane = key for the int8 scales
    for (int j = 0; j < n_mine; ++j) {
      const int st = j % kStages;
      if (j >= kStages) bar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
      const int t0 = (t_begin + j) * kTile;
      const int nk = min(kTile, fill - t0);   // live keys of the tile
      const int nbox = (nk + box_rows - 1) / box_rows;   // boxes with one
      if (lane == 0)
        bar_expect_tx(&full[st], 2u * nbox * box_rows * R::kStride);
      __syncwarp();
      unsigned char* kt = ring + st * R::kStageBytes;
      if (lane < nbox) {
        const int first = rows(row, t0 + lane * box_rows);
        unsigned char* dst = kt + lane * box_rows * R::kStride;
        tma_load_2d(dst, &tk, &full[st], head * D, first);
        tma_load_2d(dst + R::kTileBytes, &tv, &full[st], head * D, first);
      }
      if (kInt8 && lane < nk) {
        const int crow = rows(row, t0 + lane);
        sc_s[(st * 2) * kTile + lane] = k_scale[crow];
        sc_s[(st * 2 + 1) * kTile + lane] = v_scale[crow];
      }
      bar_arrive(&full[st]);                  // releases the scale stores
    }
  } else {
    // consumer warp `warp`: keys 8 warp .. 8 warp + 7 of every tile of the
    // rank. Every consumer warp waits on every stage in turn, so none is
    // ever more than one phase ahead of a barrier (a parity wait cannot
    // tell phase n from phase n + 2).
    constexpr int NE = D / kGroup;            // channels a lane scores
    // chunks of the widest of 16, 8 and 4 bytes that divides NE elements
    // (a lane's quarter row starts at a multiple of its own size)
    constexpr int kNB = NE * (int)sizeof(TC);
    constexpr int VN =
        (kNB % 16 == 0 ? 16 : kNB % 8 == 0 ? 8 : 4) / (int)sizeof(TC);
    static_assert(NE % VN == 0 && VN >= 1, "whole chunks a lane");
    const int kk = lane & (kKeysPerWarp - 1);  // the lane's key of the warp
    const int g = lane / kKeysPerWarp;        // its chunk of the key's row
    const int key = warp * kKeysPerWarp + kk; // its key of the tile
    float* p_w = p_s + warp * kKeysPerWarp * kSQ;
    for (int j = 0; j < n_mine; ++j) {
      const int st = j % kStages;
      bar_wait(&full[st], (j / kStages) & 1);
      const int t0 = (t_begin + j) * kTile;
      const int pos = t0 + key;
      // live keys of the tile that are this warp's
      const int nkw = min(max(fill - t0 - warp * kKeysPerWarp, 0),
                          kKeysPerWarp);
      const unsigned char* kt = ring + st * R::kStageBytes;
      const unsigned char* vt = kt + R::kTileBytes;
      const float* ks_t = sc_s + (st * 2) * kTile;
      const float* vs_t = ks_t + kTile;
      float p[kSQ];
#pragma unroll
      for (int i = 0; i < kSQ; ++i) p[i] = 0.f;
      if (pos < fill) {                       // scores: kGroup lanes a key
        const TC* kr =
            reinterpret_cast<const TC*>(kt + key * R::kStride) + g * NE;
        const float ksc = kInt8 ? ks_t[key] : 1.f;
#pragma unroll
        for (int e = 0; e < NE; e += VN) {
          float kv[VN];
          load_chunk<TC, VN>(kr + e, kv);
          if (kInt8) {
#pragma unroll
            for (int u = 0; u < VN; ++u) kv[u] *= ksc;
          }
#pragma unroll
          for (int i = 0; i < kSQ; ++i) {
            float qv[VN];
            load_f32<VN>(q_s + i * D + g * NE + e, qv);
#pragma unroll
            for (int u = 0; u < VN; ++u) p[i] = fmaf(kv[u], qv[u], p[i]);
          }
        }
      }
      // Online softmax per query, each step over all the queries at once
      // (independent shuffles back to back). A key's dot sums over its
      // kGroup lanes (each lane ends with the same sum: a + b and b + a
      // round alike); max and sum run over the warp's keys.
#pragma unroll
      for (int o = kKeysPerWarp; o < 32; o <<= 1) {
#pragma unroll
        for (int i = 0; i < kSQ; ++i) p[i] += __shfl_xor_sync(kFull, p[i], o);
      }
      float r[kSQ], corr[kSQ];
#pragma unroll
      for (int i = 0; i < kSQ; ++i) {
        p[i] = pos < lim0 + i ? p[i] * scale : -INFINITY;
        r[i] = p[i];
      }
#pragma unroll
      for (int o = 1; o < kKeysPerWarp; o <<= 1) {
#pragma unroll
        for (int i = 0; i < kSQ; ++i)
          r[i] = fmaxf(r[i], __shfl_xor_sync(kFull, r[i], o));
      }
#pragma unroll
      for (int i = 0; i < kSQ; ++i) {
        const float m_new = fmaxf(m[i], r[i]);
        corr[i] = m_new == -INFINITY ? 1.f : rescale(m[i], m_new);
        p[i] = p[i] == -INFINITY ? 0.f : expf(p[i] - m_new);  // not seen: 0
        m[i] = m_new;
        r[i] = p[i];
      }
#pragma unroll
      for (int o = 1; o < kKeysPerWarp; o <<= 1) {
#pragma unroll
        for (int i = 0; i < kSQ; ++i) r[i] += __shfl_xor_sync(kFull, r[i], o);
      }
#pragma unroll
      for (int i = 0; i < kSQ; ++i) {
        l[i] = l[i] * corr[i] + r[i];
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] *= corr[i];
      }
      // the key's probabilities to shared memory, for the value loop
      if (g == 0) {
#pragma unroll
        for (int i = 0; i < kSQ; ++i) p_w[kk * kSQ + i] = p[i];
      }
      __syncwarp();
      // values: lane = channel, over the warp's live keys (a slot past the
      // fill holds stale bytes and is never read)
      float vv[kKeysPerWarp][DPL];
#pragma unroll
      for (int u = 0; u < kKeysPerWarp; ++u) {   // all loads first
        if (u < nkw) {
          const int kr = warp * kKeysPerWarp + u;
          const TC* vrow = reinterpret_cast<const TC*>(vt + kr * R::kStride);
          if constexpr (kStrided) {
#pragma unroll
            for (int c = 0; c < DPL; ++c) {
              const int ch = value_chan<D>(lane, c);
              vv[u][c] = ch < D ? to_f(vrow[ch]) : 0.f;
            }
          } else {
            VecN<TC, DPL>::load(vrow + lane * DPL, vv[u]);
          }
          if (kInt8) {
            const float s = vs_t[kr];
#pragma unroll
            for (int c = 0; c < DPL; ++c) vv[u][c] *= s;
          }
        } else {
#pragma unroll
          for (int c = 0; c < DPL; ++c) vv[u][c] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kKeysPerWarp; ++u) {   // p is 0 past the fill
        float pk[kSQ];
        load_f32<kSQ>(p_w + u * kSQ, pk);
#pragma unroll
        for (int i = 0; i < kSQ; ++i) {
#pragma unroll
          for (int c = 0; c < DPL; ++c)
            acc[i][c] = fmaf(pk[i], vv[u][c], acc[i][c]);
        }
      }
      __syncwarp();       // the stage and p_w are read: both may be reused
      if (lane == 0) bar_arrive(&empty[st]);
    }
  }
  // every copy has landed and been read: the ring takes the warps' states
  __syncthreads();
  float* m_w = reinterpret_cast<float*>(ring);         // [kConsumers][kSQ]
  float* l_w = m_w + kConsumers * kSQ;
  float* acc_w = l_w + kConsumers * kSQ;               // [kConsumers][kSQ][D]
  if (warp < kConsumers) {
#pragma unroll
    for (int i = 0; i < kSQ; ++i) {
      if (lane == 0) {
        m_w[warp * kSQ + i] = m[i];
        l_w[warp * kSQ + i] = l[i];
      }
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        if (!kStrided || value_chan<D>(lane, c) < D)
          acc_w[(warp * kSQ + i) * D + value_chan<D>(lane, c)] = acc[i][c];
    }
  }
  __syncthreads();
  // Every block of the cluster has started, so rank 0's shared memory
  // takes this block's merge of its warps' states, in warp order, stored
  // straight into part[rank] and pml[rank] there.
  cluster_wait();
  float* part0 = cluster.map_shared_rank(part, 0);
  float* pml0 = cluster.map_shared_rank(pml, 0);
  for (int idx = threadIdx.x; idx < s_q * D; idx += kThreads) {
    const int i = idx / D, j = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) M = fmaxf(M, m_w[w * kSQ + i]);
    float Lw = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float f = rescale(m_w[w * kSQ + i], M);
      Lw = fmaf(l_w[w * kSQ + i], f, Lw);
      o = fmaf(acc_w[(w * kSQ + i) * D + j], f, o);
    }
    part0[(rank * kSQ + i) * D + j] = o;
    if (j == 0) {
      pml0[(rank * 2) * kSQ + i] = M;
      pml0[(rank * 2 + 1) * kSQ + i] = Lw;
    }
  }
  cluster_arrive();      // release: rank 0 sees the stores after its wait
  if (rank != 0) return;   // nothing reads this block's shared memory
  cluster_wait();
  // the cluster's merge, in rank order, from rank 0's own shared memory
  // (every rank's values loaded before the first is used; a rank past C
  // reads as a state that saw no key, whose factor is 0)
  for (int idx = threadIdx.x; idx < s_q * D; idx += kThreads) {
    const int i = idx / D, j = idx % D;
    float mr[kMaxSplit], lr[kMaxSplit], orr[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      const bool in = r < C;
      mr[r] = in ? pml[(r * 2) * kSQ + i] : -INFINITY;
      lr[r] = in ? pml[(r * 2 + 1) * kSQ + i] : 0.f;
      orr[r] = in ? part[(r * kSQ + i) * D + j] : 0.f;
    }
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) M = fmaxf(M, mr[r]);
    float Lc = 0.f, o = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      const float f = rescale(mr[r], M);
      Lc = fmaf(lr[r], f, Lc);
      o = fmaf(orr[r], f, o);
    }
    out[(((size_t)row * q_stride + i) * h + head) * D + j] =
        from_f<T>(Lc > 0.f ? o / Lc : 0.f);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API (null if it lacks it)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

template <typename TC>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<TC, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<TC, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
         : std::is_same<TC, __nv_bfloat16>::value
             ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
             : CU_TENSOR_MAP_DATA_TYPE_UINT8;     // int8: bits as they are
}

// The tensor map of a cache seen as `n_rows` rows of h * D elements (dense
// [b, S, h*D]: b * S rows; paged [nb, bs, h*D]: nb * bs rows), in boxes of
// D + 16 / sizeof(TC) columns x box_rows rows: a box from column head * D
// lands as box_rows rows of D elements each padded by the next 16 bytes of
// the row (the next head's, or zeros past the row's end), which is the
// ring's padded row. Rows out of range arrive as zeros. False if the map
// is refused.
template <typename TC, int D>
bool key_map(CUtensorMap* map, const void* ptr, long long n_rows, int h,
             int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)h * D, (cuuint64_t)n_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)h * D * sizeof(TC)};
  const cuuint32_t box[2] = {(cuuint32_t)(Ring<TC, D>::kStride / sizeof(TC)),
                             (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, map_type<TC>(), 2, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Sets the kernel's shared memory and checks, once per device, that a
// cluster of kMaxSplit of its blocks fits on the card (a smaller cluster
// then fits too).
template <typename Kernel>
cudaError_t prepare(Kernel kern, int smem, unsigned* ready) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (*ready & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, kMaxSplit);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = kMaxSplit;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  *ready |= bit;
  return cudaSuccess;
}

constexpr int sq_bucket(int s_q) {
  return s_q <= 1 ? 1 : s_q <= 2 ? 2 : s_q <= 4 ? 4 : s_q <= 8 ? 8 : 16;
}

template <typename T, typename TC, int D, int kSQ, typename Rows>
cudaError_t launch_sq(const T* q, const TC* k, const TC* v,
                     const float* k_scale, const float* v_scale,
                     const int* cache_len, T* out, int b, int s_q,
                     int q_stride, int h, int S, float scale,
                     long long n_rows, int box_rows, Rows rows,
                     cudaStream_t stream) {
  static unsigned ready = 0;   // devices prepared (one bit each)
  constexpr int smem = Smem<TC, D, kSQ>::kBytes;
  auto kern = decode_attention_kernel<T, TC, D, kSQ, Rows>;
  cudaError_t e = prepare(kern, smem, &ready);
  if (e != cudaSuccess) return e;
  CUtensorMap tk, tv;
  if (!key_map<TC, D>(&tk, k, n_rows, h, box_rows)
      || !key_map<TC, D>(&tv, v, n_rows, h, box_rows))
    return cudaErrorInvalidValue;
  const int C = min(kMaxSplit, (S + kTile - 1) / kTile);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(h, b, C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = C;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, q, tk, tv, k_scale, v_scale,
                         cache_len, out, s_q, q_stride, h, S, scale,
                         box_rows, rows);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, typename TC, int D, typename Rows>
cudaError_t launch_d(const T* q, const TC* k, const TC* v,
                     const float* k_scale, const float* v_scale,
                     const int* cache_len, T* out, int b, int s_q,
                     int q_stride, int h, int S, float scale,
                     long long n_rows, int box_rows, Rows rows,
                     cudaStream_t stream) {
  switch (sq_bucket(s_q)) {
#define DSTORCH_DECODE_SQ(SQ_)                                              \
  case SQ_:                                                                 \
    return launch_sq<T, TC, D, SQ_, Rows>(q, k, v, k_scale, v_scale,        \
                                          cache_len, out, b, s_q, q_stride, \
                                          h, S, scale, n_rows, box_rows,    \
                                          rows, stream);
    DSTORCH_DECODE_SQ(1)
    DSTORCH_DECODE_SQ(2)
    DSTORCH_DECODE_SQ(4)
    DSTORCH_DECODE_SQ(8)
    DSTORCH_DECODE_SQ(16)
#undef DSTORCH_DECODE_SQ
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename TC, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const int* cache_len, void* out, int b, int s_q,
                   int q_stride, int h, int d, int S, float scale,
                   long long n_rows, int box_rows, Rows rows,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const TC* kt = static_cast<const TC*>(k);
  const TC* vt = static_cast<const TC*>(v);
  T* ot = static_cast<T*>(out);
  switch (d) {
#define DSTORCH_DECODE_CASE(D_)                                             \
  case D_:                                                                  \
    return launch_d<T, TC, D_, Rows>(qt, kt, vt, k_scale, v_scale,          \
                                     cache_len, ot, b, s_q, q_stride, h, S, \
                                     scale, n_rows, box_rows, rows, stream);
    DSTORCH_DECODE_CASE(32)
    DSTORCH_DECODE_CASE(64)
    DSTORCH_DECODE_CASE(80)
    DSTORCH_DECODE_CASE(96)
    DSTORCH_DECODE_CASE(128)
#undef DSTORCH_DECODE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename Rows>
int dispatch(const void* q, const void* k, const void* v, const void* k_scale,
             const void* v_scale, const int* cache_len, void* out, int b,
             int s_q, int q_stride, int h, int d, int S, float scale,
             int dtype, int int8, long long n_rows, int box_rows, Rows rows,
             void* stream) {
  if (s_q < 1 || s_q > kMaxSQ || q_stride < s_q || b < 1 || h < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (int8 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
#define DSTORCH_DECODE_TYPES(T_, TC_)                                       \
  return (int)launch<T_, TC_>(q, k, v, ks, vs, cache_len, out, b, s_q,      \
                              q_stride, h, d, S, scale, n_rows, box_rows,  \
                              rows, st);
  if (dtype == 0 && !int8) DSTORCH_DECODE_TYPES(float, float)
  if (dtype == 0) DSTORCH_DECODE_TYPES(float, int8_t)
  if (dtype == 1 && !int8) DSTORCH_DECODE_TYPES(__nv_bfloat16, __nv_bfloat16)
  if (dtype == 1) DSTORCH_DECODE_TYPES(__nv_bfloat16, int8_t)
  if (dtype == 2 && !int8) DSTORCH_DECODE_TYPES(__half, __half)
  if (dtype == 2) DSTORCH_DECODE_TYPES(__half, int8_t)
#undef DSTORCH_DECODE_TYPES
  return (int)cudaErrorInvalidValue;
}

}  // namespace

