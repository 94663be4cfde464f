// Sort-free sampling epilogue for Hopper (sm_90a): top-k / top-p filter and
// the draw, one kernel launch a call.
//
// Replaces the Pallas kernel `_sampling_kernel` in
// deepspeed_tpu/ops/pallas/sampling.py (wrappers `threshold_filter_logits`
// and `fused_sample`). Semantics are the TPU kernel's, row by row, on logits
// the wrapper has already divided by the temperature:
//   * order key: bitcast f32 -> i32, negatives reflected (INT32_MAX - bits,
//     wrapping for -0.0), strictly monotonic in the float order;
//   * top-k: the k-th largest key, ties kept (the largest t with
//     count(key >= t) >= k);
//   * top-p, over the top-k output y with e = exp(y - max): the largest
//     present key K with mass(key >= K) >= p * Z, Z the sum of e (the
//     smallest present key above the TPU kernel's bisection result);
//     masked logits become -1e10;
//   * draw: first-index argmax of the filtered row, or of row + gumbel.
//
// Bound: device-memory bytes (one read of the [V] row, the gumbel row when
// sampling, one write of the filtered row when asked). Design:
//   * A row is split over a thread-block cluster of C blocks (grid C * b,
//     cluster dims (C, 1, 1), C a power of two up to 16, non-portable
//     above 8). C is picked from b so that b * C comes near the SM count
//     (C = 1 once b fills the card), no block gets fewer than kMinSlice
//     entries, and a filtering block's slices fit its shared memory.
//   * Greedy (no filter) streams: one read of the slice with 16-byte loads
//     (gumbel in the same pass), a (max, first index) per block, one merge
//     in rank 0 through distributed shared memory. Nothing is staged.
//   * Filtering: each block reads its slice of V / C entries once, with
//     16-byte loads, into its shared memory (and the gumbel slice beside
//     it); the row is never read from device memory again.
//   * Both cuts are radix selects on the 32-bit key in place of the 33-step
//     bisections: 4 rounds of 8-bit digits, most significant first. A
//     round histograms the digit of each live entry (those whose digits so
//     far match the ones chosen) into per-warp 256-bin histograms, and a
//     warp walks the summed bins from the top to the digit where the
//     running total (count for top-k, probability mass for top-p) reaches
//     the target. Counts use shared-memory integer atomics, which the
//     hardware aggregates within a warp. Mass is summed exactly, as 64-bit
//     fixed point (e * 2^44, truncated; a row stays below 2^63): float
//     atomics on shared memory are compare-and-swap loops on this card,
//     slow under the contention of a digit histogram, so each mass goes in
//     as three 15-bit pieces by native integer atomics.
//     Integer sums do not depend on their order, so every block of a
//     cluster walks the same bins, a call is bitwise reproducible, and the
//     cut differs from the f32 reference only where the f32 mass sits
//     within its own rounding of p * Z. e = exp(y - max) is computed once
//     per entry and kept in shared memory.
//   * Candidate path (top-k, with top-p after it or not): each block
//     selects its own slice's k-th key with block barriers only and keeps
//     its entries at or above it (at most k plus ties); one cluster
//     barrier later every block gathers the C lists (each global top-k
//     entry is in its block's list) and finds the global k-th key and the
//     top-p cut on them, again with block barriers only. That is one
//     cluster barrier for the two cuts, where the cluster-wide descents
//     below take a barrier a round.
//   * General path (top-p alone, or candidates past kGather: large k or
//     ties): the descents run over the whole row, each round's histogram
//     published double-buffered by round parity and summed over the
//     cluster through distributed shared memory after one cluster barrier.
//     Only entries with e > 0 can decide the top-p cut (e is monotonic in
//     the key), so after top-k its rounds touch only the kept entries.
//   * A last cluster barrier keeps every block's shared memory alive until
//     the others have read it.
//
// Plain C interface (no PyTorch headers), bound with ctypes by
// deepspeed_tpu_torch/ops/cuda/sampling.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;               // 8-bit digits
constexpr int kRounds = 4;               // 32-bit keys
constexpr int kMaxCluster = 16;          // non-portable above 8
constexpr int kMinSlice = 2048;          // entries a block at least
constexpr int kStageBytes = 192 * 1024;  // a filtering block's slices
constexpr int kGather = 1024;            // candidates of the whole row
constexpr float kNegCap = -1e10f;        // the reference's masked value
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMassScale = 17592186044416.f;   // 2^44: fixed-point mass
constexpr int kPieceBits = 15;           // a mass in three 15-bit pieces
constexpr int kMassCopies = 4;           // mass histograms, a warp pair each
typedef unsigned long long u64;

__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : (int)(0x7fffffffu - (unsigned)b);
}

// the order key as an unsigned integer with the same order
__device__ __forceinline__ unsigned radix_key(float x) {
  return (unsigned)order_key(x) ^ 0x80000000u;
}

__device__ __forceinline__ u64 fixed_mass(float e) {
  return __float2ull_rz(e * kMassScale);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {   // release
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {     // acquire
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// A cluster barrier, or a block barrier (far cheaper) when the cluster is
// one block
__device__ __forceinline__ void cluster_sync(int C) {
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
}

struct Shared {
  union {                               // digit histograms
    int cnt[kWarps][kBins];                   // one a warp
    unsigned mass[kMassCopies][3][kBins];     // a mass's 15-bit pieces
  } hist;
  // this block's histogram (counts or fixed-point mass) by round parity,
  // or a scalar in word kBins
  u64 pub[2][kBins + 1];
  float cand[kGather];                  // this block's top-k candidates
  float gathered[kGather];              // the whole row's
  float best[kMaxCluster];              // rank 0: each block's draw
  int best_i[kMaxCluster];
  float red_f[kWarps];
  int red_i[kWarps];
  u64 red_u[kWarps];
  unsigned sel_digit;                   // the chosen digit of a round
  u64 sel_above;                        // count or mass of the bins above
  int n_cand;                           // this block's candidates
  int cand_at[kMaxCluster + 1];         // rank q's first gathered entry
};

struct Cut {
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

// (value, index) with the larger value, then the lower index
__device__ __forceinline__ void take_best(float& best, int& best_i, float v,
                                          int i) {
  if (v > best || (v == best && i < best_i)) { best = v; best_i = i; }
}

__device__ __forceinline__ void warp_best(float& best, int& best_i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, o);
    const int oi = __shfl_xor_sync(kFull, best_i, o);
    take_best(best, best_i, ob, oi);
  }
}

// Every thread returns the block's result; `red` is reusable afterwards.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ u64 block_sum(u64 v, u64* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  u64 r = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

// Word `word` of sh.pub[par] of each of the cluster's C blocks, all C
// loads in flight at once.
__device__ __forceinline__ void cluster_words(cg::cluster_group& cluster,
                                              Shared& sh, int par, int word,
                                              int C, u64* v) {
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < C) v[r] = cluster.map_shared_rank(&sh.pub[par][0], r)[word];
}

__device__ __forceinline__ u64 cluster_sum(cg::cluster_group& cluster,
                                           Shared& sh, int par, int word,
                                           int C) {
  u64 v[kMaxCluster];
  cluster_words(cluster, sh, par, word, C, v);
  u64 s = 0;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < C) s += v[r];
  return s;
}

// Publishes one scalar per block (thread 0's `mine`), one cluster barrier;
// `v` receives the cluster's scalars in rank order. Flips the parity.
__device__ __forceinline__ void exchange_scalar(cg::cluster_group& cluster,
                                                Shared& sh, int& par, int C,
                                                u64 mine, u64* v) {
  if (threadIdx.x == 0) sh.pub[par][kBins] = mine;
  cluster_sync(C);
  cluster_words(cluster, sh, par, kBins, C, v);
  par ^= 1;
}

// One round's histogram of the digit at `shift` over m entries of `vals`
// whose key matches `prefix` under `pmask`, into sh.hist; then thread t
// folds bin 255 - t of the histograms (zeroing them) and returns it:
// thread order runs from the top bin down. Counts (kMass false) of
// radix_key(vals[i]); mass (kMass true) of radix_key(cut.after_k(vals[i]))
// weighted by fixed_mass(es[i]), entries with no mass left out. A mass
// (< 2^45) goes in as three 15-bit pieces, each a native 32-bit atomic
// add into its own counter (no counter passes 2^30 for m below 2^15).
template <bool kMass>
__device__ __forceinline__ u64 histogram(Shared& sh, const float* vals,
                                         const float* es, int m, Cut cut,
                                         unsigned prefix, unsigned pmask,
                                         int shift) {
  const int warp = threadIdx.x >> 5;
  constexpr unsigned kPiece = (1u << kPieceBits) - 1;
  for (int i = threadIdx.x; i < m; i += kThreads) {
    if constexpr (!kMass) {
      const unsigned u = radix_key(vals[i]);
      if ((u & pmask) == prefix)
        atomicAdd(&sh.hist.cnt[warp][(u >> shift) & 0xff], 1);
    } else {
      const u64 f = fixed_mass(es[i]);
      const unsigned u = radix_key(cut.after_k(vals[i]));
      if (f != 0 && (u & pmask) == prefix) {
        unsigned* c =
            &sh.hist.mass[warp % kMassCopies][0][(u >> shift) & 0xff];
        atomicAdd(c, (unsigned)f & kPiece);
        atomicAdd(c + kBins, (unsigned)(f >> kPieceBits) & kPiece);
        const unsigned top = (unsigned)(f >> (2 * kPieceBits));
        if (top != 0) atomicAdd(c + 2 * kBins, top);
      }
    }
  }
  __syncthreads();
  const int bin = kBins - 1 - threadIdx.x;
  u64 h = 0;
  if constexpr (kMass) {
#pragma unroll
    for (int w = 0; w < kMassCopies; ++w) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        h += (u64)sh.hist.mass[w][p][bin] << (p * kPieceBits);
        sh.hist.mass[w][p][bin] = 0;
      }
    }
  } else {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      h += (u64)sh.hist.cnt[w][bin];
      sh.hist.cnt[w][bin] = 0;
    }
  }
  return h;
}

// Thread t holds the total h of bin 255 - t. The first (highest) bin d
// whose running total from the top (`above`, the bins > d, then bin d)
// reaches `need` goes to sh.sel_digit, `above` plus the bins above d to
// sh.sel_above: a block-wide inclusive scan in thread order. The sums are
// exact and the previous round's bin reached `need`, so some bin always
// does. Ends with the block synchronised.
__device__ __forceinline__ void select_digit(Shared& sh, u64 h, u64 above,
                                             u64 need) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  u64 inc = h;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u64 up = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += up;
  }
  if (lane == 31) sh.red_u[warp] = inc;
  __syncthreads();
  u64 before = above;
#pragma unroll
  for (int w = 0; w < kWarps - 1; ++w)
    if (w < warp) before += sh.red_u[w];
  const u64 excl = before + inc - h;
  if (excl < need && excl + h >= need) {
    sh.sel_digit = (unsigned)(kBins - 1 - t);
    sh.sel_above = excl;
  }
  __syncthreads();
}

// The radix select: the largest key t (as a signed order key) whose live
// entries at or above it total `need` (count: the need-th largest key;
// mass: the top-p cut). kCluster: each round's histogram is summed over
// the cluster (one cluster barrier a round, `par` the publishing parity);
// else over this block's m entries alone.
template <bool kMass, bool kCluster>
__device__ int descend(cg::cluster_group& cluster, Shared& sh,
                       const float* vals, const float* es, int m, Cut cut,
                       u64 need, int& par, int C) {
  unsigned prefix = 0, pmask = 0;
  u64 above = 0;
  for (int r = 0; r < kRounds; ++r) {
    const int shift = 24 - 8 * r;
    u64 h = histogram<kMass>(sh, vals, es, m, cut, prefix, pmask, shift);
    if constexpr (kCluster) {
      sh.pub[par][threadIdx.x] = h;
      cluster_sync(C);
      h = cluster_sum(cluster, sh, par, threadIdx.x, C);
      par ^= 1;
    }
    select_digit(sh, h, above, need);
    above = sh.sel_above;
    prefix |= sh.sel_digit << shift;
    pmask |= 0xffu << shift;
  }
  return (int)(prefix ^ 0x80000000u);
}

// The smallest integer at or above p * Z (Z < 2^63 is exact to 2^-53 in
// double, far inside f32's rounding of the reference's p * Z)
__device__ __forceinline__ u64 mass_need(float top_p, u64 z) {
  return (u64)ceil((double)top_p * (double)z);
}

// One row split over a cluster of C blocks (blockIdx.x = row * C + rank);
// rank r holds entries [r * S, min(V, (r + 1) * S)), S a multiple of 4.
template <bool kFilter>
__global__ void __launch_bounds__(kThreads)
sampling_kernel(const float* __restrict__ logits,   // [b, V]
                const float* __restrict__ gumbel,   // [b, V] or null
                float* __restrict__ out_logits,     // [b, V] or null
                int* __restrict__ out_tokens,       // [b] or null
                int V, int S, int top_k, float top_p, int vec) {
  extern __shared__ __align__(16) float staged[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int beg = rank * S;
  const int n = max(0, min(V, beg + S) - beg);
  const size_t at = (size_t)row * V + beg;
  const float* x = logits + at;
  const float* g = gumbel != nullptr ? gumbel + at : nullptr;
  float* o = out_logits != nullptr ? out_logits + at : nullptr;
  float best = -INFINITY;
  int best_i = V;

  if constexpr (!kFilter) {
    // this block has started: rank 0 may take its draw after the wait
    if (out_tokens != nullptr && C > 1) cluster_arrive_relaxed();
    if (vec) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* o4 = reinterpret_cast<float4*>(o);
      for (int j = tid; j < n / 4; j += kThreads) {
        const float4 a = __ldg(x4 + j);
        if (o != nullptr) o4[j] = a;
        if (out_tokens != nullptr) {
          float4 z = a;
          if (g != nullptr) {
            const float4 gg = __ldg(g4 + j);
            z.x += gg.x; z.y += gg.y; z.z += gg.z; z.w += gg.w;
          }
          const int i = beg + 4 * j;
          take_best(best, best_i, z.x, i);
          take_best(best, best_i, z.y, i + 1);
          take_best(best, best_i, z.z, i + 2);
          take_best(best, best_i, z.w, i + 3);
        }
      }
    } else {
      for (int i = tid; i < n; i += kThreads) {
        const float a = __ldg(x + i);
        if (o != nullptr) o[i] = a;
        if (out_tokens != nullptr)
          take_best(best, best_i,
                    g != nullptr ? a + __ldg(g + i) : a, beg + i);
      }
    }
    if (out_tokens == nullptr) return;
    if (C > 1) cluster_wait();
  } else {
    const bool has_k = top_k > 0 && top_k < V;
    const bool has_p = top_p > 0.f && top_p < 1.f;
    float* xs = staged;
    float* es = staged + S;                          // has_p
    float* gs = staged + (has_p ? 2 * S : S);        // gumbel, when drawing
    const bool stage_g = g != nullptr && out_tokens != nullptr;
    u64 v[kMaxCluster];

    // ---- the slice (and its gumbel slice) into shared memory, once
    float bmax = -INFINITY;
    if (vec) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
      const float4* g4 = reinterpret_cast<const float4*>(g);
      for (int j = tid; j < n / 4; j += kThreads) {
        const float4 a = __ldg(x4 + j);
        if (stage_g) reinterpret_cast<float4*>(gs)[j] = __ldg(g4 + j);
        reinterpret_cast<float4*>(xs)[j] = a;
        bmax = fmaxf(bmax, fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)));
      }
    } else {
      for (int i = tid; i < n; i += kThreads) {
        const float a = __ldg(x + i);
        if (stage_g) gs[i] = __ldg(g + i);
        xs[i] = a;
        bmax = fmaxf(bmax, a);
      }
    }
    for (int i = tid; i < kMassCopies * 3 * kBins; i += kThreads)
      (&sh.hist.mass[0][0][0])[i] = 0;
    if (tid == 0) sh.n_cand = 0;
    __syncthreads();
    Cut cut{INT_MIN, INT_MIN};
    int par = 0;
    bool done = false;   // the cuts found on the candidate path

    // ---- candidate path: this block's top-k entries, then the row's
    if (has_k) {
      const int kth_local =
          n > top_k ? descend<false, false>(cluster, sh, xs, nullptr, n, cut,
                                            (u64)top_k, par, C)
                    : INT_MIN;
      for (int i = tid; i < n; i += kThreads) {
        const float a = xs[i];
        if (order_key(a) >= kth_local) {
          const int slot = atomicAdd(&sh.n_cand, 1);
          if (slot < kGather) sh.cand[slot] = a;
        }
      }
      __syncthreads();
      exchange_scalar(cluster, sh, par, C, (u64)sh.n_cand, v);
      int total = 0;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if (q < C) {
          if (tid == 0) sh.cand_at[q] = total;
          total += (int)v[q];
        }
      }
      if (tid == 0) sh.cand_at[C] = total;
      __syncthreads();
      if (total <= kGather) {              // the same answer in every block
        // the C lists in rank order: rank q's entry i at cand_at[q] + i;
        // a thread's remote loads all in flight before its stores
        constexpr int kPer = kGather / kThreads;
        float got[kPer];
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int j = tid + r * kThreads;
          if (j < total) {
            int q = 0;
            while (j >= sh.cand_at[q + 1]) ++q;
            got[r] =
                cluster.map_shared_rank(&sh.cand[0], q)[j - sh.cand_at[q]];
          }
        }
#pragma unroll
        for (int r = 0; r < kPer; ++r)
          if (tid + r * kThreads < total)
            sh.gathered[tid + r * kThreads] = got[r];
        __syncthreads();
        cut.kth_k = descend<false, false>(cluster, sh, sh.gathered, nullptr,
                                          total, cut, (u64)top_k, par, C);
        bool fits = true;
        if (has_p) {
          // the row's max is a candidate; masked entries carry no mass
          // unless it sits within 104 of -1e10 (then: the general path)
          float gmax = -INFINITY;
          for (int j = tid; j < total; j += kThreads)
            gmax = fmaxf(gmax, sh.gathered[j]);
          const float mx = block_max(gmax, sh.red_f);
          fits = expf(kNegCap - mx) == 0.f;
          if (fits) {
            u64 z = 0;
            for (int j = tid; j < total; j += kThreads) {
              const float e = expf(cut.after_k(sh.gathered[j]) - mx);
              es[j] = e;
              z += fixed_mass(e);
            }
            z = block_sum(z, sh.red_u);       // also orders es
            cut.kth_p = descend<true, false>(cluster, sh, sh.gathered, es,
                                             total, cut,
                                             mass_need(top_p, z), par, C);
          }
        }
        done = fits;
      }
      if (!done) cut.kth_k = INT_MIN;
    }

    // ---- general path: the descents over the whole row
    if (!done) {
      if (has_k)
        cut.kth_k = descend<false, true>(cluster, sh, xs, nullptr, n, cut,
                                         (u64)top_k, par, C);
      if (has_p) {
        bmax = block_max(bmax, sh.red_f);
        exchange_scalar(cluster, sh, par, C, __float_as_uint(bmax), v);
        float mx = -INFINITY;
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)
          if (q < C) mx = fmaxf(mx, __uint_as_float((unsigned)v[q]));
        u64 z = 0;
        for (int i = tid; i < n; i += kThreads) {
          const float e = expf(cut.after_k(xs[i]) - mx);
          es[i] = e;
          z += fixed_mass(e);
        }
        z = block_sum(z, sh.red_u);         // also orders es
        exchange_scalar(cluster, sh, par, C, z, v);
        u64 zz = 0;
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)
          if (q < C) zz += v[q];
        cut.kth_p = descend<true, true>(cluster, sh, xs, es, n, cut,
                                        mass_need(top_p, zz), par, C);
      }
    }

    // ---- the outputs from the staged slice
    if (o != nullptr) {
      if (vec) {
        for (int j = tid; j < n / 4; j += kThreads) {
          const float4 a = reinterpret_cast<const float4*>(xs)[j];
          reinterpret_cast<float4*>(o)[j] =
              make_float4(cut.after_p(a.x), cut.after_p(a.y),
                          cut.after_p(a.z), cut.after_p(a.w));
        }
      } else {
        for (int i = tid; i < n; i += kThreads) o[i] = cut.after_p(xs[i]);
      }
    }
    if (out_tokens != nullptr) {
      for (int i = tid; i < n; i += kThreads) {   // ascending: first index
        float y = cut.after_p(xs[i]);
        if (stage_g) y += gs[i];
        take_best(best, best_i, y, beg + i);
      }
    }
  }

  // ---- the draw: each block's (max, first index) into rank 0, then rank
  // 0 merges them in rank order. The barrier also keeps every block's
  // shared memory alive until the cluster has read it.
  if (out_tokens != nullptr) {
    warp_best(best, best_i);
    if (lane == 0) { sh.red_f[warp] = best; sh.red_i[warp] = best_i; }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w)
        take_best(best, best_i, sh.red_f[w], sh.red_i[w]);
      cluster.map_shared_rank(&sh.best[0], 0)[rank] = best;
      cluster.map_shared_rank(&sh.best_i[0], 0)[rank] = best_i;
    }
  }
  cluster_sync(C);
  if (out_tokens != nullptr && rank == 0 && tid == 0) {
    best = sh.best[0];
    best_i = sh.best_i[0];
    for (int q = 1; q < C; ++q)
      take_best(best, best_i, sh.best[q], sh.best_i[q]);
    out_tokens[row] = best_i;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Kernel attributes, set once per device: the dynamic shared memory a
// filtering block may take and clusters above the portable 8 blocks.
template <typename Kernel>
cudaError_t prepare(Kernel kern, int dev, unsigned* ready) {
  const unsigned bit = 1u << (dev & 31);
  if (*ready & bit) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  *ready |= bit;
  return cudaSuccess;
}

}  // namespace

// top_k <= 0 or >= V: no top-k cut; top_p outside (0, 1): no top-p cut.
// Either output pointer may be null. Returns a cudaError_t (0 on success):
// cudaErrorInvalidValue when a filtering call's row does not fit the
// shared memory of 16 blocks (V beyond 262144 with a gumbel row and
// top-p, 393216 with one of them, 786432 with neither).
extern "C" int dstorch_sampling(const float* logits, const float* gumbel,
                                float* out_logits, int* out_tokens, int b,
                                int V, int top_k, float top_p, void* stream) {
  if (b < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const bool has_k = top_k > 0 && top_k < V;
  const bool has_p = top_p > 0.f && top_p < 1.f;
  const bool filter = has_k || has_p;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // b * C near the SM count; at least kMinSlice entries a block; a
  // filtering block's slices within kStageBytes
  int C = kMaxCluster;
  while (C > 1 && (long long)b * C > sms) C >>= 1;
  while (C > 1 && (long long)C * kMinSlice > V) C >>= 1;
  const int per = 4 * (1 + (has_p ? 1 : 0)
                       + (gumbel != nullptr && out_tokens != nullptr ? 1 : 0));
  auto slice = [V](int c) { return ((V + c - 1) / c + 3) / 4 * 4; };
  if (filter)
    while (C < kMaxCluster && (long long)slice(C) * per > kStageBytes) C <<= 1;
  const int S = slice(C);
  if (filter && (long long)S * per > kStageBytes)
    return (int)cudaErrorInvalidValue;
  const int vec = V % 4 == 0 && aligned16(logits)
                  && (gumbel == nullptr || aligned16(gumbel))
                  && (out_logits == nullptr || aligned16(out_logits));

  static unsigned ready[2] = {0, 0};   // devices prepared, per kernel
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C * (unsigned)b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = filter ? (size_t)S * per : 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (filter) {
    e = prepare(sampling_kernel<true>, dev, &ready[1]);
    if (e != cudaSuccess) return (int)e;
    e = cudaLaunchKernelEx(&cfg, sampling_kernel<true>, logits, gumbel,
                           out_logits, out_tokens, V, S, top_k, top_p, vec);
  } else {
    e = prepare(sampling_kernel<false>, dev, &ready[0]);
    if (e != cudaSuccess) return (int)e;
    e = cudaLaunchKernelEx(&cfg, sampling_kernel<false>, logits, gumbel,
                           out_logits, out_tokens, V, S, top_k, top_p, vec);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
