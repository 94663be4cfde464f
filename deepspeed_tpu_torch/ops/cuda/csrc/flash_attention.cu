// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   * flash_fwd_*     <- `_fwd_kernel`     (B1)
//   * flash_bwd_dq_*  <- `_bwd_dq_kernel`  (B1b)
//   * flash_bwd_dkv_* <- `_bwd_dkv_kernel` (B1b)
// They compute what the TPU kernels compute, accumulating in f32:
//   s = q k^T * scale (causal: keys after the query are masked)
//   out = softmax(s) v, lse = m + log(l)   (l == 0 -> out 0, lse = m: l_safe)
//   p = exp(s - lse), dp = dO v^T, ds = p (dp - delta) * scale
//   dq = ds k,  dk = ds^T q,  dv = p^T dO      (delta = rowsum(dO * out))
// q/k/v/dO are read as [B, S, H, D] with the strides the caller gives
// (channels contiguous), so the fused qkv projection's views need no copy;
// out/dq/dk/dv are written contiguous [B, S, H, D], lse and delta are
// [B, H, S] f32. Any S >= 1.
//
// Bound: at the training shape (S=1024, D=64, causal, bf16) attention does
// 250-340 flops per byte it must move, around the card's bf16 balance
// (~295): bytes bound the forward, the products the two backward kernels.
// Only wgmma reaches the tensor cores' rate, and only if the tiles arrive
// without the threads' help. Two families:
//
//   * bf16 / fp16 (the training path), d in {32, 64, 96, 128): wgmma
//     kernels fed by TMA. A block has two consumer warpgroups of 64 rows
//     each (wgmma's m64) and a producer warpgroup, one warp of which
//     works; setmaxnreg moves its registers to the consumers (240 a
//     thread). The producer loads the block's resident tiles once and
//     keeps a 3-stage ring of the walked tiles in flight, each stage
//     guarded by a full and an empty mbarrier; the consumers never stage
//     anything themselves. Each consumer warpgroup is software pipelined:
//     the products of tile i run on the tensor cores with the last
//     products of tile i - 1, and the exponentials of tile i run while
//     the latter do.
//       - forward: 128 query rows per block (Q resident), walking key tiles
//         of kN keys (128 for d <= 64, else 64: registers) through the
//         ring of K and V. S = Q K^T (both operands in shared memory,
//         K-major), the online softmax on the accumulators in registers
//         with exp2 and scale * log2(e) folded into the scores, P rounded
//         to the input type in registers as the A operand of O += P V (V
//         read MN-major, the transpose flag: the m64 accumulator layout is
//         the A fragment layout). Tile i's S runs with tile i - 1's P V.
//         Only tiles that cross the diagonal or S are masked.
//       - dq: 128 query rows (Q, dO resident), key tiles of 64: S = Q K^T
//         and dP = dO V^T from shared memory, dS / scale = P (dP - delta)
//         in registers, dQ += dS K (the scale applied once, at the store).
//       - dk/dv: 128 keys (K, V resident), query tiles of 64 (32 for
//         d >= 96: registers) through a ring of Q, dO and the tile's lse and
//         delta (which a producer warp copies, lse pre-scaled by log2(e),
//         +inf past S so those queries get p = 0 unmasked). S^T = K Q^T and
//         dP^T = V dO^T from shared memory, P^T and dS^T / scale in
//         registers as the A operands of dV += P^T dO and dK += dS^T Q.
//     Tiles live in shared memory as 32-column panels of 64-byte rows with
//     the 64-byte swizzle, which TMA writes and the wgmma descriptors read,
//     so every d is a whole number of panels (one TMA box per panel; a
//     128-byte swizzle would split d = 96 into unequal boxes). The tensor
//     maps are 4-D over (d, H, S, B) with the caller's strides: the rows
//     of a ragged tail past S arrive as zeros, never from the next batch
//     row. They are encoded per call on the host (cuTensorMapEncodeTiled,
//     fetched with cudaGetDriverEntryPoint: no -lcuda) and passed as
//     __grid_constant__ parameters. The backward keeps the reference's two
//     passes: no atomics, so the gradients are bitwise reproducible. p and
//     ds are rounded to the input type for the products (the TPU kernels
//     keep them f32; the tests bound the difference).
//   * f32: CUDA-core FMAs (exact f32 products, so they agree with the plain
//     version to summation order). A row is owned by neighbouring threads
//     (attention_tiles.cuh's row splits), each holding a share of its
//     channels in registers; K/V (or Q/dO) tiles of 64 rows are staged as
//     f32; partial dots are summed with shuffles. f32 is on no main path.
// All kernels skip causal tiles above the diagonal and launch the longest
// causal tiles first.
//
// Plain C interface (no PyTorch headers), bound with ctypes by
// deepspeed_tpu_torch/ops/cuda/flash_attention.py.

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

// ===========================================================================
// bf16 / fp16: wgmma kernels
// ===========================================================================
template <int D>
struct FwdTile {
  static constexpr int kM = 128;                   // query rows per block
  static constexpr int kN = D <= 64 ? 128 : 64;    // keys per tile
  static constexpr int kStages = 3;
  static constexpr int kQ = kM * D * 2;            // bytes of the Q tile
  static constexpr int kKV = kN * D * 2;           // bytes of a K (V) tile
  static constexpr size_t kSmem = hopper_smem(kQ, 2 * kKV, kStages);
};

// The online softmax of one key tile's scores s (this thread's values of
// its two rows), in place: s becomes p = 2^(s c2 - m) in f32, m (log2
// units) and the thread's partial l are updated, corr is the factor the
// running output takes. One FFMA and one exp2 a score: the row max is
// taken over the raw scores (over -s when c2 < 0, kPos false) and scaled
// once. kEdge: the tile crosses S or (causal) the diagonal, and keys past
// S or after the row are masked; the other tiles take a path without the
// mask's instructions.
template <int kN, bool kCausal, bool kEdge, bool kPos>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l,
                                             float* corr, float c2, int k0,
                                             const int* row, int S,
                                             int lane) {
  const auto masked = [&](int e) {
    const int key = k0 + acc_col(lane, e);
    return key >= S || (kCausal && key > row[(e >> 1) & 1]);
  };
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) {
    const float x = kEdge && masked(e) ? -INFINITY : kPos ? s[e] : -s[e];
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // a row masked in the whole tile: -inf * |c2| (NaN at c2 = 0) loses
    // to m in fmaxf
    const float m_new = fmaxf(m[r], quad_max(mx[r]) * (kPos ? c2 : -c2));
    corr[r] = exp2_fast(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) {
    float p = exp2_fast(fmaf(s[e], c2, -m[(e >> 1) & 1]));
    if (kEdge && masked(e)) p = 0.f;
    s[e] = p;
    l[(e >> 1) & 1] += p;
  }
}

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       T* __restrict__ out, float* __restrict__ lse, int B,
                       int S, int H, float scale) {
  using C = FwdTile<D>;
  constexpr int kM = C::kM, kN = C::kN, kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  T* qbuf = reinterpret_cast<T*>(base);                // [2][kM rows]
  unsigned char* ring = base + 2 * C::kQ;             // stage: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * C::kKV);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;                  // [2]
  uint64_t* qempty = qfull + 2;                       // [2]
  // Persistent: each block takes one work tile a round (snake) from the
  // (128-row tile, head, batch row) list, whose longest causal tiles come
  // first. The ring's slot counter runs on across work tiles.
  const int nt = (S + kM - 1) / kM;
  const int n_items = nt * H * B;
  const auto item = [&](int w, int& q0, int& h, int& b) {
    const int hb = w % (H * B);
    q0 = (nt - 1 - w / (H * B)) * kM;
    h = hb % H;
    b = hb / H;
    return ((kCausal ? min(S, q0 + kM) : S) + kN - 1) / kN;   // key tiles
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], kConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {
      bar_init(&qfull[i], 1);
      bar_init(&qempty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {                       // the producer
    regs_down<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      int g = 0;                                      // ring slot counter
      for (int j = 0; j * (int)gridDim.x < n_items; ++j) {
        const int w = snake(j);
        if (w >= n_items) break;                // a short last round
        int q0, h, b;
        const int n_kt = item(w, q0, h, b);
        if (j >= 2) bar_wait(&qempty[j & 1], ((j >> 1) & 1) ^ 1);
        bar_expect(&qfull[j & 1], C::kQ);
        tma_tile<D, kM>(qbuf + (j & 1) * kM * D, &tq, &qfull[j & 1], h, q0,
                        b);
        for (int i = 0; i < n_kt; ++i, ++g) {
          const int st = g % kStages;
          if (g >= kStages) bar_wait(&empty[st], ((g / kStages) & 1) ^ 1);
          unsigned char* kv = ring + st * 2 * C::kKV;
          bar_expect(&full[st], 2 * C::kKV);
          tma_tile<D, kN>(kv, &tk, &full[st], h, i * kN, b);
          tma_tile<D, kN>(kv + C::kKV, &tv, &full[st], h, i * kN, b);
        }
      }
    }
    return;
  }

  // Each warpgroup walks the key tiles it sees, [0, n_wg), software
  // pipelined: while the tensor cores run tile i's S = Q K^T and tile
  // i - 1's O += P V, the warpgroup's threads wait only for S and then run
  // tile i's softmax; tiles of the work tile past n_wg are only released.
  regs_up<kConsumerRegs>();
  const int wg = warp >> 2;
  const float c2 = scale * kLog2e;
  const auto slot_wait = [&](int g) {
    bar_wait(&full[g % kStages], (g / kStages) & 1);
  };
  const auto release = [&](int g) {
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[g % kStages]);
  };
  const auto k_tile = [&](int g) {
    return reinterpret_cast<const T*>(ring + (g % kStages) * 2 * C::kKV);
  };
  const auto v_tile = [&](int g) { return k_tile(g) + kN * D; };
  float o[D / 2], s[kN / 2], corr[2], m[2], l[2];
  uint32_t pa[kN / 16][4];
  int g = 0;
#pragma unroll 1
  for (int j = 0; j * (int)gridDim.x < n_items; ++j) {
    const int w = snake(j);
    if (w >= n_items) break;                // a short last round
    int q0, h, b;
    const int n_kt = item(w, q0, h, b);
    const int r0 = q0 + wg * 64;                      // the warpgroup's rows
    const int w16 = r0 + (warp & 3) * 16;
    const int row[2] = {w16 + (lane >> 2), w16 + (lane >> 2) + 8};
    const int n_wg = kCausal ? min(n_kt, (r0 + 63) / kN + 1) : n_kt;
    const T* qs = qbuf + (j & 1) * kM * D;
    const auto softmax = [&](int i) {
      const int k0 = i * kN;
      const bool edge = k0 + kN > S || (kCausal && k0 + kN - 1 > r0);
      const auto go = [&](auto e, auto pos) {
        softmax_tile<kN, kCausal, decltype(e)::value, decltype(pos)::value>(
            s, m, l, corr, c2, k0, row, S, lane);
      };
      if (c2 >= 0.f) {
        if (edge) go(std::true_type{}, std::true_type{});
        else go(std::false_type{}, std::true_type{});
      } else {
        if (edge) go(std::true_type{}, std::false_type{});
        else go(std::false_type{}, std::false_type{});
      }
    };
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    m[0] = m[1] = kNegInf;                            // log2 units
    l[0] = l[1] = 0.f;
    bar_wait(&qfull[j & 1], (j >> 1) & 1);

    slot_wait(g);
    fence_regs<D / 2>(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<T, kN>::ss(s, desc_k<kM>(qs, wg * 64, kk),
                       desc_k<kN>(k_tile(g), 0, kk), kk);
    wg_commit();
    wg_wait();
    fence_regs<kN / 2>(s);
    softmax(0);
    to_a<T, kN>(pa, s);
#pragma unroll 1
    for (int i = 1; i < n_wg; ++i) {
      slot_wait(g + i);
      fence_regs<D / 2>(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, kN>::ss(s, desc_k<kM>(qs, wg * 64, kk),
                         desc_k<kN>(k_tile(g + i), 0, kk), kk);
      wg_commit();
#pragma unroll
      for (int jj = 0; jj < kN / 16; ++jj)
        Wgmma<T, D>::rs(o, pa[jj], desc_mn<kN>(v_tile(g + i - 1), jj), 1);
      wg_commit();
      wg_wait<1>();                                   // S of tile i
      fence_regs<kN / 2>(s);
      softmax(i);
      wg_wait<0>();                                   // P V of tile i - 1
      fence_regs<D / 2>(o);
      release(g + i - 1);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e >> 1) & 1];
      to_a<T, kN>(pa, s);
    }
    fence_regs<D / 2>(o);
    wg_fence();
#pragma unroll
    for (int jj = 0; jj < kN / 16; ++jj)
      Wgmma<T, D>::rs(o, pa[jj], desc_mn<kN>(v_tile(g + n_wg - 1), jj), 1);
    wg_commit();
    wg_wait();
    fence_regs<D / 2>(o);
    release(g + n_wg - 1);
    __syncwarp();
    if (lane == 0) bar_arrive(&qempty[j & 1]);   // the last read of Q
    for (int i = n_wg; i < n_kt; ++i) {      // tiles after all its rows
      slot_wait(g + i);
      release(g + i);
    }
    g += n_kt;

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = quad_sum(l[r]);
      const float l_safe = lr == 0.f ? 1.f : lr;
      inv[r] = 1.f / l_safe;
      if ((lane & 3) == 0 && row[r] < S)
        lse[((long long)b * H + h) * S + row[r]] = m[r] * kLn2 + logf(l_safe);
    }
    store_acc<T, D>(out, o, b, row, h, S, H, inv, lane);
  }
}

template <int D>
struct DqTile {
  static constexpr int kM = 128;                   // query rows per block
  static constexpr int kN = 64;                    // keys per tile
  static constexpr int kQ = kM * D * 2;            // bytes of Q (and dO)
  static constexpr int kKV = kN * D * 2;           // bytes of a K (V) tile
  static constexpr int kStages = 3;
  static constexpr size_t kSmem = hopper_smem(2 * kQ, 2 * kKV, kStages);
};

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dq, int B, int S, int H,
                          float scale) {
  using C = DqTile<D>;
  constexpr int kM = C::kM, kN = C::kN, kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  T* qbuf = reinterpret_cast<T*>(base);        // [2][Q, dO] of kM rows
  unsigned char* ring = base + 4 * C::kQ;             // stage: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * C::kKV);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;                  // [2]
  uint64_t* qempty = qfull + 2;                       // [2]
  // persistent over (128-row tile, head, batch row), as the forward
  const int nt = (S + kM - 1) / kM;
  const int n_items = nt * H * B;
  const auto item = [&](int w, int& q0, int& h, int& b) {
    const int hb = w % (H * B);
    q0 = (nt - 1 - w / (H * B)) * kM;
    h = hb % H;
    b = hb / H;
    return ((kCausal ? min(S, q0 + kM) : S) + kN - 1) / kN;   // key tiles
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], kConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {
      bar_init(&qfull[i], 1);
      bar_init(&qempty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {                       // the producer
    regs_down<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      int g = 0;
      for (int j = 0; j * (int)gridDim.x < n_items; ++j) {
        const int w = snake(j);
        if (w >= n_items) break;                // a short last round
        int q0, h, b;
        const int n_kt = item(w, q0, h, b);
        T* qs = qbuf + (j & 1) * 2 * kM * D;
        if (j >= 2) bar_wait(&qempty[j & 1], ((j >> 1) & 1) ^ 1);
        bar_expect(&qfull[j & 1], 2 * C::kQ);
        tma_tile<D, kM>(qs, &tq, &qfull[j & 1], h, q0, b);
        tma_tile<D, kM>(qs + kM * D, &tdo, &qfull[j & 1], h, q0, b);
        for (int i = 0; i < n_kt; ++i, ++g) {
          const int st = g % kStages;
          if (g >= kStages) bar_wait(&empty[st], ((g / kStages) & 1) ^ 1);
          unsigned char* kv = ring + st * 2 * C::kKV;
          bar_expect(&full[st], 2 * C::kKV);
          tma_tile<D, kN>(kv, &tk, &full[st], h, i * kN, b);
          tma_tile<D, kN>(kv + C::kKV, &tv, &full[st], h, i * kN, b);
        }
      }
    }
    return;
  }

  // Pipelined as the forward: tile i's S and dP run with tile i - 1's
  // dQ += dS K, and tile i's dS is computed while dQ runs.
  regs_up<kConsumerRegs>();
  const int wg = warp >> 2;
  const float c2 = scale * kLog2e;
  const auto slot_wait = [&](int g) {
    bar_wait(&full[g % kStages], (g / kStages) & 1);
  };
  const auto release = [&](int g) {
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[g % kStages]);
  };
  const auto k_tile = [&](int g) {
    return reinterpret_cast<const T*>(ring + (g % kStages) * 2 * C::kKV);
  };
  float s[kN / 2], dp[kN / 2], acc[D / 2];
  uint32_t da[kN / 16][4];
  int g = 0;
#pragma unroll 1
  for (int j = 0; j * (int)gridDim.x < n_items; ++j) {
    const int w = snake(j);
    if (w >= n_items) break;                // a short last round
    int q0, h, b;
    const int n_kt = item(w, q0, h, b);
    const int r0 = q0 + wg * 64;
    const int w16 = r0 + (warp & 3) * 16;
    const int row[2] = {w16 + (lane >> 2), w16 + (lane >> 2) + 8};
    const int n_wg = kCausal ? min(n_kt, (r0 + 63) / kN + 1) : n_kt;
    const T* qs = qbuf + (j & 1) * 2 * kM * D;
    const T* dos = qs + kM * D;
    float L[2], dl[2];    // lse in log2 units (+inf past S: p = 0), delta
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long at = ((long long)b * H + h) * S + row[r];
      L[r] = row[r] < S ? lse[at] * kLog2e : INFINITY;
      dl[r] = row[r] < S ? delta[at] : 0.f;
    }
    // S and dP of a ring slot (one commit group)
    const auto scores = [&](int slot) {
      const T* ks = k_tile(slot);
      const T* vs = ks + kN * D;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, kN>::ss(s, desc_k<kM>(qs, wg * 64, kk),
                         desc_k<kN>(ks, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, kN>::ss(dp, desc_k<kM>(dos, wg * 64, kk),
                         desc_k<kN>(vs, 0, kk), kk);
      wg_commit();
    };
    // dS of key tile i into s; keys past S need no mask: their K rows
    // arrive as zeros, so their dS times K adds nothing. Only a tile across
    // the diagonal takes the causal mask's instructions.
    const auto grad_scores = [&](int i) {
      const int k0 = i * kN;
      const auto body = [&](auto diag) {
#pragma unroll
        for (int e = 0; e < kN / 2; ++e) {
          const int r = (e >> 1) & 1;
          float p = exp2_fast(fmaf(s[e], c2, -L[r]));
          if constexpr (decltype(diag)::value)
            if (k0 + acc_col(lane, e) > row[r]) p = 0.f;
          s[e] = p * (dp[e] - dl[r]);            // dS / scale
        }
      };
      if (kCausal && k0 + kN - 1 > r0) body(std::true_type{});
      else body(std::false_type{});
    };
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    bar_wait(&qfull[j & 1], (j >> 1) & 1);

    slot_wait(g);
    fence_regs<D / 2>(acc);
    wg_fence();
    scores(g);
    wg_wait();
    fence_regs<kN / 2>(s);
    fence_regs<kN / 2>(dp);
    grad_scores(0);
    to_a<T, kN>(da, s);
#pragma unroll 1
    for (int i = 1; i < n_wg; ++i) {
      slot_wait(g + i);
      fence_regs<D / 2>(acc);
      wg_fence();
      scores(g + i);
#pragma unroll
      for (int jj = 0; jj < kN / 16; ++jj)
        Wgmma<T, D>::rs(acc, da[jj], desc_mn<kN>(k_tile(g + i - 1), jj), 1);
      wg_commit();
      wg_wait<1>();
      fence_regs<kN / 2>(s);
      fence_regs<kN / 2>(dp);
      grad_scores(i);
      wg_wait<0>();
      fence_regs<D / 2>(acc);
      release(g + i - 1);
      to_a<T, kN>(da, s);
    }
    fence_regs<D / 2>(acc);
    wg_fence();
#pragma unroll
    for (int jj = 0; jj < kN / 16; ++jj)
      Wgmma<T, D>::rs(acc, da[jj], desc_mn<kN>(k_tile(g + n_wg - 1), jj), 1);
    wg_commit();
    wg_wait();
    fence_regs<D / 2>(acc);
    release(g + n_wg - 1);
    __syncwarp();
    if (lane == 0) bar_arrive(&qempty[j & 1]);   // the last read of Q, dO
    for (int i = n_wg; i < n_kt; ++i) {    // tiles after all its rows
      slot_wait(g + i);
      release(g + i);
    }
    g += n_kt;
    const float sc[2] = {scale, scale};   // dS carried the scale out
    store_acc<T, D>(dq, acc, b, row, h, S, H, sc, lane);
  }
}

template <int D>
struct DkvTile {
  static constexpr int kN = 128;                   // keys per block
  static constexpr int kM = D <= 64 ? 64 : 32;     // queries per tile
  static constexpr int kKV = kN * D * 2;           // bytes of K (and V)
  static constexpr int kQ = kM * D * 2;            // bytes of a Q (dO) tile
  // a stage: Q, dO, then the tile's lse (log2 units) and delta, rounded
  // up so that every stage's tiles start 1024-aligned
  static constexpr int kStage = (2 * kQ + 2 * kM * 4 + 1023) / 1024 * 1024;
  static constexpr int kStages = 3;
  static constexpr size_t kSmem = hopper_smem(2 * kKV, kStage, kStages);
};

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, int B,
                           int S, int H, float scale) {
  using C = DkvTile<D>;
  constexpr int kM = C::kM, kN = C::kN, kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  T* kvbuf = reinterpret_cast<T*>(base);       // [2][K, V] of kN rows
  unsigned char* ring = base + 4 * C::kKV;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * C::kStage);
  uint64_t* empty = full + kStages;
  uint64_t* kvfull = empty + kStages;                 // [2]
  uint64_t* kvempty = kvfull + 2;                     // [2]
  // persistent over (128-key tile, head, batch row), the key tiles with
  // the most causal query tiles first
  const int n_kt = (S + kN - 1) / kN;
  const int n_items = n_kt * H * B;
  const int nq = (S + kM - 1) / kM;
  const auto item = [&](int w, int& k0, int& qt0, int& h, int& b) {
    const int hb = w % (H * B);
    k0 = w / (H * B) * kN;
    qt0 = kCausal ? k0 / kM : 0;              // tiles below the diagonal
    h = hb % H;
    b = hb / H;
    return nq - qt0;                          // query tiles
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      bar_init(&full[i], 32);                 // every producer lane
      bar_init(&empty[i], kConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {
      bar_init(&kvfull[i], 1);
      bar_init(&kvempty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {                       // the producer
    regs_down<kProducerRegs>();
    if (warp > kConsumerWarps) return;
    int g = 0;
    for (int j = 0; j * (int)gridDim.x < n_items; ++j) {
      const int w = snake(j);
      if (w >= n_items) break;                // a short last round
      int k0, qt0, h, b;
      const int n_qt = item(w, k0, qt0, h, b);
      const long long stat0 = ((long long)b * H + h) * S;
      if (lane == 0) {
        T* ks = kvbuf + (j & 1) * 2 * kN * D;
        if (j >= 2) bar_wait(&kvempty[j & 1], ((j >> 1) & 1) ^ 1);
        bar_expect(&kvfull[j & 1], 2 * C::kKV);
        tma_tile<D, kN>(ks, &tk, &kvfull[j & 1], h, k0, b);
        tma_tile<D, kN>(ks + kN * D, &tv, &kvfull[j & 1], h, k0, b);
      }
      for (int i = 0; i < n_qt; ++i, ++g) {
        const int st = g % kStages, q0 = (qt0 + i) * kM;
        if (g >= kStages) bar_wait(&empty[st], ((g / kStages) & 1) ^ 1);
        unsigned char* stage = ring + st * C::kStage;
        float* ls = reinterpret_cast<float*>(stage + 2 * C::kQ);
        for (int r = lane; r < kM; r += 32) {
          const bool in = q0 + r < S;
          ls[r] = in ? lse[stat0 + q0 + r] * kLog2e : INFINITY;
          ls[kM + r] = in ? delta[stat0 + q0 + r] : 0.f;
        }
        if (lane == 0) {
          bar_expect(&full[st], 2 * C::kQ);
          tma_tile<D, kM>(stage, &tq, &full[st], h, q0, b);
          tma_tile<D, kM>(stage + C::kQ, &tdo, &full[st], h, q0, b);
        } else {
          bar_arrive(&full[st]);
        }
      }
    }
    return;
  }

  // Each warpgroup walks the query tiles that see its keys, [first, n_qt)
  // (causal: the tiles before are only released), pipelined as the
  // forward: tile i's S^T and dP^T run with tile i - 1's dV += P^T dO and
  // dK += dS^T Q, and tile i's P and dS are computed meanwhile.
  regs_up<kConsumerRegs>();
  const int wg = warp >> 2;
  const float c2 = scale * kLog2e;
  const auto stage_of = [&](int g) { return ring + (g % kStages) * C::kStage; };
  const auto slot_wait = [&](int g) {
    bar_wait(&full[g % kStages], (g / kStages) & 1);
  };
  const auto release = [&](int g) {
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[g % kStages]);
  };
  float p[kM / 2], ds[kM / 2], dka[D / 2], dva[D / 2];
  uint32_t pa[kM / 16][4], da[kM / 16][4];
  int g = 0;
#pragma unroll 1
  for (int j = 0; j * (int)gridDim.x < n_items; ++j) {
    const int w = snake(j);
    if (w >= n_items) break;                // a short last round
    int k0, qt0, h, b;
    const int n_qt = item(w, k0, qt0, h, b);
    const int r0 = k0 + wg * 64;                      // the warpgroup's keys
    const int w16 = r0 + (warp & 3) * 16;
    const int krow[2] = {w16 + (lane >> 2), w16 + (lane >> 2) + 8};
    const int first = kCausal ? min(n_qt, r0 / kM - qt0) : 0;
    const T* ks = kvbuf + (j & 1) * 2 * kN * D;
    const T* vs = ks + kN * D;
    // transposed scores of a ring slot: rows are the warpgroup's keys,
    // columns the tile's queries (one commit group)
    const auto scores = [&](int slot) {
      const T* qs = reinterpret_cast<const T*>(stage_of(slot));
      const T* dos = qs + kM * D;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, kM>::ss(p, desc_k<kN>(ks, wg * 64, kk),
                         desc_k<kM>(qs, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, kM>::ss(ds, desc_k<kN>(vs, wg * 64, kk),
                         desc_k<kM>(dos, 0, kk), kk);
      wg_commit();
    };
    // P and dS / scale of query tile i (ring slot `slot`)
    const auto grad_scores = [&](int i, int slot) {
      const int q0 = (qt0 + i) * kM;
      const float* ls =
          reinterpret_cast<const float*>(stage_of(slot) + 2 * C::kQ);
      const auto body = [&](auto diag) {
#pragma unroll
        for (int e = 0; e < kM / 2; ++e) {
          const int c = acc_col(lane, e);
          float x = exp2_fast(fmaf(p[e], c2, -ls[c]));  // +inf past S: 0
          if constexpr (decltype(diag)::value)
            if (q0 + c < krow[(e >> 1) & 1]) x = 0.f;
          p[e] = x;
          ds[e] = x * (ds[e] - ls[kM + c]);     // dS / scale
        }
      };
      if (kCausal && q0 < r0 + 63) body(std::true_type{});
      else body(std::false_type{});
    };
    // dV += P^T dO and dK += dS^T Q of a ring slot (one commit group)
    const auto grads = [&](int slot) {
      const T* qs = reinterpret_cast<const T*>(stage_of(slot));
      const T* dos = qs + kM * D;
#pragma unroll
      for (int jj = 0; jj < kM / 16; ++jj)
        Wgmma<T, D>::rs(dva, pa[jj], desc_mn<kM>(dos, jj), 1);
#pragma unroll
      for (int jj = 0; jj < kM / 16; ++jj)
        Wgmma<T, D>::rs(dka, da[jj], desc_mn<kM>(qs, jj), 1);
      wg_commit();
    };
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dka[e] = dva[e] = 0.f;
    bar_wait(&kvfull[j & 1], (j >> 1) & 1);

    for (int i = 0; i < first; ++i) {      // tiles before all its keys
      slot_wait(g + i);
      release(g + i);
    }
    if (first < n_qt) {
      slot_wait(g + first);
      fence_regs<D / 2>(dva);
      fence_regs<D / 2>(dka);
      wg_fence();
      scores(g + first);
      wg_wait();
      fence_regs<kM / 2>(p);
      fence_regs<kM / 2>(ds);
      grad_scores(first, g + first);
      to_a<T, kM>(pa, p);
      to_a<T, kM>(da, ds);
#pragma unroll 1
      for (int i = first + 1; i < n_qt; ++i) {
        slot_wait(g + i);
        fence_regs<D / 2>(dva);
        fence_regs<D / 2>(dka);
        wg_fence();
        scores(g + i);
        grads(g + i - 1);
        wg_wait<1>();
        fence_regs<kM / 2>(p);
        fence_regs<kM / 2>(ds);
        grad_scores(i, g + i);
        wg_wait<0>();
        fence_regs<D / 2>(dva);
        fence_regs<D / 2>(dka);
        release(g + i - 1);
        to_a<T, kM>(pa, p);
        to_a<T, kM>(da, ds);
      }
      fence_regs<D / 2>(dva);
      fence_regs<D / 2>(dka);
      wg_fence();
      grads(g + n_qt - 1);
      wg_wait();
      fence_regs<D / 2>(dva);
      fence_regs<D / 2>(dka);
      release(g + n_qt - 1);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&kvempty[j & 1]);  // the last read of K, V
    g += n_qt;
    const float one[2] = {1.f, 1.f}, sc[2] = {scale, scale};
    store_acc<T, D>(dk, dka, b, krow, h, S, H, sc, lane);   // dS / scale
    store_acc<T, D>(dv, dva, b, krow, h, S, H, one, lane);
  }
}

// ===========================================================================
// f32: CUDA-core FMAs
// ===========================================================================
// Forward: one block per (query tile, head, batch row); thread = (row, part)
template <int D, bool kCausal>
__global__ void __launch_bounds__(FwdSplit<D>::kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, Strides sq, Strides sk,
                     Strides sv, float* __restrict__ out,
                     float* __restrict__ lse, int S, int H, float scale) {
  using SP = FwdSplit<D>;
  constexpr int TPR = SP::kTpr;
  constexpr int kCh = SP::kCh;
  extern __shared__ float smem[];
  float* ks = smem;                           // [kRows][D]
  float* vs = smem + kRows * D;               // [kRows][D]
  const int nt = (S + kRows - 1) / kRows;
  const int qt = nt - 1 - blockIdx.x;         // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int part = threadIdx.x % TPR;
  const int qi = qt * kRows + threadIdx.x / TPR;

  float qr[kCh], acc[kCh];
  load_row<SP>(q, sq, b, qi, h, S, part, qr);
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = 0.f;
  float m = kNegInf, l = 0.f;

  const int kt_last = kCausal ? qt : nt - 1;  // tiles above the diagonal skip
#pragma unroll 1
  for (int kt = 0; kt <= kt_last; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();
    stage_f32<D>(ks, k, sk, b, h, k0, S);
    stage_f32<D>(vs, v, sv, b, h, k0, S);
    __syncthreads();
    const int n = min(kRows, S - k0);
    const int lim = kCausal ? min(n, qi - k0 + 1) : n;   // keys j < lim seen
#pragma unroll 1
    for (int j0 = 0; j0 < n; j0 += kFwdGroup) {
      float sc[kFwdGroup];
#pragma unroll
      for (int u = 0; u < kFwdGroup; ++u)
        sc[u] = part_dot<SP>(qr, ks + (j0 + u) * D, part);
      row_sum<TPR, kFwdGroup>(sc);
      float gmax = kNegInf;
#pragma unroll
      for (int u = 0; u < kFwdGroup; ++u) {
        sc[u] = (j0 + u < lim) ? sc[u] * scale : kNegInf;
        gmax = fmaxf(gmax, sc[u]);
      }
      const float m_new = fmaxf(m, gmax);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kFwdGroup; ++u) {
        sc[u] = (j0 + u < lim) ? expf(sc[u] - m_new) : 0.f;
        psum += sc[u];
      }
      l = l * corr + psum;
      m = m_new;
#pragma unroll
      for (int c = 0; c < kCh; ++c) acc[c] *= corr;
#pragma unroll
      for (int u = 0; u < kFwdGroup; ++u)
        axpy_row<SP>(acc, sc[u], vs + (j0 + u) * D, part);
    }
  }

  if (qi < S) {
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int c = 0; c < kCh; ++c) acc[c] *= inv;
    store_row<SP>(out, b, qi, h, S, H, part, acc);
    if (part == 0) lse[((long long)b * H + h) * S + qi] = m + logf(l_safe);
  }
}

// dq: one block per (query tile, head, batch row), walking its key tiles
template <int D, bool kCausal>
__global__ void __launch_bounds__(BwdSplit<D>::kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout, Strides sq,
                        Strides sk, Strides sv, Strides sdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int H, float scale) {
  using SP = BwdSplit<D>;
  constexpr int TPR = SP::kTpr;
  constexpr int kCh = SP::kCh;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + kRows * D;
  const int nt = (S + kRows - 1) / kRows;
  const int qt = nt - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int part = threadIdx.x % TPR;
  const int qi = qt * kRows + threadIdx.x / TPR;

  float qr[kCh], dor[kCh], acc[kCh];
  load_row<SP>(q, sq, b, qi, h, S, part, qr);
  load_row<SP>(dout, sdo, b, qi, h, S, part, dor);
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = 0.f;
  const long long stat = ((long long)b * H + h) * S + qi;
  const float L = qi < S ? lse[stat] : 0.f;
  const float dl = qi < S ? delta[stat] : 0.f;

  const int kt_last = kCausal ? qt : nt - 1;
#pragma unroll 1
  for (int kt = 0; kt <= kt_last; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();
    stage_f32<D>(ks, k, sk, b, h, k0, S);
    stage_f32<D>(vs, v, sv, b, h, k0, S);
    __syncthreads();
    const int n = min(kRows, S - k0);
    const int lim = kCausal ? min(n, qi - k0 + 1) : n;
#pragma unroll 1
    for (int j0 = 0; j0 < n; j0 += kBwdGroup) {
      float sc[kBwdGroup], dp[kBwdGroup];
#pragma unroll
      for (int u = 0; u < kBwdGroup; ++u) {
        sc[u] = part_dot<SP>(qr, ks + (j0 + u) * D, part);
        dp[u] = part_dot<SP>(dor, vs + (j0 + u) * D, part);
      }
      row_sum<TPR, kBwdGroup>(sc);
      row_sum<TPR, kBwdGroup>(dp);
#pragma unroll
      for (int u = 0; u < kBwdGroup; ++u) {
        const float p = (j0 + u < lim) ? expf(sc[u] * scale - L) : 0.f;
        axpy_row<SP>(acc, p * (dp[u] - dl) * scale, ks + (j0 + u) * D,
                     part);
      }
    }
  }
  if (qi < S) store_row<SP>(dq, b, qi, h, S, H, part, acc);
}

// dk, dv: one block per (key tile, head, batch row), walking its query tiles
template <int D, bool kCausal>
__global__ void __launch_bounds__(BwdSplit<D>::kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout, Strides sq,
                         Strides sk, Strides sv, Strides sdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int S, int H, float scale) {
  using SP = BwdSplit<D>;
  constexpr int TPR = SP::kTpr;
  constexpr int kCh = SP::kCh;
  extern __shared__ float smem[];
  float* qs = smem;                           // [kRows][D]
  float* dos = smem + kRows * D;              // [kRows][D]
  float* lses = smem + 2 * kRows * D;         // [kRows]
  float* dels = lses + kRows;                 // [kRows]
  const int nt = (S + kRows - 1) / kRows;
  const int kt = blockIdx.x;                  // the longest (causal) first
  const int h = blockIdx.y, b = blockIdx.z;
  const int part = threadIdx.x % TPR;
  const int kj = kt * kRows + threadIdx.x / TPR;

  float kr[kCh], vr[kCh], dkr[kCh], dvr[kCh];
  load_row<SP>(k, sk, b, kj, h, S, part, kr);
  load_row<SP>(v, sv, b, kj, h, S, part, vr);
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    dkr[c] = 0.f;
    dvr[c] = 0.f;
  }
  const long long stat0 = ((long long)b * H + h) * S;

#pragma unroll 1
  for (int qt = kCausal ? kt : 0; qt < nt; ++qt) {   // tiles below the diagonal
    const int q0 = qt * kRows;
    __syncthreads();
    stage_f32<D>(qs, q, sq, b, h, q0, S);
    stage_f32<D>(dos, dout, sdo, b, h, q0, S);
    for (int i = threadIdx.x; i < kRows; i += blockDim.x) {
      const bool in = q0 + i < S;
      lses[i] = in ? lse[stat0 + q0 + i] : 0.f;
      dels[i] = in ? delta[stat0 + q0 + i] : 0.f;
    }
    __syncthreads();
    const int n = min(kRows, S - q0);
    // query rows i >= first see this key (causal); rows past S are masked
    const int first = kCausal ? max(0, kj - q0) : 0;
#pragma unroll 1
    for (int i0 = 0; i0 < n; i0 += kBwdGroup) {
      float sc[kBwdGroup], dp[kBwdGroup];
#pragma unroll
      for (int u = 0; u < kBwdGroup; ++u) {
        sc[u] = part_dot<SP>(kr, qs + (i0 + u) * D, part);
        dp[u] = part_dot<SP>(vr, dos + (i0 + u) * D, part);
      }
      row_sum<TPR, kBwdGroup>(sc);
      row_sum<TPR, kBwdGroup>(dp);
#pragma unroll
      for (int u = 0; u < kBwdGroup; ++u) {
        const int i = i0 + u;
        const bool vis = i < n && i >= first;
        const float p = vis ? expf(sc[u] * scale - lses[i]) : 0.f;
        axpy_row<SP>(dvr, p, dos + i * D, part);
        axpy_row<SP>(dkr, p * (dp[u] - dels[i]) * scale, qs + i * D, part);
      }
    }
  }
  if (kj < S) {
    store_row<SP>(dk, b, kj, h, S, H, part, dkr);
    store_row<SP>(dv, b, kj, h, S, H, part, dvr);
  }
}

// ===========================================================================
// Launch and dispatch
// ===========================================================================

template <typename T, int D, bool C>
struct Fwd {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         void* out, float* lse, const long long* st, int B,
                         int S, int H, float scale, cudaStream_t stream) {
    if constexpr (sizeof(T) == 2) {
      using Tile = FwdTile<D>;
      CUtensorMap m[3];
      const void* ptrs[3] = {q, k, v};
      const int rows[3] = {Tile::kM, Tile::kN, Tile::kN};
      if (!tile_maps<T>(m, ptrs, rows, 3, st, B, S, H, D))
        return cudaErrorInvalidValue;
      const int items = (S + Tile::kM - 1) / Tile::kM * H * B;
      return launch(flash_fwd_wgmma_kernel<T, D, C>,
                    dim3(std::min(items, sm_count())), kHopperThreads,
                    Tile::kSmem, stream, m[0], m[1], m[2], as<T>(out), lse,
                    B, S, H, scale);
    } else {
      return launch(flash_fwd_f32_kernel<D, C>, grid_of(B, S, H),
                    FwdSplit<D>::kThreads, f32_smem<D>(2, 0), stream,
                    as<T>(q), as<T>(k), as<T>(v), strides_at(st, 0),
                    strides_at(st, 1), strides_at(st, 2), as<T>(out), lse, S,
                    H, scale);
    }
  }
};

template <typename T, int D, bool C>
struct Dq {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, const long long* st,
                         int B, int S, int H, float scale,
                         cudaStream_t stream) {
    if constexpr (sizeof(T) == 2) {
      using Tile = DqTile<D>;
      CUtensorMap m[4];
      const void* ptrs[4] = {q, k, v, dout};
      const int rows[4] = {Tile::kM, Tile::kN, Tile::kN, Tile::kM};
      if (!tile_maps<T>(m, ptrs, rows, 4, st, B, S, H, D))
        return cudaErrorInvalidValue;
      const int items = (S + Tile::kM - 1) / Tile::kM * H * B;
      return launch(flash_bwd_dq_wgmma_kernel<T, D, C>,
                    dim3(std::min(items, sm_count())), kHopperThreads,
                    Tile::kSmem, stream, m[0], m[1], m[2], m[3], lse, delta,
                    as<T>(dq), B, S, H, scale);
    } else {
      return launch(flash_bwd_dq_f32_kernel<D, C>, grid_of(B, S, H),
                    BwdSplit<D>::kThreads, f32_smem<D>(2, 0), stream,
                    as<T>(q), as<T>(k), as<T>(v), as<T>(dout),
                    strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
                    strides_at(st, 3), lse, delta, as<T>(dq), S, H, scale);
    }
  }
};

template <typename T, int D, bool C>
struct Dkv {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv,
                         const long long* st, int B, int S, int H,
                         float scale, cudaStream_t stream) {
    if constexpr (sizeof(T) == 2) {
      using Tile = DkvTile<D>;
      CUtensorMap m[4];
      const void* ptrs[4] = {q, k, v, dout};
      const int rows[4] = {Tile::kM, Tile::kN, Tile::kN, Tile::kM};
      if (!tile_maps<T>(m, ptrs, rows, 4, st, B, S, H, D))
        return cudaErrorInvalidValue;
      const int items = (S + Tile::kN - 1) / Tile::kN * H * B;
      return launch(flash_bwd_dkv_wgmma_kernel<T, D, C>,
                    dim3(std::min(items, sm_count())), kHopperThreads,
                    Tile::kSmem, stream, m[0], m[1], m[2], m[3], lse, delta,
                    as<T>(dk), as<T>(dv), B, S, H, scale);
    } else {
      return launch(flash_bwd_dkv_f32_kernel<D, C>, grid_of(B, S, H),
                    BwdSplit<D>::kThreads, f32_smem<D>(2, 2), stream,
                    as<T>(q), as<T>(k), as<T>(v), as<T>(dout),
                    strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
                    strides_at(st, 3), lse, delta, as<T>(dk), as<T>(dv), S,
                    H, scale);
    }
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; d in {32, 64, 96, 128}.
// `strides` is a host array of (batch, seq, head) element strides: q, k, v
// for the forward; q, k, v, dO for the backward (16-bit: each a multiple of
// 8 elements, the pointers 16-byte aligned). Returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for a shape the kernels lack or a tensor
// map that cannot be encoded).
extern "C" int dstorch_flash_fwd(const void* q, const void* k, const void* v,
                                 void* out, float* lse,
                                 const long long* strides, int B, int S,
                                 int H, int d, int causal, float scale,
                                 int dtype, void* stream) {
  if (bad_shape(B, S, H)) return (int)cudaErrorInvalidValue;
  return (int)dispatch<Fwd>(dtype, d, causal, q, k, v, out, lse, strides, B,
                            S, H, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int dstorch_flash_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dq, const long long* strides, int B,
                                    int S, int H, int d, int causal,
                                    float scale, int dtype, void* stream) {
  if (bad_shape(B, S, H)) return (int)cudaErrorInvalidValue;
  return (int)dispatch<Dq>(dtype, d, causal, q, k, v, dout, lse, delta, dq,
                           strides, B, S, H, scale,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int dstorch_flash_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dk, void* dv,
                                     const long long* strides, int B, int S,
                                     int H, int d, int causal, float scale,
                                     int dtype, void* stream) {
  if (bad_shape(B, S, H)) return (int)cudaErrorInvalidValue;
  return (int)dispatch<Dkv>(dtype, d, causal, q, k, v, dout, lse, delta, dk,
                            dv, strides, B, S, H, scale,
                            static_cast<cudaStream_t>(stream));
}
