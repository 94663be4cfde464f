// Block-sparse attention forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas kernels of
// deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py:
//   * sparse_fwd_*     <- `_fwd_kernel`     (B5)
//   * sparse_bwd_dq_*  <- `_bwd_dq_kernel`  (B5b)
//   * sparse_bwd_dkv_* <- `_bwd_dkv_kernel` (B5b)
// They compute what the TPU kernels compute, accumulating in f32. Key j is
// visible to query i when the layout's fine block of (i, j) is live, j < S,
// (causal) j <= i, and (with a key-padding mask) kvm[b, j] > 0:
//   s = q k^T * scale over visible pairs, online softmax from m = -1e30
//   out = softmax(s) v, lse = m + log(l); a dead row (no visible key)
//   writes zeros and lse = -1e30 (flash keeps lse = m there)
//   p = exp(s - lse) where visible and lse > -1e30 / 2 (the dead-row guard),
//   dp = dO v^T, ds = p (dp - delta) * scale
//   dq = ds k,  dk = ds^T q,  dv = p^T dO      (delta = rowsum(dO * out))
//
// The layout arrives compiled at the kernels' 64-row tile (the TPU kernels
// take tiles of up to 128 rows and expand the fine mask with two 0/1
// matmuls; here the host does the expansion once per layout):
//   * the row LUT (forward, dq): for each (head, query tile), the count of
//     live key tiles, their indices and, for each, a 64-bit mask of the live
//     fine blocks inside the tile pair: bit (r >> shift) * (64 >> shift)
//     + (c >> shift) for tile-local query r and key c, 1 << shift =
//     min(layout block, 64). A block of 64 is one bit; 128 spans 2 x 2 tiles;
//   * the column LUT (dk/dv): for each (head, key tile), the live query
//     tiles, with the same masks (still indexed query-major).
// The forward and dq kernels take one block per (query tile, head, batch
// row), walking its row-LUT entries. The dk/dv kernel takes one block per
// work item: at most 16 column-LUT entries of one (head, key tile). A key
// tile with a longer LUT row (BigBird's global key tile is seen by every
// query tile) is split over several items, each writing its f32 partial to
// a workspace slot of its own; the last one to finish (a ticket counter)
// sums the tile's partials in item order and stores the tile, so the
// result does not depend on which block finishes first. Without the split
// that one block walked all 512 query tiles alone and took most of the
// kernel's time at the training shape. A tile with no entry still stores
// its rows (zeros: out of a dead query tile, dk/dv of a key tile no query
// reaches).
//
// Bound: per live 64 x 64 tile pair the forward does 4 * 64 * 4096 flops
// against 2 staged bf16 tiles (16 KB at D = 64): ~64 flops per staged byte,
// under the card's bf16 balance (~295), but the staging mostly hits L2 (a
// key tile is reused by the neighbouring query tiles of its window). Counted
// once, the bytes (q, k, v, out, dO, grads) bound all three kernels at the
// training shape (S = 32768, D = 64, BigBird block 64). Two families, on the
// tile code of attention_tiles.cuh: bf16 and fp16 through mma.sync
// m16n8k16 with p and ds rounded to the input type for the next product;
// f32 through exact CUDA-core FMAs. The mask costs a shared-memory read and
// a bit test per score. The forward and dq kernels do not split long LUT
// rows (a bidirectional layout's global query tile walks every key tile;
// the causal training layout has none).
//
// Plain C interface (no PyTorch headers), bound with ctypes by
// deepspeed_tpu_torch/ops/cuda/sparse_attention.py.

#include "attention_tiles.cuh"

namespace {

// A look-up table of live tiles. Row `at` = head * (tiles per head) + tile
// holds cnt[at] entries: idx[at * len + t] is the other operand's tile and
// bits[at * len + t] the fine-block mask of the tile pair.
struct Lut {
  const int* idx;
  const int* cnt;
  const unsigned long long* bits;
  int len;
  int shift;      // log2(min(layout block, 64))
};

// The dk/dv kernel's work items: items[7 * i ..] = head, key tile, first
// and end column-LUT entry, the key tile's first workspace partial (-1: the
// tile is not split), the item's rank among the tile's items, the tile's
// item count. ws [B, parts, 2, kRows, D] f32 holds one partial per split
// item (written in full before it is read); tickets [B, parts] arrive
// zeroed and count the finished items of a tile at its first partial.
struct Work {
  const int* items;
  float* ws;
  int* tickets;
  int parts;
};

// Writes this block's dk/dv partial (dk at `mine`, dv at mine + kRows * D,
// element (row, col) at row * D + col, given by `at(i)` for the thread's
// i-th value) to its own slot; the last block of the tile to finish sums
// the tile's `items` partials, which start at `first`, in rank order. True
// in that block, whose registers then hold the sums.
template <int D, int N, class At>
__device__ __forceinline__ bool combine(float* first, int rank, int items,
                                        int* ticket, float* dk, float* dv,
                                        At at) {
  constexpr int kPart = 2 * kRows * D;
  __shared__ int last;
  float* mine = first + (long long)rank * kPart;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    __stcg(mine + at(i), dk[i]);
    __stcg(mine + kRows * D + at(i), dv[i]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == items - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
#pragma unroll
  for (int i = 0; i < N; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll 1
  for (int c = 0; c < items; ++c) {
    const float* part = first + (long long)c * kPart;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      dk[i] += __ldcg(part + at(i));
      dv[i] += __ldcg(part + kRows * D + at(i));
    }
  }
  return true;
}

// whether the fine block holding tile-local (query r, key c) is live
__device__ __forceinline__ bool live(unsigned long long bits, int r, int c,
                                     int shift) {
  const int per_row = kRows >> shift;
  return (bits >> ((r >> shift) * per_row + (c >> shift))) & 1ull;
}

// key exists and the key-padding mask (if any) keeps it
__device__ __forceinline__ bool key_kept(const float* kvm, int b, int key,
                                         int S) {
  return key < S && (kvm == nullptr || kvm[(long long)b * S + key] > 0.f);
}

// 1 / 0 flags of keys k0 .. k0+kRows-1 into shared memory
__device__ __forceinline__ void stage_keys(float* ok, const float* kvm, int b,
                                           int k0, int S) {
  for (int i = threadIdx.x; i < kRows; i += blockDim.x)
    ok[i] = key_kept(kvm, b, k0 + i, S) ? 1.f : 0.f;
}

// lse (-1e30 past S: such rows see nothing) and delta of query rows
// q0 .. q0+kRows-1 into shared memory
__device__ __forceinline__ void stage_stats(float* lses, float* dels,
                                            const float* lse,
                                            const float* delta,
                                            long long stat0, int q0, int S) {
  for (int i = threadIdx.x; i < kRows; i += blockDim.x) {
    const bool in = q0 + i < S;
    lses[i] = in ? lse[stat0 + q0 + i] : kNegInf;
    dels[i] = in ? delta[stat0 + q0 + i] : 0.f;
  }
}

// ===========================================================================
// bf16 / fp16: tensor cores (T is the element type)
// ===========================================================================
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
sparse_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, Strides sq, Strides sk,
                     Strides sv, Lut lut, const float* __restrict__ kvm,
                     T* __restrict__ out, float* __restrict__ lse, int S,
                     int H, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kRows * LD;
  T* vs = ks + kRows * LD;
  float* kok = reinterpret_cast<float*>(vs + kRows * LD);     // [kRows]
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * 16;
  const int q0 = qt * kRows;
  const int r[2] = {row0 + (lane >> 2), row0 + (lane >> 2) + 8};
  const long long at = (long long)h * gridDim.x + qt;
  const int cnt = lut.cnt[at];

  stage16<D>(qs, q, sq, b, h, q0, S);
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

#pragma unroll 1
  for (int t = 0; t < cnt; ++t) {
    const int k0 = lut.idx[at * lut.len + t] * kRows;
    const unsigned long long bits = lut.bits[at * lut.len + t];
    __syncthreads();
    stage16<D>(ks, k, sk, b, h, k0, S);
    stage16<D>(vs, v, sv, b, h, k0, S);
    stage_keys(kok, kvm, b, k0, S);
    __syncthreads();
    float s[kRows / 8][4];
    tile_qkt<T, D, kRows / 8>(s, qs, ks, row0, lane);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * (lane & 3) + (e & 1), i = e >> 1;
        const bool seen = kok[c] != 0.f && live(bits, r[i], c, lut.shift)
                          && (!kCausal || k0 + c <= q0 + r[i]);
        s[n][e] = seen ? s[n][e] * scale : -INFINITY;
        mx[i] = fmaxf(mx[i], s[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);  // masked: exp(-inf) = 0
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
    tile_pv<T, D>(o, s, vs, lane);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    inv[i] = 1.f / l_safe;
    if ((lane & 3) == 0 && q0 + r[i] < S)
      lse[((long long)b * H + h) * S + q0 + r[i]] =
          m[i] <= kNegInf / 2 ? kNegInf : m[i] + logf(l_safe);
  }
  store_rows<T, D>(out, o, b, q0 + row0, h, S, H, inv, lane);
}

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
sparse_bwd_dq_tc_kernel(const T* __restrict__ q,
                        const T* __restrict__ k,
                        const T* __restrict__ v,
                        const T* __restrict__ dout, Strides sq,
                        Strides sk, Strides sv, Strides sdo, Lut lut,
                        const float* __restrict__ kvm,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        T* __restrict__ dq, int S, int H, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kRows * LD;
  T* ks = dos + kRows * LD;
  T* vs = ks + kRows * LD;
  float* kok = reinterpret_cast<float*>(vs + kRows * LD);     // [kRows]
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * 16;
  const int q0 = qt * kRows;
  const int r[2] = {row0 + (lane >> 2), row0 + (lane >> 2) + 8};
  const long long at = (long long)h * gridDim.x + qt;
  const int cnt = lut.cnt[at];
  float L[2], dl[2];
  bool alive[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = q0 + r[i] < S;
    const long long st = ((long long)b * H + h) * S + q0 + r[i];
    L[i] = in ? lse[st] : kNegInf;
    dl[i] = in ? delta[st] : 0.f;
    alive[i] = L[i] > kNegInf / 2;
  }

  stage16<D>(qs, q, sq, b, h, q0, S);
  stage16<D>(dos, dout, sdo, b, h, q0, S);
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

#pragma unroll 1
  for (int t = 0; t < cnt; ++t) {
    const int k0 = lut.idx[at * lut.len + t] * kRows;
    const unsigned long long bits = lut.bits[at * lut.len + t];
    __syncthreads();
    stage16<D>(ks, k, sk, b, h, k0, S);
    stage16<D>(vs, v, sv, b, h, k0, S);
    stage_keys(kok, kvm, b, k0, S);
    __syncthreads();
    float s[kRows / 8][4], dp[kRows / 8][4];
    tile_qkt<T, D, kRows / 8>(s, qs, ks, row0, lane);
    tile_qkt<T, D, kRows / 8>(dp, dos, vs, row0, lane);
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * (lane & 3) + (e & 1), i = e >> 1;
        const bool seen = alive[i] && kok[c] != 0.f
                          && live(bits, r[i], c, lut.shift)
                          && (!kCausal || k0 + c <= q0 + r[i]);
        const float p = seen ? expf(s[n][e] * scale - L[i]) : 0.f;
        s[n][e] = p * (dp[n][e] - dl[i]) * scale;              // ds
      }
    tile_pv<T, D>(acc, s, ks, lane);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<T, D>(dq, acc, b, q0 + row0, h, S, H, one, lane);
}

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
sparse_bwd_dkv_tc_kernel(const T* __restrict__ q,
                         const T* __restrict__ k,
                         const T* __restrict__ v,
                         const T* __restrict__ dout, Strides sq,
                         Strides sk, Strides sv, Strides sdo, Lut lut,
                         Work work, const float* __restrict__ kvm,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int S,
                         int H, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kRows * LD;
  T* qs = vs + kRows * LD;
  T* dos = qs + kRows * LD;
  float* lses = reinterpret_cast<float*>(dos + kRows * LD);   // [kRows]
  float* dels = lses + kRows;                                  // [kRows]
  const int* item = work.items + 7 * blockIdx.x;
  const int h = item[0], kt = item[1], first = item[4], b = blockIdx.y;
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * 16;
  const int k0 = kt * kRows;
  // this thread's two key rows, tile-local
  const int r[2] = {row0 + (lane >> 2), row0 + (lane >> 2) + 8};
  const bool kept[2] = {key_kept(kvm, b, k0 + r[0], S),
                        key_kept(kvm, b, k0 + r[1], S)};
  const long long at = (long long)h * ((S + kRows - 1) / kRows) + kt;
  const long long stat0 = ((long long)b * H + h) * S;

  stage16<D>(ks, k, sk, b, h, k0, S);
  stage16<D>(vs, v, sv, b, h, k0, S);
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

#pragma unroll 1
  for (int t = item[2]; t < item[3]; ++t) {
    const int q0 = lut.idx[at * lut.len + t] * kRows;
    const unsigned long long bits = lut.bits[at * lut.len + t];
    __syncthreads();
    stage16<D>(qs, q, sq, b, h, q0, S);
    stage16<D>(dos, dout, sdo, b, h, q0, S);
    stage_stats(lses, dels, lse, delta, stat0, q0, S);
    __syncthreads();
    // transposed scores: rows are this warp's keys, columns the tile's
    // queries
    float p[kRows / 8][4], ds[kRows / 8][4];
    tile_qkt<T, D, kRows / 8>(p, ks, qs, row0, lane);
    tile_qkt<T, D, kRows / 8>(ds, vs, dos, row0, lane);
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * (lane & 3) + (e & 1), i = e >> 1;
        const bool seen = kept[i] && lses[c] > kNegInf / 2
                          && live(bits, c, r[i], lut.shift)
                          && (!kCausal || q0 + c >= k0 + r[i]);
        p[n][e] = seen ? expf(p[n][e] * scale - lses[c]) : 0.f;
        ds[n][e] = p[n][e] * (ds[n][e] - dels[c]) * scale;
      }
    tile_pv<T, D>(dva, p, dos, lane);
    tile_pv<T, D>(dka, ds, qs, lane);
  }
  if (first >= 0) {
    // value i = 4 n + e of the accumulators: row r[e >> 1], column
    // n * 8 + 2 (lane & 3) + (e & 1)
    const auto at_i = [&](int i) {
      return r[(i & 3) >> 1] * D + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
    };
    const long long at0 = (long long)b * work.parts + first;
    if (!combine<D, D / 2>(work.ws + at0 * 2 * kRows * D, item[5], item[6],
                           work.tickets + at0, &dka[0][0], &dva[0][0],
                           at_i))
      return;
  }
  const float one[2] = {1.f, 1.f};
  store_rows<T, D>(dk, dka, b, k0 + row0, h, S, H, one, lane);
  store_rows<T, D>(dv, dva, b, k0 + row0, h, S, H, one, lane);
}

// ===========================================================================
// f32: CUDA-core FMAs
// ===========================================================================
// Forward: one block per (query tile, head, batch row); thread = (row, part)
template <int D, bool kCausal>
__global__ void __launch_bounds__(FwdSplit<D>::kThreads)
sparse_fwd_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, Strides sq, Strides sk,
                      Strides sv, Lut lut, const float* __restrict__ kvm,
                      float* __restrict__ out, float* __restrict__ lse,
                      int S, int H, float scale) {
  using SP = FwdSplit<D>;
  constexpr int TPR = SP::kTpr;
  constexpr int kCh = SP::kCh;
  extern __shared__ float smem[];
  float* ks = smem;                           // [kRows][D]
  float* vs = smem + kRows * D;               // [kRows][D]
  float* kok = smem + 2 * kRows * D;          // [kRows]
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int part = threadIdx.x % TPR, r = threadIdx.x / TPR;
  const int qi = qt * kRows + r;
  const long long at = (long long)h * gridDim.x + qt;
  const int cnt = lut.cnt[at];

  float qr[kCh], acc[kCh];
  load_row<SP>(q, sq, b, qi, h, S, part, qr);
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = 0.f;
  float m = kNegInf, l = 0.f;

#pragma unroll 1
  for (int t = 0; t < cnt; ++t) {
    const int k0 = lut.idx[at * lut.len + t] * kRows;
    const unsigned long long bits = lut.bits[at * lut.len + t];
    __syncthreads();
    stage_f32<D>(ks, k, sk, b, h, k0, S);
    stage_f32<D>(vs, v, sv, b, h, k0, S);
    stage_keys(kok, kvm, b, k0, S);
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < kRows; j0 += kFwdGroup) {
      float sc[kFwdGroup];
      bool seen[kFwdGroup];
#pragma unroll
      for (int u = 0; u < kFwdGroup; ++u)
        sc[u] = part_dot<SP>(qr, ks + (j0 + u) * D, part);
      row_sum<TPR, kFwdGroup>(sc);
      float gmax = kNegInf;
#pragma unroll
      for (int u = 0; u < kFwdGroup; ++u) {
        const int j = j0 + u;
        seen[u] = kok[j] != 0.f && live(bits, r, j, lut.shift)
                  && (!kCausal || k0 + j <= qi);
        sc[u] = seen[u] ? sc[u] * scale : kNegInf;
        gmax = fmaxf(gmax, sc[u]);
      }
      const float m_new = fmaxf(m, gmax);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kFwdGroup; ++u) {
        sc[u] = seen[u] ? expf(sc[u] - m_new) : 0.f;
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
    if (part == 0)
      lse[((long long)b * H + h) * S + qi] =
          m <= kNegInf / 2 ? kNegInf : m + logf(l_safe);
  }
}

// dq: one block per (query tile, head, batch row), walking its row LUT
template <int D, bool kCausal>
__global__ void __launch_bounds__(BwdSplit<D>::kThreads)
sparse_bwd_dq_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout, Strides sq,
                         Strides sk, Strides sv, Strides sdo, Lut lut,
                         const float* __restrict__ kvm,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int S, int H, float scale) {
  using SP = BwdSplit<D>;
  constexpr int TPR = SP::kTpr;
  constexpr int kCh = SP::kCh;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + kRows * D;
  float* kok = smem + 2 * kRows * D;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int part = threadIdx.x % TPR, r = threadIdx.x / TPR;
  const int qi = qt * kRows + r;
  const long long at = (long long)h * gridDim.x + qt;
  const int cnt = lut.cnt[at];

  float qr[kCh], dor[kCh], acc[kCh];
  load_row<SP>(q, sq, b, qi, h, S, part, qr);
  load_row<SP>(dout, sdo, b, qi, h, S, part, dor);
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = 0.f;
  const long long stat = ((long long)b * H + h) * S + qi;
  const float L = qi < S ? lse[stat] : kNegInf;
  const float dl = qi < S ? delta[stat] : 0.f;
  const bool alive = L > kNegInf / 2;

#pragma unroll 1
  for (int t = 0; t < cnt; ++t) {
    const int k0 = lut.idx[at * lut.len + t] * kRows;
    const unsigned long long bits = lut.bits[at * lut.len + t];
    __syncthreads();
    stage_f32<D>(ks, k, sk, b, h, k0, S);
    stage_f32<D>(vs, v, sv, b, h, k0, S);
    stage_keys(kok, kvm, b, k0, S);
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < kRows; j0 += kBwdGroup) {
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
        const int j = j0 + u;
        const bool seen = alive && kok[j] != 0.f
                          && live(bits, r, j, lut.shift)
                          && (!kCausal || k0 + j <= qi);
        const float p = seen ? expf(sc[u] * scale - L) : 0.f;
        axpy_row<SP>(acc, p * (dp[u] - dl) * scale, ks + j * D, part);
      }
    }
  }
  if (qi < S) store_row<SP>(dq, b, qi, h, S, H, part, acc);
}

// dk, dv: one block per (key tile, head, batch row), walking its column LUT
template <int D, bool kCausal>
__global__ void __launch_bounds__(BwdSplit<D>::kThreads)
sparse_bwd_dkv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout, Strides sq,
                          Strides sk, Strides sv, Strides sdo, Lut lut,
                          Work work, const float* __restrict__ kvm,
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
  const int* item = work.items + 7 * blockIdx.x;
  const int h = item[0], kt = item[1], first = item[4], b = blockIdx.y;
  const int part = threadIdx.x % TPR, r = threadIdx.x / TPR;
  const int kj = kt * kRows + r;
  const long long at = (long long)h * ((S + kRows - 1) / kRows) + kt;
  const bool kept = key_kept(kvm, b, kj, S);
  const long long stat0 = ((long long)b * H + h) * S;

  float kr[kCh], vr[kCh], dkr[kCh], dvr[kCh];
  load_row<SP>(k, sk, b, kj, h, S, part, kr);
  load_row<SP>(v, sv, b, kj, h, S, part, vr);
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    dkr[c] = 0.f;
    dvr[c] = 0.f;
  }

#pragma unroll 1
  for (int t = item[2]; t < item[3]; ++t) {
    const int q0 = lut.idx[at * lut.len + t] * kRows;
    const unsigned long long bits = lut.bits[at * lut.len + t];
    __syncthreads();
    stage_f32<D>(qs, q, sq, b, h, q0, S);
    stage_f32<D>(dos, dout, sdo, b, h, q0, S);
    stage_stats(lses, dels, lse, delta, stat0, q0, S);
    __syncthreads();
#pragma unroll 1
    for (int i0 = 0; i0 < kRows; i0 += kBwdGroup) {
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
        const bool seen = kept && lses[i] > kNegInf / 2
                          && live(bits, i, r, lut.shift)
                          && (!kCausal || q0 + i >= kj);
        const float p = seen ? expf(sc[u] * scale - lses[i]) : 0.f;
        axpy_row<SP>(dvr, p, dos + i * D, part);
        axpy_row<SP>(dkr, p * (dp[u] - dels[i]) * scale, qs + i * D, part);
      }
    }
  }
  if (first >= 0) {
    const auto at_i = [&](int i) {
      return r * D + chan<SP>(part, i >> 2) + (i & 3);
    };
    const long long at0 = (long long)b * work.parts + first;
    if (!combine<D, kCh>(work.ws + at0 * 2 * kRows * D, item[5], item[6],
                         work.tickets + at0, dkr, dvr, at_i))
      return;
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
                         void* out, float* lse, const long long* st, Lut lut,
                         const float* kvm, int B, int S, int H, float scale,
                         cudaStream_t stream) {
    const dim3 grid = grid_of(B, S, H);
    const auto go = [&](auto kernel, int threads, size_t smem) {
      return launch(kernel, grid, threads, smem, stream, as<T>(q), as<T>(k),
                    as<T>(v), strides_at(st, 0), strides_at(st, 1),
                    strides_at(st, 2), lut, kvm, as<T>(out), lse, S, H,
                    scale);
    };
    if constexpr (sizeof(T) == 2)
      return go(sparse_fwd_tc_kernel<T, D, C>, kTcThreads, tc_smem<D>(3, 1));
    else
      return go(sparse_fwd_f32_kernel<D, C>, FwdSplit<D>::kThreads,
                f32_smem<D>(2, 1));
  }
};

template <typename T, int D, bool C>
struct Dq {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, const long long* st,
                         Lut lut, const float* kvm, int B, int S, int H,
                         float scale, cudaStream_t stream) {
    const dim3 grid = grid_of(B, S, H);
    const auto go = [&](auto kernel, int threads, size_t smem) {
      return launch(kernel, grid, threads, smem, stream, as<T>(q), as<T>(k),
                    as<T>(v), as<T>(dout), strides_at(st, 0),
                    strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
                    lut, kvm, lse, delta, as<T>(dq), S, H, scale);
    };
    if constexpr (sizeof(T) == 2)
      return go(sparse_bwd_dq_tc_kernel<T, D, C>, kTcThreads, tc_smem<D>(4, 1));
    else
      return go(sparse_bwd_dq_f32_kernel<D, C>, BwdSplit<D>::kThreads,
                f32_smem<D>(2, 1));
  }
};

template <typename T, int D, bool C>
struct Dkv {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv,
                         const long long* st, Lut lut, Work work,
                         int n_items, const float* kvm, int B, int S, int H,
                         float scale, cudaStream_t stream) {
    const dim3 grid(n_items, B);
    const auto go = [&](auto kernel, int threads, size_t smem) {
      return launch(kernel, grid, threads, smem, stream, as<T>(q), as<T>(k),
                    as<T>(v), as<T>(dout), strides_at(st, 0),
                    strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
                    lut, work, kvm, lse, delta, as<T>(dk), as<T>(dv), S, H,
                    scale);
    };
    if constexpr (sizeof(T) == 2)
      return go(sparse_bwd_dkv_tc_kernel<T, D, C>, kTcThreads,
                tc_smem<D>(4, 2));
    else
      return go(sparse_bwd_dkv_f32_kernel<D, C>, BwdSplit<D>::kThreads,
                f32_smem<D>(2, 2));
  }
};

// the mask of a tile pair has 64 bits: a fine block of at least 8 rows
bool bad_lut(int len, int shift) { return len < 1 || shift < 3 || shift > 6; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; d in {32, 64, 96, 128}. `strides` is a host
// array of (batch, seq, head) element strides: q, k, v for the forward;
// q, k, v, dO for the backward. lut_idx / lut_cnt / lut_bits are device
// arrays [H, tiles, lut_len] / [H, tiles] / [H, tiles, lut_len]: the row LUT
// for the forward and dq, the column LUT for dk/dv. kvm: the f32 [B, S]
// key-padding mask (> 0 attends) or null. The dk/dv kernel also takes its
// work items ([n_items, 7] int32, see Work) and, when parts > 0, the
// workspace and the zeroed tickets. Returns a cudaError_t (0 on success).
extern "C" int dstorch_sparse_fwd(const void* q, const void* k, const void* v,
                                  void* out, float* lse,
                                  const long long* strides,
                                  const int* lut_idx, const int* lut_cnt,
                                  const unsigned long long* lut_bits,
                                  int lut_len, int shift, const float* kvm,
                                  int B, int S, int H, int d, int causal,
                                  float scale, int dtype, void* stream) {
  if (bad_shape(B, S, H) || bad_lut(lut_len, shift))
    return (int)cudaErrorInvalidValue;
  const Lut lut{lut_idx, lut_cnt, lut_bits, lut_len, shift};
  return (int)dispatch<Fwd>(dtype, d, causal, q, k, v, out, lse, strides,
                            lut, kvm, B, S, H, scale,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int dstorch_sparse_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dq, const long long* strides,
                                     const int* lut_idx, const int* lut_cnt,
                                     const unsigned long long* lut_bits,
                                     int lut_len, int shift,
                                     const float* kvm, int B, int S, int H,
                                     int d, int causal, float scale,
                                     int dtype, void* stream) {
  if (bad_shape(B, S, H) || bad_lut(lut_len, shift))
    return (int)cudaErrorInvalidValue;
  const Lut lut{lut_idx, lut_cnt, lut_bits, lut_len, shift};
  return (int)dispatch<Dq>(dtype, d, causal, q, k, v, dout, lse, delta, dq,
                           strides, lut, kvm, B, S, H, scale,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int dstorch_sparse_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dk, void* dv,
                                      const long long* strides,
                                      const int* lut_idx, const int* lut_cnt,
                                      const unsigned long long* lut_bits,
                                      int lut_len, int shift,
                                      const int* items, int n_items,
                                      int parts, float* ws, int* tickets,
                                      const float* kvm, int B, int S, int H,
                                      int d, int causal, float scale,
                                      int dtype, void* stream) {
  if (bad_shape(B, S, H) || bad_lut(lut_len, shift) || n_items < 1
      || (parts > 0 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Lut lut{lut_idx, lut_cnt, lut_bits, lut_len, shift};
  const Work work{items, ws, tickets, parts};
  return (int)dispatch<Dkv>(dtype, d, causal, q, k, v, dout, lse, delta, dk,
                            dv, strides, lut, work, n_items, kvm, B, S, H,
                            scale, static_cast<cudaStream_t>(stream));
}
