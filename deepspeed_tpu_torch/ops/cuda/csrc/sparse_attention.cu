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
// The forward takes one block per (query tile, head, batch row), walking
// its row-LUT entries. The backward walks two host work lists:
//   * dq: (head, query tile) pairs sorted by their row-LUT length, longest
//     first; an item walks its row LUT;
//   * dk/dv: items of at most 32 column-LUT entries of one (head, key
//     tile), longest first. A key tile with a longer LUT row (BigBird's
//     global key tile is seen by every query tile) is split over several
//     items, each writing its f32 partial to a workspace slot of its own.
//     The 16-bit kernel sums them up a fixed binary tree over the items'
//     ranks (ticket counters decide which item of a node adds its two
//     halves); the f32 kernel's last item to finish sums them in rank
//     order. Either way the result does not depend on which item finishes
//     first (no atomics on the sums: dq, dk and dv are bitwise
//     reproducible).
// An item with no entry still stores its rows (zeros: dq of a dead query
// tile, dk/dv of a key tile no query reaches).
//
// Bound: counted once, the bytes (q, k, v, out, dO, grads) bound all three
// kernels at the training shape (S = 32768, D = 64, BigBird block 64): a
// live 64 x 64 tile pair does 6-8 * 64 * 4096 flops in the backward
// against two 8 KB tiles that mostly hit L2 (a tile is reused by the
// neighbouring tiles of its window). Three designs:
//   * bf16 / fp16 backward (the training path), d in {32, 64, 96, 128):
//     persistent wgmma kernels on the machinery of flash_attention.cu
//     (hopper.cuh), one block per SM. Each block runs two pipelines, one per
//     consumer warpgroup (wgmma's m64 is the layout's 64-row tile): a
//     producer warp of the producer warpgroup (setmaxnreg 56 / 224) takes
//     the pipeline's items in a snake over the sorted list, loads an item's
//     resident tiles (dq: Q, dO; dk/dv: K, V) into one of two buffers and
//     the LUT-listed tiles (dq: K, V; dk/dv: Q, dO) into a ring of 2-4
//     stages that runs on across items, all by TMA through 4-D tensor maps
//     over (d, H, S, B) with the caller's strides (rows past S arrive as
//     zeros). Beside the tiles it writes the side values into shared
//     memory: lse in log2 units (+inf on dead rows and past S, so exp2 gives
//     p = 0 without a mask) and delta of the query rows (dq: the item's;
//     dk/dv: each stage's), each stage's tile index and fine-block mask, the
//     kept keys of the key tile as 64 bits, and whether the pair needs a
//     mask at all. Its lanes read the LUT row and the list 32 entries at a
//     time and issue the side values' loads before they wait for a free
//     slot. The consumers run ss wgmma m64n64k16 for S = Q K^T and
//     dP = dO V^T (dk/dv: S^T = K Q^T, dP^T = V dO^T) and rs wgmma with P
//     or dS rounded to the input type in registers for dQ += dS K, dV +=
//     P^T dO and dK += dS^T Q, software pipelined as flash's backward: the
//     products of tile i run while the exponentials of tile i - 1 do. For
//     d >= 96 dk/dv walks a query tile as two 32-row halves (registers).
//     Only tile pairs on the causal diagonal, with a partly live fine mask,
//     (dq) with a dropped or missing key take the masked body; dk/dv zeroes
//     the rows of dropped keys at the store instead (a row of dK, dV
//     depends only on its own key's scores).
//   * bf16 / fp16 forward: 4-warp blocks on mma.sync m16n8k16
//     (attention_tiles.cuh), K and V staged by the threads; the mask costs
//     a shared-memory read and a bit test per score.
//   * f32: exact CUDA-core FMAs, on no main path; the dq kernel takes one
//     block per query tile, the dk/dv kernel one per work item.
// The forward and dq do not split long LUT rows (a bidirectional layout's
// global query tile walks every key tile; the causal training layout has
// none; the dq list puts such rows first).
//
// Plain C interface (no PyTorch headers), bound with ctypes by
// deepspeed_tpu_torch/ops/cuda/sparse_attention.py.

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

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
// item (written in full before it is read); tickets [B, parts, kLevels]
// arrive zeroed and count arrivals: the f32 kernel counts a tile's finished
// items at level 0 of its first partial, the 16-bit kernel the two halves
// of each node of its combine tree at (left-most rank, level).
constexpr int kLevels = 16;       // a tile split over at most 2^16 items
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

// ===========================================================================
// bf16 / fp16 backward: wgmma kernels fed by TMA (B5b)
// ===========================================================================
// Registers a thread after the roles split: the producer warps keep a chunk
// of 32 work items and the side values of a stage in flight, so their
// warpgroup keeps 56 and the consumers take 224 (4 x 32 x 112 = 8 x 32 x 56
// registers move from the launch's 168 a thread).
constexpr int kSpProducerRegs = 56;
constexpr int kSpConsumerRegs = 224;
constexpr int kPipes = 2;                 // one per consumer warpgroup

// What a producer warp tells its consumer warpgroup beside the tiles of a
// resident buffer (the work item) or of a ring stage (one LUT entry).
struct Side {
  float lse[kRows];       // query rows: lse in log2 units, +inf past S and
  float delta[kRows];     //   on dead rows (so exp2 gives 0 unmasked)
  unsigned long long bits;    // stage: the tile pair's fine-block mask
  unsigned long long keys;    // bit c: key c of the key tile exists and is
  //                             kept (dq: the stage's; dk/dv: the item's)
  int tile;               // stage: the walked tile; buffer: the item's own
  int masked;             // stage: the pair takes the masked body
  int shift;              // stage: log2 of the fine block (read per stage,
  //                         so the masked body's index arithmetic stays in
  //                         the loop instead of taking registers)
  int h, b, n, first, rank, items;   // buffer: the item (n LUT entries)
};

template <int D>
struct BwdTile {
  // two 64-row tiles (Q and dO, or K and V) a buffer and a stage
  static constexpr int kTile = 2 * kRows * D * 2;
  static constexpr int kStages = D <= 64 ? 4 : 2;
  static constexpr int kRes = D <= 96 ? 2 : 1;
  // dk/dv walks a query tile in halves of 32 rows for d >= 96 (registers)
  static constexpr int kHalves = D <= 64 ? 1 : 2;
  static constexpr int kBufs = kRes + kStages;
  // one pipeline: its tiles, sides and barriers, 1024-aligned
  static constexpr int kSides = kBufs * kTile;
  static constexpr int kBars = kSides + kBufs * (int)sizeof(Side);
  static constexpr int kPipe = (kBars + 8 * 2 * kBufs + 1023) / 1024 * 1024;
  static constexpr size_t kSmem = 1024 + kPipes * kPipe;
};

// One warpgroup's pipeline in shared memory: kRes resident buffers (the
// next item's load during this one's end) and a ring of kStages stages,
// each with a full and an empty mbarrier; its tiles (1024-aligned), then
// their sides, then the barriers, all at fixed offsets from its base.
template <int D>
struct Pipe {
  using C = BwdTile<D>;
  unsigned char* base;
  __device__ Pipe(unsigned char* smem, int p) : base(smem + p * C::kPipe) {}
  __device__ unsigned char* res(int j) const {
    return base + (j % C::kRes) * C::kTile;
  }
  __device__ unsigned char* stage(int g) const {
    return base + (C::kRes + g % C::kStages) * C::kTile;
  }
  __device__ Side* rside(int j) const {
    return reinterpret_cast<Side*>(base + C::kSides) + j % C::kRes;
  }
  __device__ Side* sside(int g) const {
    return reinterpret_cast<Side*>(base + C::kSides) + C::kRes
           + g % C::kStages;
  }
  __device__ uint64_t* full(int g) const {
    return reinterpret_cast<uint64_t*>(base + C::kBars) + g % C::kStages;
  }
  __device__ uint64_t* empty(int g) const {
    return full(0) + C::kStages + g % C::kStages;
  }
  __device__ uint64_t* rfull(int j) const {
    return full(0) + 2 * C::kStages + j % C::kRes;
  }
  __device__ uint64_t* rempty(int j) const {
    return full(0) + 2 * C::kStages + C::kRes + j % C::kRes;
  }
  // the barrier counts: every producer lane arrives on a full one (lane 0
  // with the TMA bytes), one lane of each consumer warp on an empty one
  __device__ void init() const {
    for (int i = 0; i < C::kStages; ++i) {
      bar_init(full(i), 32);
      bar_init(empty(i), 4);
    }
    for (int i = 0; i < C::kRes; ++i) {
      bar_init(rfull(i), 32);
      bar_init(rempty(i), 4);
    }
  }
};

// The work item of round j of pipeline p in a persistent kernel: the
// pipelines (two a block) take rounds in alternating directions, so a list
// sorted longest first spreads evenly over them; batch rows are the fastest
// index, so every row of the longest items comes first.
__device__ __forceinline__ int pipe_round(int j, int p) {
  const int n = kPipes * gridDim.x, at = kPipes * blockIdx.x + p;
  return j * n + ((j & 1) ? n - 1 - at : at);
}

// every fine block of a tile pair live
__device__ __forceinline__ unsigned long long all_live(int shift) {
  const int n = (kRows >> shift) * (kRows >> shift);
  return n >= 64 ? ~0ull : (1ull << n) - 1;
}

// the 128 threads of consumer warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

__device__ __forceinline__ void bar_release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(bar);
}

// p, passed through an empty asm: the descriptors of an item's resident
// tiles are then computed where each product is issued, not hoisted out of
// the loop into registers that the accumulators need
template <typename P>
__device__ __forceinline__ P* anew(P* p) {
  uint64_t a = reinterpret_cast<uint64_t>(p);
  asm volatile("" : "+l"(a));
  return reinterpret_cast<P*>(a);
}

// A producer lane's part of the side values of 64 query rows from q0: lse
// and delta of rows q0 + lane and q0 + 32 + lane, loaded into registers
// before the slot is free (their latency runs during the wait) and stored
// after it, lse in log2 units (+inf past S and on dead rows)
struct RowStats {
  float lse[2], delta[2];
  __device__ void load(const float* lse_g, const float* delta_g,
                       long long stat0, int q0, int S, int lane) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + lane + 32 * i;
      lse[i] = row < S ? lse_g[stat0 + row] : kNegInf;
      delta[i] = row < S ? delta_g[stat0 + row] : 0.f;
    }
  }
  __device__ void store(Side* s, int lane) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s->lse[lane + 32 * i] = lse[i] > kNegInf / 2 ? lse[i] * kLog2e
                                                   : INFINITY;
      s->delta[lane + 32 * i] = delta[i];
    }
  }
};

// Whether keys k0 + lane and k0 + 32 + lane exist and are kept: the mask is
// read before the slot is free, the 64 flags gathered by a ballot after
struct KeyFlags {
  float kept[2];
  __device__ void load(const float* kvm, int b, int k0, int S, int lane) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + lane + 32 * i;
      kept[i] = key >= S ? 0.f
                : kvm == nullptr ? 1.f : kvm[(long long)b * S + key];
    }
  }
  __device__ unsigned long long ballot() const {
    return __ballot_sync(kFull, kept[0] > 0.f)
           | (static_cast<unsigned long long>(
                  __ballot_sync(kFull, kept[1] > 0.f))
              << 32);
  }
};

// dq: one work item is (head, query tile) x batch row, walking the query
// tile's row LUT; items[2 i ..] = head, query tile, longest rows first.
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kHopperThreads, 1)
sparse_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo, Lut lut,
                           const int* __restrict__ items, int n_items,
                           const float* __restrict__ kvm,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dq, int B, int S, int H,
                           float scale) {
  using C = BwdTile<D>;
  constexpr int kStages = C::kStages, kRes = C::kRes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int nt = (S + kRows - 1) / kRows;
  const int n_work = n_items * B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int p = 0; p < kPipes; ++p) Pipe<D>(base, p).init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {                       // the producers
    regs_down<kSpProducerRegs>();
    const int p = warp - kConsumerWarps;
    if (p >= kPipes) return;
    const Pipe<D> pipe(base, p);
    int g = 0, e_h = 0, e_qt = 0, e_cnt = 0;
    for (int j = 0;; ++j) {
      const int w = pipe_round(j, p);
      if (w >= n_work) break;
      if ((j & 31) == 0) {          // lane l: the item of round j + l
        const int wl = pipe_round(j + lane, p);
        if (wl < n_work) {
          const int it = wl / B;
          e_h = items[2 * it];
          e_qt = items[2 * it + 1];
          e_cnt = lut.cnt[e_h * nt + e_qt];
        }
      }
      const int h = __shfl_sync(kFull, e_h, j & 31);
      const int qt = __shfl_sync(kFull, e_qt, j & 31);
      const int cnt = __shfl_sync(kFull, e_cnt, j & 31);
      const int b = w % B, q0 = qt * kRows;
      const long long at = (long long)h * nt + qt;
      RowStats rows;
      rows.load(lse, delta, ((long long)b * H + h) * S, q0, S, lane);
      if (j >= kRes) bar_wait(pipe.rempty(j), ((j / kRes) & 1) ^ 1);
      Side* rs = pipe.rside(j);
      rows.store(rs, lane);
      if (lane == 0) {
        rs->h = h;
        rs->b = b;
        rs->tile = qt;
        rs->n = cnt;
        if (cnt > 0) {
          T* qs = reinterpret_cast<T*>(pipe.res(j));
          bar_expect(pipe.rfull(j), C::kTile);
          tma_tile<D, kRows>(qs, &tq, pipe.rfull(j), h, q0, b);
          tma_tile<D, kRows>(qs + kRows * D, &tdo, pipe.rfull(j),
                             h, q0, b);
        } else {
          bar_arrive(pipe.rfull(j));
        }
      } else {
        bar_arrive(pipe.rfull(j));
      }
      for (int c0 = 0; c0 < cnt; c0 += 32) {
        int idx = 0;
        unsigned long long bits = 0;
        if (c0 + lane < cnt) {
          idx = lut.idx[at * lut.len + c0 + lane];
          bits = lut.bits[at * lut.len + c0 + lane];
        }
        const int m = min(32, cnt - c0);
        for (int t = 0; t < m; ++t, ++g) {
          const int kt = __shfl_sync(kFull, idx, t);
          const unsigned long long fb = __shfl_sync(kFull, bits, t);
          KeyFlags keys;
          keys.load(kvm, b, kt * kRows, S, lane);
          if (g >= kStages) bar_wait(pipe.empty(g), ((g / kStages) & 1) ^ 1);
          const unsigned long long kept = keys.ballot();
          if (lane == 0) {
            Side* ss = pipe.sside(g);
            ss->tile = kt;
            ss->bits = fb;
            ss->keys = kept;
            ss->masked = (kCausal && kt == qt) || fb != all_live(lut.shift)
                         || kept != ~0ull;
            ss->shift = lut.shift;
            T* ks = reinterpret_cast<T*>(pipe.stage(g));
            bar_expect(pipe.full(g), C::kTile);
            tma_tile<D, kRows>(ks, &tk, pipe.full(g), h, kt * kRows, b);
            tma_tile<D, kRows>(ks + kRows * D, &tv, pipe.full(g), h,
                               kt * kRows, b);
          } else {
            bar_arrive(pipe.full(g));
          }
        }
      }
    }
    return;
  }

  // Each consumer warpgroup walks its pipeline's items; within an item it
  // is pipelined as flash's dq: tile i's S = Q K^T and dP = dO V^T run on
  // the tensor cores with tile i - 1's dQ += dS K, and tile i's dS / scale
  // = P (dP - delta) is computed while the latter runs. Only the pairs the
  // producer flags take the mask's instructions.
  regs_up<kSpConsumerRegs>();
  const int wg = warp >> 2;
  const Pipe<D> pipe(base, wg);
  const float c2 = scale * kLog2e;
  const int w16 = (warp & 3) * 16;
  const int rl[2] = {w16 + (lane >> 2), w16 + (lane >> 2) + 8};  // local
  const auto slot_wait = [&](int g) {
    bar_wait(pipe.full(g), (g / kStages) & 1);
  };
  float s[kRows / 2], dp[kRows / 2], acc[D / 2];
  uint32_t da[kRows / 16][4];
  int g = 0;
#pragma unroll 1
  for (int j = 0;; ++j) {
    const int w = pipe_round(j, wg);
    if (w >= n_work) break;
    bar_wait(pipe.rfull(j), (j / kRes) & 1);
    const Side* rs = pipe.rside(j);
    const int cnt = rs->n, h = rs->h, b = rs->b, q0 = rs->tile * kRows;
    float L[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      L[r] = rs->lse[rl[r]];
      dl[r] = rs->delta[rl[r]];
    }
    const T* qs = reinterpret_cast<const T*>(pipe.res(j));   // Q, then dO
    const auto k_tile = [&](int slot) {
      return reinterpret_cast<const T*>(pipe.stage(slot));
    };
    // S and dP of a ring slot (one commit group)
    const auto scores = [&](int slot) {
      const T* ks = k_tile(slot);
      const T* vs = ks + kRows * D;
      const T* q = anew(qs);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, kRows>::ss(s, desc_k<kRows>(q, 0, kk),
                            desc_k<kRows>(ks, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, kRows>::ss(dp, desc_k<kRows>(q + kRows * D, 0, kk),
                            desc_k<kRows>(vs, 0, kk), kk);
      wg_commit();
    };
    // dS / scale of a ring slot into s
    const auto grad_scores = [&](int slot) {
      const Side* ss = pipe.sside(slot);
      const auto body = [&](auto masked) {
        unsigned long long rb[2] = {0, 0}, keys = 0;
        int k0 = 0, shift = 0;
        if constexpr (decltype(masked)::value) {
          k0 = ss->tile * kRows;
          keys = ss->keys;
          shift = ss->shift;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            rb[r] = ss->bits >> ((rl[r] >> shift) * (kRows >> shift));
        }
#pragma unroll
        for (int e = 0; e < kRows / 2; ++e) {
          const int r = (e >> 1) & 1;
          float x = exp2_fast(fmaf(s[e], c2, -L[r]));   // +inf L: 0
          if constexpr (decltype(masked)::value) {
            const int c = acc_col(lane, e);
            const bool seen = ((rb[r] >> (c >> shift)) & 1ull)
                              && ((keys >> c) & 1ull)
                              && (!kCausal || k0 + c <= q0 + rl[r]);
            if (!seen) x = 0.f;
          }
          s[e] = x * (dp[e] - dl[r]);
        }
      };
      if (ss->masked) body(std::true_type{});
      else body(std::false_type{});
    };
    const auto grads = [&](int slot) {
#pragma unroll
      for (int jj = 0; jj < kRows / 16; ++jj)
        Wgmma<T, D>::rs(acc, da[jj], desc_mn<kRows>(k_tile(slot), jj), 1);
      wg_commit();
    };
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    if (cnt > 0) {
      slot_wait(g);
      fence_regs<D / 2>(acc);
      wg_fence();
      scores(g);
      wg_wait();
      fence_regs<kRows / 2>(s);
      fence_regs<kRows / 2>(dp);
      grad_scores(g);
      to_a<T, kRows>(da, s);
#pragma unroll 1
      for (int i = 1; i < cnt; ++i) {
        slot_wait(g + i);
        fence_regs<D / 2>(acc);
        wg_fence();
        scores(g + i);
        grads(g + i - 1);
        wg_wait<1>();
        fence_regs<kRows / 2>(s);
        fence_regs<kRows / 2>(dp);
        grad_scores(g + i);
        wg_wait<0>();
        fence_regs<D / 2>(acc);
        bar_release(pipe.empty(g + i - 1), lane);
        to_a<T, kRows>(da, s);
      }
      bar_release(pipe.rempty(j), lane);   // the last read of Q, dO
      fence_regs<D / 2>(acc);
      wg_fence();
      grads(g + cnt - 1);
      wg_wait();
      fence_regs<D / 2>(acc);
      bar_release(pipe.empty(g + cnt - 1), lane);
    } else {
      bar_release(pipe.rempty(j), lane);
    }
    g += cnt;
    const int row[2] = {q0 + rl[0], q0 + rl[1]};
    const float sc[2] = {scale, scale};   // dS carried the scale out
    store_acc<T, D>(dq, acc, b, row, h, S, H, sc, lane);
  }
}

// dk, dv: one work item is (head, key tile, a run of at most 32 column-LUT
// entries) x batch row (the Work list, longest first); a split key tile's
// items write f32 partials, summed up a binary tree over their ranks.
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kHopperThreads, 1)
sparse_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo, Lut lut,
                            Work work, int n_items,
                            const float* __restrict__ kvm,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int B,
                            int S, int H, float scale) {
  using C = BwdTile<D>;
  constexpr int kStages = C::kStages, kRes = C::kRes, kHalves = C::kHalves;
  constexpr int kM = kRows / kHalves;           // query rows a step
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last_flag[kPipes];
  unsigned char* base = align1024(smem_raw);
  const int nt = (S + kRows - 1) / kRows;
  const int n_work = n_items * B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int p = 0; p < kPipes; ++p) Pipe<D>(base, p).init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {                       // the producers
    regs_down<kSpProducerRegs>();
    const int p = warp - kConsumerWarps;
    if (p >= kPipes) return;
    const Pipe<D> pipe(base, p);
    int g = 0, e[4] = {0, 0, 0, 0};
    for (int j = 0;; ++j) {
      const int w = pipe_round(j, p);
      if (w >= n_work) break;
      if ((j & 31) == 0) {          // lane l: the item of round j + l
        const int wl = pipe_round(j + lane, p);
        if (wl < n_work) {
#pragma unroll
          for (int f = 0; f < 4; ++f) e[f] = work.items[7 * (wl / B) + f];
        }
      }
      const int h = __shfl_sync(kFull, e[0], j & 31);
      const int kt = __shfl_sync(kFull, e[1], j & 31);
      const int t0 = __shfl_sync(kFull, e[2], j & 31);
      const int n = __shfl_sync(kFull, e[3], j & 31) - t0;
      const int b = w % B, k0 = kt * kRows;
      const long long at = (long long)h * nt + kt;
      const long long stat0 = ((long long)b * H + h) * S;
      KeyFlags keys;
      keys.load(kvm, b, k0, S, lane);
      int split[3] = {0, 0, 0};     // first partial, rank, items
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < 3; ++f)
          split[f] = work.items[7 * (w / B) + 4 + f];
      }
      if (j >= kRes) bar_wait(pipe.rempty(j), ((j / kRes) & 1) ^ 1);
      const unsigned long long kept = keys.ballot();
      if (lane == 0) {
        Side* rs = pipe.rside(j);
        rs->h = h;
        rs->b = b;
        rs->tile = kt;
        rs->n = n;
        rs->first = split[0];
        rs->rank = split[1];
        rs->items = split[2];
        rs->keys = kept;
        if (n > 0) {
          T* ks = reinterpret_cast<T*>(pipe.res(j));
          bar_expect(pipe.rfull(j), C::kTile);
          tma_tile<D, kRows>(ks, &tk, pipe.rfull(j), h, k0, b);
          tma_tile<D, kRows>(ks + kRows * D, &tv, pipe.rfull(j), h,
                             k0, b);
        } else {
          bar_arrive(pipe.rfull(j));
        }
      } else {
        bar_arrive(pipe.rfull(j));
      }
      for (int c0 = 0; c0 < n; c0 += 32) {
        int idx = 0;
        unsigned long long bits = 0;
        if (c0 + lane < n) {
          idx = lut.idx[at * lut.len + t0 + c0 + lane];
          bits = lut.bits[at * lut.len + t0 + c0 + lane];
        }
        const int m = min(32, n - c0);
        for (int t = 0; t < m; ++t, ++g) {
          const int qt = __shfl_sync(kFull, idx, t);
          const unsigned long long fb = __shfl_sync(kFull, bits, t);
          RowStats rows;
          rows.load(lse, delta, stat0, qt * kRows, S, lane);
          if (g >= kStages) bar_wait(pipe.empty(g), ((g / kStages) & 1) ^ 1);
          Side* ss = pipe.sside(g);
          rows.store(ss, lane);
          if (lane == 0) {
            ss->tile = qt;
            ss->bits = fb;
            ss->masked = (kCausal && qt == kt) || fb != all_live(lut.shift);
            ss->shift = lut.shift;
            T* qs = reinterpret_cast<T*>(pipe.stage(g));
            bar_expect(pipe.full(g), C::kTile);
            tma_tile<D, kRows>(qs, &tq, pipe.full(g), h, qt * kRows, b);
            tma_tile<D, kRows>(qs + kRows * D, &tdo, pipe.full(g), h,
                               qt * kRows, b);
          } else {
            bar_arrive(pipe.full(g));
          }
        }
      }
    }
    return;
  }

  // Each consumer warpgroup walks its pipeline's items, pipelined as
  // flash's dk/dv over steps (a query tile, or half of one for d >= 96):
  // step i's S^T = K Q^T and dP^T = V dO^T run with step i - 1's
  // dV += P^T dO and dK += dS^T Q, and step i's P and dS / scale are
  // computed meanwhile. Keys the padding mask drops get zero rows at the
  // store (a row of dK, dV depends only on its own key's scores), so only
  // the causal diagonal and partly live tile pairs take the mask's
  // instructions; queries past S and dead rows have lse +inf (p = 0).
  regs_up<kSpConsumerRegs>();
  const int wg = warp >> 2;
  const Pipe<D> pipe(base, wg);
  const float c2 = scale * kLog2e;
  const int w16 = (warp & 3) * 16;
  const int rl[2] = {w16 + (lane >> 2), w16 + (lane >> 2) + 8};  // keys
  const auto slot_wait = [&](int g) {
    bar_wait(pipe.full(g), (g / kStages) & 1);
  };
  float p[kM / 2], ds[kM / 2], dka[D / 2], dva[D / 2];
  uint32_t pa[kM / 16][4], da[kM / 16][4];
  int g = 0;
#pragma unroll 1
  for (int j = 0;; ++j) {
    const int w = pipe_round(j, wg);
    if (w >= n_work) break;
    bar_wait(pipe.rfull(j), (j / kRes) & 1);
    const Side* rs = pipe.rside(j);     // read again at the item's end
    const int n = rs->n;
    const T* kv = reinterpret_cast<const T*>(pipe.res(j));   // K, then V
    const auto q_tile = [&](int step) {
      return reinterpret_cast<const T*>(pipe.stage(g + step / kHalves));
    };
    // transposed scores of a step: rows are the warpgroup's keys, columns
    // the step's queries (one commit group)
    const auto scores = [&](int step) {
      const T* qs = q_tile(step);
      const T* dos = qs + kRows * D;
      const int r0 = (step % kHalves) * kM;
      const T* ks = anew(kv);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, kM>::ss(p, desc_k<kRows>(ks, 0, kk),
                         desc_k<kRows>(qs, r0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, kM>::ss(ds, desc_k<kRows>(ks + kRows * D, 0, kk),
                         desc_k<kRows>(dos, r0, kk), kk);
      wg_commit();
    };
    // P and dS / scale of a step
    const auto grad_scores = [&](int step) {
      const Side* ss = pipe.sside(g + step / kHalves);
      const int r0 = (step % kHalves) * kM;
      const float* ls = ss->lse + r0;
      const float* dl = ss->delta + r0;
      const auto body = [&](auto masked) {
        unsigned long long bits = 0;
        int q0 = 0, shift = 0;
        if constexpr (decltype(masked)::value) {
          bits = ss->bits;
          q0 = ss->tile * kRows;
          shift = ss->shift;
        }
#pragma unroll
        for (int e = 0; e < kM / 2; ++e) {
          const int c = acc_col(lane, e);
          float x = exp2_fast(fmaf(p[e], c2, -ls[c]));  // +inf lse: 0
          if constexpr (decltype(masked)::value) {
            const int key = rl[(e >> 1) & 1], cq = r0 + c;
            const bool seen =
                ((bits >> ((cq >> shift) * (kRows >> shift) + (key >> shift)))
                 & 1ull)
                && (!kCausal || q0 + cq >= rs->tile * kRows + key);
            if (!seen) x = 0.f;
          }
          p[e] = x;
          ds[e] = x * (ds[e] - dl[c]);          // dS / scale
        }
      };
      if (ss->masked) body(std::true_type{});
      else body(std::false_type{});
    };
    // dV += P^T dO and dK += dS^T Q of a step (one commit group)
    const auto grads = [&](int step) {
      const T* qs = q_tile(step);
      const T* dos = qs + kRows * D;
      const int j0 = (step % kHalves) * (kM / 16);
#pragma unroll
      for (int jj = 0; jj < kM / 16; ++jj)
        Wgmma<T, D>::rs(dva, pa[jj], desc_mn<kRows>(dos, j0 + jj), 1);
#pragma unroll
      for (int jj = 0; jj < kM / 16; ++jj)
        Wgmma<T, D>::rs(dka, da[jj], desc_mn<kRows>(qs, j0 + jj), 1);
      wg_commit();
    };
    // after step i's products: its stage is free once its last half is done
    const auto step_done = [&](int step) {
      if (step % kHalves == kHalves - 1)
        bar_release(pipe.empty(g + step / kHalves), lane);
    };
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dka[e] = dva[e] = 0.f;
    const int steps = n * kHalves;
    if (steps > 0) {
      slot_wait(g);
      fence_regs<D / 2>(dva);
      fence_regs<D / 2>(dka);
      wg_fence();
      scores(0);
      wg_wait();
      fence_regs<kM / 2>(p);
      fence_regs<kM / 2>(ds);
      grad_scores(0);
      to_a<T, kM>(pa, p);
      to_a<T, kM>(da, ds);
#pragma unroll 1
      for (int i = 1; i < steps; ++i) {
        if (i % kHalves == 0) slot_wait(g + i / kHalves);
        fence_regs<D / 2>(dva);
        fence_regs<D / 2>(dka);
        wg_fence();
        scores(i);
        grads(i - 1);
        wg_wait<1>();
        fence_regs<kM / 2>(p);
        fence_regs<kM / 2>(ds);
        grad_scores(i);
        wg_wait<0>();
        fence_regs<D / 2>(dva);
        fence_regs<D / 2>(dka);
        step_done(i - 1);
        to_a<T, kM>(pa, p);
        to_a<T, kM>(da, ds);
      }
      fence_regs<D / 2>(dva);
      fence_regs<D / 2>(dka);
      wg_fence();
      grads(steps - 1);
      wg_wait();
      fence_regs<D / 2>(dva);
      fence_regs<D / 2>(dka);
      step_done(steps - 1);
    }
    g += n;
    const int h = rs->h, b = rs->b, k0 = rs->tile * kRows;
    const int first = rs->first, rank = rs->rank, n_parts = rs->items;
    const unsigned long long kept = rs->keys;
    bar_release(pipe.rempty(j), lane);       // the item's last read of it
    if (first >= 0) {
      // A split key tile: its items' partials are summed up a binary tree
      // over their ranks. At level l the value of ranks [r0, r0 + 2^l)
      // meets that of [r0 + 2^l, r0 + 2^(l+1)) (if any): each half's
      // carrier writes it to the slot of its left-most rank and counts on
      // the node's ticket; the second to arrive reads the other half, adds
      // the halves and carries the sum up; the first leaves. A node's sum
      // does not depend on which half arrives second (IEEE addition
      // commutes), so dk and dv are bitwise reproducible, and no item reads
      // more than one partial a level (the tile's last item reading all of
      // them one after another took half the kernel's time).
      constexpr int kPart = 2 * kRows * D;
      const long long tile = (long long)b * work.parts + first;
      // this thread's two rows of a slot: value pairs (4 j + 2 r, + 1) of
      // the accumulators at columns 8 j + 2 (lane & 3), + 1 of row r
      const auto slot = [&](int rk, int r) {
        return work.ws + (tile + rk) * kPart + rl[r] * D + 2 * (lane & 3);
      };
      bool carry = true;
#pragma unroll 1
      for (int l = 0; (1 << l) < n_parts; ++l) {
        const int half = 1 << l, r0 = rank & ~(2 * half - 1);
        if (r0 + half >= n_parts) continue;        // no right half
        const bool left = (rank & half) == 0;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float* mine = slot(left ? r0 : r0 + half, r) + 8 * jj;
            __stcg(reinterpret_cast<float2*>(mine),
                   make_float2(dka[4 * jj + 2 * r], dka[4 * jj + 2 * r + 1]));
            __stcg(reinterpret_cast<float2*>(mine + kRows * D),
                   make_float2(dva[4 * jj + 2 * r], dva[4 * jj + 2 * r + 1]));
          }
        __threadfence();
        wg_sync(wg);
        if ((threadIdx.x & 127) == 0)
          last_flag[wg] =
              atomicAdd(work.tickets + (tile + r0) * kLevels + l, 1) == 1;
        wg_sync(wg);
        if (!last_flag[wg]) {
          carry = false;
          break;
        }
        __threadfence();
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float* other = slot(left ? r0 + half : r0, r) + 8 * jj;
            const float2 x = __ldcg(reinterpret_cast<const float2*>(other));
            const float2 y = __ldcg(
                reinterpret_cast<const float2*>(other + kRows * D));
            dka[4 * jj + 2 * r] += x.x;
            dka[4 * jj + 2 * r + 1] += x.y;
            dva[4 * jj + 2 * r] += y.x;
            dva[4 * jj + 2 * r + 1] += y.y;
          }
      }
      if (!carry) continue;
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e)
      if (!((kept >> rl[(e >> 1) & 1]) & 1ull)) dka[e] = dva[e] = 0.f;
    const int row[2] = {k0 + rl[0], k0 + rl[1]};
    const float one[2] = {1.f, 1.f}, sc[2] = {scale, scale};
    store_acc<T, D>(dk, dka, b, row, h, S, H, sc, lane);   // dS / scale
    store_acc<T, D>(dv, dva, b, row, h, S, H, one, lane);
  }
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
                         work.tickets + at0 * kLevels, dkr, dvr, at_i))
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
                         Lut lut, const int* items, int n_items,
                         const float* kvm, int B, int S, int H, float scale,
                         cudaStream_t stream) {
    if constexpr (sizeof(T) == 2) {
      CUtensorMap m[4];
      const void* ptrs[4] = {q, k, v, dout};
      const int rows[4] = {kRows, kRows, kRows, kRows};
      if (!tile_maps<T>(m, ptrs, rows, 4, st, B, S, H, D))
        return cudaErrorInvalidValue;
      const int blocks = std::min((n_items * B + kPipes - 1) / kPipes,
                                  sm_count());
      return launch(sparse_bwd_dq_wgmma_kernel<T, D, C>, dim3(blocks),
                    kHopperThreads, BwdTile<D>::kSmem, stream, m[0], m[1],
                    m[2], m[3], lut, items, n_items, kvm, lse, delta,
                    as<T>(dq), B, S, H, scale);
    } else {
      return launch(sparse_bwd_dq_f32_kernel<D, C>, grid_of(B, S, H),
                    BwdSplit<D>::kThreads, f32_smem<D>(2, 1), stream,
                    as<T>(q), as<T>(k), as<T>(v), as<T>(dout),
                    strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
                    strides_at(st, 3), lut, kvm, lse, delta, as<T>(dq), S, H,
                    scale);
    }
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
    if constexpr (sizeof(T) == 2) {
      CUtensorMap m[4];
      const void* ptrs[4] = {q, k, v, dout};
      const int rows[4] = {kRows, kRows, kRows, kRows};
      if (!tile_maps<T>(m, ptrs, rows, 4, st, B, S, H, D))
        return cudaErrorInvalidValue;
      const int blocks = std::min((n_items * B + kPipes - 1) / kPipes,
                                  sm_count());
      return launch(sparse_bwd_dkv_wgmma_kernel<T, D, C>, dim3(blocks),
                    kHopperThreads, BwdTile<D>::kSmem, stream, m[0], m[1],
                    m[2], m[3], lut, work, n_items, kvm, lse, delta,
                    as<T>(dk), as<T>(dv), B, S, H, scale);
    } else {
      return launch(sparse_bwd_dkv_f32_kernel<D, C>, dim3(n_items, B),
                    BwdSplit<D>::kThreads, f32_smem<D>(2, 2), stream,
                    as<T>(q), as<T>(k), as<T>(v), as<T>(dout),
                    strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
                    strides_at(st, 3), lut, work, kvm, lse, delta, as<T>(dk),
                    as<T>(dv), S, H, scale);
    }
  }
};

// the mask of a tile pair has 64 bits: a fine block of at least 8 rows
bool bad_lut(int len, int shift) { return len < 1 || shift < 3 || shift > 6; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; d in {32, 64, 96, 128}.
// `strides` is a host array of (batch, seq, head) element strides: q, k, v
// for the forward; q, k, v, dO for the backward. lut_idx / lut_cnt / lut_bits are device
// arrays [H, tiles, lut_len] / [H, tiles] / [H, tiles, lut_len]: the row LUT
// for the forward and dq, the column LUT for dk/dv. kvm: the f32 [B, S]
// key-padding mask (> 0 attends) or null. The dq kernel also takes its work
// list ([n_items, 2] int32: head, query tile; longest LUT rows first), the
// dk/dv kernel its work items ([n_items, 7] int32, see Work) and, when
// parts > 0, the workspace and the zeroed tickets ([B, parts, kLevels];
// the f32 dq kernel reads no list). 16-bit strides are multiples of 8 elements and the pointers
// 16-byte aligned (the tensor maps). Returns a cudaError_t (0 on success).
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
                                     const int* items, int n_items,
                                     const float* kvm, int B, int S, int H,
                                     int d, int causal, float scale,
                                     int dtype, void* stream) {
  if (bad_shape(B, S, H) || bad_lut(lut_len, shift) || n_items < 1)
    return (int)cudaErrorInvalidValue;
  const Lut lut{lut_idx, lut_cnt, lut_bits, lut_len, shift};
  return (int)dispatch<Dq>(dtype, d, causal, q, k, v, dout, lse, delta, dq,
                           strides, lut, items, n_items, kvm, B, S, H, scale,
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
