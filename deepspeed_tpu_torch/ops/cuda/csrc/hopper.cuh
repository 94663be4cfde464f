// Hopper (sm_90a) building blocks shared by the wgmma attention kernels of
// flash_attention.cu (B1, B1b) and sparse_attention.cu (B5, B5b):
//
//   * mbarriers (init, expect_tx, arrive, a parity wait that traps after
//     10 s instead of hanging the card), TMA tensor-map loads of 32-column
//     panels, wgmma matrix descriptors of 64-byte-swizzled tiles, the
//     wgmma fences, setmaxnreg, exp2 on the special-function unit, the
//     m64 accumulator's column map, its A fragments and its store, and the
//     forwards' online softmax over one key tile's accumulators;
//   * the host side: cuTensorMapEncodeTiled (fetched through the runtime,
//     so no -lcuda), the 4-D (d, H, S, B) tile maps read through the
//     caller's strides, and the SM count of the current device.
//
// Everything is in an anonymous namespace: each source that includes this
// header gets its own copy.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums (header only: no -lcuda)

#include <type_traits>

#include "attention_tiles.cuh"
#include "wgmma.cuh"

namespace {

// ===========================================================================
// Hopper primitives: mbarriers, TMA, wgmma descriptors and fences
// ===========================================================================
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kPanel = 32;                 // columns of a 64-byte panel row
constexpr int kConsumerWarps = 8;          // two warpgroups
// + the producer warpgroup: one of its warps works, but setmaxnreg moves
// registers between whole warpgroups of the block
constexpr int kHopperThreads = 32 * (kConsumerWarps + 4);

// The 16-bit flash and sparse kernels' head dim for a true head dim D:
// d = 80 (GPT 2.7B's 2560 / 32) is not a whole number of 32-column panels,
// so it runs the d = 96 kernels. The tensor maps keep D = 80 as their inner
// extent, so TMA fills columns 80-95 of the third panel with zeros: Q K^T
// gains nothing from them, P V, dQ, dK and dV compute those columns as
// zeros, and the stores write only the first 80 (the kernels' DO).
template <int D>
constexpr int kWgmmaD = D == 80 ? 96 : D;

// Registers a thread after the roles split in the flash kernels: the
// launch gives each of the 12 warps 168 (65536 / 384); the producer
// warpgroup hands back all but 24 to the block's pool and the consumers
// take 240 from it (4 x 32 x 144 = 8 x 32 x 72 registers move).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int N>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
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

// one box (32 channels from c, one head, `rows` rows from s, one batch row)
// of a (d, H, S, B) tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c), "r"(h), "r"(s), "r"(b)
      : "memory");
}

// `rows` rows of all D channels: D / kCols boxes into consecutive panels
// (kCols: the panel's columns, 32 with the 64-byte swizzle, 64 with the
// 128-byte one; the tensor map's box and swizzle match it)
template <int D, int kRowsIn, int kCols = kPanel>
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int s, int b) {
#pragma unroll
  for (int c = 0; c < D / kCols; ++c)
    tma_load(static_cast<char*>(dst) + c * kRowsIn * kCols * 2, map, bar,
             c * kCols, h, s, b);
}

// wgmma matrix descriptor of a swizzled operand in panels of kCols columns
// (64-byte swizzle for 32, 128-byte for 64): start address, leading byte
// offset (MN-major: from one panel to the next), stride byte offset (from
// 8 rows to the next 8: 8 panel rows), layout
template <int kCols = kPanel>
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo) {
  static_assert(kCols == 32 || kCols == 64, "a panel is 64 or 128 bytes");
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(8 * kCols * 2 >> 4) << 32)
         | ((kCols == 64 ? 1ull : 2ull) << 62);
}

// K-major operand: rows from `row` of a tile of kRowsIn rows, depth slice kk
// (16 channels) of its panels
template <int kRowsIn, int kCols = kPanel, typename T>
__device__ __forceinline__ uint64_t desc_k(const T* tile, int row, int kk) {
  constexpr int kSlices = kCols / 16;          // depth slices a panel
  return desc<kCols>(tile + (kk / kSlices) * kRowsIn * kCols + row * kCols
                     + (kk % kSlices) * 16, 16);
}

// MN-major operand: depth slice j (rows 16 j ..) of a tile of kRowsIn rows,
// its columns across the panels
template <int kRowsIn, int kCols = kPanel, typename T>
__device__ __forceinline__ uint64_t desc_mn(const T* tile, int j) {
  return desc<kCols>(tile + j * 16 * kCols, kRowsIn * kCols * 2);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are still running
// (groups complete in order)
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma (issue .. wait)
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The work tile of this block's round j in a persistent kernel: rounds
// alternate direction over the blocks, so a list sorted longest first
// spreads evenly over them (each block's j-th tile is the same in its
// producer and its consumers).
__device__ __forceinline__ int snake(int j) {
  return j * gridDim.x + ((j & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// column of accumulator value i (its row is g + 8 * ((i >> 1) & 1))
__device__ __forceinline__ int acc_col(int lane, int i) {
  return (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
}

// The online softmax of one key tile's scores s (this thread's values of
// its two rows of an m64 x kN accumulator), in place: s becomes p =
// 2^(s c2 - m) in f32, m (log2 units, from -1e30) and the thread's partial
// l are updated, corr is the factor the running output takes. One FFMA and
// one exp2 a score: the row max is taken over the raw scores (over -s when
// c2 < 0, kPos false) and scaled once. kMasked: `hidden(e)` says whether
// value e is masked (p = 0, out of the max); the other tiles take a path
// without the mask's instructions. A row masked in the whole tile keeps
// its m and l (-inf * |c2|, or NaN at c2 = 0, loses to m in fmaxf), so a
// row that sees nothing ends with m = -1e30 and l = 0.
template <int kN, bool kMasked, bool kPos, class Hidden>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l,
                                             float* corr, float c2,
                                             Hidden hidden) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) {
    const float x = kMasked && hidden(e) ? -INFINITY : kPos ? s[e] : -s[e];
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]) * (kPos ? c2 : -c2));
    corr[r] = exp2_fast(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) {
    float p = exp2_fast(fmaf(s[e], c2, -m[(e >> 1) & 1]));
    if (kMasked && hidden(e)) p = 0.f;
    s[e] = p;
    l[(e >> 1) & 1] += p;
  }
}

// the A fragments of a 64 x N accumulator (k16 slices), rounded to T
template <typename T, int N>
__device__ __forceinline__ void to_a(uint32_t (*a)[4], const float* d) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[j][r] = pack<T>(d[8 * j + 2 * r], d[8 * j + 2 * r + 1]);
}

// the thread's two rows of the first D columns of a 64 x D' accumulator
// (D' >= D) into a contiguous [B, S, H, D] tensor, times inv[row]
template <typename T, int D>
__device__ __forceinline__ void store_acc(T* base, const float* d, int b,
                                          const int* row, int h, int S, int H,
                                          const float* inv, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    T* p = base + (((long long)b * S + row[i]) * H + h) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          pack<T>(d[4 * j + 2 * i] * inv[i], d[4 * j + 2 * i + 1] * inv[i]);
  }
}

// Shared memory of a Hopper kernel: two buffers of its `resident` tiles
// (the next work tile's load during this one's end), `stages` ring stages
// of `stage` bytes, the barriers (full and empty per stage and per
// resident buffer), and slack to align the tiles to 1024 bytes (the
// swizzle repeats every 512).
constexpr size_t hopper_smem(int resident, int stage, int stages) {
  return 1024 + 2 * resident + stages * stage + 8 * (2 * stages + 4);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// ===========================================================================
// Host side: tensor maps, SM count
// ===========================================================================
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

// The tensor map of a [B, S, H, D] 16-bit tensor read through its element
// strides, as 4-D (D, H, S, B) boxes of `cols` channels (32: 64-byte
// swizzle, 64: 128-byte) x 1 head x `rows` rows x 1 batch row; rows past S
// (and any coordinate out of range) arrive as zeros. A dimension of extent
// 1 gets a packed stride (its own may be anything). False if the map is
// refused.
bool tile_map(CUtensorMap* map, const void* ptr, Strides st, int B, int S,
              int H, int D, int rows, CUtensorMapDataType type,
              int cols = kPanel) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const long long sh = H > 1 ? st.h : D;
  const long long ss = S > 1 ? st.s : sh * H;
  const long long sb = B > 1 ? st.b : ss * S;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, f16>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// maps of q, k, v (, dO): `rows` of each from the kernel's tile sizes,
// panels of `cols` channels
template <typename T>
bool tile_maps(CUtensorMap* maps, const void* const* ptrs, const int* rows,
               int n, const long long* st, int B, int S, int H, int D,
               int cols = kPanel) {
  for (int i = 0; i < n; ++i)
    if (!tile_map(&maps[i], ptrs[i], strides_at(st, i), B, S, H, D, rows[i],
                  map_type<T>(), cols))
      return false;
  return true;
}

// the current device's SMs: one persistent block each
int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  return cached[dev] > 0 ? cached[dev] : 1;
}

}  // namespace
