// Tile building blocks of the block-sparse attention kernels for Hopper
// (sm_90a), sparse_attention.cu (B5, B5b); the f32 parts also serve the f32
// flash kernels of flash_attention.cu (whose 16-bit kernels are wgmma
// kernels of their own):
//
//   * bf16 / fp16: mma.sync m16n8k16 fragments (16-bit in, f32 accumulate),
//     tiles of kRows rows staged in shared memory with rows padded by 16
//     bytes, the 16 x kRows score tile of a warp kept as accumulators;
//   * f32: CUDA-core FMAs over rows split among neighbouring threads;
//   * launch helpers (dynamic shared memory opt-in, strides, typed pointers).
//
// Everything is in an anonymous namespace: each source that includes this
// header gets its own copy, and only the sources' extern "C" functions are
// exported.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;           // rows of a query tile and of a key tile
constexpr float kNegInf = -1e30f;   // the TPU kernels' initial running max
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, s, h;                // in elements; channel stride is 1
};

// ===========================================================================
// bf16 / fp16: tensor cores (mma.sync m16n8k16)
// ===========================================================================
using bf16 = __nv_bfloat16;
using f16 = __half;
constexpr int kWarps = 4;           // 16 rows each
constexpr int kTcThreads = 32 * kWarps;

// c += a b: a 16x16 (row), b 16x8 (col), c 16x8 f32. Fragments (lane =
// 4 g + t): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8,
// 2t+8..); b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g); c0-1 (g, 2t..2t+1),
// c2-3 (g+8, 2t..2t+1). T (bf16 or fp16) is the type of a and b.
template <typename T>
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b);
template <>
__device__ __forceinline__ void mma<bf16>(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma<f16>(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__device__ __forceinline__ uint32_t lds32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats rounded to T (round to nearest even), packed lo | hi << 16
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack<bf16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack<f16>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A operand: rows row0.., depth k0.. of a row-major tile x[row][k]
template <typename T>
__device__ __forceinline__ void frag_a(uint32_t* a, const T* x, int ld,
                                       int row0, int k0, int lane) {
  const T* p = x + (row0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// B operand: columns n0..n0+7, depth k0.. of y^T, y stored [n][k]
template <typename T>
__device__ __forceinline__ void frag_b(uint32_t* b, const T* y, int ld,
                                       int n0, int k0, int lane) {
  const T* p = y + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b[0] = lds32(p);
  b[1] = lds32(p + 8);
}

// B operands of two 8-column tiles (n0.., n0+8..), depth k0..k0+15, of z
// stored [k][n]: b[0..1] for columns n0.., b[2..3] for n0+8..
template <typename T>
__device__ __forceinline__ void frag_b_trans(uint32_t* b, const T* z,
                                             int ld, int k0, int n0,
                                             int lane) {
  const int mat = lane >> 3;
  const T* p = z + (k0 + (lane & 7) + (mat & 1) * 8) * ld + n0
               + (mat >> 1) * 8;
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// Rows r0 .. r0+kRows-1 of one head of a 16-bit tensor into shared memory
// [kRows][D + 8], zeros past S.
template <int D, typename T>
__device__ __forceinline__ void stage16(T* dst, const T* base, Strides st,
                                        int b, int h, int r0, int S) {
  constexpr int kPerRow = D / 8;    // 16-byte words
  for (int idx = threadIdx.x; idx < kRows * kPerRow; idx += blockDim.x) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * 8;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      w = *reinterpret_cast<const uint4*>(
          base + b * st.b + (long long)(r0 + r) * st.s + h * st.h + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = w;
  }
}

// c[N][4] = x[rows] y^T over depth D: x rows from row0, y rows 0..8N-1
template <typename T, int D, int N>
__device__ __forceinline__ void tile_qkt(float (*c)[4], const T* x,
                                         const T* y, int row0, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    frag_a(a, x, LD, row0, kk * 16, lane);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      uint32_t bb[2];
      frag_b(bb, y, LD, n * 8, kk * 16, lane);
      mma<T>(c[n], a, bb);
    }
  }
}

// acc[D/8][4] += w z, w the 16 x kRows register tile (as mma accumulators,
// rounded to T), z a [kRows][D] shared tile
template <typename T, int D>
__device__ __forceinline__ void tile_pv(float (*acc)[4], float (*w)[4],
                                        const T* z, int lane) {
#pragma unroll
  for (int j = 0; j < kRows / 16; ++j) {
    const uint32_t a[4] = {pack<T>(w[2 * j][0], w[2 * j][1]),
                           pack<T>(w[2 * j][2], w[2 * j][3]),
                           pack<T>(w[2 * j + 1][0], w[2 * j + 1][1]),
                           pack<T>(w[2 * j + 1][2], w[2 * j + 1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bb[4];
      frag_b_trans(bb, z, D + 8, j * 16, np * 16, lane);
      mma<T>(acc[2 * np], a, bb);
      mma<T>(acc[2 * np + 1], a, bb + 2);
    }
  }
}

// the thread's two rows (g, g+8) of a 16 x D accumulator into a contiguous
// [B, S, H, D] 16-bit tensor, times inv[row]
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, float (*acc)[4], int b,
                                           int row0, int h, int S, int H,
                                           const float* inv, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + (lane >> 2) + 8 * i;
    if (row >= S) continue;
    T* p = base + (((long long)b * S + row) * H + h) * D + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(p + n * 8) =
          pack<T>(acc[n][2 * i] * inv[i], acc[n][2 * i + 1] * inv[i]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// ===========================================================================
// f32: CUDA-core FMAs
// ===========================================================================
constexpr int kFwdGroup = 16;       // keys scored per softmax rescale
constexpr int kBwdGroup = 8;        // keys (dq) / query rows (dk, dv) per step

// How a row of D channels is split over threads: each owns CH channels,
// and the threads of a row are a power of two (the shuffle sums). The
// forward takes 32; the backward kernels hold three or four row vectors, so
// they take 16 up to D = 64 (registers limit them). D = 96 takes 24 in both
// (4 threads a row).
template <int D, int CH>
struct Split {
  static constexpr int kD = D;
  static constexpr int kCh = CH;
  static constexpr int kTpr = D / CH;       // threads per row
  static constexpr int kChunks = CH / 4;    // 4-channel chunks per thread
  static constexpr int kThreads = kRows * kTpr;
};
template <int D>
using FwdSplit = Split<D, (D == 96 ? 24 : 32)>;
template <int D>
using BwdSplit = Split<D, (D == 96 ? 24 : D <= 64 ? 16 : 32)>;

// first channel of chunk i of the thread that is part `part` of its row
template <class SP>
__device__ __forceinline__ int chan(int part, int i) {
  return 4 * (part + SP::kTpr * i);
}

// This thread's channels of a row into registers (zeros past S).
template <class SP>
__device__ __forceinline__ void load_row(const float* base, Strides st, int b,
                                         int s, int h, int S, int part,
                                         float* out) {
#pragma unroll
  for (int i = 0; i < SP::kChunks; ++i) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S)
      x = *reinterpret_cast<const float4*>(
          base + b * st.b + s * st.s + h * st.h + chan<SP>(part, i));
    out[4 * i] = x.x; out[4 * i + 1] = x.y;
    out[4 * i + 2] = x.z; out[4 * i + 3] = x.w;
  }
}

template <class SP>
__device__ __forceinline__ void store_row(float* base, int b, int s, int h,
                                          int S, int H, int part,
                                          const float* v) {
  float* p = base + (((long long)b * S + s) * H + h) * SP::kD;
#pragma unroll
  for (int i = 0; i < SP::kChunks; ++i)
    *reinterpret_cast<float4*>(p + chan<SP>(part, i)) =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// Rows r0 .. r0+kRows-1 of one head into shared memory [kRows][D], zeros
// past S.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* base,
                                          Strides st, int b, int h, int r0,
                                          int S) {
  constexpr int kPerRow = D / 4;
  for (int idx = threadIdx.x; idx < kRows * kPerRow; idx += blockDim.x) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      x = *reinterpret_cast<const float4*>(
          base + b * st.b + (long long)(r0 + r) * st.s + h * st.h + c);
    *reinterpret_cast<float4*>(dst + r * D + c) = x;
  }
}

// this thread's part of dot(row registers, staged row)
template <class SP>
__device__ __forceinline__ float part_dot(const float* reg, const float* row,
                                          int part) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < SP::kChunks; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(row + chan<SP>(part, i));
    acc = fmaf(reg[4 * i], x.x, acc);
    acc = fmaf(reg[4 * i + 1], x.y, acc);
    acc = fmaf(reg[4 * i + 2], x.z, acc);
    acc = fmaf(reg[4 * i + 3], x.w, acc);
  }
  return acc;
}

// reg += w * staged row (this thread's channels)
template <class SP>
__device__ __forceinline__ void axpy_row(float* reg, float w, const float* row,
                                         int part) {
#pragma unroll
  for (int i = 0; i < SP::kChunks; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(row + chan<SP>(part, i));
    reg[4 * i] = fmaf(w, x.x, reg[4 * i]);
    reg[4 * i + 1] = fmaf(w, x.y, reg[4 * i + 1]);
    reg[4 * i + 2] = fmaf(w, x.z, reg[4 * i + 2]);
    reg[4 * i + 3] = fmaf(w, x.w, reg[4 * i + 3]);
  }
}

// sum over the TPR neighbouring lanes that share a row
template <int TPR, int N>
__device__ __forceinline__ void row_sum(float* v) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) {
#pragma unroll
    for (int u = 0; u < N; ++u) v[u] += __shfl_xor_sync(kFull, v[u], o);
  }
}

// ===========================================================================
// Launch helpers
// ===========================================================================
// Launch `kernel` on `stream` (dynamic shared memory above 48 KB is opted
// into first); returns the launch's error.
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

dim3 grid_of(int B, int S, int H) {
  return dim3((S + kRows - 1) / kRows, H, B);
}

// 16-bit shared memory: `tiles` [kRows][D + 8] tiles plus `stats` f32 rows
template <int D>
constexpr size_t tc_smem(int tiles, int stats) {
  return tiles * kRows * (D + 8) * 2 + stats * kRows * sizeof(float);
}

// f32 shared memory: `tiles` [kRows][D] tiles plus `stats` f32 rows
template <int D>
constexpr size_t f32_smem(int tiles, int stats) {
  return (tiles * kRows * D + stats * kRows) * sizeof(float);
}

// One launcher per kernel and element type T (bf16 / fp16: tensor cores,
// float: CUDA cores); the pointers arrive untyped from the C interface.
template <typename T>
const T* as(const void* p) { return static_cast<const T*>(p); }
template <typename T>
T* as(void* p) { return static_cast<T*>(p); }

// The element types of the C interfaces: 0 = float32, 1 = bfloat16,
// 2 = float16; the head dims: 32, 64, 96, 128.
// Calls F<T, D, causal>::run(args...) for the runtime dtype / D / causal.
template <template <typename, int, bool> class F, typename... Args>
cudaError_t dispatch(int dtype, int d, int causal, Args... args) {
#define DSTORCH_ATTENTION_CASE(T, D)                                  \
  if (d == D)                                                         \
    return causal ? F<T, D, true>::run(args...)                       \
                  : F<T, D, false>::run(args...);
#define DSTORCH_ATTENTION_DTYPE(T)                                    \
  DSTORCH_ATTENTION_CASE(T, 32)                                       \
  DSTORCH_ATTENTION_CASE(T, 64)                                       \
  DSTORCH_ATTENTION_CASE(T, 96)                                       \
  DSTORCH_ATTENTION_CASE(T, 128)
  if (dtype == 0) {
    DSTORCH_ATTENTION_DTYPE(float)
  } else if (dtype == 1) {
    DSTORCH_ATTENTION_DTYPE(bf16)
  } else if (dtype == 2) {
    DSTORCH_ATTENTION_DTYPE(f16)
  }
#undef DSTORCH_ATTENTION_DTYPE
#undef DSTORCH_ATTENTION_CASE
  return cudaErrorInvalidValue;
}

bool bad_shape(int B, int S, int H) { return B < 1 || S < 1 || H < 1; }

}  // namespace
