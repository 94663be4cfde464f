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
// [B, H, S] f32. Any S >= 1: tail tiles are zero-filled and masked.
//
// Bound: at the training shape (S=1024, D=64, causal, bf16) attention does
// 250-340 flops per byte it must move, around the card's bf16 balance
// (~295): bytes bound the forward, the products the two backward kernels.
// Only the tensor cores come near either bound. The TPU kernels' 1024x1024
// VMEM tiles have no counterpart here. Two families:
//   * bf16 (the training path): tensor cores through mma.sync m16n8k16
//     (bf16 in, f32 accumulate). One block of 4 warps per (64-row tile,
//     head, batch row); the tiles are staged in shared memory as bf16 with
//     rows padded by 16 bytes (conflict-free fragment loads). Each warp owns
//     16 rows of the tile: the forward and dq kernels 16 query rows against
//     a 64-key tile, the dk/dv kernel 16 key rows against a 64-query tile.
//     Score tiles stay in registers as mma accumulators; p and ds are
//     rounded to bf16 to feed the next product (the accumulator layout of
//     two 8-column tiles is the A operand layout of a 16-deep product).
//     The TPU kernels keep p.v in f32; the tests bound the difference.
//   * f32: CUDA-core FMAs (exact f32 products, so they agree with the plain
//     version to summation order). A row is owned by D/32 neighbouring
//     threads (the backward: D/16 up to D = 64), each holding 32 (16) of
//     its channels in registers in interleaved 4-channel chunks; K/V (or
//     Q/dO) tiles are staged as f32; partial dots are summed with shuffles.
// Both: online softmax in f32, causal tiles above the diagonal skipped by
// all three kernels at the same absolute positions, dk/dv accumulated in
// f32 until the final store, the longest causal tiles launched first.
// cp.async / TMA staging and wgmma tiles are later work.
//
// Plain C interface (no PyTorch headers), bound with ctypes by
// deepspeed_tpu_torch/ops/cuda/flash_attention.py.

#include <cuda_bf16.h>
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
// bf16: tensor cores (mma.sync m16n8k16)
// ===========================================================================
using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;           // 16 rows each
constexpr int kTcThreads = 32 * kWarps;

// c += a b: a 16x16 (row), b 16x8 (col), c 16x8 f32. Fragments (lane =
// 4 g + t): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8,
// 2t+8..); b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g); c0-1 (g, 2t..2t+1),
// c2-3 (g+8, 2t..2t+1).
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A operand: rows row0.., depth k0.. of a row-major tile x[row][k]
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* x, int ld,
                                       int row0, int k0, int lane) {
  const bf16* p = x + (row0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// B operand: columns n0..n0+7, depth k0.. of y^T, y stored [n][k]
__device__ __forceinline__ void frag_b(uint32_t* b, const bf16* y, int ld,
                                       int n0, int k0, int lane) {
  const bf16* p = y + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b[0] = lds32(p);
  b[1] = lds32(p + 8);
}

// B operands of two 8-column tiles (n0.., n0+8..), depth k0..k0+15, of z
// stored [k][n]: b[0..1] for columns n0.., b[2..3] for n0+8..
__device__ __forceinline__ void frag_b_trans(uint32_t* b, const bf16* z,
                                             int ld, int k0, int n0,
                                             int lane) {
  const int mat = lane >> 3;
  const bf16* p = z + (k0 + (lane & 7) + (mat & 1) * 8) * ld + n0
                  + (mat >> 1) * 8;
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// Rows r0 .. r0+kRows-1 of one head into shared memory [kRows][D + 8],
// zeros past S.
template <int D>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* base,
                                           Strides st, int b, int h, int r0,
                                           int S) {
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
template <int D, int N>
__device__ __forceinline__ void tile_qkt(float (*c)[4], const bf16* x,
                                         const bf16* y, int row0, int lane) {
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
      mma(c[n], a, bb);
    }
  }
}

// acc[D/8][4] += w z, w the 16 x kRows register tile (as mma accumulators,
// rounded to bf16), z a [kRows][D] shared tile
template <int D>
__device__ __forceinline__ void tile_pv(float (*acc)[4], float (*w)[4],
                                        const bf16* z, int lane) {
#pragma unroll
  for (int j = 0; j < kRows / 16; ++j) {
    const uint32_t a[4] = {pack(w[2 * j][0], w[2 * j][1]),
                           pack(w[2 * j][2], w[2 * j][3]),
                           pack(w[2 * j + 1][0], w[2 * j + 1][1]),
                           pack(w[2 * j + 1][2], w[2 * j + 1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bb[4];
      frag_b_trans(bb, z, D + 8, j * 16, np * 16, lane);
      mma(acc[2 * np], a, bb);
      mma(acc[2 * np + 1], a, bb + 2);
    }
  }
}

// the thread's two rows (g, g+8) of a 16 x D accumulator into a contiguous
// [B, S, H, D] bf16 tensor, times inv[row]
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, float (*acc)[4],
                                           int b, int row0, int h, int S,
                                           int H, const float* inv,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + (lane >> 2) + 8 * i;
    if (row >= S) continue;
    bf16* p = base + (((long long)b * S + row) * H + h) * D + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(p + n * 8) =
          pack(acc[n][2 * i] * inv[i], acc[n][2 * i + 1] * inv[i]);
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

template <int D, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, Strides sq, Strides sk,
                    Strides sv, bf16* __restrict__ out,
                    float* __restrict__ lse, int S, int H, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kRows * LD;
  bf16* vs = ks + kRows * LD;
  const int nt = (S + kRows - 1) / kRows;
  const int qt = nt - 1 - blockIdx.x;         // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * 16;
  const int q0 = qt * kRows;
  const int qrow[2] = {q0 + row0 + (lane >> 2), q0 + row0 + (lane >> 2) + 8};

  stage_bf16<D>(qs, q, sq, b, h, q0, S);
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int kt_last = kCausal ? qt : nt - 1;
#pragma unroll 1
  for (int kt = 0; kt <= kt_last; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();
    stage_bf16<D>(ks, k, sk, b, h, k0, S);
    stage_bf16<D>(vs, v, sv, b, h, k0, S);
    __syncthreads();
    float s[kRows / 8][4];
    tile_qkt<D, kRows / 8>(s, qs, ks, row0, lane);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
        const bool seen = key < S && (!kCausal || key <= qrow[e >> 1]);
        s[n][e] = seen ? s[n][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
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
    tile_pv<D>(o, s, vs, lane);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    inv[i] = 1.f / l_safe;
    if ((lane & 3) == 0 && qrow[i] < S)
      lse[((long long)b * H + h) * S + qrow[i]] = m[i] + logf(l_safe);
  }
  store_rows<D>(out, o, b, q0 + row0, h, S, H, inv, lane);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout, Strides sq, Strides sk,
                       Strides sv, Strides sdo, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int S, int H, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kRows * LD;
  bf16* ks = dos + kRows * LD;
  bf16* vs = ks + kRows * LD;
  const int nt = (S + kRows - 1) / kRows;
  const int qt = nt - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * 16;
  const int q0 = qt * kRows;
  const int qrow[2] = {q0 + row0 + (lane >> 2), q0 + row0 + (lane >> 2) + 8};
  float L[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = ((long long)b * H + h) * S + qrow[i];
    L[i] = qrow[i] < S ? lse[at] : 0.f;
    dl[i] = qrow[i] < S ? delta[at] : 0.f;
  }

  stage_bf16<D>(qs, q, sq, b, h, q0, S);
  stage_bf16<D>(dos, dout, sdo, b, h, q0, S);
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int kt_last = kCausal ? qt : nt - 1;
#pragma unroll 1
  for (int kt = 0; kt <= kt_last; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();
    stage_bf16<D>(ks, k, sk, b, h, k0, S);
    stage_bf16<D>(vs, v, sv, b, h, k0, S);
    __syncthreads();
    float s[kRows / 8][4], dp[kRows / 8][4];
    tile_qkt<D, kRows / 8>(s, qs, ks, row0, lane);
    tile_qkt<D, kRows / 8>(dp, dos, vs, row0, lane);
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
        const bool seen = key < S && (!kCausal || key <= qrow[e >> 1]);
        const float p = seen ? expf(s[n][e] * scale - L[e >> 1]) : 0.f;
        s[n][e] = p * (dp[n][e] - dl[e >> 1]) * scale;     // ds
      }
    tile_pv<D>(acc, s, ks, lane);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq, acc, b, q0 + row0, h, S, H, one, lane);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout, Strides sq,
                        Strides sk, Strides sv, Strides sdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                        int H, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kRows * LD;
  bf16* qs = vs + kRows * LD;
  bf16* dos = qs + kRows * LD;
  float* lses = reinterpret_cast<float*>(dos + kRows * LD);   // [kRows]
  float* dels = lses + kRows;                                  // [kRows]
  const int nt = (S + kRows - 1) / kRows;
  const int kt = blockIdx.x;                  // the longest (causal) first
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * 16;
  const int k0 = kt * kRows;
  const int krow[2] = {k0 + row0 + (lane >> 2), k0 + row0 + (lane >> 2) + 8};
  const long long stat0 = ((long long)b * H + h) * S;

  stage_bf16<D>(ks, k, sk, b, h, k0, S);
  stage_bf16<D>(vs, v, sv, b, h, k0, S);
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

#pragma unroll 1
  for (int qt = kCausal ? kt : 0; qt < nt; ++qt) {   // tiles below the diagonal
    const int q0 = qt * kRows;
    __syncthreads();
    stage_bf16<D>(qs, q, sq, b, h, q0, S);
    stage_bf16<D>(dos, dout, sdo, b, h, q0, S);
    for (int i = threadIdx.x; i < kRows; i += blockDim.x) {
      const bool in = q0 + i < S;
      lses[i] = in ? lse[stat0 + q0 + i] : 0.f;
      dels[i] = in ? delta[stat0 + q0 + i] : 0.f;
    }
    __syncthreads();
    // transposed scores: rows are this warp's keys, columns the tile's
    // queries
    float p[kRows / 8][4], ds[kRows / 8][4];
    tile_qkt<D, kRows / 8>(p, ks, qs, row0, lane);
    tile_qkt<D, kRows / 8>(ds, vs, dos, row0, lane);
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * (lane & 3) + (e & 1);
        const bool seen = q0 + col < S
                          && (!kCausal || q0 + col >= krow[e >> 1]);
        p[n][e] = seen ? expf(p[n][e] * scale - lses[col]) : 0.f;
        ds[n][e] = p[n][e] * (ds[n][e] - dels[col]) * scale;
      }
    tile_pv<D>(dva, p, dos, lane);
    tile_pv<D>(dka, ds, qs, lane);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk, dka, b, k0 + row0, h, S, H, one, lane);
  store_rows<D>(dv, dva, b, k0 + row0, h, S, H, one, lane);
}

// ===========================================================================
// f32: CUDA-core FMAs
// ===========================================================================
constexpr int kFwdGroup = 16;       // keys scored per softmax rescale
constexpr int kBwdGroup = 8;        // keys (dq) / query rows (dk, dv) per step

// How a row of D channels is split over threads: each owns CH channels.
// The forward takes 32; the backward kernels hold three or four row
// vectors, so they take 16 up to D = 64 (registers limit them).
template <int D, int CH>
struct Split {
  static constexpr int kD = D;
  static constexpr int kCh = CH;
  static constexpr int kTpr = D / CH;       // threads per row
  static constexpr int kChunks = CH / 4;    // 4-channel chunks per thread
  static constexpr int kThreads = kRows * kTpr;
};
template <int D>
using FwdSplit = Split<D, 32>;
template <int D>
using BwdSplit = Split<D, (D <= 64 ? 16 : 32)>;

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

// bf16 shared memory: `tiles` [kRows][D + 8] tiles plus `stats` f32 rows
template <int D>
constexpr size_t tc_smem(int tiles, int stats) {
  return tiles * kRows * (D + 8) * sizeof(bf16) + stats * kRows * sizeof(float);
}

// f32 shared memory: `tiles` [kRows][D] tiles plus `stats` f32 rows
template <int D>
constexpr size_t f32_smem(int tiles, int stats) {
  return (tiles * kRows * D + stats * kRows) * sizeof(float);
}

// One launcher per kernel and element type T (bf16: tensor cores, float:
// CUDA cores); the pointers arrive untyped from the C interface.
template <typename T>
const T* as(const void* p) { return static_cast<const T*>(p); }
template <typename T>
T* as(void* p) { return static_cast<T*>(p); }

template <typename T, int D, bool C>
struct Fwd {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         void* out, float* lse, const long long* st, int B,
                         int S, int H, float scale, cudaStream_t stream) {
    const dim3 grid = grid_of(B, S, H);
    const auto go = [&](auto kernel, int threads, size_t smem) {
      return launch(kernel, grid, threads, smem, stream, as<T>(q), as<T>(k),
                    as<T>(v), strides_at(st, 0), strides_at(st, 1),
                    strides_at(st, 2), as<T>(out), lse, S, H, scale);
    };
    if constexpr (sizeof(T) == 2)
      return go(flash_fwd_tc_kernel<D, C>, kTcThreads, tc_smem<D>(3, 0));
    else
      return go(flash_fwd_f32_kernel<D, C>, FwdSplit<D>::kThreads,
                  f32_smem<D>(2, 0));
  }
};

template <typename T, int D, bool C>
struct Dq {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, const long long* st,
                         int B, int S, int H, float scale,
                         cudaStream_t stream) {
    const dim3 grid = grid_of(B, S, H);
    const auto go = [&](auto kernel, int threads, size_t smem) {
      return launch(kernel, grid, threads, smem, stream, as<T>(q), as<T>(k),
                    as<T>(v), as<T>(dout), strides_at(st, 0),
                    strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
                    lse, delta, as<T>(dq), S, H, scale);
    };
    if constexpr (sizeof(T) == 2)
      return go(flash_bwd_dq_tc_kernel<D, C>, kTcThreads,
                  tc_smem<D>(4, 0));
    else
      return go(flash_bwd_dq_f32_kernel<D, C>, BwdSplit<D>::kThreads,
                  f32_smem<D>(2, 0));
  }
};

template <typename T, int D, bool C>
struct Dkv {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv,
                         const long long* st, int B, int S, int H,
                         float scale, cudaStream_t stream) {
    const dim3 grid = grid_of(B, S, H);
    const auto go = [&](auto kernel, int threads, size_t smem) {
      return launch(kernel, grid, threads, smem, stream, as<T>(q), as<T>(k),
                    as<T>(v), as<T>(dout), strides_at(st, 0),
                    strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
                    lse, delta, as<T>(dk), as<T>(dv), S, H, scale);
    };
    if constexpr (sizeof(T) == 2)
      return go(flash_bwd_dkv_tc_kernel<D, C>, kTcThreads,
                  tc_smem<D>(4, 2));
    else
      return go(flash_bwd_dkv_f32_kernel<D, C>, BwdSplit<D>::kThreads,
                  f32_smem<D>(2, 2));
  }
};

// Calls F<T, D, causal>::run(args...) for the runtime dtype / D / causal.
template <template <typename, int, bool> class F, typename... Args>
cudaError_t dispatch(int dtype, int d, int causal, Args... args) {
#define DSTORCH_FLASH_CASE(T, D)                                      \
  if (d == D)                                                         \
    return causal ? F<T, D, true>::run(args...)                       \
                  : F<T, D, false>::run(args...);
  if (dtype == 0) {
    DSTORCH_FLASH_CASE(float, 32)
    DSTORCH_FLASH_CASE(float, 64)
    DSTORCH_FLASH_CASE(float, 128)
  } else if (dtype == 1) {
    DSTORCH_FLASH_CASE(bf16, 32)
    DSTORCH_FLASH_CASE(bf16, 64)
    DSTORCH_FLASH_CASE(bf16, 128)
  }
#undef DSTORCH_FLASH_CASE
  return cudaErrorInvalidValue;
}

bool bad_shape(int B, int S, int H) { return B < 1 || S < 1 || H < 1; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d in {32, 64, 128}. `strides` is a host
// array of (batch, seq, head) element strides: q, k, v for the forward;
// q, k, v, dO for the backward. Returns a cudaError_t (0 on success).
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
