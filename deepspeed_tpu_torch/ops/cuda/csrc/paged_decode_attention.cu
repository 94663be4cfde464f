// Decode attention over a paged cache (B3, with its int8 branch): the C
// interface. The kernel and its design are in decode_attention.cuh;
// decode_attention.cu holds the dense layout.

#include "decode_attention.cuh"

// The paged layout: k/v pools [nb, bs, h*d] (scales [nb, bs]), tables
// [b, T] int32; S = T * bs. q, out and q_stride as decode_attention.cu.
extern "C" int dstorch_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const int* tables,
    const int* cache_len, void* out, int b, int s_q, int q_stride, int h,
    int d, int nb, int bs, int T, float scale, int dtype, int int8,
    void* stream) {
  if (nb < 1 || bs < 8 || bs % 8 || T < 1) return (int)cudaErrorInvalidValue;
  // boxes of gcd(bs, kTile) rows: each lies inside one block and a tile is
  // a whole number of them
  return dispatch(q, k_pool, v_pool, k_scale, v_scale, cache_len, out, b, s_q,
                  q_stride, h, d, T * bs, scale, dtype, int8,
                  (long long)nb * bs, std::gcd(bs, kTile),
                  PagedRows{tables, T, bs, nb}, stream);
}
