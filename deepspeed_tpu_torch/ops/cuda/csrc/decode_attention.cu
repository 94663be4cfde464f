// Decode attention over a dense [b, S, h*d] cache (B2, with its int8
// branch): the C interface. The kernel and its design are in
// decode_attention.cuh; paged_decode_attention.cu holds the paged layout.

#include "decode_attention.cuh"

// dtype (of q and out): 0 = float32, 1 = bfloat16, 2 = float16. int8: the
// cache is int8 with f32 scales k_scale / v_scale (else they are unused and
// may be null). q and out are [b, q_stride, h, d] with q_stride >= s_q: a
// piece of a wider call passes its first column and the call's width, and
// reads and writes its s_q columns in place.
// Returns a cudaError_t (0 on success).
extern "C" int dstorch_decode_attention(const void* q, const void* k,
                                        const void* v, const void* k_scale,
                                        const void* v_scale,
                                        const int* cache_len, void* out, int b,
                                        int s_q, int q_stride, int h, int d,
                                        int S, float scale, int dtype,
                                        int int8, void* stream) {
  return dispatch(q, k, v, k_scale, v_scale, cache_len, out, b, s_q,
                  q_stride, h, d, S, scale, dtype, int8, (long long)b * S,
                  kTile, DenseRows{S}, stream);
}
