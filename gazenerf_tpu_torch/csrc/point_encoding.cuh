// The positional encoding of a sample point inside the field kernels' tiles
// (embed_in_kernel: the TPU kernels' _embed_tile and _embed_bwd_tile,
// gazenerf_tpu/kernels/fused_field.py), shared by the field forward
// (csrc/field_fwd.cuh, K1) and backward (csrc/fused_field_bwd.cu, K2).
//
// Column c of the encoding of a point x (3 floats) is x_c for c < 3, then per
// octave i = 0, 1, ... sin(2^i x_d) for d = 0..2 and cos(2^i x_d) for d =
// 0..2 (upstream's channel order).  The argument 2^i x_d is exact (a power
// of two), and sinf / cosf take their full range reduction: the sources
// build without --use_fast_math, and the arguments reach 2^9 |x| at the
// model's ten octaves.  Each column is computed in f32; the tile rounds it
// to bf16 once, where it stores the embedding.

#pragma once

#include <cuda_bf16.h>

namespace enc {

// Column c of the encoding of x, in f32
__device__ __forceinline__ float encode(const float* x, int c) {
  if (c < 3) return x[c];
  const int j = c - 3, i = j / 6, w = j - 6 * i;
  const float a = ldexpf(x[w % 3], i);
  return w < 3 ? sinf(a) : cosf(a);
}

// Entry (pt, c), c < De, of the bf16 embedding a tile stores: read from
// `embed` ([*, De] bf16), or kPoints: computed from the points `embed`
// holds ([*, 3] f32) and rounded once
template <bool kPoints>
__device__ __forceinline__ __nv_bfloat16 embed_at(const __nv_bfloat16* embed, size_t pt, int c,
                                                  int De) {
  if constexpr (kPoints)
    return __float2bfloat16(encode(reinterpret_cast<const float*>(embed) + pt * 3, c));
  else
    return embed[pt * De + c];
}

// Component d of a point's cotangent from its embedding's f32 cotangent de
// ([De]): the columns that read x_d in increasing order (the identity
// column, then each octave's sin and cos columns), each term the column's
// cotangent times its derivative (cos(a), or -sin(a), at a = 2^i x_d) times
// 2^i, as _embed_bwd_tile's dxb . P^T forms them.
__device__ __forceinline__ float encode_vjp(const float* x, const float* de, int d, int De) {
  float s = de[d];
  for (int i = 0; 6 * i + 9 <= De; ++i) {
    const float f = ldexpf(1.f, i), a = ldexpf(x[d], i);
    s += de[3 + 6 * i + d] * cosf(a) * f;
    s += de[6 + 6 * i + d] * -sinf(a) * f;
  }
  return s;
}

}  // namespace enc
