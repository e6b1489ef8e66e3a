// The fused field backward's tile body, shared by the single-branch
// backward (csrc/fused_field_bwd.cu, K2, which recomputes the activations)
// and the dual-branch backward (csrc/fused_field2_bwd.cu, K4, which reads
// them from the forward's stash): given a 64-point tile's (whole rays')
// activations and pre-ReLU densities, it runs the volume-integration
// backward, then backpropagates through the heads and the 8-layer trunk,
// giving the tile's embedding, z-value and segment-length cotangents.  A
// ray longer than a tile (S a multiple of 64) spans S / 64 tiles, which one
// CTA runs in two sweeps: each tile's forward part (densities and the
// folded feature head's dot products), then the integration backward over
// the whole ray, then each tile's backward (ray_tiles and integrate_ray).  The
// weight gradients are not formed here: the body writes each layer's
// bf16-rounded cotangent to a chunk buffer in device memory, and the dW GEMM
// (csrc/field_dw.cuh) contracts it with the layer's input over a whole chunk
// of points.  Bias and conditioning-row gradients (and dWd) are added into a
// small per-CTA f32 buffer.
//
// Numerics: data gradients are f32; weight gradients are bf16 x bf16
// products (activation x bf16-rounded cotangent) summed in f32; bias and
// conditioning-row gradients are f32 sums.
//  * f32 data gradients on bf16 tensor cores: each f32 cotangent g is kept
//    as two bf16 halves, g_hi = bf16(g) and g_lo = bf16(g - g_hi), and
//    g . W^T is two bf16 mma.sync products summed in f32.  The weights are
//    bf16-exact, so the result carries ~16 mantissa bits of g (relative error
//    ~2^-17), against f32's 24.  g_hi is also the bf16-rounded cotangent the
//    weight gradients take.
//  * the 258-wide feature head is folded per ray, as in the forward:
//      dfeat_s = w_s gfeat, so dy1_s = w_s (Wr2 gfeat) and
//      feat_s . gfeat = y1_s . (Wr2 gfeat) + br2 . gfeat;
//      dWr2 = sum_rays (sum_s w_s y1_s)^T gfeat, dbr2 = sum_rays (sum_s w_s) gfeat.
//    The body writes each ray's sum_s w_s y1_s and sum_s w_s; the head
//    kernel (csrc/field_dw.cuh) contracts them with gfeat.  The one rounding
//    difference from the TPU kernels is that they round dfeat to bf16 before
//    their dWr2 product and this body does not.
//
// What bounds it on Hopper, and what the design does about it.  Per point the
// data gradients are ~2.6 M bf16 multiply-adds (the hi and lo halves), ~1.3 M
// more in K2's recompute: tensor-core work, with only ~50 bytes per point of
// traffic the function needs.  The parent design lost most of its time
// elsewhere (PERF.md): a per-CTA weight-gradient slab read and written
// in device memory for every tile, weight fragments read from L2 twice per
// product (hi and lo), 260-468 bytes of spill per thread, and integration and
// head sections run by one thread or uncoalesced.  So:
//  * every product reads its weights from shared memory: [N, 16] K-slices of
//    the [N, K] weight are staged by cp.async into a ring of five stages,
//    four slices ahead of the one in use (one barrier per slice; L2's latency
//    under load is longer than a slice's products), and their fragments are
//    read with ldmatrix; one B fragment feeds the hi and the lo product of
//    both m16 halves (four mma.sync);
//  * shared memory holds the current activation A, the cotangent halves
//    D_hi / D_lo ([64, H + 8] bf16 each), the embedding tile and the stages.
//    With 64 rows, one pass of 12 warps (2 x 6, each 32 rows x 64 columns)
//    covers all output columns of a layer in registers, so every layer is
//    computed in place: all warps finish reading, then all write.  Twelve
//    warps rather than sixteen leave 168 registers a thread, room for the
//    64 accumulators and the hi and lo fragments without spilling.  The
//    backward's ReLU masks (the layer inputs) are prefetched into A by
//    cp.async behind the product that precedes their epilogue;
//  * a layer's D_hi leaves shared memory as whole rows, 16 bytes per thread;
//  * the integration backward runs a warp per ray, the transmittance product
//    and the strict suffix sum as warp scans; Wr2 . gfeat a warp per output
//    along C (coalesced), br2 . gfeat a warp per ray.  For a ray that spans
//    tiles the per-point floats (density, feat . gfeat, weight, density
//    cotangent) are kept for all its S points, and one warp walks its
//    64-sample blocks first to last for the transmittance, then last to
//    first for the suffix sums; nothing of it leaves the CTA.

#pragma once

#include "field_dw.cuh"
#include "tile_mma.cuh"

namespace fbwd {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;       // points per tile (whole rays)
constexpr int kColWarps = 6;    // warps across a layer's columns, 2 down its rows
constexpr int kThreads = 2 * kColWarps * 32;  // 12 warps: up to 168 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 32;   // two m16 tiles per warp
constexpr int kWarpCols = 64;   // eight n8 tiles per warp
constexpr int kNi = kWarpCols / 8;
constexpr int kMaxCols = kColWarps * kWarpCols;  // one pass covers 384 columns
constexpr int kPad = 8;         // bf16 elements of row padding
constexpr int kXSlots = 9;      // x0..x7, y0b: the weight gradients' left operands
constexpr int kDSlots = 10;     // dy1, dy0, dpre7 .. dpre0: their right operands
constexpr int kSliceK = 16;     // weight K-columns per stage: 32-byte rows, unpadded
constexpr int kStages = 5;      // slices in flight: four ahead of the one in use
constexpr int kStageElems = kMaxCols * kSliceK;
constexpr float kEps = 1e-10f;

static_assert(kRows == 2 * kWarpRows, "2 warp rows cover the tile");
static_assert(kThreads >= 4 * kRows, "row reductions use 4 threads per row");

// Rays per tile (whole rays) when S divides kRows; a ray of S > kRows (a
// multiple of kRows) spans S / kRows tiles instead, and a tile holds part
// of one ray
__host__ __device__ inline int tile_rays(int S) { return S < kRows ? kRows / S : 1; }
__host__ __device__ inline int ray_tiles(int S) { return S > kRows ? S / kRows : 1; }

// the per-point floats a CTA keeps: a tile's, or a whole ray's
__host__ __device__ inline int kept_points(int S) { return S > kRows ? S : kRows; }

// D slot of the cotangent of trunk layer j's pre-activation (dpre_j)
__host__ __device__ constexpr int dpre_slot(int j) { return kDSlots - 1 - j; }

// Wmid slot of trunk layer i (not 0 or 5, whose weights stand alone)
__host__ __device__ constexpr int mid_slot(int i) { return i < 5 ? i - 1 : i - 2; }

// Offsets (in floats) of every gradient in the output buffer, each block
// row-major in the JAX layout.  The weight blocks come from the dW GEMM, Wr2
// and br2 (one [H/2 + 1, C] block) from the head kernel; from `small` on,
// the blocks are summed over the per-CTA buffers.
struct Grads {
  size_t w0e, wmid, w5e, w5x, wr0, wr1x, wr2, br2;
  size_t small, bmid, wd, bd, br0, cb0, cb5, cbr1, total;
};

__host__ __device__ inline Grads grad_layout(int B, int Kp, int H, int C) {
  const size_t H2 = H / 2, h = H, kp = Kp, c = C, b = B;
  Grads s;
  size_t o = 0;
  s.w0e = o;  o += kp * h;
  s.wmid = o; o += 6 * h * h;
  s.w5e = o;  o += kp * h;
  s.w5x = o;  o += h * h;
  s.wr0 = o;  o += h * h;
  s.wr1x = o; o += h * H2;
  s.wr2 = o;  o += H2 * c;
  s.br2 = o;  o += c;
  s.small = o;
  s.bmid = o; o += 6 * h;
  s.wd = o;   o += h;
  s.bd = o;   o += 1;
  s.br0 = o;  o += h;
  s.cb0 = o;  o += b * h;
  s.cb5 = o;  o += b * h;
  s.cbr1 = o; o += b * H2;
  s.total = (o + 3) & ~(size_t)3;  // a second branch's buffer starts 16-byte aligned
  return s;
}

__host__ __device__ inline size_t align256(size_t o) { return (o + 255) & ~(size_t)255; }

// Byte offsets of one chunk's buffers, for chunks of up to P points: the
// dW GEMM's operands, rows point-major.
struct Chunk {
  size_t x[kXSlots];     // [P, H] bf16, x0..x7, y0b (K2 only: K4 reads its stash)
  size_t y1;             // [P, H/2] bf16, y1 (K2 recomputing rays that span tiles)
  size_t e;              // [P, Kp] bf16, the zero-padded embedding
  size_t d[2][kDSlots];  // per branch: dy1 [P, H/2], dy0, dpre7 .. dpre0 [P, H] bf16
  size_t aw[2];          // per branch [P / S, H/2 + 1] f32: sum_s w_s y1_s, sum_s w_s
  size_t part;           // the dW GEMM's partial sums (fdw::kMaxSplits copies of
                         // the weight blocks, f32), one branch at a time
  size_t total;
};

__host__ __device__ inline Chunk chunk_layout(size_t P, int S, int Kp, int H, bool with_x,
                                              int branches) {
  const size_t h = H, h2 = H / 2;
  Chunk c;
  size_t o = 0;
  for (int i = 0; i < kXSlots; ++i) {
    c.x[i] = o;
    if (with_x) o = align256(o + P * h * 2);
  }
  c.y1 = o;
  if (with_x && S > kRows) o = align256(o + P * h2 * 2);
  c.e = o;
  o = align256(o + P * Kp * 2);
  for (int br = 0; br < 2; ++br) {
    for (int j = 0; j < kDSlots; ++j) {
      c.d[br][j] = o;
      if (br < branches) o = align256(o + P * (j == 0 ? h2 : h) * 2);
    }
    c.aw[br] = o;
    if (br < branches) o = align256(o + P / S * (h2 + 1) * 4);
  }
  c.part = o;  // the weight blocks W0e .. Wr1x, in floats: grad_layout's wr2
  o = align256(o + (size_t)fdw::kMaxSplits * (2 * Kp * h + 8 * h * h + h * h2) * 4);
  c.total = o;
  return c;
}

// One K-segment of a product: the [kRows, K] tile `a` (and its lo half `lo`,
// for a hi/lo product; row stride lda, in shared memory) times the [N, K]
// row-major weight w in global memory, transposed.
struct Seg {
  const bf16* a;
  const bf16* lo;
  int lda;
  const bf16* w;
  int K;
};

// the fragment helpers (csrc/tile_mma.cuh)
using tile::bf2f;
using tile::cp_async16;
using tile::cp_async_commit;
using tile::cp_async_wait;
using tile::ldsm_x4;
using tile::mma16816;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Element offset in a stage of 16-byte half h of row n: rows of 32 bytes,
// the halves swapped in rows 4-7 of every 8, so that the 8 rows an ldmatrix
// reads fall in 8 distinct groups of 4 banks
__device__ __forceinline__ int stage_at(int n, int h) {
  return n * kSliceK + ((h ^ (n >> 2)) & 1) * 8;
}

// K-columns [k0, k0 + 16) of the N rows of w ([N, K]) into the stage st,
// asynchronously
__device__ __forceinline__ void stage_slice(bf16* st, const bf16* w, int K, int k0, int N) {
  for (int i = threadIdx.x; i < 2 * N; i += kThreads) {
    const int n = i >> 1, h = i & 1;
    cp_async16(st + stage_at(n, h), w + (size_t)n * K + k0 + h * 8);
  }
}

// dst[r, :width] (row stride ld, shared) = src[r, :width] (contiguous rows,
// global), 16-byte cp.async copies, not committed
__device__ __forceinline__ void load_tile_async(bf16* dst, int ld, const bf16* src, int width) {
  const int vec = width / 8;
  for (int i = threadIdx.x; i < kRows * vec; i += kThreads) {
    const int r = i / vec, v = i - r * vec;
    cp_async16(dst + r * ld + v * 8, src + (size_t)r * width + v * 8);
  }
}

// dst[r, :width] (row stride ld) = src[r, :width] (contiguous), 16-byte copies
__device__ inline void load_tile(bf16* dst, int ld, const bf16* src, int width) {
  const int vec = width / 8;
  for (int i = threadIdx.x; i < kRows * vec; i += kThreads) {
    const int r = i / vec, v = i - r * vec;
    *reinterpret_cast<uint4*>(dst + r * ld + v * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * width + v * 8);
  }
}

// dst[r, :width] (contiguous rows, global) = src[r, :width] (row stride ld),
// 16-byte copies
__device__ inline void store_tile(bf16* dst, const bf16* src, int ld, int width) {
  const int vec = width / 8;
  for (int i = threadIdx.x; i < kRows * vec; i += kThreads) {
    const int r = i / vec, v = i - r * vec;
    *reinterpret_cast<uint4*>(dst + (size_t)r * width + v * 8) =
        *reinterpret_cast<const uint4*>(src + r * ld + v * 8);
  }
}

// acc += a[:, k0:k0+16] . st^T (and lo[:, k0:k0+16] . st^T) for the warp's
// 32 rows and its 64 columns below N
template <bool kLo>
__device__ __forceinline__ void slice_mma(const Seg& s, int k0, const bf16* st, int N, int row0,
                                          int col0, float (&acc)[2][kNi][4]) {
  const int lane = threadIdx.x & 31;
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int off = (row0 + mi * 16 + (lane & 15)) * s.lda + k0 + (lane >> 4) * 8;
    ldsm_x4(ah[mi], s.a + off);
    if (kLo) ldsm_x4(al[mi], s.lo + off);
  }
#pragma unroll
  for (int np = 0; np < kNi / 2; ++np) {
    if (col0 + np * 16 >= N) continue;  // uniform across the warp
    uint32_t b[4];
    ldsm_x4(b, st + stage_at(col0 + np * 16 + ((lane >> 4) << 3) + (lane & 7), (lane >> 3) & 1));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      mma16816(acc[mi][2 * np], ah[mi], b[0], b[1]);
      mma16816(acc[mi][2 * np + 1], ah[mi], b[2], b[3]);
      if (kLo) {
        mma16816(acc[mi][2 * np], al[mi], b[0], b[1]);
        mma16816(acc[mi][2 * np + 1], al[mi], b[2], b[3]);
      }
    }
  }
}

// acc = sum over segments of act . w^T (hi and lo halves when kLo) for all
// kRows rows and N <= kMaxCols columns (N a multiple of 16, every K a
// multiple of 16).  Thread layout: warp (wr, wc) = (warp / 6, warp % 6)
// owns rows wr*32 + [0, 32) and columns wc*64 + [0, 64); element
// acc[mi][ni][2h + j] is row wr*32 + mi*16 + g + 8h, column wc*64 + ni*8 +
// 2t + j.  The weights pass through the stages; `pre` (when given) is a
// [kRows, pre_w] tile copied into `pre_dst` (row stride `pre_ld`) behind the
// first slices.  All threads take part; the copies have landed on return, but
// the caller synchronises before reading them or reusing the stages.
template <bool kLo>
__device__ __forceinline__ void gemm_rows(const Seg& s0, const Seg& s1, int nseg, int N,
                                          bf16* stages, float (&acc)[2][kNi][4],
                                          const bf16* pre = nullptr, bf16* pre_dst = nullptr,
                                          int pre_w = 0, int pre_ld = 0) {
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp / kColWarps) * kWarpRows, col0 = (warp % kColWarps) * kWarpCols;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
  const int n0 = s0.K / kSliceK;
  const int total = n0 + (nseg > 1 ? s1.K / kSliceK : 0);
  auto fetch = [&](int i) {
    if (i < total) {
      const bool first = i < n0;
      stage_slice(stages + (i % kStages) * kStageElems, first ? s0.w : s1.w,
                  first ? s0.K : s1.K, (first ? i : i - n0) * kSliceK, N);
    }
    cp_async_commit();
  };
  fetch(0);
  if (pre) load_tile_async(pre_dst, pre_ld, pre, pre_w);
#pragma unroll
  for (int i = 1; i < kStages - 1; ++i) fetch(i);
  for (int i = 0; i < total; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slice i have landed
    __syncthreads();               // everyone's; and slice i - 1's stage is free
    fetch(i + kStages - 1);
    const bool first = i < n0;
    const bf16* st = stages + (i % kStages) * kStageElems;
    if (col0 < N) slice_mma<kLo>(first ? s0 : s1, (first ? i : i - n0) * kSliceK, st, N, row0,
                                 col0, acc);
  }
  cp_async_wait<0>();
}

// Forward layer: out = bf16(act(acc + bias)) into A (row stride ld).  The
// caller has synchronised after the product.
__device__ __forceinline__ void epi_forward(const float (&acc)[2][kNi][4], int N,
                                            const float* bias, bool relu, bf16* A, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp / kColWarps) * kWarpRows, col0 = (warp % kColWarps) * kWarpCols;
#pragma unroll
  for (int ni = 0; ni < kNi; ++ni) {
    const int c = col0 + ni * 8 + 2 * t;
    if (col0 + ni * 8 >= N) continue;
    const float bias0 = bias[c], bias1 = bias[c + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + mi * 16 + g + 8 * h;
        float v0 = acc[mi][ni][2 * h] + bias0, v1 = acc[mi][ni][2 * h + 1] + bias1;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(A + r * ld + c) = __floats2bfloat162_rn(v0, v1);
      }
  }
}

// One recomputed forward layer, in place in A; its output rows also go to
// `out` ([kRows, N] in global memory) when given.  Ends after a barrier.
__device__ inline void fwd_layer(const Seg& s0, const Seg& s1, int nseg, int N,
                                 const float* bias, bool relu, bf16* A, int ld, bf16* stages,
                                 bf16* out) {
  float acc[2][kNi][4];
  gemm_rows<false>(s0, s1, nseg, N, stages, acc);
  __syncthreads();  // every warp has read A and the stages
  epi_forward(acc, N, bias, relu, A, ld);
  __syncthreads();
  if (out) store_tile(out, A, ld, N);  // A is only read until the next epilogue
}

// Cotangent epilogue: v = acc (+ dpd[r] * wd[c]), zeroed where the mask
// activation is not positive, stored as bf16 halves into Dh / Dl; the column
// sums of v over each warp row go to cs[wr * kMaxCols + c].  The caller has
// synchronised after the product (Dh / Dl are overwritten in place).
__device__ __forceinline__ void store_dpre(const float (&acc)[2][kNi][4], int N,
                                           const bf16* mask, int ldm, const float* dpd,
                                           const bf16* wd, bf16* Dh, bf16* Dl, int ld,
                                           float* cs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp / kColWarps) * kWarpRows, col0 = (warp % kColWarps) * kWarpCols;
#pragma unroll
  for (int ni = 0; ni < kNi; ++ni) {
    if (col0 + ni * 8 >= N) continue;  // uniform across the warp
    const int c = col0 + ni * 8 + 2 * t;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + mi * 16 + g + 8 * h;
        float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (dpd) {  // one rounding, whatever the code around it (K2 and K4 agree)
          v0 = __fmaf_rn(dpd[r], bf2f(wd[c]), v0);
          v1 = __fmaf_rn(dpd[r], bf2f(wd[c + 1]), v1);
        }
        if (mask) {
          if (!(bf2f(mask[r * ldm + c]) > 0.f)) v0 = 0.f;
          if (!(bf2f(mask[r * ldm + c + 1]) > 0.f)) v1 = 0.f;
        }
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(v0 - __low2float(hi), v1 - __high2float(hi));
        *reinterpret_cast<__nv_bfloat162*>(Dh + r * ld + c) = hi;
        *reinterpret_cast<__nv_bfloat162*>(Dl + r * ld + c) = lo;
        s0 += v0;
        s1 += v1;
      }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (g == 0) {
      cs[(warp / kColWarps) * kMaxCols + c] = s0;
      cs[(warp / kColWarps) * kMaxCols + c + 1] = s1;
    }
  }
}

// dembed[r, c] (row stride De) = or += the product, for c < De
__device__ __forceinline__ void epi_dembed(const float (&acc)[2][kNi][4], int N, int De,
                                           float* dembed, bool add) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp / kColWarps) * kWarpRows, col0 = (warp % kColWarps) * kWarpCols;
#pragma unroll
  for (int ni = 0; ni < kNi; ++ni) {
    if (col0 + ni * 8 >= N) continue;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + mi * 16 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = col0 + ni * 8 + 2 * t + j;
          if (c < De) {
            float* o = dembed + (size_t)r * De + c;
            *o = add ? *o + acc[mi][ni][2 * h + j] : acc[mi][ni][2 * h + j];
          }
        }
      }
  }
}

// sums[c] += cs[c] + cs[kMaxCols + c], c < N (the two warp rows, in order)
__device__ inline void add_colsum(float* sums, const float* cs, int N) {
  for (int c = threadIdx.x; c < N; c += kThreads) sums[c] += cs[c] + cs[kMaxCols + c];
}

// The shared-memory tile: bf16 activations, cotangent halves and embedding,
// the weight stages, then the f32 per-point, per-ray and column-sum buffers.
struct Shared {
  bf16 *A, *Dh, *Dl, *E;  // [kRows, H + kPad] x 3, [kRows, Kp + kPad]
  bf16* W;      // kStages x kStageElems weight slices
  // per point, of the tile or (kept_points) of the ray that spans tiles
  float* dens;  // pre-ReLU density
  float* wts;   // sample weights
  float* dpd;   // dw, then the density cotangent
  float* fg;    // feat . gfeat
  float* cs;    // [2, kMaxCols] column sums
  float* u;     // [TR, H2] Wr2 . gfeat per ray
  float* gf;    // [TR, C] gfeat of the tile's rays
  float* cg;    // [TR] br2 . gfeat
  float* ws;    // [TR] sum_s w_s
  float* end;   // first float past the tile
};

__device__ inline Shared carve(unsigned char* smem, int S, int Kp, int H, int C) {
  const int TR = tile_rays(S), H2 = H / 2, ld = H + kPad, lde = Kp + kPad, np = kept_points(S);
  Shared s;
  s.A = reinterpret_cast<bf16*>(smem);
  s.Dh = s.A + kRows * ld;
  s.Dl = s.Dh + kRows * ld;
  s.E = s.Dl + kRows * ld;
  s.W = s.E + kRows * lde;
  s.dens = reinterpret_cast<float*>(s.W + kStages * kStageElems);
  s.wts = s.dens + np;
  s.dpd = s.wts + np;
  s.fg = s.dpd + np;
  s.cs = s.fg + np;
  s.u = s.cs + 2 * kMaxCols;
  s.gf = s.u + TR * H2;
  s.cg = s.gf + TR * C;
  s.ws = s.cg + TR;
  s.end = s.ws + TR;
  return s;
}

inline size_t smem_bytes(int S, int Kp, int H, int C) {
  const int TR = tile_rays(S), H2 = H / 2;
  return (size_t)3 * kRows * (H + kPad) * sizeof(bf16) +
         (size_t)kRows * (Kp + kPad) * sizeof(bf16) +
         (size_t)kStages * kStageElems * sizeof(bf16) +
         (size_t)(4 * kept_points(S) + 2 * kMaxCols + TR * H2 + TR * C + 2 * TR) * sizeof(float);
}

// The Shared of tile k of a ray that spans tiles: its per-point floats
__device__ __forceinline__ Shared tile_of(Shared s, int k) {
  s.dens += k * kRows;
  s.wts += k * kRows;
  s.dpd += k * kRows;
  s.fg += k * kRows;
  return s;
}

// The weights one branch's backward reads: the density and feature heads
// (forward layout) and the data-gradient products' [in, out] copies.
struct BwdWeights {
  const bf16* wd;       // [H]
  const float* bd;      // [1]
  const bf16* wr2;      // [H/2, C] (in, out)
  const float* br2;     // [C]
  const bf16* w0e_t;    // [Kp, H]
  const bf16* wmid_t;   // [6, H, H]
  const bf16* w5e_t;    // [Kp, H]
  const bf16* w5x_t;    // [H, H]
  const bf16* wr0_t;    // [H, H]
  const bf16* wr1x_t;   // [H, H/2]
  int dens_vpu;         // dWd from the f32 density cotangent, else from its bf16
};

// pre-ReLU density of the tile's points from x7 in A: 4 threads per row (the
// first 8 warps), an f32 dot product of bf16 values
__device__ inline void density_pre(const Shared& s, int ld, const bf16* wd, const float* bd,
                                   int H) {
  if (threadIdx.x >= 4 * kRows) return;  // whole warps
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  float v = 0.f;
  for (int k = part; k < H; k += 4) v = __fmaf_rn(bf2f(s.A[r * ld + k]), bf2f(wd[k]), v);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  if (part == 0) s.dens[r] = v + bd[0];
}

// One tile's inputs and outputs.
struct TileIO {
  int b;                      // batch of the tile
  size_t p0, ray0;            // its first point and first ray
  const float* zvals;         // [B, R, S]
  const float* zdists;        // [B, R, S]
  const float* gbga;          // [B, R]
  const float* gdepth;        // [B, R]
  const float* gw;            // [B, R, S]
  // The base pointers stay where the caller keeps them (its kernel
  // parameters), so that the body holds no array of pointers in registers.
  const bf16* const* x;       // x0..x7 (ReLU masks), rows [*, H]; the tile's from row xrow
  size_t xrow;
  bf16* const* d;             // the D slots, rows [*, H/2] (dy1) or [*, H]; from row drow
  size_t drow;
  float* aw;                  // [TR, H/2 + 1] of the chunk's per-ray head buffer
  float* dzvals;              // [kRows] of the tile (of the ray: integrate_ray)
  float* dzdists;             // [kRows]
  float* dembed;              // [kRows, De]
  bool add;                   // add into dzvals / dzdists / dembed, else store
  bool aw_add;                // add the tile's part of sum_s w_s y1_s into aw (a ray's
                              // later tile), else store aw
};

// the tile's rows of x_i and of D slot j
__device__ __forceinline__ const bf16* x_rows(const TileIO& io, int i, int H) {
  return io.x[i] + io.xrow * H;
}

__device__ __forceinline__ bf16* d_rows(const TileIO& io, int j, int H) {
  return io.d[j] + io.drow * (j == 0 ? H / 2 : H);
}

// The product of v over the lanes below this one
__device__ __forceinline__ float warp_prefix_product(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = o * v;
  }
  const float ex = __shfl_up_sync(0xffffffffu, v, 1);
  return lane == 0 ? 1.f : ex;
}

// The sum of v over the lanes above this one
__device__ __forceinline__ float warp_suffix_sum(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, v, off);
    if (lane + off < 32) v += o;
  }
  const float ex = __shfl_down_sync(0xffffffffu, v, 1);
  return lane == 31 ? 0.f : ex;
}

// The integration backward of the tile's rays, a warp per ray: lane l holds
// samples l * spl + [0, spl) (spl = 1 or 2).  Per sample, with T the
// exclusive transmittance product and dw the weight cotangent,
//   dalpha = dw T - (sum over later samples of w dw) / (1 - alpha + eps).
// Writes wts, dpd (the density cotangent), ws and the z cotangents.  Every
// product that meets a sum is rounded where the intrinsics say, so that the
// compiler cannot fuse it one way here and another way in the other kernel
// that includes this body: K2 and K4 give the same bits.
__device__ inline void integrate_backward(const Shared& sh, const TileIO& io, int S) {
  const int TR = tile_rays(S), warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int spl = (S + 31) / 32;
  for (int ray = warp; ray < TR; ray += kWarps) {
    const size_t gray = io.ray0 + ray;
    const float gb = io.gbga[gray], gd = io.gdepth[gray];
    float sigma[2], e[2], alpha[2], zd[2], dw[2], w[2], T[2];
    float f = 1.f;  // the lane's product of (1 - alpha + eps)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int s = lane * spl + q;
      const bool ok = q < spl && s < S;
      const int r = ray * S + s;
      const size_t gp = io.p0 + r;
      sigma[q] = ok ? fmaxf(sh.dens[r], 0.f) : 0.f;
      zd[q] = ok ? io.zdists[gp] : 0.f;
      e[q] = expf(-sigma[q] * zd[q]);
      alpha[q] = 1.f - e[q];
      dw[q] = ok ? __fadd_rn(__fsub_rn(__fmaf_rn(io.zvals[gp], gd, sh.fg[r]), gb), io.gw[gp])
                 : 0.f;
      T[q] = f;
      if (ok) f *= 1.f - alpha[q] + kEps;
    }
    const float T0 = warp_prefix_product(f);
    float wdw = 0.f, wsum = 0.f, wd[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      T[q] *= T0;
      w[q] = alpha[q] * T[q];
      if (q < spl && lane * spl + q < S) {
        wd[q] = __fmul_rn(w[q], dw[q]);
        wsum += w[q];
        wdw += wd[q];
      } else {
        w[q] = wd[q] = 0.f;
      }
    }
    wsum = warp_sum(wsum);
    float suffix = warp_suffix_sum(wdw);  // over the later lanes' samples
#pragma unroll
    for (int q = 1; q >= 0; --q) {
      const int s = lane * spl + q;
      if (q >= spl || s >= S) continue;
      const int r = ray * S + s;
      const float dalpha = __fmaf_rn(dw[q], T[q], -__fdiv_rn(suffix, 1.f - alpha[q] + kEps));
      suffix += wd[q];
      sh.wts[r] = w[q];
      const float dzv = __fmul_rn(w[q], gd);
      io.dzvals[r] = io.add ? io.dzvals[r] + dzv : dzv;
      const float dzd = dalpha * sigma[q] * e[q];
      io.dzdists[r] = io.add ? io.dzdists[r] + dzd : dzd;
      sh.dpd[r] = sh.dens[r] > 0.f ? dalpha * zd[q] * e[q] : 0.f;
    }
    if (lane == 0) sh.ws[ray] = wsum;
  }
}

// The integration backward of one ray of S = n x 64 samples that spans n
// tiles (io: the ray's first point, its z cotangents; sh: its S per-point
// floats), by one warp, lane l holding samples 2 l, 2 l + 1 of each 64-sample
// block: first to last for the transmittance (T carried from block to
// block; the weights, and T parked in dpd), then last to first for the
// suffix sums of w dw (carried the other way), with integrate_backward's
// formulas and rounding.  Writes wts, dpd, ws[0] and the z cotangents.
__device__ inline void integrate_ray(const Shared& sh, const TileIO& io, int S) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, nb = S / kRows;
  const float gb = io.gbga[io.ray0], gd = io.gdepth[io.ray0];
  auto sample = [&](int s, float& sigma, float& e, float& alpha, float& zd) {
    sigma = fmaxf(sh.dens[s], 0.f);
    zd = io.zdists[io.p0 + s];
    e = expf(-sigma * zd);
    alpha = 1.f - e;
  };
  float tc = 1.f, wsum = 0.f;
  for (int k = 0; k < nb; ++k) {
    float alpha[2], T[2], sigma, e, zd;
    float f = 1.f;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      sample(k * kRows + 2 * lane + q, sigma, e, alpha[q], zd);
      T[q] = f;
      f *= 1.f - alpha[q] + kEps;
    }
    const float T0 = warp_prefix_product(f);
    const float all = __shfl_sync(0xffffffffu, T0 * f, 31);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int s = k * kRows + 2 * lane + q;
      T[q] *= T0 * tc;
      const float w = alpha[q] * T[q];
      sh.wts[s] = w;
      sh.dpd[s] = T[q];
      wsum += w;
    }
    tc *= all;
  }
  wsum = warp_sum(wsum);
  if (lane == 0) sh.ws[0] = wsum;
  float later = 0.f;  // sum of w dw over the later blocks
  for (int k = nb - 1; k >= 0; --k) {
    float alpha[2], sigma[2], e[2], zd[2], dw[2], wd[2];
    float wdw = 0.f;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int s = k * kRows + 2 * lane + q;
      const size_t gp = io.p0 + s;
      sample(s, sigma[q], e[q], alpha[q], zd[q]);
      dw[q] = __fadd_rn(__fsub_rn(__fmaf_rn(io.zvals[gp], gd, sh.fg[s]), gb), io.gw[gp]);
      wd[q] = __fmul_rn(sh.wts[s], dw[q]);
      wdw += wd[q];
    }
    float suffix = warp_suffix_sum(wdw) + later;  // over the later lanes' and blocks' samples
    later += warp_sum(wdw);
#pragma unroll
    for (int q = 1; q >= 0; --q) {
      const int s = k * kRows + 2 * lane + q;
      const float dalpha =
          __fmaf_rn(dw[q], sh.dpd[s], -__fdiv_rn(suffix, 1.f - alpha[q] + kEps));
      suffix += wd[q];
      const float dzv = __fmul_rn(sh.wts[s], gd);
      io.dzvals[s] = io.add ? io.dzvals[s] + dzv : dzv;
      const float dzd = dalpha * sigma[q] * e[q];
      io.dzdists[s] = io.add ? io.dzdists[s] + dzd : dzd;
      sh.dpd[s] = sh.dens[s] > 0.f ? dalpha * zd[q] * e[q] : 0.f;
    }
  }
}

// The folded head of the tile's TR rays (gf their cotangents gfeat): u =
// Wr2 . gfeat and cg = br2 . gfeat per ray, a warp per output, lanes along
// C.  Ends with a barrier.
__device__ inline void fold_head(const Shared& sh, const BwdWeights& W, int TR, int H2, int C) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float *u = sh.u, *gf = sh.gf, *cg = sh.cg;
  for (int i = warp; i < TR * H2 + TR; i += kWarps) {
    float s = 0.f;
    if (i < TR * H2) {
      const int ray = i / H2, k = i - ray * H2;
      const float* gr = gf + ray * C;
      const bf16* wk = W.wr2 + (size_t)k * C;
      for (int c = lane; c < C; c += 32) s = __fmaf_rn(gr[c], bf2f(wk[c]), s);
    } else {
      const float* gr = gf + (i - TR * H2) * C;
      for (int c = lane; c < C; c += 32) s = __fmaf_rn(W.br2[c], gr[c], s);
    }
    s = warp_sum(s);
    if (lane == 0) (i < TR * H2 ? u[i] : cg[i - TR * H2]) = s;
  }
  __syncthreads();
}

// fg = feat . gfeat = y1 . u + cg for the tile's points (y1 in A[:, :H/2]),
// 4 threads per row.  Ends with a barrier.
__device__ inline void fold_features(const Shared& sh, int S, int H2, int ld) {
  const int tid = threadIdx.x;
  if (tid < 4 * kRows) {
    const int r = tid >> 2, part = tid & 3, ray = r / S;
    float s = 0.f;
    for (int k = part; k < H2; k += 4)
      s = __fmaf_rn(bf2f(sh.A[r * ld + k]), sh.u[ray * H2 + k], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) sh.fg[r] = s + sh.cg[ray];
  }
  __syncthreads();
}

// The backward of one tile from the integration backward's outputs on (wts,
// dpd, ws; A[:, :H/2] y1, u the folded head): the heads, then the 8-layer
// trunk.  `small` is the CTA's f32 buffer of the gradients from L.small on
// (at offset - L.small).  Ends with a barrier: the caller may overwrite
// every shared buffer.
__device__ inline void backward_heads_trunk(const Shared& sh, const BwdWeights& W,
                                            const TileIO& io, int S, int De, int Kp, int H,
                                            const Grads& L, float* small) {
  const int H2 = H / 2, TR = tile_rays(S), ld = H + kPad;
  const int n = S < kRows ? S : kRows;  // points of a ray in the tile
  bf16 *A = sh.A, *Dh = sh.Dh, *Dl = sh.Dl, *stages = sh.W;
  float *wts = sh.wts, *dpd = sh.dpd, *cs = sh.cs, *u = sh.u, *ws = sh.ws;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, b = io.b;
  const size_t HH = (size_t)H * H;
  const Seg none = {nullptr, nullptr, 0, nullptr, 0};
  float* sm = small - L.small;  // indexed by the gradients' offsets
  float acc[2][kNi][4];

  // ---- head backward ----
  for (int i = tid; i < TR * (H2 + 1); i += kThreads) {  // aw = sum_s w_s y1_s, ws
    const int ray = i / (H2 + 1), k = i - ray * (H2 + 1);
    float s = 0.f;
    if (k < H2) {
      for (int j = 0; j < n; ++j)
        s = __fmaf_rn(wts[ray * S + j], bf2f(A[(ray * S + j) * ld + k]), s);
    } else {
      s = ws[ray];
    }
    if (!io.aw_add)
      io.aw[i] = s;
    else if (k < H2)  // sum_s w_s was stored whole with the ray's first tile
      io.aw[i] += s;
  }
  for (int i = tid; i < kRows * H2; i += kThreads) {  // dy1 = [y1 > 0] w u
    const int r = i / H2, k = i - r * H2;
    const float v = bf2f(A[r * ld + k]) > 0.f ? wts[r] * u[(r / S) * H2 + k] : 0.f;
    const bf16 hi = __float2bfloat16(v);
    Dh[r * ld + k] = hi;
    Dl[r * ld + k] = __float2bfloat16(v - bf2f(hi));
  }
  for (int k = tid; k < H2; k += kThreads) {  // dcbr1
    float s = 0.f;
    for (int r = 0; r < kRows; ++r)
      if (bf2f(A[r * ld + k]) > 0.f) s = __fmaf_rn(wts[r], u[(r / S) * H2 + k], s);
    sm[L.cbr1 + (size_t)b * H2 + k] += s;
  }
  if (warp == 0) {  // dbd
    const float s = warp_sum(dpd[lane] + dpd[lane + 32]);
    if (lane == 0) sm[L.bd] += s;
  }
  __syncthreads();
  store_tile(d_rows(io, 0, H), Dh, ld, H2);  // bf16(dy1)
  // dy0 = dy1 . Wr1x^T; x7 (the mask of dx7) into A behind it
  gemm_rows<true>({Dh, Dl, ld, W.wr1x_t, H2}, none, 1, H, stages, acc, x_rows(io, 7, H), A,
                  H, ld);
  __syncthreads();
  store_dpre(acc, H, nullptr, 0, nullptr, nullptr, Dh, Dl, ld, cs);
  __syncthreads();
  store_tile(d_rows(io, 1, H), Dh, ld, H);  // bf16(dy0)
  add_colsum(sm + L.br0, cs, H);
  for (int j = tid; j < H; j += kThreads) {  // dWd = x7^T ddens, bf16(ddens) unless dens_vpu
    float s = 0.f;
    if (W.dens_vpu)
      for (int r = 0; r < kRows; ++r) s = __fmaf_rn(bf2f(A[r * ld + j]), dpd[r], s);
    else
      for (int r = 0; r < kRows; ++r)
        s = __fmaf_rn(bf2f(A[r * ld + j]), bf2f(__float2bfloat16(dpd[r])), s);
    sm[L.wd + j] += s;
  }
  gemm_rows<true>({Dh, Dl, ld, W.wr0_t, H}, none, 1, H, stages, acc);  // dx7
  __syncthreads();
  store_dpre(acc, H, A, ld, dpd, W.wd, Dh, Dl, ld, cs);  // dpre7
  __syncthreads();
  store_tile(d_rows(io, dpre_slot(7), H), Dh, ld, H);
  add_colsum(sm + L.bmid + 5 * (size_t)H, cs, H);

  // ---- trunk backward: layers 7 .. 1 ----
#pragma unroll 1
  for (int i = 7; i >= 1; --i) {
    if (i == 5) {  // the embedding's share through fea_5
      gemm_rows<true>({Dh, Dl, ld, W.w5e_t, H}, none, 1, Kp, stages, acc);
      epi_dembed(acc, Kp, De, io.dembed, io.add);
      __syncthreads();  // the next product reuses the stages
    }
    const bf16* wt = i == 5 ? W.w5x_t : W.wmid_t + mid_slot(i) * HH;
    // dx_{i-1}; x_{i-1} (its mask) into A behind it
    gemm_rows<true>({Dh, Dl, ld, wt, H}, none, 1, H, stages, acc, x_rows(io, i - 1, H), A, H,
                    ld);
    __syncthreads();
    store_dpre(acc, H, A, ld, nullptr, nullptr, Dh, Dl, ld, cs);  // dpre_{i-1}
    __syncthreads();
    const int j = i - 1;
    store_tile(d_rows(io, dpre_slot(j), H), Dh, ld, H);
    float* bias = j == 0   ? sm + L.cb0 + (size_t)b * H
                  : j == 5 ? sm + L.cb5 + (size_t)b * H
                           : sm + L.bmid + (size_t)mid_slot(j) * H;
    add_colsum(bias, cs, H);
  }
  gemm_rows<true>({Dh, Dl, ld, W.w0e_t, H}, none, 1, Kp, stages, acc);
  epi_dembed(acc, Kp, De, io.dembed, true);
  __syncthreads();  // the caller may overwrite E, A, Dh, Dl and the floats
}

// The backward of one tile of whole rays (S divides kRows).  On entry
// (after a barrier): E holds the embedding tile, gf the cotangent gfeat of
// its rays, A[:, :H/2] y1 and dens the pre-ReLU densities.  Ends with a
// barrier: the caller may overwrite every shared buffer.
__device__ inline void backward_tile(const Shared& sh, const BwdWeights& W, const TileIO& io,
                                     int S, int De, int Kp, int H, int C, const Grads& L,
                                     float* small) {
  fold_head(sh, W, tile_rays(S), H / 2, C);
  fold_features(sh, S, H / 2, H + kPad);
  integrate_backward(sh, io, S);
  __syncthreads();
  backward_heads_trunk(sh, W, io, S, De, Kp, H, L, small);
}

// A chunk's eleven weight-gradient products (one branch): X from `x` (x0..x7,
// y0b, each [P, H] from its pointer), the embedding `e` ([P, Kp]) and the
// cotangents `d` (dy1 [P, H/2], dy0, dpre7 .. dpre0 [P, H]), into the blocks
// of `grads`, split over the points for `sms` SMs with partials in `part`.
// K2 and K4 build their jobs here: the same products in the same order.
inline fdw::Jobs weight_jobs(const bf16* const* x, const bf16* e, const bf16* const* d,
                             float* grads, const Grads& L, int Kp, int H, int P, int accumulate,
                             int sms, float* part) {
  const size_t HH = (size_t)H * H;
  fdw::Jobs js;
  js.n_jobs = 0;
  auto add = [&](const bf16* xx, int M, const bf16* dd, int N, float* out) {
    fdw::Job& jb = js.job[js.n_jobs++];
    jb.x = xx;
    jb.d = dd;
    jb.out = out;
    jb.M = M;
    jb.N = N;
  };
  add(x[8], H, d[0], H / 2, grads + L.wr1x);         // y0b^T bf16(dy1)
  add(x[7], H, d[1], H, grads + L.wr0);              // x7^T bf16(dy0)
  for (int i = 7; i >= 1; --i) {                     // layer i: x_{i-1}^T bf16(dpre_i)
    const bf16* di = d[dpre_slot(i)];
    if (i == 5) {
      add(x[4], H, di, H, grads + L.w5x);
      add(e, Kp, di, H, grads + L.w5e);
    } else {
      add(x[i - 1], H, di, H, grads + L.wmid + mid_slot(i) * HH);
    }
  }
  add(e, Kp, d[dpre_slot(0)], H, grads + L.w0e);     // E^T bf16(dpre0)
  js.P = P;
  js.accumulate = accumulate;
  fdw::number_tiles(js, sms, part);
  return js;
}

}  // namespace fbwd
