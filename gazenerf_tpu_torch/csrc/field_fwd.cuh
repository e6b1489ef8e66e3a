// The fused field forward's tile body, shared by the single-branch forward
// (csrc/fused_field_fwd.cu, K1) and the dual-branch forward
// (csrc/fused_field2_fwd.cu, K3), so the two compute the same bits for the
// same branch.  One CTA of 512 threads takes TILE_POINTS points (whole rays)
// of one batch through the positional-embedding tile -> 8-layer field MLP
// (skip at fea_5) -> density and 258-channel feature heads -> alpha
// compositing, and writes the per-ray feature / background alpha / depth and
// the per-sample weights.  With the stash on, it also writes the bf16
// activations x0..x7, y0b (rgb_0's output) and y1 (rgb_1's) of every point.
//
// Numerics: bf16 operands with f32 accumulation; bias, conditioning rows and
// ReLU applied in f32 and the result rounded to bf16 before the next
// product; rgb_0's output rounded to bf16 before rgb_1; the feature head and
// the compositing in f32.
//
// Layout:
//  * the activation tile lives in shared memory as bf16, ping-ponged between
//    two [kRows, H + 8] buffers (the +8 pad makes the fragment loads free of
//    bank conflicts); the embedding tile [kRows, Kp + 8] stays resident for
//    the skip layer;
//  * every layer is mma.sync m16n8k16 (bf16 in, f32 accumulate): 16 warps
//    in a 4 x 4 grid, each owns 32 rows x 48 columns of a 192-column pass;
//    A fragments come from shared memory, B fragments straight from the
//    weights in global memory (L2 / L1 resident, stored [out, in] so each
//    fragment register is one 32-bit load);
//  * the 1-wide density head is a per-row dot product in f32;
//  * compositing runs one thread per ray over its S samples; the 258-wide
//    head is applied after the sample reduction,
//      sum_s w_s (y1_s Wr2 + br2) = (sum_s w_s y1_s) Wr2 + (sum_s w_s) br2,
//    which is the same function with the head's operations cut by S;
//  * a stash slot is copied out of the shared-memory tile once the layer is
//    complete, 16 bytes per thread along whole rows (coalesced), indexed in
//    64 bits: one [2, 4096, 64, 384] slot alone holds 201 M elements.

#pragma once

#include "tile_mma.cuh"

#ifndef TILE_POINTS
#error "build with -DTILE_POINTS=<points per CTA> (kernels/fused_field.py)"
#endif

namespace ffwd {

typedef __nv_bfloat16 bf16;

constexpr int kRows = TILE_POINTS;  // points per CTA (whole rays)
constexpr int kThreads = 512;       // 16 warps
constexpr int kWarpRows = 32;       // two m16 tiles per warp
constexpr int kWarpCols = 48;       // six n8 tiles per warp
constexpr int kPassCols = 4 * kWarpCols;
constexpr int kPad = 8;             // bf16 elements of row padding
constexpr int kSlots = 10;          // stash: x0..x7, y0b, y1
constexpr float kEps = 1e-10f;

static_assert(kThreads == 4 * kRows, "density head uses 4 threads per row");
static_assert(kRows == 4 * kWarpRows, "4 warp rows cover the tile");

// One branch's operands and outputs.
struct Params {
  const bf16* embed;    // [B, R, S, De]
  const float* zvals;   // [B, R, S]
  const float* zdists;  // [B, R, S]
  const float* cb0;     // [B, H]   sc . W0c + b0
  const float* cb5;     // [B, H]   sc . W5c + b5
  const float* cbr1;    // [B, H/2] ac . Wr1c + br1
  const bf16* w0e;      // [H, Kp]  (out, in), columns >= De are zero
  const bf16* wmid;     // [6, H, H] fea_1..4, fea_6, fea_7
  const float* bmid;    // [6, H]
  const bf16* w5e;      // [H, Kp]
  const bf16* w5x;      // [H, H]
  const bf16* wd;       // [H]
  const float* bd;      // [1]
  const bf16* wr0;      // [H, H]
  const float* br0;     // [H]
  const bf16* wr1x;     // [H/2, H]
  const bf16* wr2;      // [H/2, C] (in, out)
  const float* br2;     // [C]
  float* feat_out;      // [B, R, C]
  float* bga_out;       // [B, R]
  float* depth_out;     // [B, R]
  float* w_out;         // [B, R, S]
  bf16* stash[kSlots];  // [B, R, S, H] (x0..x7, y0b), [B, R, S, H/2] (y1)
  int R, S, De, Kp, H, C;
};

// One K-segment of a layer's input: activations in shared memory, the
// matching weight block in global memory.
struct Operand {
  const bf16* act;  // [kRows, ld]
  int ld;
  const bf16* w;    // [N, K], row-major (out x in)
  int K;
};

// the mma.sync fragment helpers (csrc/tile_mma.cuh)
using tile::ldg32;
using tile::lds32;
using tile::mma16816;

// out[r, c] = bf16(act(sum over segments of x[r, :] . w[c, :] + bias[c]))
// for all kRows rows and the N (a multiple of 8) output columns.
__device__ inline void dense_layer(Operand s0, Operand s1, int nseg, int N, const float* bias,
                                   bool relu, bf16* out, int ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group / thread in group
  const int row0 = (warp >> 2) * kWarpRows;
  for (int pass0 = 0; pass0 < N; pass0 += kPassCols) {
    const int col0 = pass0 + (warp & 3) * kWarpCols;
    float acc[2][6][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 6; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

    for (int s = 0; s < nseg; ++s) {
      const Operand op = s ? s1 : s0;
#pragma unroll 2
      for (int k = 0; k < op.K; k += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const bf16* p = op.act + (row0 + mi * 16 + g) * op.ld + k + 2 * t;
          a[mi][0] = lds32(p);
          a[mi][1] = lds32(p + 8 * op.ld);
          a[mi][2] = lds32(p + 8);
          a[mi][3] = lds32(p + 8 * op.ld + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 6; ++ni) {
          if (col0 + ni * 8 < N) {
            const bf16* q = op.w + (size_t)(col0 + ni * 8 + g) * op.K + k + 2 * t;
            const uint32_t b0 = ldg32(q), b1 = ldg32(q + 8);
            mma16816(acc[0][ni], a[0], b0, b1);
            mma16816(acc[1][ni], a[1], b0, b1);
          }
        }
      }
    }

#pragma unroll
    for (int ni = 0; ni < 6; ++ni) {
      if (col0 + ni * 8 < N) {
        const int c = col0 + ni * 8 + 2 * t;
        const float bias0 = bias[c], bias1 = bias[c + 1];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row0 + mi * 16 + g + 8 * h;
            float v0 = acc[mi][ni][2 * h] + bias0;
            float v1 = acc[mi][ni][2 * h + 1] + bias1;
            if (relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            *reinterpret_cast<__nv_bfloat162*>(out + r * ldo + c) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

// dst[r, :N] (rows of N, global) = X[r, :N] (row stride ld, shared memory)
// for the tile's kRows rows, 16 bytes per thread; N is a multiple of 8.
__device__ inline void store_slot(bf16* dst, const bf16* X, int ld, int N) {
  const int vec = N / 8;
  for (int i = threadIdx.x; i < kRows * vec; i += kThreads) {
    const int r = i / vec, v = i - r * vec;
    *reinterpret_cast<uint4*>(dst + (size_t)r * N + v * 8) =
        *reinterpret_cast<const uint4*>(X + r * ld + v * 8);
  }
}

inline size_t smem_bytes(int S, int Kp, int H) {
  const int TR = kRows / S;
  return (size_t)2 * kRows * (H + kPad) * sizeof(bf16) +
         (size_t)kRows * (Kp + kPad) * sizeof(bf16) +
         (size_t)(2 * kRows + TR + TR * (H / 2)) * sizeof(float);
}

// The tile of batch b starting at ray r0.  kStash: write the tile's rows of
// the ten stash slots.
template <bool kStash>
__device__ inline void forward_tile(const Params& p, int b, int r0) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, H2 = p.H / 2, S = p.S, C = p.C, Kp = p.Kp;
  const int TR = kRows / S;
  const int ldx = H + kPad, lde = Kp + kPad;
  bf16* X0 = reinterpret_cast<bf16*>(smem);
  bf16* X1 = X0 + kRows * ldx;
  bf16* E = X1 + kRows * ldx;
  float* sig = reinterpret_cast<float*>(E + kRows * lde);  // [kRows]
  float* wts = sig + kRows;                                // [kRows]
  float* acc_ray = wts + kRows;                            // [TR]
  float* u = acc_ray + TR;                                 // [TR, H2]

  const int tid = threadIdx.x;
  const size_t ray0 = (size_t)b * p.R + r0;  // first ray of this CTA
  const size_t p0 = ray0 * S;                // first point
  // the tile's rows of stash slot i, of width n
  auto slot = [&](int i, int n) { return p.stash[i] + p0 * n; };

  for (int i = tid; i < kRows * Kp; i += kThreads) {
    const int r = i / Kp, c = i - r * Kp;
    E[r * lde + c] = c < p.De ? p.embed[(p0 + r) * p.De + c] : __float2bfloat16(0.f);
  }
  __syncthreads();

  const size_t HH = (size_t)H * H;
  const Operand none = {nullptr, 0, nullptr, 0};
  // trunk: fea_0 .. fea_7, ping-ponging X0 / X1; x4 in X0, x7 in X1.  A
  // stash slot is copied after the barrier that completes its layer; the
  // next layer only reads that buffer, and the one after writes it only
  // past another barrier.
  dense_layer({E, lde, p.w0e, Kp}, none, 1, H, p.cb0 + (size_t)b * H, true, X0, ldx);
  __syncthreads();
  if (kStash) store_slot(slot(0, H), X0, ldx, H);
  dense_layer({X0, ldx, p.wmid + 0 * HH, H}, none, 1, H, p.bmid + 0 * H, true, X1, ldx);
  __syncthreads();
  if (kStash) store_slot(slot(1, H), X1, ldx, H);
  dense_layer({X1, ldx, p.wmid + 1 * HH, H}, none, 1, H, p.bmid + 1 * H, true, X0, ldx);
  __syncthreads();
  if (kStash) store_slot(slot(2, H), X0, ldx, H);
  dense_layer({X0, ldx, p.wmid + 2 * HH, H}, none, 1, H, p.bmid + 2 * H, true, X1, ldx);
  __syncthreads();
  if (kStash) store_slot(slot(3, H), X1, ldx, H);
  dense_layer({X1, ldx, p.wmid + 3 * HH, H}, none, 1, H, p.bmid + 3 * H, true, X0, ldx);
  __syncthreads();
  if (kStash) store_slot(slot(4, H), X0, ldx, H);
  dense_layer({E, lde, p.w5e, Kp}, {X0, ldx, p.w5x, H}, 2, H, p.cb5 + (size_t)b * H,
              true, X1, ldx);
  __syncthreads();
  if (kStash) store_slot(slot(5, H), X1, ldx, H);
  dense_layer({X1, ldx, p.wmid + 4 * HH, H}, none, 1, H, p.bmid + 4 * H, true, X0, ldx);
  __syncthreads();
  if (kStash) store_slot(slot(6, H), X0, ldx, H);
  dense_layer({X0, ldx, p.wmid + 5 * HH, H}, none, 1, H, p.bmid + 5 * H, true, X1, ldx);
  __syncthreads();
  if (kStash) store_slot(slot(7, H), X1, ldx, H);

  // density head: 4 threads per row, f32 dot product of bf16 values
  {
    const int r = tid >> 2, part = tid & 3;
    float s = 0.f;
    for (int k = part; k < H; k += 4)
      s += __bfloat162float(X1[r * ldx + k]) * __bfloat162float(p.wd[k]);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) sig[r] = fmaxf(s + p.bd[0], 0.f);
  }
  // rgb_0 (no activation) reads x7 in X1; rgb_1 then overwrites X1
  dense_layer({X1, ldx, p.wr0, H}, none, 1, H, p.br0, false, X0, ldx);
  __syncthreads();
  if (kStash) store_slot(slot(8, H), X0, ldx, H);
  dense_layer({X0, ldx, p.wr1x, H}, none, 1, H2, p.cbr1 + (size_t)b * H2, true, X1, ldx);

  // compositing: one thread per ray, exclusive transmittance product
  if (tid < TR) {
    float T = 1.f, acc = 0.f, depth = 0.f;
    for (int s = 0; s < S; ++s) {
      const int r = tid * S + s;
      const size_t gp = p0 + r;
      const float alpha = 1.f - expf(-sig[r] * p.zdists[gp]);
      const float w = alpha * T;
      T *= 1.f - alpha + kEps;
      wts[r] = w;
      p.w_out[gp] = w;
      acc += w;
      depth += w * p.zvals[gp];
    }
    acc_ray[tid] = acc;
    p.bga_out[ray0 + tid] = 1.f - acc;
    p.depth_out[ray0 + tid] = depth;
  }
  __syncthreads();
  if (kStash) store_slot(slot(9, H2), X1, ldx, H2);

  // u[ray, c] = sum_s w_s y1_s[c]
  for (int i = tid; i < TR * H2; i += kThreads) {
    const int ray = i / H2, c = i - ray * H2;
    float s = 0.f;
    for (int j = 0; j < S; ++j) {
      const int r = ray * S + j;
      s += wts[r] * __bfloat162float(X1[r * ldx + c]);
    }
    u[i] = s;
  }
  __syncthreads();

  // feat_int[ray, c] = u[ray] . Wr2[:, c] + (sum_s w_s) br2[c]
  for (int i = tid; i < TR * C; i += kThreads) {
    const int ray = i / C, c = i - ray * C;
    const float* ur = u + ray * H2;
    float s = 0.f;
    for (int k = 0; k < H2; ++k) s += ur[k] * __bfloat162float(p.wr2[(size_t)k * C + c]);
    p.feat_out[(ray0 + ray) * C + c] = s + acc_ray[ray] * p.br2[c];
  }
}

}  // namespace ffwd
