// The fused field backward's tile body, shared by the single-branch
// backward (csrc/fused_field_bwd.cu, K2, which recomputes the activations)
// and the dual-branch backward (csrc/fused_field2_bwd.cu, K4, which reads
// them from the forward's stash): given a 64-point tile's (whole rays')
// activations x0..x7, y0b and y1 and its pre-ReLU densities, it runs the
// volume-integration backward, then backpropagates through the heads and the
// 8-layer trunk, giving the tile's embedding, z-value and segment-length
// cotangents and adding its weight, bias and conditioning-row gradients into
// a private f32 slab.
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
//    The same function with the head's operations cut by S; the one rounding
//    difference is that the TPU kernels round dfeat to bf16 before their dWr2
//    product and this body does not.
//
// Layout:
//  * the slab's weight matrices are kept in the mma accumulators' own order
//    (32 x 32 blocks, each lane's values contiguous), so every tile's
//    read-modify-write moves whole 512-byte runs per warp; a second kernel
//    sums the CTAs' slabs in CTA order into the row-major result
//    (slab_sum): no atomics, the same bits on every run;
//  * shared memory holds the current activation A, the cotangent halves
//    D_hi / D_lo ([64, H + 8] bf16 each) and the embedding tile.  With 64
//    rows, one pass of 16 warps (2 x 8, each 32 rows x 48 columns) covers
//    all output columns of a layer in registers, so every layer is computed
//    in place: all warps finish reading, then all write;
//  * every product is mma.sync m16n8k16 (bf16 in, f32 accumulate).  Data
//    products read A fragments from shared memory and B fragments straight
//    from the [in, out] weight copies in global memory (L2 resident).  The
//    weight-gradient products x^T . D_hi contract over the tile's points;
//    their fragments are gathered from the row-major tiles by 16-bit loads;
//  * the integration backward runs one thread per ray over its S samples
//    (transmittance forward, then the strict suffix sum backward).

#pragma once

#include "tile_mma.cuh"

namespace fbwd {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;       // points per tile (whole rays)
constexpr int kThreads = 512;   // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 32;   // two m16 tiles per warp
constexpr int kWarpCols = 48;   // six n8 tiles per warp
constexpr int kMaxCols = 8 * kWarpCols;  // one pass covers 384 columns
constexpr int kPad = 8;         // bf16 elements of row padding
constexpr int kSlots = 10;      // x0..x7, y0b, y1
constexpr float kEps = 1e-10f;

static_assert(kRows == 2 * kWarpRows, "2 warp rows cover the tile");
static_assert(kThreads == 8 * kRows, "row reductions use 8 threads per row");

// Offsets (in floats) of every gradient in one slab; each starts on a 16-byte
// boundary.  fused_field_bwd_slab_offsets hands them to the caller.
struct Slab {
  size_t w0e, wmid, bmid, w5e, w5x, wd, bd, wr0, br0, wr1x, wr2, br2, cb0, cb5, cbr1, total;
};

__host__ __device__ inline size_t align4(size_t o) { return (o + 3) & ~(size_t)3; }

__host__ __device__ inline Slab slab_layout(int B, int Kp, int H, int C) {
  const size_t H2 = H / 2, h = H, kp = Kp, c = C, b = B;
  Slab s;
  size_t o = 0;
  s.w0e = o;  o = align4(o + kp * h);
  s.wmid = o; o = align4(o + 6 * h * h);
  s.bmid = o; o = align4(o + 6 * h);
  s.w5e = o;  o = align4(o + kp * h);
  s.w5x = o;  o = align4(o + h * h);
  s.wd = o;   o = align4(o + h);
  s.bd = o;   o = align4(o + 1);
  s.wr0 = o;  o = align4(o + h * h);
  s.br0 = o;  o = align4(o + h);
  s.wr1x = o; o = align4(o + h * H2);
  s.wr2 = o;  o = align4(o + H2 * c);
  s.br2 = o;  o = align4(o + c);
  s.cb0 = o;  o = align4(o + b * h);
  s.cb5 = o;  o = align4(o + b * h);
  s.cbr1 = o; o = align4(o + b * H2);
  s.total = o;
  return s;
}

// One K-segment of a product: a [kRows, K] tile in shared memory times the
// [N, K] row-major weight w in global memory.
struct Seg {
  const bf16* act;
  int ld;
  const bf16* w;
  int K;
};

// the mma.sync fragment helpers (csrc/tile_mma.cuh)
using tile::bf2f;
using tile::ldg32;
using tile::lds32;
using tile::mma16816;
using tile::pack2;

// acc = sum over segments of act . w^T for all kRows rows and N <= kMaxCols
// columns (N a multiple of 8).  Thread layout: warp (wr, wc) = (warp >> 3,
// warp & 7) owns rows wr*32 + [0, 32) and columns wc*48 + [0, 48); element
// acc[mi][ni][2h + j] is row wr*32 + mi*16 + g + 8h, column wc*48 + ni*8 + 2t + j.
__device__ inline void gemm_rows(Seg s0, Seg s1, int nseg, int N, float (&acc)[2][6][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp >> 3) * kWarpRows;
  const int col0 = (warp & 7) * kWarpCols;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 6; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
  if (col0 >= N) return;
  for (int s = 0; s < nseg; ++s) {
    const Seg op = s ? s1 : s0;
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
}

// Forward layer: out = bf16(act(acc + bias)) into A (row stride ld) and the
// scratch slot ([kRows, N]).  The caller has synchronised after the product.
__device__ inline void epi_forward(const float (&acc)[2][6][4], int N, const float* bias,
                            bool relu, bf16* A, int ld, bf16* slot) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp >> 3) * kWarpRows, col0 = (warp & 7) * kWarpCols;
#pragma unroll
  for (int ni = 0; ni < 6; ++ni) {
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
        const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(A + r * ld + c) = v;
        *reinterpret_cast<__nv_bfloat162*>(slot + r * N + c) = v;
      }
  }
}

__device__ inline void fwd_layer(Seg s0, Seg s1, int nseg, int N, const float* bias, bool relu,
                          bf16* A, int ld, bf16* slot) {
  float acc[2][6][4];
  gemm_rows(s0, s1, nseg, N, acc);
  __syncthreads();  // every warp has read A: the layer may overwrite it
  epi_forward(acc, N, bias, relu, A, ld, slot);
  __syncthreads();
}

// Cotangent epilogue: v = acc (+ dpd[r] * wd[c]), zeroed where the mask
// activation is not positive, stored as bf16 halves into Dh / Dl; the column
// sums of v over each warp row go to cs[wr * kMaxCols + c].  The caller has
// synchronised after the product (Dh / Dl are overwritten in place).
__device__ inline void store_dpre(const float (&acc)[2][6][4], int N, const bf16* mask, int ldm,
                           const float* dpd, const bf16* wd, bf16* Dh, bf16* Dl, int ld,
                           float* cs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp >> 3) * kWarpRows, col0 = (warp & 7) * kWarpCols;
#pragma unroll
  for (int ni = 0; ni < 6; ++ni) {
    if (col0 + ni * 8 >= N) continue;  // uniform across the warp
    const int c = col0 + ni * 8 + 2 * t;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + mi * 16 + g + 8 * h;
        float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (dpd) {
          v0 += dpd[r] * bf2f(wd[c]);
          v1 += dpd[r] * bf2f(wd[c + 1]);
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
      cs[(warp >> 3) * kMaxCols + c] = s0;
      cs[(warp >> 3) * kMaxCols + c + 1] = s1;
    }
  }
}

// dembed[r, c] (row stride De) = or += the product, for c < De
__device__ inline void epi_dembed(const float (&acc)[2][6][4], int N, int De, float* dembed,
                           bool add) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp >> 3) * kWarpRows, col0 = (warp & 7) * kWarpCols;
#pragma unroll
  for (int ni = 0; ni < 6; ++ni) {
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

// slab[c] += cs[c] + cs[kMaxCols + c], c < N (the two warp rows, in order)
__device__ inline void add_colsum(float* slab, const float* cs, int N) {
  for (int c = threadIdx.x; c < N; c += kThreads) slab[c] += cs[c] + cs[kMaxCols + c];
}

// The weight gradient X^T . D (sum over the tile's points p of X[p, m] *
// D[p, n]) added into the [M, N] slab region, held as 32 x 32 blocks in
// fragment order (see tiled_index).  M and N are multiples of 32; each warp
// takes blocks in turn.
__device__ inline void outer_acc(const bf16* X, int ldx, int M, const bf16* D, int ldd, int N,
                          float* slab) {
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(X);
  const unsigned short* ds = reinterpret_cast<const unsigned short*>(D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_n = N / 32, n_blocks = (M / 32) * tiles_n;
  for (int blk = warp; blk < n_blocks; blk += kWarps) {
    const int m0 = (blk / tiles_n) * 32, n0 = (blk % tiles_n) * 32;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
#pragma unroll
    for (int k = 0; k < kRows; k += 16) {
      const int k0 = (k + 2 * t) * ldx, k1 = (k + 2 * t + 1) * ldx;
      const int k8 = (k + 2 * t + 8) * ldx, k9 = (k + 2 * t + 9) * ldx;
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m = m0 + mi * 16 + g;
        a[mi][0] = pack2(xs[k0 + m], xs[k1 + m]);
        a[mi][1] = pack2(xs[k0 + m + 8], xs[k1 + m + 8]);
        a[mi][2] = pack2(xs[k8 + m], xs[k9 + m]);
        a[mi][3] = pack2(xs[k8 + m + 8], xs[k9 + m + 8]);
      }
      const int d0 = (k + 2 * t) * ldd, d1 = (k + 2 * t + 1) * ldd;
      const int d8 = (k + 2 * t + 8) * ldd, d9 = (k + 2 * t + 9) * ldd;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + ni * 8 + g;
        const uint32_t b0 = pack2(ds[d0 + n], ds[d1 + n]);
        const uint32_t b1 = pack2(ds[d8 + n], ds[d9 + n]);
        mma16816(acc[0][ni], a[0], b0, b1);
        mma16816(acc[1][ni], a[1], b0, b1);
      }
    }
    // the block's 1024 floats in fragment order: lane's acc[mi][ni][0..3]
    // at float4 (mi * 4 + ni) * 32 + lane, so each access is 512 contiguous
    // bytes per warp; reduce_slabs restores the row-major layout
    float4* o = reinterpret_cast<float4*>(slab + (size_t)blk * 1024) + lane;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float4 v = o[(mi * 4 + ni) * 32];
        v.x += acc[mi][ni][0];
        v.y += acc[mi][ni][1];
        v.z += acc[mi][ni][2];
        v.w += acc[mi][ni][3];
        o[(mi * 4 + ni) * 32] = v;
      }
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

// The shared-memory tile: bf16 activations, cotangent halves and embedding,
// then the f32 per-point, per-ray and column-sum buffers.
struct Shared {
  bf16 *A, *Dh, *Dl, *E;  // [kRows, H + kPad] x 3, [kRows, Kp + kPad]
  float* dens;  // [kRows] pre-ReLU density
  float* wts;   // [kRows] sample weights
  float* dpd;   // [kRows] dw, then the density cotangent
  float* fg;    // [kRows] feat . gfeat, then transmittance
  float* cs;    // [2, kMaxCols] column sums
  float* u;     // [TR, H2] Wr2 . gfeat per ray
  float* aw;    // [TR, H2] sum_s w_s y1_s per ray
  float* gf;    // [TR, C] gfeat of the tile's rays
  float* cg;    // [TR] br2 . gfeat
  float* ws;    // [TR] sum_s w_s
  float* end;   // first float past the tile
};

__device__ inline Shared carve(unsigned char* smem, int S, int Kp, int H, int C) {
  const int TR = kRows / S, H2 = H / 2, ld = H + kPad, lde = Kp + kPad;
  Shared s;
  s.A = reinterpret_cast<bf16*>(smem);
  s.Dh = s.A + kRows * ld;
  s.Dl = s.Dh + kRows * ld;
  s.E = s.Dl + kRows * ld;
  s.dens = reinterpret_cast<float*>(s.E + kRows * lde);
  s.wts = s.dens + kRows;
  s.dpd = s.wts + kRows;
  s.fg = s.dpd + kRows;
  s.cs = s.fg + kRows;
  s.u = s.cs + 2 * kMaxCols;
  s.aw = s.u + TR * H2;
  s.gf = s.aw + TR * H2;
  s.cg = s.gf + TR * C;
  s.ws = s.cg + TR;
  s.end = s.ws + TR;
  return s;
}

inline size_t smem_bytes(int S, int Kp, int H, int C) {
  const int TR = kRows / S, H2 = H / 2;
  return (size_t)3 * kRows * (H + kPad) * sizeof(bf16) +
         (size_t)kRows * (Kp + kPad) * sizeof(bf16) +
         (size_t)(4 * kRows + 2 * kMaxCols + 2 * TR * H2 + TR * C + 2 * TR) * sizeof(float);
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
};

// pre-ReLU density of the tile's points from x7 in A: 8 threads per row, an
// f32 dot product of bf16 values
__device__ inline void density_pre(const Shared& s, int ld, const bf16* wd, const float* bd,
                                   int H) {
  const int r = threadIdx.x >> 3, part = threadIdx.x & 7;
  float v = 0.f;
  for (int k = part; k < H; k += 8) v += bf2f(s.A[r * ld + k]) * bf2f(wd[k]);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  if (part == 0) s.dens[r] = v + bd[0];
}

// One tile's inputs and per-point outputs.
struct TileIO {
  int b;                      // batch of the tile
  size_t p0, ray0;            // its first point and first ray
  const float* zvals;         // [B, R, S]
  const float* zdists;        // [B, R, S]
  const float* gbga;          // [B, R]
  const float* gdepth;        // [B, R]
  const float* gw;            // [B, R, S]
  const bf16* slot[9];        // the tile's rows of x0..x7, y0b: [kRows, H] each
  float* dzvals;              // [kRows] of the tile
  float* dzdists;             // [kRows]
  float* dembed;              // [kRows, De]
  bool add;                   // add into dzvals / dzdists / dembed, else store
};

// The backward of one tile.  On entry (after a barrier): E holds the
// embedding tile, gf the cotangent gfeat of its rays, A[:, :H/2] y1 and dens
// the pre-ReLU densities.  Ends with a barrier: the caller may overwrite every
// shared buffer.
__device__ inline void backward_tile(const Shared& sh, const BwdWeights& W, const TileIO& io,
                                     int S, int De, int Kp, int H, int C, const Slab& L,
                                     float* slab) {
  const int H2 = H / 2, TR = kRows / S, ld = H + kPad, lde = Kp + kPad;
  bf16 *A = sh.A, *Dh = sh.Dh, *Dl = sh.Dl, *E = sh.E;
  float *dens = sh.dens, *wts = sh.wts, *dpd = sh.dpd, *fg = sh.fg, *cs = sh.cs, *u = sh.u;
  float *aw = sh.aw, *gf = sh.gf, *cg = sh.cg, *ws = sh.ws;
  const int tid = threadIdx.x, b = io.b;
  const size_t p0 = io.p0, ray0 = io.ray0;
  const size_t HH = (size_t)H * H;
  const int mid_of[8] = {-1, 0, 1, 2, 3, -1, 4, 5};  // Wmid slot of trunk layer i
  float acc[2][6][4];

  // ---- the folded head: u = Wr2 . gfeat, cg = br2 . gfeat per ray ----
  for (int i = tid; i < TR * H2; i += kThreads) {
    const int ray = i / H2, k = i - ray * H2;
    const float* gr = gf + ray * C;
    const bf16* wk = W.wr2 + (size_t)k * C;
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += gr[c] * bf2f(wk[c]);
    u[i] = s;
  }
  for (int ray = tid; ray < TR; ray += kThreads) {
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += W.br2[c] * gf[ray * C + c];
    cg[ray] = s;
  }
  __syncthreads();
  {  // fg = feat . gfeat = y1 . u + cg, 8 threads per row
    const int r = tid >> 3, part = tid & 7, ray = r / S;
    float s = 0.f;
    for (int k = part; k < H2; k += 8) s += bf2f(A[r * ld + k]) * u[ray * H2 + k];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    if (part == 0) fg[r] = s + cg[ray];
  }
  __syncthreads();

  // ---- integration backward, one thread per ray ----
  if (tid < TR) {
    const size_t ray = ray0 + tid;
    const float gb = io.gbga[ray], gd = io.gdepth[ray];
    float T = 1.f, wsum = 0.f;
    for (int s = 0; s < S; ++s) {
      const int r = tid * S + s;
      const size_t gp = p0 + r;
      const float sigma = fmaxf(dens[r], 0.f);
      const float alpha = 1.f - expf(-sigma * io.zdists[gp]);
      const float w = alpha * T;
      wts[r] = w;
      wsum += w;
      dpd[r] = fg[r] + io.zvals[gp] * gd - gb + io.gw[gp];  // dw
      fg[r] = T;
      T *= 1.f - alpha + kEps;
    }
    ws[tid] = wsum;
    float suffix = 0.f;  // sum over later samples of w * dw
    for (int s = S - 1; s >= 0; --s) {
      const int r = tid * S + s;
      const size_t gp = p0 + r;
      const float sigma = fmaxf(dens[r], 0.f);
      const float zd = io.zdists[gp];
      const float e = expf(-sigma * zd);
      const float alpha = 1.f - e;
      const float dw = dpd[r], w = wts[r];
      const float dalpha = dw * fg[r] - suffix / (1.f - alpha + kEps);
      suffix += w * dw;
      io.dzvals[r] = io.add ? io.dzvals[r] + w * gd : w * gd;
      io.dzdists[r] = io.add ? io.dzdists[r] + dalpha * sigma * e : dalpha * sigma * e;
      dpd[r] = dens[r] > 0.f ? dalpha * zd * e : 0.f;
    }
  }
  __syncthreads();

  // ---- head backward ----
  for (int i = tid; i < TR * H2; i += kThreads) {  // aw = sum_s w_s y1_s
    const int ray = i / H2, k = i - ray * H2;
    float s = 0.f;
    for (int j = 0; j < S; ++j) s += wts[ray * S + j] * bf2f(A[(ray * S + j) * ld + k]);
    aw[i] = s;
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
      if (bf2f(A[r * ld + k]) > 0.f) s += wts[r] * u[(r / S) * H2 + k];
    slab[L.cbr1 + (size_t)b * H2 + k] += s;
  }
  if (tid == 0) {  // dbd
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += dpd[r];
    slab[L.bd] += s;
  }
  __syncthreads();
  for (int i = tid; i < H2 * C; i += kThreads) {  // dWr2 [H2, C]
    const int k = i / C, c = i - k * C;
    float s = 0.f;
    for (int ray = 0; ray < TR; ++ray) s += aw[ray * H2 + k] * gf[ray * C + c];
    slab[L.wr2 + i] += s;
  }
  for (int c = tid; c < C; c += kThreads) {  // dbr2
    float s = 0.f;
    for (int ray = 0; ray < TR; ++ray) s += ws[ray] * gf[ray * C + c];
    slab[L.br2 + c] += s;
  }
  load_tile(A, ld, io.slot[8], H);  // y0b
  __syncthreads();
  outer_acc(A, ld, H, Dh, ld, H2, slab + L.wr1x);  // dWr1x = y0b^T bf16(dy1)
  gemm_rows({Dh, ld, W.wr1x_t, H2}, {Dl, ld, W.wr1x_t, H2}, 2, H, acc);  // dy0
  __syncthreads();
  store_dpre(acc, H, nullptr, 0, nullptr, nullptr, Dh, Dl, ld, cs);
  __syncthreads();
  add_colsum(slab + L.br0, cs, H);
  load_tile(A, ld, io.slot[7], H);  // x7
  __syncthreads();
  outer_acc(A, ld, H, Dh, ld, H, slab + L.wr0);  // dWr0 = x7^T bf16(dy0)
  for (int j = tid; j < H; j += kThreads) {      // dWd = x7^T bf16(ddens)
    float s = 0.f;
    for (int r = 0; r < kRows; ++r)
      s += bf2f(A[r * ld + j]) * bf2f(__float2bfloat16(dpd[r]));
    slab[L.wd + j] += s;
  }
  gemm_rows({Dh, ld, W.wr0_t, H}, {Dl, ld, W.wr0_t, H}, 2, H, acc);  // dx7
  __syncthreads();
  store_dpre(acc, H, A, ld, dpd, W.wd, Dh, Dl, ld, cs);  // dpre7
  __syncthreads();
  add_colsum(slab + L.bmid + 5 * (size_t)H, cs, H);

  // ---- trunk backward: layers 7 .. 1 ----
  for (int i = 7; i >= 1; --i) {
    load_tile(A, ld, io.slot[i - 1], H);  // x_{i-1}
    __syncthreads();
    if (i == 5) {
      outer_acc(A, ld, H, Dh, ld, H, slab + L.w5x);
      outer_acc(E, lde, Kp, Dh, ld, H, slab + L.w5e);
      gemm_rows({Dh, ld, W.w5e_t, H}, {Dl, ld, W.w5e_t, H}, 2, Kp, acc);
      epi_dembed(acc, Kp, De, io.dembed, io.add);
      gemm_rows({Dh, ld, W.w5x_t, H}, {Dl, ld, W.w5x_t, H}, 2, H, acc);
    } else {
      const size_t m = mid_of[i];
      outer_acc(A, ld, H, Dh, ld, H, slab + L.wmid + m * HH);
      gemm_rows({Dh, ld, W.wmid_t + m * HH, H}, {Dl, ld, W.wmid_t + m * HH, H}, 2, H, acc);
    }
    __syncthreads();
    store_dpre(acc, H, A, ld, nullptr, nullptr, Dh, Dl, ld, cs);  // dpre_{i-1}
    __syncthreads();
    const int j = i - 1;
    float* bias = j == 0   ? slab + L.cb0 + (size_t)b * H
                  : j == 5 ? slab + L.cb5 + (size_t)b * H
                           : slab + L.bmid + (size_t)mid_of[j] * H;
    add_colsum(bias, cs, H);
  }
  outer_acc(E, lde, Kp, Dh, ld, H, slab + L.w0e);
  gemm_rows({Dh, ld, W.w0e_t, H}, {Dl, ld, W.w0e_t, H}, 2, Kp, acc);
  epi_dembed(acc, Kp, De, io.dembed, true);
  __syncthreads();  // the caller may overwrite E, A, Dh, Dl and the floats
}

// Where element k = r * N + c of an [M, N] region (a multiple of 32 both
// ways) lives when outer_acc keeps it in 32 x 32 blocks in fragment order:
// block (r / 32, c / 32) row-major, within it the mma accumulator of lane
// g * 4 + t, tile (mi, ni), slot q at (mi * 4 + ni) * 128 + lane * 4 + q.
__device__ __forceinline__ size_t tiled_index(size_t k, int N) {
  const int r = (int)(k / N), c = (int)(k % N);
  const int rr = r & 31, cc = c & 31;
  const int mi = rr >> 4, h = (rr >> 3) & 1, g = rr & 7;
  const int ni = cc >> 3, t = (cc >> 1) & 3, q = 2 * h + (cc & 1);
  const size_t blk = (size_t)(r >> 5) * (N >> 5) + (c >> 5);
  return blk * 1024 + (mi * 4 + ni) * 128 + (g * 4 + t) * 4 + q;
}

// Slab position of gradient element i (row-major layout, as the output).
__device__ inline size_t slab_index(const Slab& L, size_t i, int Kp, int H) {
  const size_t h = H, kp = Kp, HH = h * h;
  if (i >= L.wmid && i < L.wmid + 6 * HH) {
    const size_t o = L.wmid + (i - L.wmid) / HH * HH;
    return o + tiled_index(i - o, H);
  }
  const size_t starts[5] = {L.w0e, L.w5e, L.w5x, L.wr0, L.wr1x};
  const size_t sizes[5] = {kp * h, kp * h, HH, HH, h * (h / 2)};
  const int cols[5] = {H, H, H, H, H / 2};
#pragma unroll
  for (int j = 0; j < 5; ++j)
    if (i >= starts[j] && i < starts[j] + sizes[j])
      return starts[j] + tiled_index(i - starts[j], cols[j]);
  return i;  // biases, dWd, dWr2 and the conditioning rows: row-major
}

// out[i] = sum over the G CTAs c, in order, of the slabs' element i
__device__ inline void slab_sum(const float* slabs, int G, size_t len, const Slab& L, int Kp,
                                int H, float* out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t src = slab_index(L, i, Kp, H);
    float s = 0.f;
    for (int c = 0; c < G; ++c) s += slabs[(size_t)c * len + src];
    out[i] = s;
  }
}

}  // namespace fbwd
