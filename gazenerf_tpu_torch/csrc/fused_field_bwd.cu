// Fused field backward for NVIDIA Hopper (sm_90a): for every 64-point tile
// (whole rays, or a part of a ray of S = 128-256 samples) it recomputes the
// field MLP's forward (recompute mode) or reads the bf16 activations x0..x7,
// y0b and y1 that the forward stashed (stash mode; only the density
// pre-activation is recomputed, from x7), runs the volume-integration
// backward, then backpropagates through the heads and the 8-layer trunk,
// giving the embedding, z-value and segment-length cotangents per point and
// the weight, bias and conditioning-row gradients summed over all points.
//
// Replaces the TPU kernel gazenerf_tpu/kernels/fused_field_bwd.py:_bwd_kernel
// (launched by pallas_backward) with stash_acts False or True in each form of
// the stash (the bf16 stash of every layer; stash_every=k, every k-th trunk
// layer; stash_dtype int8, x0..x6 and y0b as int8 codes), dens_vpu False or
// True, and embed_in_kernel False or True: given the
// embedding it writes its f32 cotangent (a bf16 embedding's cotangent is
// that, rounded by the caller); given the points (embed_in_kernel) it
// recomputes their encoding wherever it reads the embedding (the tile, the
// GEMM's operand; the stash holds none) and writes the points' f32
// cotangent, summed from the tile's f32 embedding cotangent as the TPU
// kernel's _embed_bwd_tile sums it (csrc/point_encoding.cuh): 12 bytes a
// point in place of 252.  The tile's f32 embedding cotangent goes to a
// small per-CTA scratch, and the points' cotangent from there.  dens_vpu is
// one rounding point here: with it, dWd = x7^T ddens takes the f32 density
// cotangent, without it its bf16 rounding.  split_dw=True is this kernel
// reading the stash without dens_vpu: that mode's epilogue contracts each
// weight gradient over the stash in one large-K matmul of the bf16
// cotangents, which the chunked GEMM here (csrc/field_dw.cuh) does in every
// mode, and takes dWd from the rounded density cotangent whatever dens_vpu
// says (TPU kernel :533); models/gaze_nerf.py selects it for pallas_split_dw.
//
// Numerics follow that kernel: the recomputed activations round to bf16 at
// K1's points (csrc/fused_field_fwd.cu); data gradients are f32 (as bf16
// hi/lo mma.sync pairs), weight gradients bf16 x bf16 products summed in f32;
// the feature head is folded per ray.  The details are with the tile body in
// csrc/field_bwd.cuh, which the dual-branch backward (csrc/fused_field2_bwd.cu)
// shares, and with the weight-gradient GEMM in csrc/field_dw.cuh.
//
// Bound.  Per point the backward repeats the forward's ~1.30 M multiply-adds
// (recompute), then as many for the data gradients and as many again for the
// weight gradients: ~3.9 M per point, ~4.1 TFLOP at B=2, R=4096, S=64,
// hidden 384, against ~0.25 GB of global traffic that the function needs
// (embedding and cotangents in, embedding / z cotangents and gradients out).
// It is bound by bf16 tensor-core operations.  In stash mode the recompute
// goes (~2.6 M per point, ~2.8 TFLOP) and the stash is read (~3.83 GB, ~1.1
// ms at 3.35 TB/s): still bound by operations.
//
// Design.  The points go in chunks of whole tiles (the caller's plan,
// kernels/field_dw.py); per chunk, three launches on the stream:
//  * field_bwd_kernel: one CTA per SM walks the chunk's tiles (a ray longer
//    than a tile is one unit of S / 64 tiles, run in two sweeps: the tiles'
//    forward parts, the ray's integration backward, the tiles' backward;
//    recomputing, the first sweep keeps y1 in the chunk buffer), recomputes
//    each tile's activations (their rows go to the chunk buffer: x0..x7,
//    y0b and the padded embedding) or, in stash mode, reads x7 and y1 from
//    the stash (the padded embedding still goes to the chunk buffer; x0..x7
//    and y0b are read from the stash where the body and the GEMM need them,
//    as in the dual-branch backward), and runs the tile body, which writes each
//    layer's bf16 cotangent and each ray's folded-head sums to the chunk
//    buffer and adds the biases, conditioning rows and dWd into its CTA's
//    small f32 buffer;
//  * field_dw_kernel: dW (+)= X^T D for the eleven weight blocks over the
//    chunk's points (csrc/field_dw.cuh);
//  * field_head_kernel: dWr2 and dbr2 (+)= over the chunk's rays.
// The stash's other forms run field_bwd_part_kernel, its own instantiation of
// the tile loop, which fills the
// chunk buffer's rows of the layers that the stash does not hold in bf16, so
// that the tile body and the GEMM read every layer from one pointer per
// slot, the stash's or the chunk buffer's:
//  * stash_every=k: the missing trunk layers recomputed in forward order,
//    each from its predecessor (read from the stash into the tile when it is
//    a stashed one), and y0b, y1 from x7 as the recompute does;
//  * int8: x0..x6 and y0b dequantized into the chunk buffer, bf16(q * s) in
//    f32, 8 codes a thread and load (the simple choice: the tile body and the
//    GEMM stay as they are, at the cost of writing and reading those eight
//    layers' bf16 rows once more, ~6.1 KB a point, as the recompute does).
// After the last chunk field_sum_kernel sums the per-CTA buffers in CTA
// order.  No atomics: the same bits on every run.  Scratch: the chunk
// buffer, ~14.3 KB per point at hidden 384 (x0..x7, y0b, the embedding and
// the ten cotangents; ~7.4 KB reading the bf16 stash of every layer,
// without x0..x7 and y0b; the other forms' as the recompute's), the GEMM's
// partial sums (42 MB) and gridDim.x small buffers of ~5 K floats: ~0.53 GB
// for chunks of 528 tiles (~0.29 GB reading the bf16 stash of every layer).
// The stash equals the recompute to the bit (one forward tile code, the
// same products), so the recompute, the bf16 stash of every layer and of
// every k-th layer give the same gradients; the int8 stash's dequantized
// values are its own.

#include <cstdint>

#include "field_bwd.cuh"
#include "point_encoding.cuh"

namespace {

using namespace fbwd;

struct Params {
  const bf16* embed;    // [B, R, S, De]; kPoints: the points [B, R, S, 3] f32
  const float* zvals;   // [B, R, S]
  const float* zdists;  // [B, R, S]
  const float* cb0;     // [B, H]
  const float* cb5;     // [B, H]
  const float* cbr1;    // [B, H/2]
  // forward operands, K1's layout: [out, in]
  const bf16* w0e;      // [H, Kp]
  const bf16* wmid;     // [6, H, H]
  const float* bmid;    // [6, H]
  const bf16* w5e;      // [H, Kp]
  const bf16* w5x;      // [H, H]
  const bf16* wr0;      // [H, H]
  const float* br0;     // [H]
  const bf16* wr1x;     // [H/2, H]
  BwdWeights w;         // the heads and the data-gradient operands
  // cotangents of (feat_int, bg_alpha, depth, weights)
  const float* gfeat;   // [B, R, C]
  const float* gbga;    // [B, R]
  const float* gdepth;  // [B, R]
  const float* gw;      // [B, R, S]
  // per-point outputs
  float* dembed;        // [B, R, S, De] (kPoints: the points' [B, R, S, 3])
  float* dzvals;        // [B, R, S]
  float* dzdists;       // [B, R, S]
  // the forward's stash (stash mode): x0..x7, y0b [B, R, S, H], y1 [B, R, S, H/2]
  // (another form: those it holds in bf16, the others null)
  const bf16* stash[kXSlots + 1];
  // scratch
  float* small;             // [G, total - small] per-CTA sums
  bf16* xbase[kXSlots];     // the chunk buffer's x0..x7, y0b [P, H] (recompute mode)
  bf16* y1;                 // and y1 [P, H/2] (recompute mode, rays that span tiles)
  bf16* e;                  // its padded embedding [P, Kp]
  bf16* dbase[kDSlots];     // its cotangents dy1 [P, H/2], dy0, dpre7 .. dpre0 [P, H]
  float* aw;                // its folded-head sums [P / S, H/2 + 1]
  int R, S, De, Kp, H, C;
  int t0, nt;               // the chunk's first tile and its tiles
  Grads L;
  float* dtile;             // kPoints: per CTA a tile's f32 dembed [kRows, De]
  // another form of the stash (field_bwd_part_kernel)
  const bf16* xsrc[kXSlots];        // per slot, rows indexed by the global point: the
                                    // stash's, or the chunk buffer's less its first point
  const signed char* codes[kXSlots];  // int8: x0..x6, y0b codes [B, R, S, H] (null elsewhere)
  const float* scales;              // int8: [B, R, S, 8] f32, column j for x0..x6, y0b
  unsigned kept;                    // stash_every: bit i set when x_i is stashed
};

// The kernel's modes of the stash: none (recompute), the bf16 stash of every
// layer, another form
enum { kRecompute = 0, kFull = 1, kPart = 2 };

// The int8 stash's rows of the tile at point p0 as bf16 into the chunk
// buffer's rows from lp0: x_i = bf16(q * s), the product in f32, 8 codes a
// load.  No barrier: the body reads them after its own.
__device__ inline void dequantize_tile(const Params& p, size_t p0, size_t lp0) {
  const int H = p.H, vec = H / 8;
  for (int j = 0; j < 8; ++j) {
    const int slot = j < 7 ? j : 8;
    const signed char* src = p.codes[slot] + p0 * H;
    bf16* dst = p.xbase[slot] + lp0 * H;
    for (int i = threadIdx.x; i < kRows * vec; i += kThreads) {
      const int r = i / vec, v = i - r * vec;
      const float sc = p.scales[(p0 + r) * 8 + j];
      const uint2 q = *reinterpret_cast<const uint2*>(src + (size_t)r * H + v * 8);
      uint32_t out[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t w = k < 2 ? q.x : q.y;
        const int sh = 16 * (k & 1);
        const float f0 = __fmul_rn((float)(signed char)(w >> sh), sc);
        const float f1 = __fmul_rn((float)(signed char)(w >> (sh + 8)), sc);
        const __nv_bfloat162 b = __floats2bfloat162_rn(f0, f1);
        out[k] = *reinterpret_cast<const uint32_t*>(&b);
      }
      *reinterpret_cast<uint4*>(dst + (size_t)r * H + v * 8) =
          make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
}

// The tile at point p0's points' cotangent from its embedding's f32
// cotangent in the CTA's scratch `dt` ([kRows, De], which the tile body has
// finished).  Ends with a barrier: the next tile rewrites `dt`.
__device__ inline void store_dpts(const Params& p, const float* dt, size_t p0) {
  const int De = p.De;
  const float* pts = reinterpret_cast<const float*>(p.embed) + p0 * 3;
  for (int i = threadIdx.x; i < kRows * 3; i += kThreads) {
    const int r = i / 3, d = i - 3 * r;
    p.dembed[p0 * 3 + i] = enc::encode_vjp(pts + r * 3, dt + r * De, d, De);
  }
  __syncthreads();
}

// The tile loop of stash mode kMode.  kSpan: rays longer than a tile (S >
// kRows), a separate instantiation so that the tile code of whole rays
// carries none of the two sweeps' state; kPoints (the points encoded in the
// tile) likewise, so that the embedding's kernels carry none of it
template <int kMode, bool kSpan, bool kPoints>
__device__ __forceinline__ void tile_loop(const Params& p) {
  constexpr bool kStash = kMode == kFull;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, H2 = p.H / 2, S = p.S, C = p.C, Kp = p.Kp, De = p.De;
  const int TR = tile_rays(S), nb = kSpan ? ray_tiles(S) : 1;
  const int ld = H + kPad, lde = Kp + kPad;
  const Shared sh = carve(smem, S, Kp, H, C);
  bf16 *A = sh.A, *E = sh.E;

  float* small = p.small + (size_t)blockIdx.x * (p.L.total - p.L.small);
  const int tid = threadIdx.x;
  const size_t HH = (size_t)H * H;
  const Seg none = {nullptr, nullptr, 0, nullptr, 0};
  const size_t points_per_batch = (size_t)p.R * S;

  // The tile at point p0 (lp0 in the chunk): its embedding into E and the
  // chunk buffer, then A[:, :H2] = y1 and sk.dens its pre-ReLU densities
  auto forward = [&](const Shared& sk, size_t p0, size_t lp0, int b) {
    for (int i = tid; i < kRows * Kp; i += kThreads) {
      const int r = i / Kp, c = i - r * Kp;
      E[r * lde + c] = c < De ? enc::embed_at<kPoints>(p.embed, p0 + r, c, De)
                              : __float2bfloat16(0.f);
    }
    __syncthreads();
    store_tile(p.e + lp0 * Kp, E, lde, Kp);

    if (kStash || (kMode == kPart && p.codes[0])) {  // ---- x7 (its density), y1 into A ----
      if (kMode == kPart) dequantize_tile(p, p0, lp0);  // and x0..x6, y0b to the chunk buffer
      load_tile(A, ld, p.stash[7] + p0 * H, H);
      __syncthreads();
      density_pre(sk, ld, p.w.wd, p.w.bd, H);
      __syncthreads();
      load_tile(A, ld, p.stash[9] + p0 * H2, H2);  // A[:, :H2] = y1
      __syncthreads();
    } else {  // ---- recompute x0..x7 (those not stashed), y0b into the chunk buffer, y1 in A ----
      // (kPart: A holds x_{i-1} unless that layer is stashed, then read from there)
      bool in_a = true;
      auto input = [&](int i) {
        if (kMode == kPart && !in_a) {
          __syncthreads();  // every thread is done with A
          load_tile(A, ld, p.stash[i - 1] + p0 * H, H);
          __syncthreads();
        }
        in_a = true;
      };
      if (kMode == kPart && (p.kept & 1)) {
        in_a = false;
      } else {
        fwd_layer({E, nullptr, lde, p.w0e, Kp}, none, 1, H, p.cb0 + (size_t)b * H, true, A, ld,
                  sh.W, p.xbase[0] + lp0 * H);
      }
#pragma unroll 1
      for (int i = 1; i < 8; ++i) {
        if (kMode == kPart && (p.kept >> i & 1)) {
          in_a = false;
          continue;
        }
        input(i);
        if (i == 5)
          fwd_layer({E, nullptr, lde, p.w5e, Kp}, {A, nullptr, ld, p.w5x, H}, 2, H,
                    p.cb5 + (size_t)b * H, true, A, ld, sh.W, p.xbase[i] + lp0 * H);
        else
          fwd_layer({A, nullptr, ld, p.wmid + mid_slot(i) * HH, H}, none, 1, H,
                    p.bmid + mid_slot(i) * H, true, A, ld, sh.W, p.xbase[i] + lp0 * H);
      }
      input(8);  // x7
      density_pre(sk, ld, p.w.wd, p.w.bd, H);
      fwd_layer({A, nullptr, ld, p.wr0, H}, none, 1, H, p.br0, false, A, ld, sh.W,
                p.xbase[8] + lp0 * H);
      // A[:, :H2] = y1, kept in the chunk buffer for a ray's second sweep
      fwd_layer({A, nullptr, ld, p.wr1x, H}, none, 1, H2, p.cbr1 + (size_t)b * H2, true, A,
                ld, sh.W, kSpan ? p.y1 + lp0 * H2 : nullptr);
    }
  };
  auto tile_io = [&](size_t p0, size_t lp0, int b) {
    TileIO io;
    io.b = b;
    io.p0 = p0;
    io.ray0 = p0 / S;
    io.zvals = p.zvals;
    io.zdists = p.zdists;
    io.gbga = p.gbga;
    io.gdepth = p.gdepth;
    io.gw = p.gw;
    if (kStash) {  // the masks from the stash, rows indexed in 64 bits
      io.x = p.stash;
      io.xrow = p0;
    } else if (kMode == kPart) {  // from the stash or the chunk buffer, by the global row
      io.x = p.xsrc;
      io.xrow = p0;
    } else {
      io.x = p.xbase;
      io.xrow = lp0;
    }
    io.d = p.dbase;
    io.drow = lp0;
    io.aw = p.aw + lp0 / S * (H2 + 1);
    io.dzvals = p.dzvals + p0;
    io.dzdists = p.dzdists + p0;
    io.dembed = kPoints ? p.dtile + (size_t)blockIdx.x * kRows * De : p.dembed + p0 * De;
    io.add = false;
    io.aw_add = false;
    return io;
  };

  // a unit is a tile of whole rays, or a ray that spans nb tiles
  for (int g = blockIdx.x; g < p.nt / nb; g += gridDim.x) {
    const size_t p0 = (size_t)(p.t0 + g * nb) * kRows;  // first point of the unit
    const size_t lp0 = (size_t)g * nb * kRows;          // and in the chunk
    const int b = (int)(p0 / points_per_batch);
    const size_t ray0 = p0 / S;
    for (int i = tid; i < TR * C; i += kThreads) sh.gf[i] = p.gfeat[ray0 * C + i];
    if (!kSpan) {
      forward(sh, p0, lp0, b);
      if constexpr (kPoints) {
        const TileIO io = tile_io(p0, lp0, b);
        backward_tile(sh, p.w, io, S, De, Kp, H, C, p.L, small);
        store_dpts(p, io.dembed, p0);
      } else {
        backward_tile(sh, p.w, tile_io(p0, lp0, b), S, De, Kp, H, C, p.L, small);
      }
      continue;
    }
    // the ray's tiles' forward parts, the integration backward over all its
    // samples, then its tiles' backward
    __syncthreads();
    fold_head(sh, p.w, 1, H2, C);
    for (int k = 0; k < nb; ++k) {
      const Shared sk = tile_of(sh, k);
      forward(sk, p0 + k * kRows, lp0 + k * kRows, b);
      fold_features(sk, S, H2, ld);
    }
    integrate_ray(sh, tile_io(p0, lp0, b), S);
    __syncthreads();
    for (int k = 0; k < nb; ++k) {
      const size_t pk = p0 + k * kRows, lk = lp0 + k * kRows;
      const bool y1_stashed = kStash || (kMode == kPart && p.codes[0]);
      load_tile(A, ld, y1_stashed ? p.stash[9] + pk * H2 : p.y1 + lk * H2, H2);  // y1
      __syncthreads();
      TileIO io = tile_io(pk, lk, b);
      io.aw = p.aw + lp0 / S * (H2 + 1);  // the ray's
      io.aw_add = k > 0;
      backward_heads_trunk(tile_of(sh, k), p.w, io, S, De, Kp, H, p.L, small);
      if constexpr (kPoints) store_dpts(p, io.dembed, pk);
    }
  }
}

// recomputing (kStash false) or reading the bf16 stash of every layer
template <bool kStash, bool kSpan, bool kPoints>
__global__ void __launch_bounds__(kThreads, 1)
    field_bwd_kernel(const __grid_constant__ Params p) {
  tile_loop<kStash ? kFull : kRecompute, kSpan, kPoints>(p);
}

// reading another form of the stash
template <bool kSpan, bool kPoints>
__global__ void __launch_bounds__(kThreads, 1)
    field_bwd_part_kernel(const __grid_constant__ Params p) {
  tile_loop<kPart, kSpan, kPoints>(p);
}

// the tile kernel of stash mode `mode`, rays that span tiles or not, given
// the points or not
template <bool kSpan>
void (*tile_kernel_for(int mode, bool points))(Params) {
  if (mode == kPart)
    return points ? field_bwd_part_kernel<kSpan, true> : field_bwd_part_kernel<kSpan, false>;
  if (mode == kFull)
    return points ? field_bwd_kernel<true, kSpan, true> : field_bwd_kernel<true, kSpan, false>;
  return points ? field_bwd_kernel<false, kSpan, true> : field_bwd_kernel<false, kSpan, false>;
}

__global__ void __launch_bounds__(fdw::kThreads)
    field_dw_kernel(const __grid_constant__ fdw::Jobs js) {
  extern __shared__ __align__(16) unsigned char smem[];
  fdw::dw_tile(js, smem);
}

__global__ void __launch_bounds__(256) field_dwsum_kernel(const __grid_constant__ fdw::Jobs js) {
  fdw::dw_reduce(js);
}

__global__ void field_head_kernel(const float* aw, const float* gf, int rays, int K, int C,
                                  int accumulate, float* out) {
  fdw::head_dw(aw, gf, rays, K, C, accumulate, out);
}

__global__ void field_sum_kernel(const float* small, int G, size_t len, float* out) {
  fdw::sum_small(small, G, len, out);
}

}  // namespace

extern "C" {

// The buffers' layout: out[0..14] the offsets (in floats) of W0e, Wmid, bmid,
// W5e, W5x, Wd, bd, Wr0, br0, Wr1x, Wr2, br2, cb0, cb5, cbr1 in `grads` (each
// block row-major), out[15] the length of `grads`, out[16] the bytes of
// scratch for G CTAs and chunks of up to chunk_tiles tiles in stash mode
// `stash` (0 recompute, 1 the bf16 stash of every layer: without the chunk
// buffer's x0..x7 and y0b, 2 another form; with `points`, with the CTAs'
// tile cotangents).
void fused_field_bwd_layout(int B, int S, int Kp, int H, int C, int G, int chunk_tiles,
                            int stash, int points, long long* out) {
  const Grads s = grad_layout(B, Kp, H, C);
  const size_t v[16] = {s.w0e, s.wmid, s.bmid, s.w5e, s.w5x, s.wd, s.bd, s.wr0,
                        s.br0, s.wr1x, s.wr2, s.br2, s.cb0, s.cb5, s.cbr1, s.total};
  for (int i = 0; i < 16; ++i) out[i] = (long long)v[i];
  const Chunk c = chunk_layout((size_t)chunk_tiles * kRows, S, Kp, H, stash != kFull, 1);
  out[16] = (long long)(align256((size_t)G * (s.total - s.small) * sizeof(float)) +
                        align256(c.total) +
                        (points ? (size_t)G * kRows * Kp * sizeof(float) : 0));
}

// Launch one chunk on `stream`: tiles [t0, t0 + nt) (first: the first chunk,
// which zeroes the per-CTA sums and stores rather than adds; last: the last,
// which sums them into `grads`).  Returns the first cudaError_t (0 =
// success).  The caller (kernels/fused_field_bwd.py) has checked the shapes:
// S divides 64 (R*S a multiple of 64) or is a multiple of 64 up to 256, H
// is a multiple of 64 and at most 384, Kp a multiple of 32; nt <=
// chunk_tiles, and a chunk holds whole rays; it allocates `scratch` (the
// layout's bytes) and `grads`.  `stash` is null (recompute mode) or eleven
// pointers: x0..x7, y0b ([B, R, S, H] each) and y1 ([B, R, S, H/2]), null
// where the stash keeps no such slot (stash_every), then the int8 stash's
// scales ([B, R, S, 8] f32), null for a bf16 stash; with the scales x0..x6
// and y0b are int8 codes and x7, y1 bf16.
// `dens_vpu`: dWd from the unrounded density cotangent.  `points`: `embed`
// holds the f32 points and `dembed` gets their cotangent (De = 3 + 6
// n_freqs the encoded width), else the bf16 embedding and its f32
// cotangent.
int fused_field_bwd(const void* embed, const float* zvals, const float* zdists,
                    const float* cb0, const float* cb5, const float* cbr1,
                    const void* w0e, const void* wmid, const float* bmid, const void* w5e,
                    const void* w5x, const void* wd, const float* bd, const void* wr0,
                    const float* br0, const void* wr1x, const void* wr2, const float* br2,
                    const void* w0e_t, const void* wmid_t, const void* w5e_t,
                    const void* w5x_t, const void* wr0_t, const void* wr1x_t,
                    const float* gfeat, const float* gbga, const float* gdepth,
                    const float* gw, void* const* stash, float* dembed, float* dzvals,
                    float* dzdists, void* scratch, float* grads, int B, int R, int S, int De,
                    int Kp, int H, int C, int G, int chunk_tiles, int t0, int nt, int first,
                    int last, int dens_vpu, int points, void* stream) {
  Params p;
  p.embed = static_cast<const bf16*>(embed);
  p.zvals = zvals;
  p.zdists = zdists;
  p.cb0 = cb0;
  p.cb5 = cb5;
  p.cbr1 = cbr1;
  p.w0e = static_cast<const bf16*>(w0e);
  p.wmid = static_cast<const bf16*>(wmid);
  p.bmid = bmid;
  p.w5e = static_cast<const bf16*>(w5e);
  p.w5x = static_cast<const bf16*>(w5x);
  p.w.wd = static_cast<const bf16*>(wd);
  p.w.bd = bd;
  p.wr0 = static_cast<const bf16*>(wr0);
  p.br0 = br0;
  p.wr1x = static_cast<const bf16*>(wr1x);
  p.w.wr2 = static_cast<const bf16*>(wr2);
  p.w.br2 = br2;
  p.w.w0e_t = static_cast<const bf16*>(w0e_t);
  p.w.wmid_t = static_cast<const bf16*>(wmid_t);
  p.w.w5e_t = static_cast<const bf16*>(w5e_t);
  p.w.w5x_t = static_cast<const bf16*>(w5x_t);
  p.w.wr0_t = static_cast<const bf16*>(wr0_t);
  p.w.wr1x_t = static_cast<const bf16*>(wr1x_t);
  p.w.dens_vpu = dens_vpu;
  // the stash's mode: the bf16 stash of every layer (ten pointers, no
  // scales), or another form
  const bool quant = stash && stash[kXSlots + 1];
  int mode = stash ? kFull : kRecompute;
  p.kept = 0;
  for (int k = 0; k <= kXSlots; ++k) {
    const bool code = quant && k != 7 && k != kXSlots;
    if (stash && !stash[k]) mode = kPart;
    p.stash[k] = stash && !code ? static_cast<const bf16*>(stash[k]) : nullptr;
    if (k < kXSlots) p.codes[k] = code ? static_cast<const signed char*>(stash[k]) : nullptr;
    if (k < 8 && p.stash[k]) p.kept |= 1u << k;
  }
  if (quant) mode = kPart;
  p.scales = quant ? static_cast<const float*>(stash[kXSlots + 1]) : nullptr;
  p.gfeat = gfeat;
  p.gbga = gbga;
  p.gdepth = gdepth;
  p.gw = gw;
  p.dembed = dembed;
  p.dzvals = dzvals;
  p.dzdists = dzdists;
  p.R = R;
  p.S = S;
  p.De = De;
  p.Kp = Kp;
  p.H = H;
  p.C = C;
  p.t0 = t0;
  p.nt = nt;
  p.L = grad_layout(B, Kp, H, C);
  const size_t small_len = p.L.total - p.L.small;
  p.small = static_cast<float*>(scratch);
  unsigned char* chunk =
      static_cast<unsigned char*>(scratch) + align256((size_t)G * small_len * sizeof(float));
  const Chunk CL = chunk_layout((size_t)chunk_tiles * kRows, S, Kp, H, mode != kFull, 1);
  const size_t pt0 = (size_t)t0 * kRows;  // the chunk's first point
  for (int i = 0; i < kXSlots; ++i) {
    p.xbase[i] = mode == kFull ? nullptr : reinterpret_cast<bf16*>(chunk + CL.x[i]);
    // another form: a slot's rows by the global point, in the stash or,
    // less the chunk's first point, in the chunk buffer (integer arithmetic:
    // the row p0 of a tile of the chunk lies in the buffer)
    const uintptr_t chunk_rows = reinterpret_cast<uintptr_t>(p.xbase[i]) - pt0 * H * sizeof(bf16);
    p.xsrc[i] = mode != kPart ? nullptr
                : p.stash[i]  ? p.stash[i]
                              : reinterpret_cast<const bf16*>(chunk_rows);
  }
  p.y1 = mode == kFull ? nullptr : reinterpret_cast<bf16*>(chunk + CL.y1);
  p.e = reinterpret_cast<bf16*>(chunk + CL.e);
  for (int j = 0; j < kDSlots; ++j) p.dbase[j] = reinterpret_cast<bf16*>(chunk + CL.d[0][j]);
  p.aw = reinterpret_cast<float*>(chunk + CL.aw[0]);
  p.dtile = points ? reinterpret_cast<float*>(chunk + align256(CL.total)) : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  cudaError_t err;
  if (first) {
    err = cudaMemsetAsync(p.small, 0, (size_t)G * small_len * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = smem_bytes(S, Kp, H, C);
  const bool span = S > kRows;
  auto tile_kernel = span ? tile_kernel_for<true>(mode, points)
                          : tile_kernel_for<false>(mode, points);
  err = cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int units = nt / ray_tiles(S);  // tiles, or rays that span tiles
  tile_kernel<<<units < G ? units : G, kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int P = nt * kRows;
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const bf16* x[kXSlots];  // the GEMM's X: the chunk's rows of the stash or the chunk buffer
  for (int k = 0; k < kXSlots; ++k)
    x[k] = mode == kFull ? p.stash[k] + pt0 * H : mode == kPart ? p.xsrc[k] + pt0 * H : p.xbase[k];
  const fdw::Jobs js = weight_jobs(x, p.e, p.dbase, grads, p.L, Kp, H, P, !first, sms,
                                   reinterpret_cast<float*>(chunk + CL.part));
  err = cudaFuncSetAttribute(field_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)fdw::kSmem);
  if (err != cudaSuccess) return (int)err;
  field_dw_kernel<<<js.tiles * js.splits, fdw::kThreads, fdw::kSmem, st>>>(js);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  field_dwsum_kernel<<<fdw::blocks256(js.part_len), 256, 0, st>>>(js);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int K = H / 2 + 1;
  field_head_kernel<<<fdw::blocks256((size_t)K * C), 256, 0, st>>>(
      p.aw, gfeat + (size_t)t0 * kRows / S * C,
      P / S, K, C, !first, grads + p.L.wr2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (last) {
    field_sum_kernel<<<fdw::blocks256(small_len), 256, 0, st>>>(p.small, G, small_len,
                                                                  grads + p.L.small);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // extern "C"
