// Dual-branch fused field backward for NVIDIA Hopper (sm_90a), stash mode:
// the gradient of the dual-branch forward (csrc/fused_field2_fwd.cu) for
// both field branches in one launch, reading the activations x0..x7, y0b
// and y1 that the forward stashed instead of recomputing the trunk.  Per
// 64-point tile (whole rays; a ray longer than that in K2's two sweeps over
// its tiles) it recomputes only the density pre-activation from x7, then
// runs the shared tile backward (csrc/field_bwd.cuh: the
// integration backward, the heads, the 8-layer trunk) for the face branch,
// then for the eye branch.  The two branches' embedding, z-value and
// segment-length cotangents are summed in place; the weight gradients come
// from the dW GEMM per branch (csrc/field_dw.cuh).
//
// Replaces the TPU kernel gazenerf_tpu/kernels/fused_field2_bwd.py:_bwd_kernel
// (launched by dual_backward).
//
// Numerics are the single-branch backward's (csrc/fused_field_bwd.cu, whose
// tile body this kernel shares): f32 data gradients as bf16 hi/lo mma.sync
// pairs, weight gradients as bf16 products summed in f32, the feature head
// folded per ray, so dfeat is not rounded to bf16 before the dWr2 product
// where the TPU kernel rounds it.  The shared cotangents are summed face
// then eye per point, dembed as ((face W5e + face W0e) + eye W5e) + eye W0e;
// the TPU kernel adds face W5e, eye W5e, face W0e, eye W0e.
//
// Bound.  Without the recompute each branch does per point the data and the
// weight gradients, ~2.6 M multiply-adds (2/3 of the recompute backward's
// ~3.9 M): ~5.5 TFLOP for both branches at B=2, R=4096, S=64, hidden 384,
// ~5.5 ms at 989 TFLOP/s, against the stash read (~7.65 GB, ~2.3 ms at
// 3.35 TB/s) and ~0.3 GB of other traffic.  Bound by bf16 tensor-core
// operations.
//
// Design: as the single-branch backward's (csrc/fused_field_bwd.cu), per
// chunk of whole tiles (kernels/field_dw.py) three kinds of launch.
// dual_bwd_kernel: one CTA per SM walks the chunk's tiles; each tile runs
// branch 0 then branch 1 in the same CTA, which adds the branches' embedding,
// z-value and segment-length cotangents in place (the same threads own the
// same elements), so their sum needs no second pass and no atomics.  The
// ReLU masks are read from the stash (indexed in 64 bits), the padded
// embedding is written to the chunk buffer once, and each branch's bf16
// cotangents and folded-head sums go to its own half of the chunk buffer.
// Then per branch dual_dw_kernel (dW (+)= X^T D, X read from the stash) and
// dual_head_kernel, and after the last chunk dual_sum_kernel sums the
// per-CTA buffers in CTA order.  Each branch's weight gradients see the same
// chunks, products and sums in the same order as the single-branch
// backward's: the same bits as K2 run on that branch.  Scratch: ~14.7 KB per
// point of the chunk (both branches' cotangents and the embedding) and
// 2 x gridDim.x small buffers.

#include "field_bwd.cuh"

namespace {

using namespace fbwd;

struct Branch {
  BwdWeights w;
  const float* gfeat;          // [B, R, C]
  const float* gbga;           // [B, R]
  const float* gdepth;         // [B, R]
  const float* gw;             // [B, R, S]
  const bf16* stash[kXSlots + 1];  // [B, R, S, H] x0..x7, y0b; [B, R, S, H/2] y1
};

struct Params {
  const bf16* embed;    // [B, R, S, De]
  const float* zvals;   // [B, R, S]
  const float* zdists;  // [B, R, S]
  Branch br[2];         // face, eyes
  float* dembed;        // [B, R, S, De] summed over the branches
  float* dzvals;        // [B, R, S]
  float* dzdists;       // [B, R, S]
  float* small;             // [2, G, total - small] per-CTA sums
  bf16* e;                  // the chunk buffer's padded embedding [P, Kp]
  bf16* dbase[2][kDSlots];  // per branch its cotangents dy1 [P, H/2], dy0, dpre7 .. dpre0
  float* aw[2];             // per branch its folded-head sums [P / S, H/2 + 1]
  int G, R, S, De, Kp, H, C;
  int t0, nt;               // the chunk's first tile and its tiles
  Grads L;
};

// kSpan: rays longer than a tile (S > kRows), a separate instantiation as K2's
template <bool kSpan>
__global__ void __launch_bounds__(kThreads, 1)
    dual_bwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, H2 = p.H / 2, S = p.S, C = p.C, Kp = p.Kp, De = p.De;
  const int TR = tile_rays(S), nb = kSpan ? ray_tiles(S) : 1;
  const int ld = H + kPad, lde = Kp + kPad;
  const Shared sh = carve(smem, S, Kp, H, C);
  const size_t small_len = p.L.total - p.L.small;

  const int tid = threadIdx.x;
  const size_t points_per_batch = (size_t)p.R * S;

  // branch q's tile at point p0: A[:, :H2] = y1 and sk.dens its pre-ReLU
  // densities, from the stash
  auto forward = [&](const Branch& q, const Shared& sk, size_t p0) {
    load_tile(sh.A, ld, q.stash[7] + p0 * H, H);  // x7
    __syncthreads();
    density_pre(sk, ld, q.w.wd, q.w.bd, H);
    __syncthreads();
    load_tile(sh.A, ld, q.stash[9] + p0 * H2, H2);  // A[:, :H2] = y1
    __syncthreads();
  };
  auto tile_io = [&](const Branch& q, int br, size_t p0, size_t lp0, int b) {
    TileIO io;
    io.b = b;
    io.p0 = p0;
    io.ray0 = p0 / S;
    io.zvals = p.zvals;
    io.zdists = p.zdists;
    io.gbga = q.gbga;
    io.gdepth = q.gdepth;
    io.gw = q.gw;
    io.x = q.stash;
    io.xrow = p0;
    io.d = p.dbase[br];
    io.drow = lp0;
    io.aw = p.aw[br] + lp0 / S * (H2 + 1);
    io.dzvals = p.dzvals + p0;
    io.dzdists = p.dzdists + p0;
    io.dembed = p.dembed + p0 * De;
    io.add = br > 0;
    io.aw_add = false;
    return io;
  };

  // a unit is a tile of whole rays, or a ray that spans nb tiles
  for (int g = blockIdx.x; g < p.nt / nb; g += gridDim.x) {
    const size_t p0 = (size_t)(p.t0 + g * nb) * kRows;  // first point of the unit
    const size_t lp0 = (size_t)g * nb * kRows;          // and in the chunk
    const int b = (int)(p0 / points_per_batch);
    const size_t ray0 = p0 / S;

    for (int k = 0; k < nb; ++k) {  // the padded embedding into the chunk buffer
      if (k > 0) __syncthreads();   // the last tile's copy has read E
      for (int i = tid; i < kRows * Kp; i += kThreads) {
        const int r = i / Kp, c = i - r * Kp;
        sh.E[r * lde + c] =
            c < De ? p.embed[(p0 + k * kRows + r) * De + c] : __float2bfloat16(0.f);
      }
      __syncthreads();
      store_tile(p.e + (lp0 + k * kRows) * Kp, sh.E, lde, Kp);
    }
#pragma unroll 1  // one copy of the body for both branches: the same code as K2's
    for (int br = 0; br < 2; ++br) {
      const Branch& q = p.br[br];
      float* small = p.small + ((size_t)br * p.G + blockIdx.x) * small_len;
      for (int i = tid; i < TR * C; i += kThreads) sh.gf[i] = q.gfeat[ray0 * C + i];
      if (!kSpan) {
        forward(q, sh, p0);
        backward_tile(sh, q.w, tile_io(q, br, p0, lp0, b), S, De, Kp, H, C, p.L, small);
        continue;
      }
      // K2's two sweeps over the ray's tiles (csrc/fused_field_bwd.cu)
      __syncthreads();
      fold_head(sh, q.w, 1, H2, C);
      for (int k = 0; k < nb; ++k) {
        const Shared sk = tile_of(sh, k);
        forward(q, sk, p0 + k * kRows);
        fold_features(sk, S, H2, ld);
      }
      integrate_ray(sh, tile_io(q, br, p0, lp0, b), S);
      __syncthreads();
      for (int k = 0; k < nb; ++k) {
        const size_t pk = p0 + k * kRows, lk = lp0 + k * kRows;
        load_tile(sh.A, ld, q.stash[9] + pk * H2, H2);  // y1
        __syncthreads();
        TileIO io = tile_io(q, br, pk, lk, b);
        io.aw = p.aw[br] + lp0 / S * (H2 + 1);  // the ray's
        io.aw_add = k > 0;
        backward_heads_trunk(tile_of(sh, k), q.w, io, S, De, Kp, H, p.L, small);
      }
    }
  }
}

__global__ void __launch_bounds__(fdw::kThreads)
    dual_dw_kernel(const __grid_constant__ fdw::Jobs js) {
  extern __shared__ __align__(16) unsigned char smem[];
  fdw::dw_tile(js, smem);
}

__global__ void __launch_bounds__(256) dual_dwsum_kernel(const __grid_constant__ fdw::Jobs js) {
  fdw::dw_reduce(js);
}

__global__ void dual_head_kernel(const float* aw, const float* gf, int rays, int K, int C,
                                 int accumulate, float* out) {
  fdw::head_dw(aw, gf, rays, K, C, accumulate, out);
}

__global__ void dual_sum_kernel(const float* small, int G, size_t len, float* out) {
  fdw::sum_small(small, G, len, out);
}

}  // namespace

extern "C" {

// The layout of one branch's gradient buffer, in floats, as the
// single-branch backward's (fused_field_bwd_layout): out[0..14] the offsets
// of W0e, Wmid, bmid, W5e, W5x, Wd, bd, Wr0, br0, Wr1x, Wr2, br2, cb0, cb5,
// cbr1, out[15] its length; out[16] the bytes of scratch for G CTAs and
// chunks of up to chunk_tiles tiles.
void fused_field2_bwd_layout(int B, int S, int Kp, int H, int C, int G, int chunk_tiles,
                             long long* out) {
  const Grads s = grad_layout(B, Kp, H, C);
  const size_t v[16] = {s.w0e, s.wmid, s.bmid, s.w5e, s.w5x, s.wd, s.bd, s.wr0,
                        s.br0, s.wr1x, s.wr2, s.br2, s.cb0, s.cb5, s.cbr1, s.total};
  for (int i = 0; i < 16; ++i) out[i] = (long long)v[i];
  const Chunk c = chunk_layout((size_t)chunk_tiles * kRows, S, Kp, H, false, 2);
  out[16] = (long long)(align256((size_t)2 * G * (s.total - s.small) * sizeof(float)) + c.total);
}

// Launch one chunk on `stream`: tiles [t0, t0 + nt) of both branches (first
// and last as for the single-branch backward), each branch's gradients into
// its half of `grads` ([2, total]).  Returns the first cudaError_t (0 =
// success).  The weights and cotangents are stacked on a leading axis of 2
// (face, eyes); `stash` is 20 pointers, branch-major, slots x0..x7, y0b
// ([B, R, S, H] bf16) and y1 ([B, R, S, H/2]).  The caller
// (kernels/fused_field2_bwd.py) has checked the shapes as for the
// single-branch backward and allocates `scratch` and `grads`.
int fused_field2_bwd(const void* embed, const float* zvals, const float* zdists,
                     const void* wd, const float* bd, const void* wr2, const float* br2,
                     const void* w0e_t, const void* wmid_t, const void* w5e_t,
                     const void* w5x_t, const void* wr0_t, const void* wr1x_t,
                     const float* gfeat, const float* gbga, const float* gdepth,
                     const float* gw, void* const* stash, float* dembed, float* dzvals,
                     float* dzdists, void* scratch, float* grads, int B, int R, int S, int De,
                     int Kp, int H, int C, int G, int chunk_tiles, int t0, int nt, int first,
                     int last, void* stream) {
  const size_t b = B, r = R, s = S, h = H, h2 = H / 2, kp = Kp, c = C;
  Params p;
  p.embed = static_cast<const bf16*>(embed);
  p.zvals = zvals;
  p.zdists = zdists;
  p.dembed = dembed;
  p.dzvals = dzvals;
  p.dzdists = dzdists;
  p.G = G;
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
      static_cast<unsigned char*>(scratch) + align256((size_t)2 * G * small_len * sizeof(float));
  const Chunk CL = chunk_layout((size_t)chunk_tiles * kRows, S, Kp, H, false, 2);
  p.e = reinterpret_cast<bf16*>(chunk + CL.e);
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < kDSlots; ++j) p.dbase[i][j] = reinterpret_cast<bf16*>(chunk + CL.d[i][j]);
    p.aw[i] = reinterpret_cast<float*>(chunk + CL.aw[i]);
  }
  for (int i = 0; i < 2; ++i) {
    Branch& q = p.br[i];
    q.w.wd = static_cast<const bf16*>(wd) + i * h;
    q.w.bd = bd + i;
    q.w.wr2 = static_cast<const bf16*>(wr2) + i * h2 * c;
    q.w.br2 = br2 + i * c;
    q.w.w0e_t = static_cast<const bf16*>(w0e_t) + i * kp * h;
    q.w.wmid_t = static_cast<const bf16*>(wmid_t) + i * 6 * h * h;
    q.w.w5e_t = static_cast<const bf16*>(w5e_t) + i * kp * h;
    q.w.w5x_t = static_cast<const bf16*>(w5x_t) + i * h * h;
    q.w.wr0_t = static_cast<const bf16*>(wr0_t) + i * h * h;
    q.w.wr1x_t = static_cast<const bf16*>(wr1x_t) + i * h * h2;
    q.w.dens_vpu = 0;  // the dual path rounds the density cotangent, as JAX's
    q.gfeat = gfeat + i * b * r * c;
    q.gbga = gbga + i * b * r;
    q.gdepth = gdepth + i * b * r;
    q.gw = gw + i * b * r * s;
    for (int k = 0; k <= kXSlots; ++k)
      q.stash[k] = static_cast<const bf16*>(stash[i * (kXSlots + 1) + k]);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  cudaError_t err;
  if (first) {
    err = cudaMemsetAsync(p.small, 0, (size_t)2 * G * small_len * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = smem_bytes(S, Kp, H, C);
  auto tile_kernel = S > kRows ? dual_bwd_kernel<true> : dual_bwd_kernel<false>;
  err = cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int units = nt / ray_tiles(S);  // tiles, or rays that span tiles
  tile_kernel<<<units < G ? units : G, kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dual_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)fdw::kSmem);
  if (err != cudaSuccess) return (int)err;

  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int P = nt * kRows, K = H / 2 + 1;
  const size_t pt0 = (size_t)t0 * kRows;  // the chunk's first point
  for (int i = 0; i < 2; ++i) {
    const Branch& q = p.br[i];
    float* gi = grads + i * p.L.total;
    const bf16* x[kXSlots];
    for (int k = 0; k < kXSlots; ++k) x[k] = q.stash[k] + pt0 * h;
    const fdw::Jobs js = weight_jobs(x, p.e, p.dbase[i], gi, p.L, Kp, H, P, !first, sms,
                                     reinterpret_cast<float*>(chunk + CL.part));
    dual_dw_kernel<<<js.tiles * js.splits, fdw::kThreads, fdw::kSmem, st>>>(js);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dual_dwsum_kernel<<<fdw::blocks256(js.part_len), 256, 0, st>>>(js);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dual_head_kernel<<<fdw::blocks256((size_t)K * C), 256, 0, st>>>(
        p.aw[i], q.gfeat + pt0 / S * C, P / S, K, C, !first, gi + p.L.wr2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (last) {
      dual_sum_kernel<<<fdw::blocks256(small_len), 256, 0, st>>>(
          p.small + (size_t)i * G * small_len, G, small_len, gi + p.L.small);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

}  // extern "C"
