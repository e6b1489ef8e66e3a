// Dual-branch fused field backward for NVIDIA Hopper (sm_90a), stash mode:
// the gradient of the dual-branch forward (csrc/fused_field2_fwd.cu) for
// both field branches in one launch, reading the activations x0..x7, y0b
// and y1 that the forward stashed instead of recomputing the trunk.  Per
// 64-point tile (whole rays) it recomputes only the density pre-activation
// from x7, then runs the shared tile backward (csrc/field_bwd.cuh: the
// integration backward, the heads, the 8-layer trunk) for the face branch,
// then for the eye branch.  The two branches' embedding, z-value and
// segment-length cotangents are summed in shared memory and stored once;
// the weight, bias and conditioning-row gradients go to one private slab set
// per branch.
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
// Design (correct and simple first): one persistent CTA per SM walks the
// tiles; each tile runs branch 0 then branch 1 in the same CTA, so the sum
// of the shared cotangents needs no second pass and no atomics.  A stash
// slot's tile rows are read back with 16-byte loads, one layer at a time,
// where the recompute backward reads its per-CTA scratch.  The stash is
// indexed in 64 bits.  Slabs are summed in CTA order per branch: the same
// bits on every run.  Scratch: 2 x gridDim.x slabs of slab_len floats (~1.4
// GB for 132 CTAs at hidden 384).

#include "field_bwd.cuh"

namespace {

using namespace fbwd;

struct Branch {
  BwdWeights w;
  const float* gfeat;          // [B, R, C]
  const float* gbga;           // [B, R]
  const float* gdepth;         // [B, R]
  const float* gw;             // [B, R, S]
  const bf16* stash[kSlots];   // [B, R, S, H] x0..x7, y0b; [B, R, S, H/2] y1
  float* slabs;                // [gridDim.x, slab_len]
};

struct Params {
  const bf16* embed;    // [B, R, S, De]
  const float* zvals;   // [B, R, S]
  const float* zdists;  // [B, R, S]
  Branch br[2];         // face, eyes
  float* dembed;        // [B, R, S, De] summed over the branches
  float* dzvals;        // [B, R, S]
  float* dzdists;       // [B, R, S]
  int R, S, De, Kp, H, C, n_tiles;
  size_t slab_len;
  Slab L;
};

__global__ void __launch_bounds__(kThreads, 1) dual_bwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, H2 = p.H / 2, S = p.S, C = p.C, Kp = p.Kp, De = p.De;
  const int TR = kRows / S;
  const int ld = H + kPad, lde = Kp + kPad;
  const Shared sh = carve(smem, S, Kp, H, C);
  float* dE = sh.end;            // [kRows, De] the summed embedding cotangent
  float* dzv = dE + kRows * De;  // [kRows] the summed z-value cotangent
  float* dzd = dzv + kRows;      // [kRows] the summed segment-length cotangent

  const int tid = threadIdx.x;
  const size_t points_per_batch = (size_t)p.R * S;

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const size_t p0 = (size_t)tile * kRows;  // first point of the tile
    const int b = (int)(p0 / points_per_batch);
    const size_t ray0 = p0 / S;

    for (int i = tid; i < kRows * Kp; i += kThreads) {
      const int r = i / Kp, c = i - r * Kp;
      sh.E[r * lde + c] = c < De ? p.embed[(p0 + r) * De + c] : __float2bfloat16(0.f);
    }
    for (int br = 0; br < 2; ++br) {
      const Branch& q = p.br[br];
      for (int i = tid; i < TR * C; i += kThreads) sh.gf[i] = q.gfeat[ray0 * C + i];
      load_tile(sh.A, ld, q.stash[7] + p0 * H, H);  // x7
      __syncthreads();
      density_pre(sh, ld, q.w.wd, q.w.bd, H);
      __syncthreads();
      load_tile(sh.A, ld, q.stash[9] + p0 * H2, H2);  // A[:, :H2] = y1
      __syncthreads();

      TileIO io;
      io.b = b;
      io.p0 = p0;
      io.ray0 = ray0;
      io.zvals = p.zvals;
      io.zdists = p.zdists;
      io.gbga = q.gbga;
      io.gdepth = q.gdepth;
      io.gw = q.gw;
      for (int i = 0; i < 9; ++i) io.slot[i] = q.stash[i] + p0 * H;
      io.dzvals = dzv;
      io.dzdists = dzd;
      io.dembed = dE;
      io.add = br > 0;
      backward_tile(sh, q.w, io, S, De, Kp, H, C, p.L, q.slabs + (size_t)blockIdx.x * p.slab_len);
    }
    // one store of the summed per-point cotangents (backward_tile ended
    // with a barrier)
    for (int i = tid; i < kRows * De; i += kThreads) p.dembed[p0 * De + i] = dE[i];
    for (int r = tid; r < kRows; r += kThreads) {
      p.dzvals[p0 + r] = dzv[r];
      p.dzdists[p0 + r] = dzd[r];
    }
    __syncthreads();  // the next tile overwrites dE, dzv, dzd
  }
}

__global__ void dual_slab_sum(const float* slabs, int G, size_t len, Slab L, int Kp, int H,
                              float* out) {
  slab_sum(slabs, G, len, L, Kp, H, out);
}

size_t dual_smem_bytes(int S, int Kp, int H, int C, int De) {
  return smem_bytes(S, Kp, H, C) + (size_t)(kRows * De + 2 * kRows) * sizeof(float);
}

}  // namespace

extern "C" {

// The layout of one branch's gradient buffer, in floats, as the
// single-branch backward's (fused_field_bwd_slab_offsets): out[0..14] the
// offsets of W0e, Wmid, bmid, W5e, W5x, Wd, bd, Wr0, br0, Wr1x, Wr2, br2,
// cb0, cb5, cbr1, out[15] the length of one slab.
void fused_field2_bwd_slab_offsets(int B, int Kp, int H, int C, long long* out) {
  const Slab s = slab_layout(B, Kp, H, C);
  const size_t v[16] = {s.w0e, s.wmid, s.bmid, s.w5e, s.w5x, s.wd, s.bd, s.wr0,
                        s.br0, s.wr1x, s.wr2, s.br2, s.cb0, s.cb5, s.cbr1, s.total};
  for (int i = 0; i < 16; ++i) out[i] = (long long)v[i];
}

// Launch on `stream`: zero the 2 x G slabs, run G persistent CTAs over the
// B*R*S/64 tiles, sum each branch's slabs into its half of `grads`
// ([2, slab_len], slab layout).  Returns the first cudaError_t (0 =
// success).  The weights and cotangents are stacked on a leading axis of 2
// (face, eyes); `stash` is 20 pointers, branch-major, slots x0..x7, y0b
// ([B, R, S, H] bf16) and y1 ([B, R, S, H/2]).  The caller
// (kernels/fused_field2_bwd.py) has checked the shapes as for the
// single-branch backward and allocates `slabs` ([2, G, slab_len] f32) and
// `grads`.
int fused_field2_bwd(const void* embed, const float* zvals, const float* zdists,
                     const void* wd, const float* bd, const void* wr2, const float* br2,
                     const void* w0e_t, const void* wmid_t, const void* w5e_t,
                     const void* w5x_t, const void* wr0_t, const void* wr1x_t,
                     const float* gfeat, const float* gbga, const float* gdepth,
                     const float* gw, void* const* stash, float* dembed, float* dzvals,
                     float* dzdists, float* slabs, float* grads, int B, int R, int S,
                     int De, int Kp, int H, int C, int G, void* stream) {
  const size_t b = B, r = R, s = S, h = H, h2 = H / 2, kp = Kp, c = C;
  Params p;
  p.embed = static_cast<const bf16*>(embed);
  p.zvals = zvals;
  p.zdists = zdists;
  p.dembed = dembed;
  p.dzvals = dzvals;
  p.dzdists = dzdists;
  p.R = R;
  p.S = S;
  p.De = De;
  p.Kp = Kp;
  p.H = H;
  p.C = C;
  p.n_tiles = (int)(b * r * s / kRows);
  p.L = slab_layout(B, Kp, H, C);
  p.slab_len = p.L.total;
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
    q.gfeat = gfeat + i * b * r * c;
    q.gbga = gbga + i * b * r;
    q.gdepth = gdepth + i * b * r;
    q.gw = gw + i * b * r * s;
    for (int k = 0; k < kSlots; ++k) q.stash[k] = static_cast<const bf16*>(stash[i * kSlots + k]);
    q.slabs = slabs + i * (size_t)G * p.slab_len;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  cudaError_t err =
      cudaMemsetAsync(slabs, 0, (size_t)2 * G * p.slab_len * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = dual_smem_bytes(S, Kp, H, C, De);
  err = cudaFuncSetAttribute(dual_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dual_bwd_kernel<<<G, kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)((p.slab_len + 255) / 256 < 2048 ? (p.slab_len + 255) / 256 : 2048);
  for (int i = 0; i < 2; ++i) {
    dual_slab_sum<<<blocks, 256, 0, st>>>(p.br[i].slabs, G, p.slab_len, p.L, Kp, H,
                                          grads + i * p.slab_len);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
