// Fused field backward for NVIDIA Hopper (sm_90a), recompute mode: for every
// 64-point tile (whole rays) it recomputes the field MLP's forward, runs the
// volume-integration backward, then backpropagates through the heads and the
// 8-layer trunk, giving the embedding, z-value and segment-length cotangents
// per point and the weight, bias and conditioning-row gradients summed over
// all points.
//
// Replaces the TPU kernel gazenerf_tpu/kernels/fused_field_bwd.py:_bwd_kernel
// (launched by pallas_backward) with stash_acts=False, split_dw=False,
// dens_vpu=False and embed_in_kernel=False.
//
// Numerics follow that kernel: the recomputed activations round to bf16 at
// K1's points (csrc/fused_field_fwd.cu); data gradients are f32 (as bf16
// hi/lo mma.sync pairs), weight gradients bf16 x bf16 products summed in f32;
// the feature head is folded per ray.  The details are with the tile body in
// csrc/field_bwd.cuh, which the dual-branch backward (csrc/fused_field2_bwd.cu)
// shares.
//
// Bound.  Per point the backward repeats the forward's ~1.30 M multiply-adds
// (recompute), then as many for the data gradients and as many again for the
// weight gradients: ~3.9 M per point, ~4.1 TFLOP at B=2, R=4096, S=64,
// hidden 384, against ~0.25 GB of global traffic that the function needs
// (embedding and cotangents in, embedding / z cotangents and gradients out).
// It is bound by bf16 tensor-core operations.
//
// Design (correct and simple first; wgmma, TMA and a better dW reduction are
// later work):
//  * Weight gradients are a reduction over all B*R*S points.  The TPU kernel
//    keeps them resident across its sequential grid; Hopper's blocks run in
//    parallel, so this kernel runs one persistent CTA per SM, each walking
//    tiles blockIdx.x, blockIdx.x + gridDim.x, ... and adding each tile's
//    products into a private f32 slab of every dW / db / dcb in global
//    memory (in fragment order); a second kernel then sums the slabs in CTA
//    order.  Scratch: gridDim.x slabs of slab_len floats (~5.4 MB each at
//    hidden 384, ~0.72 GB for 132 CTAs).  No atomics: the result is
//    deterministic, the same bits on every run.
//  * The backward needs x0..x7, y0b and y1 of a tile (10 x 64 x 384 bf16),
//    more than an SM holds next to its working buffers.  The recompute
//    writes them to a per-CTA bf16 scratch (10 slots of [64, H], 0.49 MB
//    per CTA) and the backward reads back one layer at a time.


#include "field_bwd.cuh"

namespace {

using namespace fbwd;

struct Params {
  const bf16* embed;    // [B, R, S, De]
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
  float* dembed;        // [B, R, S, De]
  float* dzvals;        // [B, R, S]
  float* dzdists;       // [B, R, S]
  // scratch
  bf16* acts;           // [gridDim.x, kSlots, kRows, H]
  float* slabs;         // [gridDim.x, slab_len]
  int R, S, De, Kp, H, C, n_tiles;
  size_t slab_len;
  Slab L;
};

__global__ void __launch_bounds__(kThreads, 1) field_bwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, H2 = p.H / 2, S = p.S, C = p.C, Kp = p.Kp, De = p.De;
  const int TR = kRows / S;
  const int ld = H + kPad, lde = Kp + kPad;
  const Shared sh = carve(smem, S, Kp, H, C);
  bf16* A = sh.A;
  bf16* E = sh.E;

  float* slab = p.slabs + (size_t)blockIdx.x * p.slab_len;
  bf16* scr = p.acts + (size_t)blockIdx.x * kSlots * kRows * H;
  const int tid = threadIdx.x;
  const size_t HH = (size_t)H * H;
  const Seg none = {nullptr, 0, nullptr, 0};
  const int mid_of[8] = {-1, 0, 1, 2, 3, -1, 4, 5};  // Wmid slot of trunk layer i
  const size_t points_per_batch = (size_t)p.R * S;

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const size_t p0 = (size_t)tile * kRows;  // first point of the tile
    const int b = (int)(p0 / points_per_batch);
    const size_t ray0 = p0 / S;

    for (int i = tid; i < kRows * Kp; i += kThreads) {
      const int r = i / Kp, c = i - r * Kp;
      E[r * lde + c] = c < De ? p.embed[(p0 + r) * De + c] : __float2bfloat16(0.f);
    }
    for (int i = tid; i < TR * C; i += kThreads) sh.gf[i] = p.gfeat[ray0 * C + i];
    __syncthreads();

    // ---- recompute: x0..x7 (slots 0..7), y0b (8), y1 (9) ----
    fwd_layer({E, lde, p.w0e, Kp}, none, 1, H, p.cb0 + (size_t)b * H, true, A, ld, scr);
    for (int i = 1; i < 8; ++i) {
      bf16* slot = scr + (size_t)i * kRows * H;
      if (i == 5)
        fwd_layer({E, lde, p.w5e, Kp}, {A, ld, p.w5x, H}, 2, H, p.cb5 + (size_t)b * H, true,
                  A, ld, slot);
      else
        fwd_layer({A, ld, p.wmid + mid_of[i] * HH, H}, none, 1, H, p.bmid + mid_of[i] * H,
                  true, A, ld, slot);
    }
    density_pre(sh, ld, p.w.wd, p.w.bd, H);
    fwd_layer({A, ld, p.wr0, H}, none, 1, H, p.br0, false, A, ld, scr + 8 * kRows * (size_t)H);
    fwd_layer({A, ld, p.wr1x, H}, none, 1, H2, p.cbr1 + (size_t)b * H2, true, A, ld,
              scr + 9 * kRows * (size_t)H);  // A[:, :H2] = y1

    TileIO io;
    io.b = b;
    io.p0 = p0;
    io.ray0 = ray0;
    io.zvals = p.zvals;
    io.zdists = p.zdists;
    io.gbga = p.gbga;
    io.gdepth = p.gdepth;
    io.gw = p.gw;
    for (int i = 0; i < 9; ++i) io.slot[i] = scr + (size_t)i * kRows * H;
    io.dzvals = p.dzvals + p0;
    io.dzdists = p.dzdists + p0;
    io.dembed = p.dembed + p0 * De;
    io.add = false;
    backward_tile(sh, p.w, io, S, De, Kp, H, C, p.L, slab);
  }
}

__global__ void reduce_slabs(const float* slabs, int G, size_t len, Slab L, int Kp, int H,
                             float* out) {
  slab_sum(slabs, G, len, L, Kp, H, out);
}

}  // namespace

extern "C" {

// The gradient buffer's layout, in floats: out[0..14] the offsets of W0e,
// Wmid, bmid, W5e, W5x, Wd, bd, Wr0, br0, Wr1x, Wr2, br2, cb0, cb5, cbr1 (each
// block row-major in `grads`), out[15] the length of one CTA's slab and of
// `grads`.
void fused_field_bwd_slab_offsets(int B, int Kp, int H, int C, long long* out) {
  const Slab s = slab_layout(B, Kp, H, C);
  const size_t v[16] = {s.w0e, s.wmid, s.bmid, s.w5e, s.w5x, s.wd, s.bd, s.wr0,
                        s.br0, s.wr1x, s.wr2, s.br2, s.cb0, s.cb5, s.cbr1, s.total};
  for (int i = 0; i < 16; ++i) out[i] = (long long)v[i];
}

// Launch on `stream`: zero the G slabs, run G persistent CTAs over the
// B*R*S/64 tiles, sum the slabs into `grads` (slab layout).  Returns the
// first cudaError_t (0 = success).  The caller (kernels/fused_field_bwd.py)
// has checked the shapes: S divides 64, R*S is a multiple of 64, H is a
// multiple of 64 and at most 384, Kp a multiple of 32; it allocates `acts`
// ([G, 10, 64, H] bf16), `slabs` ([G, slab_len] f32) and `grads`.
int fused_field_bwd(const void* embed, const float* zvals, const float* zdists,
                    const float* cb0, const float* cb5, const float* cbr1,
                    const void* w0e, const void* wmid, const float* bmid, const void* w5e,
                    const void* w5x, const void* wd, const float* bd, const void* wr0,
                    const float* br0, const void* wr1x, const void* wr2, const float* br2,
                    const void* w0e_t, const void* wmid_t, const void* w5e_t,
                    const void* w5x_t, const void* wr0_t, const void* wr1x_t,
                    const float* gfeat, const float* gbga, const float* gdepth,
                    const float* gw, float* dembed, float* dzvals, float* dzdists,
                    void* acts, float* slabs, float* grads, int B, int R, int S, int De,
                    int Kp, int H, int C, int G, void* stream) {
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
  p.gfeat = gfeat;
  p.gbga = gbga;
  p.gdepth = gdepth;
  p.gw = gw;
  p.dembed = dembed;
  p.dzvals = dzvals;
  p.dzdists = dzdists;
  p.acts = static_cast<bf16*>(acts);
  p.slabs = slabs;
  p.R = R;
  p.S = S;
  p.De = De;
  p.Kp = Kp;
  p.H = H;
  p.C = C;
  p.n_tiles = (int)((size_t)B * R * S / kRows);
  p.L = slab_layout(B, Kp, H, C);
  p.slab_len = p.L.total;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  cudaError_t err = cudaMemsetAsync(slabs, 0, (size_t)G * p.slab_len * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(S, Kp, H, C);
  err = cudaFuncSetAttribute(field_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  field_bwd_kernel<<<G, kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)((p.slab_len + 255) / 256 < 2048 ? (p.slab_len + 255) / 256 : 2048);
  reduce_slabs<<<blocks, 256, 0, st>>>(slabs, G, p.slab_len, p.L, Kp, H, grads);
  return (int)cudaGetLastError();
}

}  // extern "C"
