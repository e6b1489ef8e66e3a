// Fused field forward for NVIDIA Hopper (sm_90a): positional-embedding tile
// -> 8-layer field MLP (skip at fea_5) -> density and 258-channel feature
// heads -> alpha compositing -> per-ray feature / background alpha / depth /
// sample weights.  The [N, 384] activations and the [N, 258] per-sample
// features never leave the SM.
//
// Under a gradient it also writes the activation stash, which the backward
// (csrc/fused_field_bwd.cu) can read instead of recomputing the trunk: the
// bf16 x0..x7, y0b and y1 per point, or only the trunk layers i with
// i % k == k - 1 (stash_every=k), or x0..x6 and y0b as per-point int8 codes
// with an f32 scale per point and tag, x7 and y1 in bf16 (stash_dtype int8).
//
// Replaces the TPU kernel gazenerf_tpu/kernels/fused_field.py:_field_kernel
// (launched by _pallas_forward), with and without its stash in each of its
// forms, given the bf16 embedding or (embed_in_kernel) the f32 sample points,
// which each tile encodes itself (its _embed_tile; csrc/point_encoding.cuh):
// 12 bytes a point in place of 126, and the [B, R, S, 63] embedding never
// reaches device memory.  Its dens_vpu mode computes the same density head:
// the port's is always an f32 dot product of bf16 values on the CUDA cores.
//
// Numerics follow that kernel: bf16 operands with f32 accumulation; bias,
// conditioning rows and ReLU applied in f32 and the result rounded to bf16
// before the next product; rgb_0's output rounded to bf16 before rgb_1; the
// feature head and the compositing in f32.
//
// Bound.  At the render shape (R = 4096 rays x S = 64 samples, hidden 384)
// one launch does ~1.30 M multiply-adds per point on the tensor cores
// (~0.68 TFLOP) against ~40 MB of global traffic (bf16 embedding in, f32
// outputs, 2.7 MB of weights), far above the H100's ~295 FLOP per byte: it
// is bound by bf16 tensor-core operations.  With the stash at the training
// shape (B=2) it writes 7,296 bytes per point, ~3.83 GB (~1.1 ms at 3.35
// TB/s) against ~1.4 ms of products: still bound by operations; the int8
// stash writes 4,256 bytes per point, stash_every=2 3,072 and 4 1,536.
//
// Design: one CTA takes whole rays, 128 points = 128 / S rays or, for rays
// longer than that (S = 192, 256), the fewest whole rays that fill whole
// 128-point tiles, which it runs one after another carrying each ray's
// compositing sums; so the compositing needs no cross-CTA step.  The tile
// body, its layout and its numerics are in csrc/field_fwd.cuh, which the
// dual-branch forward (csrc/fused_field2_fwd.cu) shares: the weights streamed
// once per tile into a shared-memory ring by a producer warp's bulk copies,
// the products on wgmma, the layers in three rotating column blocks,
// compositing a warp per ray.  The stash leaves shared memory by tensor stores (TMA) behind the
// next layer's products, through ten tensor maps over [B R S, N] rows built
// here and passed in the kernel's parameters, as in the dual-branch forward;
// a partial stash skips the stores of the layers it does not keep (a mask in
// the parameters of a kernel of its own, field_fwd_part_kernel, so that the
// stash kernel's registers stay as they were).  The int8 stash is a kernel of
// its own too (field_fwd_quant_kernel): after each quantized layer the consumer threads
// take each row's amax from the layer's bf16 rows in shared memory, then
// write its codes and scale to device memory with plain stores (16 bytes of
// the row in, 8 out, per thread and chunk), in line with the products: the
// simple design.  x7 and y1 leave by the tensor stores as before.

#include "field_fwd.cuh"

namespace {

// kSpan: rays longer than a tile (cta_tiles(S) > 1); kPoints: the points
// encoded in the tile (a separate instantiation, so that the embedding's
// kernels carry none of it)
template <bool kSpan, bool kPoints>
__global__ void __launch_bounds__(ffwd::kThreads, 1) field_fwd_kernel(ffwd::Params p) {
  ffwd::forward_tile<false, kSpan, kPoints>(p, nullptr, blockIdx.y,
                                            blockIdx.x * ffwd::rays_per_cta<kSpan>(p.S));
}

struct StashParams {
  ffwd::Params p;
  CUtensorMap stash[ffwd::kSlots];  // x0..x7, y0b, y1 (those in mask)
  unsigned mask;                    // field_fwd_part_kernel: bit l, layer l's slot is stashed
};

template <bool kSpan, bool kPoints>
__global__ void __launch_bounds__(ffwd::kThreads, 1)
    field_fwd_stash_kernel(const __grid_constant__ StashParams sp) {
  ffwd::forward_tile<true, kSpan, kPoints>(sp.p, sp.stash, blockIdx.y,
                                           blockIdx.x * ffwd::rays_per_cta<kSpan>(sp.p.S));
}

// a partial stash: the slots in the mask
template <bool kSpan, bool kPoints>
__global__ void __launch_bounds__(ffwd::kThreads, 1)
    field_fwd_part_kernel(const __grid_constant__ StashParams sp) {
  ffwd::forward_tile<true, kSpan, kPoints, ffwd::kFormMask>(
      sp.p, sp.stash, blockIdx.y, blockIdx.x * ffwd::rays_per_cta<kSpan>(sp.p.S), sp.mask);
}

struct QuantParams {
  ffwd::Params p;
  CUtensorMap stash[ffwd::kSlots];       // x7 and y1 (slots 7 and 9) in bf16
  signed char* codes[ffwd::kSlots];      // x0..x6, y0b (slots 0..6, 8): [B R S, H] int8
  float* scales;                         // [B R S, kQuantTags] f32
};

// the int8 stash: its own instantiation, so that the bf16 stash kernels carry
// none of the quantizer
template <bool kSpan, bool kPoints>
__global__ void __launch_bounds__(ffwd::kThreads, 1)
    field_fwd_quant_kernel(const __grid_constant__ QuantParams qp) {
  ffwd::forward_tile<true, kSpan, kPoints, ffwd::kFormQuant>(
      qp.p, qp.stash, blockIdx.y, blockIdx.x * ffwd::rays_per_cta<kSpan>(qp.p.S), 0, qp.codes,
      qp.scales);
}

template <typename Kernel, typename Arg>
int launch(Kernel kernel, const Arg& arg, int B, int R, int S, int Kp, int H, cudaStream_t st) {
  const size_t smem = ffwd::smem_bytes(S, Kp, H);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(R / ffwd::cta_rays(S), B);
  kernel<<<grid, ffwd::kThreads, smem, st>>>(arg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The caller (kernels/fused_field.py) has checked the shapes: S divides
// 64 or is a multiple of 64 up to 256, R is a multiple of cta_rays(S), H is
// a multiple of 64 up to 192 or of 128 up to 384, and Kp a multiple of 64.
// `wstream` is scratch for stream_slices(H, Kp) slices, which pack_stream
// fills first.  `stash` is
// null (no stash) or eleven pointers: x0..x7, y0b ([B, R, S, H] each) and y1
// ([B, R, S, H/2]), null where the stash keeps no such slot, then the int8
// stash's scales ([B, R, S, 8] f32), null for a bf16 stash; with the scales,
// x0..x6 and y0b are int8 codes, x7 and y1 bf16, and every slot is given.
// `encode`: `embed` holds the f32 points [B, R, S, 3],
// which the tiles encode into De = 3 + 6 n_freqs columns, else the bf16
// embedding [B, R, S, De].
int fused_field_fwd(const void* embed, const float* zvals, const float* zdists,
                    const float* cb0, const float* cb5, const float* cbr1,
                    const void* w0e, const void* wmid, const float* bmid,
                    const void* w5e, const void* w5x, const void* wd,
                    const float* bd, const void* wr0, const float* br0,
                    const void* wr1x, const void* wr2, const float* br2, void* wstream,
                    float* feat_out, float* bga_out, float* depth_out,
                    float* w_out, void* const* stash, int B, int R, int S, int De, int Kp,
                    int H, int C, int encode, void* stream) {
  typedef ffwd::bf16 bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ffwd::StreamPlan plan = ffwd::stream_plan(
      static_cast<const bf16*>(w0e), static_cast<const bf16*>(wmid), static_cast<const bf16*>(w5e),
      static_cast<const bf16*>(w5x), static_cast<const bf16*>(wr0), static_cast<const bf16*>(wr1x),
      H, Kp);
  ffwd::pack_stream<<<ffwd::stream_slices(H, Kp), 4 * ffwd::kPassCols, 0, st>>>(
      plan, static_cast<bf16*>(wstream));
  ffwd::Params p = {};
  p.embed = static_cast<const bf16*>(embed);
  p.zvals = zvals;
  p.zdists = zdists;
  p.cb0 = cb0;
  p.cb5 = cb5;
  p.cbr1 = cbr1;
  p.wstream = static_cast<const bf16*>(wstream);
  p.bmid = bmid;
  p.wd = static_cast<const bf16*>(wd);
  p.bd = bd;
  p.br0 = br0;
  p.wr2 = static_cast<const bf16*>(wr2);
  p.br2 = br2;
  p.feat_out = feat_out;
  p.bga_out = bga_out;
  p.depth_out = depth_out;
  p.w_out = w_out;
  p.R = R;
  p.S = S;
  p.De = De;
  p.Kp = Kp;
  p.H = H;
  p.C = C;
  const bool span = ffwd::cta_tiles(S) > 1;
  if (!stash) {
    auto k = encode ? (span ? field_fwd_kernel<true, true> : field_fwd_kernel<false, true>)
                    : (span ? field_fwd_kernel<true, false> : field_fwd_kernel<false, false>);
    return launch(k, p, B, R, S, Kp, H, st);
  }
  const size_t points = (size_t)B * R * S;
  auto map = [&](CUtensorMap* m, int k) {
    return ffwd::stash_map(m, stash[k], points, k + 1 < ffwd::kSlots ? H : H / 2);
  };
  if (stash[ffwd::kSlots]) {  // the int8 stash
    QuantParams qp = {};
    qp.p = p;
    for (int k = 0; k < ffwd::kSlots; ++k) {
      if (!stash[k]) return (int)cudaErrorInvalidValue;
      if (k == 7 || k == 9) {
        if (!map(&qp.stash[k], k)) return (int)cudaErrorInvalidValue;
      } else {
        qp.codes[k] = static_cast<signed char*>(stash[k]);
      }
    }
    qp.scales = static_cast<float*>(stash[ffwd::kSlots]);
    auto k = encode ? (span ? field_fwd_quant_kernel<true, true>
                            : field_fwd_quant_kernel<false, true>)
                    : (span ? field_fwd_quant_kernel<true, false>
                            : field_fwd_quant_kernel<false, false>);
    return launch(k, qp, B, R, S, Kp, H, st);
  }
  StashParams sp = {};
  sp.p = p;
  for (int k = 0; k < ffwd::kSlots; ++k) {
    if (!stash[k]) continue;
    if (!map(&sp.stash[k], k)) return (int)cudaErrorInvalidValue;
    sp.mask |= 1u << k;
  }
  if (!sp.mask) return (int)cudaErrorInvalidValue;
  if (sp.mask != (1u << ffwd::kSlots) - 1) {
    auto k = encode ? (span ? field_fwd_part_kernel<true, true>
                            : field_fwd_part_kernel<false, true>)
                    : (span ? field_fwd_part_kernel<true, false>
                            : field_fwd_part_kernel<false, false>);
    return launch(k, sp, B, R, S, Kp, H, st);
  }
  auto k = encode
               ? (span ? field_fwd_stash_kernel<true, true> : field_fwd_stash_kernel<false, true>)
               : (span ? field_fwd_stash_kernel<true, false> : field_fwd_stash_kernel<false, false>);
  return launch(k, sp, B, R, S, Kp, H, st);
}

}  // extern "C"
