// Dual-branch fused field forward for NVIDIA Hopper (sm_90a): the face and
// the eye field of GazeNeRF, each an 8-layer MLP with density and
// 258-channel feature heads plus alpha compositing, on one shared
// positional-embedding input, in one launch.  Under a gradient it also
// writes both branches' bf16 activation stash (x0..x7, y0b, y1 per point),
// which the dual backward (csrc/fused_field2_bwd.cu) reads instead of
// recomputing the trunk.
//
// Replaces the TPU kernel gazenerf_tpu/kernels/fused_field2.py:_fwd_kernel
// (launched by _dual_forward), with and without its stash.
//
// Numerics are the single-branch forward's (csrc/fused_field_fwd.cu): the
// tile body is shared (csrc/field_fwd.cuh), so without the stash each
// branch's outputs equal that kernel's on the same branch to the bit.  The
// stash holds the bf16 values the next product reads.
//
// Bound.  At the training shape (B=2, R = 4096 rays x S = 64 samples, hidden
// 384) the two branches do ~2.6 M multiply-adds per point on the tensor
// cores (~2.7 TFLOP, ~2.8 ms at 989 TFLOP/s); the stash is 7,296 bytes per
// point and branch (9 x 384 + 192 bf16 values), ~7.65 GB for both, ~2.3 ms
// at 3.35 TB/s.  Bound by bf16 tensor-core operations, the stash writes
// close behind; without the stash (serving) it is far above the card's ~295
// FLOP per byte.
//
// Design: the TPU kernel interleaves the two
// branches' layers in one program so the MXU has a second chain to fill its
// gaps; on Hopper two independent chains overlap as well in separate CTAs.
// So the branch is a grid dimension (blockIdx.z), each CTA runs the
// single-branch tile body on its branch's weights and conditioning rows,
// and the embedding tile is read by two CTAs (L2 serves the second).  The
// stash leaves shared memory by tensor stores (TMA) that run behind the next
// layer's products (csrc/field_fwd.cuh); its tensor maps, built here, are
// kernel parameters.

#include "field_fwd.cuh"

namespace {

struct DualParams {
  ffwd::Params br[2];                      // face, eyes
  CUtensorMap stash[2][ffwd::kSlots];      // per branch x0..x7, y0b, y1 (with the stash)
};

template <bool kStash, bool kSpan>
__global__ void __launch_bounds__(ffwd::kThreads, 1)
    dual_fwd_kernel(const __grid_constant__ DualParams dp) {
  // the branch's operands from shared memory: indexed by blockIdx.z in the
  // kernel parameters, they would take a local copy and registers
  __shared__ ffwd::Params p;
  if (threadIdx.x == 0) p = dp.br[blockIdx.z];
  __syncthreads();
  ffwd::forward_tile<kStash, kSpan>(p, kStash ? dp.stash[blockIdx.z] : nullptr, blockIdx.y,
                                    blockIdx.x * ffwd::rays_per_cta<kSpan>(p.S));
}

template <bool kStash, bool kSpan>
int launch_kernel(const DualParams& dp, int B, int R, int S, int Kp, int H, cudaStream_t stream) {
  const size_t smem = ffwd::smem_bytes(S, Kp, H);
  cudaError_t err = cudaFuncSetAttribute(
      dual_fwd_kernel<kStash, kSpan>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(R / ffwd::cta_rays(S), B, 2);
  dual_fwd_kernel<kStash, kSpan><<<grid, ffwd::kThreads, smem, stream>>>(dp);
  return (int)cudaGetLastError();
}

template <bool kStash>
int launch(const DualParams& dp, int B, int R, int S, int Kp, int H, cudaStream_t stream) {
  return ffwd::cta_tiles(S) > 1 ? launch_kernel<kStash, true>(dp, B, R, S, Kp, H, stream)
                                : launch_kernel<kStash, false>(dp, B, R, S, Kp, H, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// Every weight, bias and conditioning row is stacked on a leading axis of 2
// (face, eyes) in the single-branch kernel's layout, and so are the weight
// stream scratch (filled per branch by pack_stream first) and the four
// outputs ([2, B, R, C], [2, B, R], [2, B, R], [2, B, R, S]).  `stash` is
// null (no stash) or 20 pointers: branch-major, slots x0..x7, y0b
// ([B, R, S, H] bf16 each) and y1 ([B, R, S, H/2]).  The caller
// (kernels/fused_field2.py) has checked the shapes as for the
// single-branch kernel.
int fused_field2_fwd(const void* embed, const float* zvals, const float* zdists,
                     const float* cb0, const float* cb5, const float* cbr1,
                     const void* w0e, const void* wmid, const float* bmid,
                     const void* w5e, const void* w5x, const void* wd,
                     const float* bd, const void* wr0, const float* br0,
                     const void* wr1x, const void* wr2, const float* br2, void* wstream,
                     float* feat_out, float* bga_out, float* depth_out,
                     float* w_out, void* const* stash, int B, int R, int S, int De,
                     int Kp, int H, int C, void* stream) {
  typedef ffwd::bf16 bf16;
  const size_t b = B, r = R, s = S, h = H, h2 = H / 2, kp = Kp, c = C;
  const int slices = ffwd::stream_slices(H, Kp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DualParams dp = {};
  for (int i = 0; i < 2; ++i) {
    ffwd::Params& p = dp.br[i];
    bf16* branch_stream =
        static_cast<bf16*>(wstream) + i * (size_t)slices * ffwd::kStageBytes / sizeof(bf16);
    const ffwd::StreamPlan plan = ffwd::stream_plan(
        static_cast<const bf16*>(w0e) + i * h * kp, static_cast<const bf16*>(wmid) + i * 6 * h * h,
        static_cast<const bf16*>(w5e) + i * h * kp, static_cast<const bf16*>(w5x) + i * h * h,
        static_cast<const bf16*>(wr0) + i * h * h, static_cast<const bf16*>(wr1x) + i * h2 * h, H,
        Kp);
    ffwd::pack_stream<<<slices, 4 * ffwd::kPassCols, 0, st>>>(plan, branch_stream);
    p.embed = static_cast<const bf16*>(embed);
    p.zvals = zvals;
    p.zdists = zdists;
    p.cb0 = cb0 + i * b * h;
    p.cb5 = cb5 + i * b * h;
    p.cbr1 = cbr1 + i * b * h2;
    p.wstream = branch_stream;
    p.bmid = bmid + i * 6 * h;
    p.wd = static_cast<const bf16*>(wd) + i * h;
    p.bd = bd + i;
    p.br0 = br0 + i * h;
    p.wr2 = static_cast<const bf16*>(wr2) + i * h2 * c;
    p.br2 = br2 + i * c;
    p.feat_out = feat_out + i * b * r * c;
    p.bga_out = bga_out + i * b * r;
    p.depth_out = depth_out + i * b * r;
    p.w_out = w_out + i * b * r * s;
    for (int k = 0; k < ffwd::kSlots && stash; ++k)
      if (!ffwd::stash_map(&dp.stash[i][k], stash[i * ffwd::kSlots + k], b * r * s,
                     k + 1 < ffwd::kSlots ? h : h2))
        return (int)cudaErrorInvalidValue;
    p.R = R;
    p.S = S;
    p.De = De;
    p.Kp = Kp;
    p.H = H;
    p.C = C;
  }
  return stash ? launch<true>(dp, B, R, S, Kp, H, st) : launch<false>(dp, B, R, S, Kp, H, st);
}

}  // extern "C"
