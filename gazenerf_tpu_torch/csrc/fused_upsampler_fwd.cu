// Fused upsampler block, forward, for NVIDIA Hopper (sm_90a): one whole
// PixelShuffleUpsample block of the neural renderer with its folded
// feat_layer,
//
//   h1  = lrelu(x W1 + b1)                  [*, 2F]
//   z   = lrelu(h1 W2g + b2g) + x P          [*, 4F]  group-major phases
//   z3  = z_k W3 + b3 for each phase k       [*, 4 F3]
//   out = the 9-tap blur-shuffle stencil of z3, [B, 2H, 2W, F3] in x's type.
//
// Replaces the TPU kernel gazenerf_tpu/kernels/fused_upsampler.py:_fwd_kernel
// (launched by _fwd_pallas) in its bf16 configuration (use_bf16=True).
//
// Numerics follow that kernel: x, W1, W2g, W3 rounded to bf16; products
// accumulate in f32; bias and lrelu in f32; h1 rounded to bf16; z kept in
// f32 with the residual x P = bf16(x) (P is the 0/1 channel-tile matrix, a
// gather here: column k*F + c of P picks channel (4c + k) % F), then rounded
// to bf16 per phase before W3; z3 in f32; the stencil sums in f32 and rounds
// once to x's type.
//
// Bound.  Per pixel 2F^2 + 8F^2 + 4 F F3 multiply-adds: at B=2 each of the
// three blocks (F = 258, 129, 64 at 64^2, 128^2, 256^2 pixels) is ~6.5 G
// multiply-adds, 13 us at 989 TFLOP/s; the bytes the function must move (x
// in, the [B, 2H, 2W, F3] output, the weights) grow from ~15 MB (4.5 us at
// 3.35 TB/s) at the first block to ~50 MB (15 us) at the last.  So the
// first block is bound by bf16 tensor-core operations, the last by bytes.
//
// Design (correct and simple first; the TPU kernel's halo recompute that
// keeps z3 on chip, ldmatrix, wgmma and TMA are later work): two launches.
//  1. chain_kernel: one CTA of 256 threads per 32-pixel tile runs x -> h1 ->
//     z_k -> z3_k with mma.sync m16n8k16 (csrc/tile_mma.cuh), the tiles of
//     x, h1 and one phase of z in shared memory as bf16; B fragments read
//     straight from the zero-padded bf16 weights in global memory (L2
//     resident).  z3 goes to an f32 scratch [B, H, W, 4 F3] in global
//     memory.
//  2. the stencil (csrc/phase_stencil.cuh) from the scratch to the output.
// The odd widths (F = 129) are zero-padded to the mma tile on both K and N
// by the caller; stores are masked to the real widths.

#include "phase_stencil.cuh"
#include "tile_mma.cuh"

namespace {

using tile::bf16;
using tile::kPad;
using tile::kRows;
using tile::kThreads;

struct Params {
  const bf16* x;    // [P, F] bf16, P = B*H*W pixels
  const bf16* w1f;  // [F2p, Fp]     W1^T, zero-padded
  const float* b1;  // [2F]
  const bf16* w2f;  // [4, Fp, F2p]  per phase k: W2g[:, kF:(k+1)F]^T, zero-padded
  const float* b2;  // [4F] group-major
  const bf16* w3f;  // [F3p, Fp]     W3^T, zero-padded
  const float* b3;  // [F3]
  float* z3;        // [P, 4 F3]
  int P, F, F3, Fp, F2p, F3p;
};

// z3[p0 + r, k F3 + c] = v + b3[c] for the tile's real rows and columns
struct EpiZ3 {
  float* out;  // z3 + p0 * 4 F3 + k F3
  int ld, n, rows;
  const float* b3;
  __device__ void operator()(int r, int c, float& v0, float& v1) const {
    if (r >= rows) return;
    if (c < n) out[(size_t)r * ld + c] = v0 + b3[c];
    if (c + 1 < n) out[(size_t)r * ld + c + 1] = v1 + b3[c + 1];
  }
};

__global__ void __launch_bounds__(kThreads) chain_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = p.Fp + kPad, ldh = p.F2p + kPad;
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [kRows, ldx]
  bf16* h1 = xs + kRows * ldx;                // [kRows, ldh]
  bf16* zs = h1 + kRows * ldh;                // [kRows, ldx]
  const int p0 = blockIdx.x * kRows;
  const int rows = min(kRows, p.P - p0);

  for (int i = threadIdx.x; i < kRows * p.Fp; i += kThreads) {
    const int r = i / p.Fp, c = i - r * p.Fp;
    xs[r * ldx + c] = (r < rows && c < p.F) ? p.x[(size_t)(p0 + r) * p.F + c]
                                             : __float2bfloat16(0.f);
  }
  __syncthreads();
  {
    const tile::Seg s = {xs, ldx, p.w1f, p.Fp};
    tile::gemm(&s, 1, p.F2p, tile::EpiH1{h1, ldh, p.b1, 2 * p.F});
  }
  __syncthreads();
  for (int k = 0; k < 4; ++k) {
    const tile::Seg s2 = {h1, ldh, p.w2f + (size_t)k * p.Fp * p.F2p, p.F2p};
    tile::gemm(&s2, 1, p.Fp, tile::EpiZ{zs, ldx, p.b2 + k * p.F, xs, ldx, p.F, k});
    __syncthreads();
    const tile::Seg s3 = {zs, ldx, p.w3f, p.Fp};
    tile::gemm(&s3, 1, p.F3p,
               EpiZ3{p.z3 + (size_t)p0 * 4 * p.F3 + k * p.F3, 4 * p.F3, p.F3, rows, p.b3});
    __syncthreads();  // the next phase overwrites zs
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: the chain into the scratch z3 ([B*H*W, 4 F3] f32), then
// the stencil into y ([B, 2H, 2W, F3], bf16 if y_bf16 else f32).  Returns
// the first cudaError_t (0 = success).  The caller
// (kernels/fused_upsampler.py) has checked the shapes and padded the
// weights: Fp = pad16(F), F2p = pad16(2F), F3p = pad16(F3).
int fused_upsampler_fwd(const void* x, const void* w1f, const float* b1, const void* w2f,
                        const float* b2, const void* w3f, const float* b3, float* z3, void* y,
                        int B, int H, int W, int F, int F3, int y_bf16, void* stream) {
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.w1f = static_cast<const bf16*>(w1f);
  p.b1 = b1;
  p.w2f = static_cast<const bf16*>(w2f);
  p.b2 = b2;
  p.w3f = static_cast<const bf16*>(w3f);
  p.b3 = b3;
  p.z3 = z3;
  p.P = B * H * W;
  p.F = F;
  p.F3 = F3;
  p.Fp = tile::pad16(F);
  p.F2p = tile::pad16(2 * F);
  p.F3p = tile::pad16(F3);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem =
      (size_t)kRows * (2 * (p.Fp + kPad) + p.F2p + kPad) * sizeof(bf16);
  cudaError_t err =
      cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  chain_kernel<<<(p.P + kRows - 1) / kRows, kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return y_bf16 ? stencil::launch_fwd<float, __nv_bfloat16>(z3, y, B, H, W, F3, st)
                : stencil::launch_fwd<float, float>(z3, y, B, H, W, F3, st);
}

}  // extern "C"
