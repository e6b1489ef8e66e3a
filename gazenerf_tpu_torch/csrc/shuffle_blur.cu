// Blur-shuffle stencil for NVIDIA Hopper (sm_90a): K5, blur3x3(pixel_shuffle2
// (x)) on a group-major [B, H, W, 4C] input into [B, 2H, 2W, C], and K6, its
// adjoint (the transposed stencil with the edge folds) from the
// [B, 2H, 2W, C] cotangent back to [B, H, W, 4C].
//
// Replaces the TPU kernels gazenerf_tpu/kernels/shuffle_blur.py:_fwd_kernel
// (launched by _stencil_fwd; the depth-to-space that follows it in XLA is
// folded into this kernel's store) and :_bwd_kernel (launched by
// _stencil_bwd; this kernel reads dy directly where the TPU one reads a
// zero-padded space-to-depth copy of it).
//
// Numerics follow those kernels: the nine taps summed in f32, the result
// rounded once to the input's type (f32 or bf16).  See phase_stencil.cuh.
//
// Bound.  Nine multiply-adds per output element against one element read
// and one written: bound by bytes.  At B=2 the renderer's three levels
// (C = 129, 64, 32 at H = W = 64, 128, 256) move 8.5, 16.8 and 33.6 MB in
// bf16 each way (5, 10 and 20 us at 3.35 TB/s).
//
// Design (phase_stencil.cuh states it in full): a CTA takes a strip of
// columns and a run of rows and walks down the rows with the three rows (K6:
// three pairs of dy rows) its outputs need in a shared-memory ring, one row
// copied per step by 16-byte cp.async while the previous one is computed, so
// each input byte comes from device memory about once.  A thread takes one
// pixel and up to 16 bytes of consecutive channels: four vector reads per
// output from shared memory (the 2 x 2 outputs of a pixel share their
// 4 x 4 neighbourhood), four vector stores, and no division per element.
// The fused upsampler's forward (K7) runs the same forward on its f32
// scratch.

#include "phase_stencil.cuh"

extern "C" {

// Launch K5 on `stream`: x [B, H, W, 4C] -> y [B, 2H, 2W, C], both bf16
// (is_bf16 = 1) or both f32 (0).  Returns the cudaError_t of the launch (0 =
// success).
int shuffle_blur_fwd(const void* x, void* y, int B, int H, int W, int C, int is_bf16,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf;
  return is_bf16 ? stencil::launch_fwd<bf, bf>(x, y, B, H, W, C, st)
                 : stencil::launch_fwd<float, float>(x, y, B, H, W, C, st);
}

// Launch K6 on `stream`: dy [B, 2H, 2W, C] -> dx [B, H, W, 4C], both of one
// type as for K5.
int shuffle_blur_bwd(const void* dy, void* dx, int B, int H, int W, int C, int is_bf16,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf;
  return is_bf16 ? stencil::launch_bwd<bf, bf>(dy, dx, B, H, W, C, st)
                 : stencil::launch_bwd<float, float>(dy, dx, B, H, W, C, st);
}

}  // extern "C"
