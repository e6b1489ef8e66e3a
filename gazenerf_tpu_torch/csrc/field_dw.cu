// The fused field backward's weight-gradient GEMM (csrc/field_dw.cuh) on its
// own: out_j[M_j, N_j] (+)= x_j[P, M_j]^T d_j[P, N_j] for a list of bf16
// products over the same P points, in one launch.  The fused field
// backwards (csrc/fused_field_bwd.cu, csrc/fused_field2_bwd.cu) launch the
// same device code under their own kernel names, per chunk of points; this
// entry lets kernels/field_dw.py hold the GEMM against its plain version and
// time it.

#include "field_dw.cuh"

namespace {

__global__ void __launch_bounds__(fdw::kThreads) dw_kernel(const __grid_constant__ fdw::Jobs js) {
  extern __shared__ __align__(16) unsigned char smem[];
  fdw::dw_tile(js, smem);
}

__global__ void __launch_bounds__(256) dwsum_kernel(const __grid_constant__ fdw::Jobs js) {
  fdw::dw_reduce(js);
}

}  // namespace

extern "C" {

// Launch on `stream` the n_jobs products (at most 12): x[j] [P, M[j]] and
// d[j] [P, N[j]] bf16 with contiguous rows, out[j] [M[j], N[j]] f32; M and N
// multiples of 32, P a multiple of 32; `part` holds fdw::kMaxSplits times
// the sum of M[j] N[j] floats of partial sums.  Returns the first
// cudaError_t (0 = success); 1 (cudaErrorInvalidValue) for more jobs than
// the kernel takes.
int field_dw(int n_jobs, const void* const* x, const void* const* d, float* const* out,
             const int* M, const int* N, int P, int accumulate, float* part, void* stream) {
  if (n_jobs < 1 || n_jobs > fdw::kMaxJobs) return (int)cudaErrorInvalidValue;
  fdw::Jobs js;
  js.n_jobs = n_jobs;
  for (int j = 0; j < n_jobs; ++j) {
    js.job[j].x = static_cast<const fdw::bf16*>(x[j]);
    js.job[j].d = static_cast<const fdw::bf16*>(d[j]);
    js.job[j].out = out[j];
    js.job[j].M = M[j];
    js.job[j].N = N[j];
  }
  js.P = P;
  js.accumulate = accumulate;
  cudaError_t err;
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  fdw::number_tiles(js, sms, part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)fdw::kSmem);
  if (err != cudaSuccess) return (int)err;
  dw_kernel<<<js.tiles * js.splits, fdw::kThreads, fdw::kSmem, st>>>(js);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dwsum_kernel<<<fdw::blocks256(js.part_len), 256, 0, st>>>(js);
  return (int)cudaGetLastError();
}

}  // extern "C"
