// The renderer's blur-shuffle stencil, blur3x3(pixel_shuffle2(x)), on a
// group-major [B, H, W, 4C] input (channel k*C + c is shuffle phase k of
// channel c), and its adjoint.  Shared by csrc/shuffle_blur.cu (K5 / K6) and
// the fused upsampler's two kernels, which run it on their f32 scratch.
//
// Numerics: the taps (1, 2, 1)/4 x (1, 2, 1)/4 are powers of two, so every
// tap product is exact and a fused multiply-add rounds like a product and a
// sum; the sums run in f32 in the order of the plain versions in
// kernels/shuffle_blur.py, and the result is rounded once to the output type.
// The kernel and its plain version give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace stencil {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// y[b, 2h+i, 2w+j, c] = sum_{a, e in 0..2} f[a] f[e] sh[2h+i+a-1, 2w+j+e-1],
// sh the shuffled image with a reflect boundary, which at phase granularity
// is the edge clamp of the phase images: shuffled offset m = i + a - 1 reads
// phase row m & 1 of block h + (m >> 1), clamped to [0, H).  One thread per
// output element; y is [B, 2H, 2W, C].  Grid (row chunks, 2H, B): block
// (., p, b) takes output row p of image b, its 2W*C elements in order, so
// the index arithmetic stays in 32 bits.
template <typename Tin, typename Tout>
__global__ void fwd_kernel(const Tin* __restrict__ x, Tout* __restrict__ y, int H, int W,
                           int C) {
  const float f[3] = {0.25f, 0.5f, 0.25f};
  const unsigned e_idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (e_idx >= 2u * W * C) return;
  const int p = blockIdx.y, b = blockIdx.z;
  const int q = (int)(e_idx / (unsigned)C), c = (int)(e_idx - (unsigned)q * C);
  const int h = p >> 1, ii = p & 1, w = q >> 1, jj = q & 1;
  const Tin* xb = x + (size_t)b * H * W * 4 * C + c;
  float acc = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int m = ii + a - 1;
    const int row = clampi(h + (m >> 1), H - 1);
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int nn = jj + e - 1;
      const int col = clampi(w + (nn >> 1), W - 1);
      const int k = (m & 1) * 2 + (nn & 1);
      acc += (f[a] * f[e]) * load_f(xb + ((size_t)row * W + col) * 4 * C + (size_t)k * C);
    }
  }
  store_f(y + ((size_t)b * 2 * H + p) * 2 * W * C + e_idx, acc);
}

// The adjoint along one axis of length L: position M of the shuffled image
// receives 0.5 of output M and 0.25 of outputs M - 1 and M + 1 that exist,
// plus the reflected taps: output 0 reads M = 1 (so M = 1 takes 0.5 of
// output 0) and output L - 1 reads M = L - 2.
__device__ __forceinline__ float w_prev(int M) { return M == 1 ? 0.5f : 0.25f; }
__device__ __forceinline__ float w_next(int M, int L) { return M == L - 2 ? 0.5f : 0.25f; }

// The adjoint of fwd_kernel at element (b, h, w, k*C + c) of its [B, H, W,
// 4C] input, from dy [B, 2H, 2W, C]: shuffled position (M, N) = (2h + k/2,
// 2w + k%2), separable: each of the (up to) three rows of dy is summed over
// its (up to) three columns first, in order.
template <typename Tin>
__device__ __forceinline__ float adjoint_at(const Tin* __restrict__ dy, int b, int h, int w,
                                            int k, int c, int H, int W, int C) {
  const int L = 2 * H, Lc = 2 * W;
  const int M = 2 * h + (k >> 1), N = 2 * w + (k & 1);
  const Tin* db = dy + (size_t)b * L * Lc * C + c;
  float acc = 0.f;
#pragma unroll
  for (int dm = -1; dm <= 1; ++dm) {
    const int p = M + dm;
    if (p < 0 || p >= L) continue;
    const Tin* row = db + (size_t)p * Lc * C;
    float rs = 0.f;
    if (N >= 1) rs += w_prev(N) * load_f(row + (size_t)(N - 1) * C);
    rs += 0.5f * load_f(row + (size_t)N * C);
    if (N + 1 < Lc) rs += w_next(N, Lc) * load_f(row + (size_t)(N + 1) * C);
    acc += (dm < 0 ? w_prev(M) : dm > 0 ? w_next(M, L) : 0.5f) * rs;
  }
  return acc;
}

// dx [B, H, W, 4C] = the adjoint of fwd_kernel, one thread per element.
// Grid (row chunks, H, B): block (., h, b) takes row h of dx in image b.
template <typename Tin, typename Tout>
__global__ void bwd_kernel(const Tin* __restrict__ dy, Tout* __restrict__ dx, int H, int W,
                           int C) {
  const unsigned e_idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (e_idx >= 4u * W * C) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int w = (int)(e_idx / (4u * C));
  const int r = (int)(e_idx - (unsigned)w * 4u * C);
  const int k = r / C, c = r - k * C;
  store_f(dx + ((size_t)b * H + h) * W * 4 * C + e_idx, adjoint_at(dy, b, h, w, k, c, H, W, C));
}

constexpr int kThreads = 256;

// Launch either direction on `stream`; returns the cudaError_t of the launch
// (an image taller than the grid's 65535 rows or a batch over 65535 is
// refused there).
template <typename Tin, typename Tout>
int launch_fwd(const void* x, void* y, int B, int H, int W, int C, cudaStream_t stream) {
  const dim3 grid((2 * W * C + kThreads - 1) / kThreads, 2 * H, B);
  fwd_kernel<Tin, Tout><<<grid, kThreads, 0, stream>>>(static_cast<const Tin*>(x),
                                                         static_cast<Tout*>(y), H, W, C);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch_bwd(const void* dy, void* dx, int B, int H, int W, int C, cudaStream_t stream) {
  const dim3 grid((4 * W * C + kThreads - 1) / kThreads, H, B);
  bwd_kernel<Tin, Tout><<<grid, kThreads, 0, stream>>>(static_cast<const Tin*>(dy),
                                                         static_cast<Tout*>(dx), H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace stencil
