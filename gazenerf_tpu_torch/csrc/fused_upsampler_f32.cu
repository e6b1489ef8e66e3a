// Fused upsampler block in f32, forward (K7) and backward (K8), for NVIDIA
// Hopper (sm_90a): the f32 renderer's PixelShuffleUpsample block with its
// folded feat_layer,
//
//   h1  = lrelu(x W1 + b1)                  [*, 2F]
//   z   = lrelu(h1 W2g + b2g) + x P          [*, 4F]  group-major phases
//   z3  = z_k W3 + b3 for each phase k       [*, 4 F3]
//   out = the 9-tap blur-shuffle stencil of z3, [B, 2H, 2W, F3],
//
// and its gradient.  Replaces the TPU kernels
// gazenerf_tpu/kernels/fused_upsampler.py:_fwd_kernel (launched by
// _fwd_pallas) and _bwd_kernel (launched by _bwd_pallas) in their f32
// configuration (use_bf16=False); csrc/fused_upsampler_{fwd,bwd}.cu take
// the bf16 one.
//
// Numerics: every operand, product and intermediate (h1, z, z3, and the
// cotangents) is f32, as the TPU kernel's f32 mode has it: this mode exists
// for its accuracy, so no product runs on the tensor cores (TF32 keeps ~10
// mantissa bits, and a split of each operand into bf16 pieces short of three
// falls short too).  A product is a chain of f32 fused multiply-adds in
// increasing k from zero, bias added after; the stencil and its adjoint are
// csrc/phase_stencil.cuh's (K5 / K6 at f32).  The weight gradients sum the
// pixels in slices of up to kSliceRows rows, each slice in blocks of kRowsStage
// rows added to the slice's sum, and the slices pairwise: the f32 sums over
// up to 4 x 131,072 rows stay within a few units of f32 rounding of their
// terms, and no atomic makes the order vary (two launches give the same bits).
//
// Bound.  Per pixel 2F^2 + 8F^2 + 4 F F3 multiply-adds forward, three times
// that backward (the chain's recompute, its data and its weight gradients):
// at B=2 each of the three blocks is ~6.5 G multiply-adds forward, ~0.19 ms
// at the H100's 67 TFLOP/s of f32 outside the tensor cores, against ~15-50 MB
// of bytes (under 0.02 ms): bound by f32 operations.
//
// Design: the simple tile kernels that are right, on the CUDA cores.
//  * chain_fwd: a CTA takes a tile of TP pixels (8 warps, TP / 8 rows a
//    warp; TP the most rows whose x, h1 and one phase of z fit in shared
//    memory) and runs the chain in shared memory: every product reads its
//    left operand from shared memory (one value for the whole warp) and its
//    weights along their rows from device memory (32 neighbouring columns a
//    warp, from L1 / L2: every CTA reads all the weights), four columns a
//    lane.  z3 goes to an f32 scratch [B, H, W, 4 F3]; the stencil follows.
//  * the backward: the stencil's adjoint into dz3 [P, 4 F3]; chain_bwd
//    recomputes the chain of a tile, then per phase dz_k = dz3_k W3^T, the
//    lrelu masks, the residual's adjoint (a gather of the four channels
//    that read each x channel, in increasing order), dh1 = dzp W2g^T and dx
//    = dh1p W1^T + the residual's part, writing the weight gradients'
//    operands (h1, z, dzp, dh1p; x and dz3 are there already) to f32
//    scratch; atb_slices then contracts each pair over the pixels in 64 x 64
//    output tiles and slices of rows, and sum_slices adds the slices.
// Making it fast (weights staged in shared memory, tensor-core emulation of
// f32 by three bf16 pieces) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "phase_stencil.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kColsLane = 4;       // output columns a lane takes per pass (32 apart)
constexpr int kSmemLimit = 232448;  // shared memory a CTA may take (H100: 227 KB)
constexpr int kTileM = 64;         // atb_slices: output rows and columns of a CTA
constexpr int kRowsStage = 16;     // rows of a shared-memory stage
constexpr int kSliceRows = 1024;   // rows of one slice of the weight gradients' sums

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.2f * v; }

// out[r, n] = epi(r, n, sum_k A[r, k] W[k, n]) for the tile's rows (kRpw a
// warp) and n < N: A in shared memory (row stride lda), W [K, ldw] in device
// memory from its column 0, products in increasing k.  Lane l takes columns
// n0 + l + 32 j, j < kColsLane, of each pass of 128 columns.
template <int kRpw, class Epi>
__device__ __forceinline__ void tile_product(const float* A, int lda, const float* __restrict__ W,
                                             int ldw, int K, int N, Epi epi) {
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * kRpw;
  const float* a = A + r0 * lda;
  for (int n0 = 0; n0 < N; n0 += 32 * kColsLane) {
    float acc[kRpw][kColsLane];
#pragma unroll
    for (int r = 0; r < kRpw; ++r)
#pragma unroll
      for (int j = 0; j < kColsLane; ++j) acc[r][j] = 0.f;
    bool on[kColsLane];
#pragma unroll
    for (int j = 0; j < kColsLane; ++j) on[j] = n0 + lane + 32 * j < N;
    const float* w = W + n0 + lane;
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      float wv[kColsLane];
#pragma unroll
      for (int j = 0; j < kColsLane; ++j) wv[j] = on[j] ? __ldg(w + (size_t)k * ldw + 32 * j) : 0.f;
#pragma unroll
      for (int r = 0; r < kRpw; ++r) {
        const float av = a[r * lda + k];
#pragma unroll
        for (int j = 0; j < kColsLane; ++j) acc[r][j] = __fmaf_rn(av, wv[j], acc[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRpw; ++r)
#pragma unroll
      for (int j = 0; j < kColsLane; ++j)
        if (on[j]) epi(r0 + r, n0 + lane + 32 * j, acc[r][j]);
  }
}

struct Fwd {
  const float* x;    // [P, F]
  const float* w1;   // [F, 2F] (in, out)
  const float* b1;   // [2F]
  const float* w2;   // [2F, 4F] group-major columns
  const float* b2;   // [4F]
  const float* w3;   // [F, F3]
  const float* b3;   // [F3]
  float* z3;         // [P, 4 F3]
  long long P;
  int F, F3;
};

// Shared floats per tile row: x, h1 and one phase of z
__host__ __device__ inline int fwd_row_floats(int F, int F3) { return 4 * F; }
// x (later dz_k), h1 (later dh1p), zp (later dzp), dz3, the residual's dx
__host__ __device__ inline int bwd_row_floats(int F, int F3) { return 8 * F + 4 * F3; }

// the x channel that group-major z channel k F + c adds: (4c + k) mod F
__device__ __forceinline__ int res_channel(int k, int c, int F) { return (4 * c + k) % F; }

template <int kRpw>
__global__ void __launch_bounds__(kThreads) chain_fwd(const Fwd p) {
  extern __shared__ __align__(16) float sm[];
  constexpr int TP = kRpw * kWarps;
  const int F = p.F, F3 = p.F3, F2 = 2 * F, F4 = 4 * F;
  float* sx = sm;            // [TP, F]
  float* sh1 = sx + TP * F;  // [TP, 2F]
  float* sz = sh1 + TP * F2;  // [TP, F]
  const long long p0 = (long long)blockIdx.x * TP;
  for (int i = threadIdx.x; i < TP * F; i += kThreads) {
    const int r = i / F;
    sx[i] = p0 + r < p.P ? p.x[p0 * F + i] : 0.f;
  }
  __syncthreads();
  tile_product<kRpw>(sx, F, p.w1, F2, F, F2,
                     [&](int r, int n, float acc) { sh1[r * F2 + n] = lrelu(acc + p.b1[n]); });
  __syncthreads();
  for (int k = 0; k < 4; ++k) {
    tile_product<kRpw>(sh1, F2, p.w2 + k * F, F4, F2, F, [&](int r, int c, float acc) {
      sz[r * F + c] = lrelu(acc + p.b2[k * F + c]) + sx[r * F + res_channel(k, c, F)];
    });
    __syncthreads();
    tile_product<kRpw>(sz, F, p.w3, F3, F, F3, [&](int r, int c, float acc) {
      if (p0 + r < p.P) p.z3[(p0 + r) * 4 * F3 + k * F3 + c] = acc + p.b3[c];
    });
    __syncthreads();  // the next phase rewrites z
  }
}

struct Bwd {
  const float* x;     // [P, F]
  const float* w1;    // [F, 2F]
  const float* b1;    // [2F]
  const float* w2;    // [2F, 4F]
  const float* b2;    // [4F]
  const float* w3t;   // W3^T [F3, F]
  const float* w2t;   // W2g^T [4F, 2F]
  const float* w1t;   // W1^T [2F, F]
  const float* dz3;   // [P, 4 F3], the stencil's adjoint of dy
  float* h1;          // [P, 2F]   out: the weight gradients' operands
  float* z;           // [P, 4F]
  float* dzp;         // [P, 4F]
  float* dh1p;        // [P, 2F]
  float* dx;          // [P, F]
  long long P;
  int F, F3;
};

template <int kRpw>
__global__ void __launch_bounds__(kThreads) chain_bwd(const Bwd p) {
  extern __shared__ __align__(16) float sm[];
  constexpr int TP = kRpw * kWarps;
  const int F = p.F, F3 = p.F3, F2 = 2 * F, F4 = 4 * F, F34 = 4 * F3;
  float* sx = sm;              // [TP, F]: x, then one phase of dz
  float* sh1 = sx + TP * F;    // [TP, 2F]: h1, then dh1p
  float* szp = sh1 + TP * F2;  // [TP, 4F]: zp, then dzp
  float* sd3 = szp + TP * F4;  // [TP, 4 F3]
  float* sdr = sd3 + TP * F34;  // [TP, F]: the residual's part of dx
  const long long p0 = (long long)blockIdx.x * TP;
  auto in = [&](int r) { return p0 + r < p.P; };
  for (int i = threadIdx.x; i < TP * F; i += kThreads) {
    sx[i] = in(i / F) ? p.x[p0 * F + i] : 0.f;
    sdr[i] = 0.f;
  }
  for (int i = threadIdx.x; i < TP * F34; i += kThreads)
    sd3[i] = in(i / F34) ? p.dz3[p0 * F34 + i] : 0.f;
  __syncthreads();
  // ---- the chain's recompute: h1, zp; h1 and z to the operands ----
  tile_product<kRpw>(sx, F, p.w1, F2, F, F2, [&](int r, int n, float acc) {
    const float h = lrelu(acc + p.b1[n]);
    sh1[r * F2 + n] = h;
    if (in(r)) p.h1[(p0 + r) * F2 + n] = h;
  });
  __syncthreads();
  tile_product<kRpw>(sh1, F2, p.w2, F4, F2, F4, [&](int r, int n, float acc) {
    const float zp = acc + p.b2[n];
    szp[r * F4 + n] = zp;
    const int k = n / F, c = n - k * F;
    if (in(r)) p.z[(p0 + r) * F4 + n] = lrelu(zp) + sx[r * F + res_channel(k, c, F)];
  });
  __syncthreads();
  // ---- per phase: dz_k = dz3_k W3^T, dzp_k, the residual's adjoint ----
  for (int k = 0; k < 4; ++k) {
    tile_product<kRpw>(sd3 + k * F3, F34, p.w3t, F, F3, F,
                       [&](int r, int c, float acc) { sx[r * F + c] = acc; });
    __syncthreads();
    for (int i = threadIdx.x; i < TP * F; i += kThreads) {
      const int r = i / F, f = i - r * F;
      // dzp = lrelu'(zp) dz in place of zp
      const int n = k * F + f;
      const float d = sx[i], zp = szp[r * F4 + n];
      const float g = zp > 0.f ? d : 0.2f * d;
      szp[r * F4 + n] = g;
      if (in(r)) p.dzp[(p0 + r) * F4 + n] = g;
      // x channel f takes dz_k at the channels c with 4c + k = f + jF, j = 0..3
      float s = sdr[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = f + j * F;
        if ((m & 3) == k) s += sx[r * F + (m >> 2)];
      }
      sdr[i] = s;
    }
    __syncthreads();
  }
  // ---- dh1p = lrelu'(h1p) (dzp W2g^T), in place of h1 (h1 > 0 iff h1p > 0) ----
  tile_product<kRpw>(szp, F4, p.w2t, F2, F4, F2, [&](int r, int n, float acc) {
    const float g = sh1[r * F2 + n] > 0.f ? acc : 0.2f * acc;
    sh1[r * F2 + n] = g;
    if (in(r)) p.dh1p[(p0 + r) * F2 + n] = g;
  });
  __syncthreads();
  // ---- dx = dh1p W1^T + the residual's part ----
  tile_product<kRpw>(sh1, F2, p.w1t, F, F2, F, [&](int r, int c, float acc) {
    if (in(r)) p.dx[(p0 + r) * F + c] = acc + sdr[r * F + c];
  });
}

// One weight gradient's contraction over rows: out[M, N] = A^T B with A
// [rows, M] (or ones when A is null: the column sums of B) and B [rows, N],
// row-major.  Grid (column tiles, row tiles, slices): a CTA takes a 64 x 64
// output tile (a thread 4 x 4) over one slice of rows, in stages of
// kRowsStage rows whose products are summed apart and then added to the
// slice's sum, and writes it to part[slice, M, N].
__global__ void __launch_bounds__(kThreads) atb_slices(const float* A, const float* B, int rows,
                                                       int M, int N, float* part) {
  __shared__ __align__(16) float sa[kRowsStage][kTileM];
  __shared__ __align__(16) float sb[kRowsStage][kTileM];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kTileM, m0 = blockIdx.y * kTileM;
  const int r_begin = blockIdx.z * kSliceRows;
  const int r_end = min(rows, r_begin + kSliceRows);
  float acc[4][4], stage[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int r0 = r_begin; r0 < r_end; r0 += kRowsStage) {
    for (int i = threadIdx.x; i < kRowsStage * kTileM; i += kThreads) {
      const int r = i / kTileM, c = i - r * kTileM, row = r0 + r;
      const bool live = row < r_end;
      sa[r][c] = live && m0 + c < M ? (A ? A[(size_t)row * M + m0 + c] : 1.f) : 0.f;
      sb[r][c] = live && n0 + c < N ? B[(size_t)row * N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) stage[i][j] = 0.f;
#pragma unroll 4
    for (int r = 0; r < kRowsStage; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&sa[r][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&sb[r][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) stage[i][j] = __fmaf_rn(av[i], bv[j], stage[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += stage[i][j];
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (m < M && n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// out[i] = the pairwise sum over s of part[s, i]: slice s joins the sums of
// the slices before it as in a binary counter (s = ..., 4 + 5 + 6 + 7, ...)
__global__ void sum_slices(const float* part, int slices, int len, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float stack[16];
  int top = 0;
  for (int s = 0; s < slices; ++s) {
    float v = part[(size_t)s * len + i];
    for (int t = s; t & 1; t >>= 1) v = stack[--top] + v;
    stack[top++] = v;
  }
  float v = stack[--top];
  while (top) v = stack[--top] + v;
  out[i] = v;
}

// the most rows a tile may take (8, 16, 32 or 64) whose shared memory fits
inline int tile_rows(int row_floats) {
  for (int tp = 64; tp >= 8; tp /= 2)
    if ((size_t)tp * row_floats * sizeof(float) <= kSmemLimit) return tp;
  return 0;
}

// launch the chain kernel k (of tiles of tp rows) over rows pixels
template <class P>
cudaError_t launch_chain(void (*k)(P), int tp, long long rows, const P& p, size_t smem,
                         cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  k<<<(unsigned)((rows + tp - 1) / tp), kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

cudaError_t contract(const float* A, const float* B, int rows, int M, int N, float* part,
                     float* out, cudaStream_t st) {
  const int slices = (rows + kSliceRows - 1) / kSliceRows;
  dim3 grid((N + kTileM - 1) / kTileM, (M + kTileM - 1) / kTileM, slices);
  atb_slices<<<grid, kThreads, 0, st>>>(A, B, rows, M, N, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int len = M * N;
  sum_slices<<<(len + 255) / 256, 256, 0, st>>>(part, slices, len, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of a tile of the forward (bwd = 0) or the backward chain at widths
// F, F3; 0 when not even 8 rows fit in shared memory.
int fused_upsampler_f32_rows(int F, int F3, int bwd) {
  return tile_rows(bwd ? bwd_row_floats(F, F3) : fwd_row_floats(F, F3));
}

// Floats of the backward's scratch for P pixels: dz3 [P, 4 F3], h1 [P, 2F],
// z and dzp [P, 4F], dh1p [P, 2F], then the slices of the largest weight
// gradient's sums.
long long fused_upsampler_f32_scratch(long long P, int F, int F3) {
  const long long slices = (4 * P + kSliceRows - 1) / kSliceRows;
  long long part = slices * F * F3;  // dW3 over the 4P phase rows
  const long long s1 = (P + kSliceRows - 1) / kSliceRows;
  part = part > s1 * 8LL * F * F ? part : s1 * 8LL * F * F;  // dW2g [2F, 4F]
  return P * (4LL * F3 + 12LL * F) + part;
}

// K7 at f32 on `stream`: x [P = B*H*W, F] f32 and f32 weights ([in, out],
// W2g's columns group-major) -> z3 scratch [P, 4 F3] -> y [B, 2H, 2W, F3]
// (bf16 if y_bf16, else f32).  Returns the first cudaError_t (0 = success).
int fused_upsampler_f32_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                            const float* b2, const float* w3, const float* b3, float* z3,
                            void* y, int B, int H, int W, int F, int F3, int y_bf16,
                            void* stream) {
  Fwd p = {x, w1, b1, w2, b2, w3, b3, z3, (long long)B * H * W, F, F3};
  const int tp = fused_upsampler_f32_rows(F, F3, 0);
  if (!tp) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)tp * fwd_row_floats(F, F3) * sizeof(float);
  auto k = tp == 64 ? chain_fwd<8> : tp == 32 ? chain_fwd<4> : tp == 16 ? chain_fwd<2>
                                                                         : chain_fwd<1>;
  cudaError_t err = launch_chain(k, tp, p.P, p, smem, st);
  if (err != cudaSuccess) return (int)err;
  return y_bf16 ? stencil::launch_fwd<float, bf16>(z3, y, B, H, W, F3, st)
                : stencil::launch_fwd<float, float>(z3, y, B, H, W, F3, st);
}

// K8 at f32 on `stream`: dy [B, 2H, 2W, F3] f32 -> dx [P, F] f32 and the
// weight gradients dW1 [F, 2F], db1 [2F], dW2g [2F, 4F], db2g [4F], dW3
// [F, F3], db3 [F3].  w3t, w2t, w1t are W3^T [F3, F], W2g^T [4F, 2F], W1^T
// [2F, F]; scratch holds fused_upsampler_f32_scratch floats.
int fused_upsampler_f32_bwd(const float* x, const float* dy, const float* w1, const float* b1,
                            const float* w2, const float* b2, const float* w3t,
                            const float* w2t, const float* w1t, float* dx, float* dw1,
                            float* db1, float* dw2, float* db2, float* dw3, float* db3,
                            float* scratch, int B, int H, int W, int F, int F3, void* stream) {
  const long long P = (long long)B * H * W;
  Bwd p;
  p.x = x;
  p.w1 = w1;
  p.b1 = b1;
  p.w2 = w2;
  p.b2 = b2;
  p.w3t = w3t;
  p.w2t = w2t;
  p.w1t = w1t;
  float* dz3 = scratch;
  p.dz3 = dz3;
  p.h1 = dz3 + P * 4 * F3;
  p.z = p.h1 + P * 2 * F;
  p.dzp = p.z + P * 4 * F;
  p.dh1p = p.dzp + P * 4 * F;
  float* part = p.dh1p + P * 2 * F;
  p.dx = dx;
  p.P = P;
  p.F = F;
  p.F3 = F3;
  const int tp = fused_upsampler_f32_rows(F, F3, 1);
  if (!tp) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e = stencil::launch_bwd<float, float>(dy, dz3, B, H, W, F3, st);
  if (e) return e;
  const size_t smem = (size_t)tp * bwd_row_floats(F, F3) * sizeof(float);
  auto k = tp == 64 ? chain_bwd<8> : tp == 32 ? chain_bwd<4> : tp == 16 ? chain_bwd<2>
                                                                         : chain_bwd<1>;
  cudaError_t err = launch_chain(k, tp, P, p, smem, st);
  if (err != cudaSuccess) return (int)err;
  const int rows = (int)P;
  if ((err = contract(x, p.dh1p, rows, F, 2 * F, part, dw1, st)) != cudaSuccess) return (int)err;
  if ((err = contract(nullptr, p.dh1p, rows, 1, 2 * F, part, db1, st)) != cudaSuccess)
    return (int)err;
  if ((err = contract(p.h1, p.dzp, rows, 2 * F, 4 * F, part, dw2, st)) != cudaSuccess)
    return (int)err;
  if ((err = contract(nullptr, p.dzp, rows, 1, 4 * F, part, db2, st)) != cudaSuccess)
    return (int)err;
  // the phases' rows: z [P, 4F] read as [4P, F], dz3 [P, 4 F3] as [4P, F3]
  if ((err = contract(p.z, dz3, 4 * rows, F, F3, part, dw3, st)) != cudaSuccess) return (int)err;
  return (int)contract(nullptr, dz3, 4 * rows, 1, F3, part, db3, st);
}

}  // extern "C"
