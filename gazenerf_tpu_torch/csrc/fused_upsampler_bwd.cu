// Fused upsampler block, backward, for NVIDIA Hopper (sm_90a): the gradient
// of csrc/fused_upsampler_fwd.cu's block with respect to x and the six
// weights and biases.
//
// Replaces the TPU kernel gazenerf_tpu/kernels/fused_upsampler.py:_bwd_kernel
// (launched by _bwd_pallas) in its bf16 configuration (use_bf16=True).
//
// Numerics follow that kernel: dz3 = the stencil's adjoint of dy, in f32;
// per phase dz_k = dz3_k W3^T, a product of f32 operands; dzp = lrelu'(zp)
// dz; dh1 = bf16(dzp) bf16(W2g)^T; dx = bf16(dh1p) bf16(W1)^T + P bf16(dz)
// with dh1p = lrelu'(h1p) dh1; the weight gradients are products of bf16
// activations and bf16-rounded cotangents summed in f32 (dW3 = sum_k
// bf16(z_k)^T bf16(dz3_k), dW2g = h1^T bf16(dzp), dW1 = bf16(x)^T
// bf16(dh1p)), the bias gradients f32 sums.
//  * the f32 product on bf16 tensor cores: each f32 operand u is split into
//    u_hi = bf16(u) and u_lo = bf16(u - u_hi), and dz3 W3^T is the sum of
//    the three mma.sync products hi.hi + hi.lo + lo.hi (relative error
//    ~2^-16, against bf16's 2^-8).
//  * the lrelu masks: zp > 0 is kept as a byte per element; h1p > 0 is read
//    as bf16(lrelu(h1p)) > 0, the same test.
//
// Bound.  Per pixel the backward repeats the forward's chain up to z (2F^2 +
// 8F^2 multiply-adds), then dz (4 F F3, three times for the split), dh1
// (8F^2), dx (2F^2) and the weight gradients (as many as the forward):
// ~4x the forward's operations, ~26 G multiply-adds per block at B=2, 53
// us at 989 TFLOP/s, against 10-80 MB of bytes that must move (x, dy and dx,
// the weights and their gradients).
//
// Design (correct and simple first): three launches.
//  1. the stencil's adjoint (csrc/phase_stencil.cuh) from dy into an f32
//     scratch dz3 [B, H, W, 4 F3];
//  2. block_bwd_kernel: G persistent CTAs (one per SM), each walking
//     32-pixel tiles blockIdx.x, blockIdx.x + G, ...: recompute h1 and, per phase, z_k
//     and its mask; dW3 and db3; dz_k (split product) into bf16(dzp) for all
//     phases and the residual's cotangent; dW2g, db2; dh1 (one product over
//     the four phases), dW1, db1; dx.  The weight gradients go into a
//     private f32 slab per CTA in global memory (read-modify-write per tile);
//  3. sum_slabs sums the G slabs in CTA order.
// The TPU kernel keeps dW resident across its sequential grid; Hopper's
// blocks run in parallel, so this is K2's deterministic slab design: no
// atomics, the same bits on every run.

#include "phase_stencil.cuh"
#include "tile_mma.cuh"

namespace {

using tile::bf16;
using tile::kPad;
using tile::kRows;
using tile::kThreads;

// Offsets (in floats) of the gradients in one slab and in the output;
// each starts on a 16-byte boundary.
struct Layout {
  size_t w1, b1, w2, b2, w3, b3, total;
};

__host__ __device__ inline size_t align4(size_t o) { return (o + 3) & ~(size_t)3; }

__host__ __device__ inline Layout layout(int F, int F3) {
  const size_t f = F, f3 = F3;
  Layout L;
  size_t o = 0;
  L.w1 = o; o = align4(o + f * 2 * f);
  L.b1 = o; o = align4(o + 2 * f);
  L.w2 = o; o = align4(o + 2 * f * 4 * f);
  L.b2 = o; o = align4(o + 4 * f);
  L.w3 = o; o = align4(o + f * f3);
  L.b3 = o; o = align4(o + f3);
  L.total = o;
  return L;
}

struct Params {
  const bf16* x;     // [P, F] bf16
  const float* dz3;  // [P, 4 F3] f32, the stencil's adjoint of dy
  const bf16* w1f;   // [F2p, Fp]     W1^T (recompute)
  const float* b1;   // [2F]
  const bf16* w2f;   // [4, Fp, F2p]  per phase W2g^T (recompute)
  const float* b2;   // [4F]
  const bf16* w1b;   // [Fp, F2p]     W1
  const bf16* w2b;   // [F2p, 4 Fp]   W2g, phase-padded columns
  const bf16* w3hi;  // [Fp, F3p]     W3, bf16 high half
  const bf16* w3lo;  // [Fp, F3p]     W3 - high half, in bf16
  void* dx;          // [P, F] bf16 or f32
  float* slabs;      // [G, L.total]
  Layout L;
  int P, F, F3, Fp, F2p, F3p, n_tiles, dx_bf16;
};

// dz_k: bf16(dzp) into phase k's columns of dzp, bf16(dz) into dzb; the
// values left for the column sums are dzp
struct EpiDz {
  bf16* dzp;  // dzp + k Fp
  int ldp;
  bf16* dzb;
  int ldb;
  const unsigned char* mask;
  int ldm;
  __device__ void operator()(int r, int c, float& v0, float& v1) const {
    const __nv_bfloat162 d = __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(dzb + r * ldb + c) = d;
    v0 = mask[r * ldm + c] ? v0 : 0.2f * v0;
    v1 = mask[r * ldm + c + 1] ? v1 : 0.2f * v1;
    *reinterpret_cast<__nv_bfloat162*>(dzp + r * ldp + c) = __floats2bfloat162_rn(v0, v1);
  }
};

// dh1p = lrelu'(h1p) dh1, in place of h1 as bf16; zero in the padded columns
struct EpiDh1 {
  bf16* h1;
  int ld, n;
  __device__ void operator()(int r, int c, float& v0, float& v1) const {
    bf16* o = h1 + r * ld + c;
    v0 = c < n ? (tile::bf2f(o[0]) > 0.f ? v0 : 0.2f * v0) : 0.f;
    v1 = c + 1 < n ? (tile::bf2f(o[1]) > 0.f ? v1 : 0.2f * v1) : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
  }
};

// dx = v + the residual's cotangent, stored for the tile's real rows
struct EpiDx {
  void* dx;
  const float* dxr;
  int F, rows, p0, bf;
  __device__ void one(int r, int c, float v) const {
    if (r >= rows || c >= F) return;
    const size_t o = (size_t)(p0 + r) * F + c;
    v += dxr[r * F + c];
    if (bf)
      static_cast<bf16*>(dx)[o] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(dx)[o] = v;
  }
  __device__ void operator()(int r, int c, float& v0, float& v1) const {
    one(r, c, v0);
    one(r, c + 1, v1);
  }
};

// The channels c of phase k whose residual reads x channel f: 4c + k = f
// (mod F).  With d = gcd(4, F) there are d of them or none; returns the count.
__device__ int residual_sources(int k, int f, int F, int (&src)[4]) {
  const int d = F % 4 == 0 ? 4 : (F % 2 == 0 ? 2 : 1);
  int e = ((f - k) % F + F) % F;
  if (e % d) return 0;
  const int Fq = F / d, a = 4 / d;
  e /= d;
  const int inv2 = (Fq + 1) / 2;  // Fq is odd whenever a > 1
  const int inv = a == 1 ? 1 : (a == 2 ? inv2 : (inv2 * inv2) % Fq);
  const int c0 = (e * inv) % Fq;
  for (int i = 0; i < d; ++i) src[i] = c0 + i * Fq;
  return d;
}

// slab[c] += cs[c] + cs[ldcs + c] for c < n (the two row groups, in order)
__device__ void add_colsum(float* slab, const float* cs, int ldcs, int n) {
  for (int c = threadIdx.x; c < n; c += kThreads) slab[c] += cs[c] + cs[ldcs + c];
}

__global__ void __launch_bounds__(kThreads, 1) block_bwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = p.F, F3 = p.F3, Fp = p.Fp, F2p = p.F2p, F3p = p.F3p;
  const int ldx = Fp + kPad, ldh = F2p + kPad, ldd = F3p + kPad, ldp = 4 * Fp + kPad;
  const int ldcs = F2p > Fp ? F2p : Fp;
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [kRows, ldx]  bf16(x)
  bf16* h1 = xs + kRows * ldx;                // [kRows, ldh]  h1, then bf16(dh1p)
  bf16* zs = h1 + kRows * ldh;                // [kRows, ldx]  z_k, then bf16(dz_k)
  bf16* dhi = zs + kRows * ldx;               // [kRows, ldd]  dz3_k high half
  bf16* dlo = dhi + kRows * ldd;              // [kRows, ldd]  dz3_k low half
  bf16* dzp = dlo + kRows * ldd;              // [kRows, ldp]  bf16(dzp), 4 phases
  float* dxr = reinterpret_cast<float*>(dzp + kRows * ldp);  // [kRows, F]
  float* cs = dxr + kRows * F;                               // [2, ldcs]
  unsigned char* mask = reinterpret_cast<unsigned char*>(cs + 2 * ldcs);  // [kRows, Fp]

  const Layout& L = p.L;
  float* slab = p.slabs + (size_t)blockIdx.x * L.total;
  const int tid = threadIdx.x;

  for (int tile_i = blockIdx.x; tile_i < p.n_tiles; tile_i += gridDim.x) {
    const int p0 = tile_i * kRows;
    const int rows = min(kRows, p.P - p0);

    for (int i = tid; i < kRows * Fp; i += kThreads) {
      const int r = i / Fp, c = i - r * Fp;
      xs[r * ldx + c] = (r < rows && c < F) ? p.x[(size_t)(p0 + r) * F + c]
                                             : __float2bfloat16(0.f);
    }
    __syncthreads();
    {  // recompute h1
      const tile::Seg s = {xs, ldx, p.w1f, Fp};
      tile::gemm(&s, 1, F2p, tile::EpiH1{h1, ldh, p.b1, 2 * F});
    }
    __syncthreads();

    for (int k = 0; k < 4; ++k) {
      {  // recompute z_k and its mask
        const tile::Seg s = {h1, ldh, p.w2f + (size_t)k * Fp * F2p, F2p};
        tile::gemm(&s, 1, Fp, tile::EpiZ{zs, ldx, p.b2 + k * F, xs, ldx, F, k, mask, Fp});
      }
      // dz3_k as bf16 halves; db3 from the f32 values
      const float* d3 = p.dz3 + (size_t)p0 * 4 * F3 + k * F3;
      for (int i = tid; i < kRows * F3p; i += kThreads) {
        const int r = i / F3p, c = i - r * F3p;
        const float v = (r < rows && c < F3) ? d3[(size_t)r * 4 * F3 + c] : 0.f;
        const bf16 hi = __float2bfloat16_rn(v);
        dhi[r * ldd + c] = hi;
        dlo[r * ldd + c] = __float2bfloat16_rn(v - tile::bf2f(hi));
      }
      for (int c = tid; c < F3; c += kThreads) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r) s += d3[(size_t)r * 4 * F3 + c];
        slab[L.b3 + c] += s;
      }
      __syncthreads();
      // dW3 += bf16(z_k)^T bf16(dz3_k)
      tile::outer_acc(zs, ldx, F, dhi, ldd, F3, slab + L.w3, F3);
      __syncthreads();  // zs is overwritten with bf16(dz_k) below
      {  // dz_k = dz3_k W3^T as three bf16 products
        const tile::Seg s[3] = {{dhi, ldd, p.w3hi, F3p}, {dhi, ldd, p.w3lo, F3p},
                                {dlo, ldd, p.w3hi, F3p}};
        tile::gemm(s, 3, Fp, EpiDz{dzp + k * Fp, ldp, zs, ldx, mask, Fp}, cs, ldcs);
      }
      __syncthreads();
      add_colsum(slab + L.b2 + (size_t)k * F, cs, ldcs, F);  // db2
      // the residual's cotangent: dxr[r, f] (+)= sum of bf16(dz_k)[r, c]
      // over the channels c whose residual reads f, in increasing c
      for (int i = tid; i < kRows * F; i += kThreads) {
        const int r = i / F, f = i - r * F;
        int src[4];
        const int n = residual_sources(k, f, F, src);
        float s = k == 0 ? 0.f : dxr[i];
        for (int j = 0; j < n; ++j) s += tile::bf2f(zs[r * ldx + src[j]]);
        dxr[i] = s;
      }
      __syncthreads();
    }

    // dW2g += h1^T bf16(dzp), phase by phase into the [2F, 4F] slab
    for (int k = 0; k < 4; ++k)
      tile::outer_acc(h1, ldh, 2 * F, dzp + k * Fp, ldp, F, slab + L.w2 + (size_t)k * F, 4 * F);
    __syncthreads();  // h1 is overwritten with bf16(dh1p) below
    {  // dh1 = bf16(dzp) bf16(W2g)^T over the four phases
      const tile::Seg s = {dzp, ldp, p.w2b, 4 * Fp};
      tile::gemm(&s, 1, F2p, EpiDh1{h1, ldh, 2 * F}, cs, ldcs);
    }
    __syncthreads();
    add_colsum(slab + L.b1, cs, ldcs, 2 * F);  // db1
    tile::outer_acc(xs, ldx, F, h1, ldh, 2 * F, slab + L.w1, 2 * F);  // dW1
    {  // dx = bf16(dh1p) bf16(W1)^T + the residual's cotangent
      const tile::Seg s = {h1, ldh, p.w1b, F2p};
      tile::gemm(&s, 1, Fp, EpiDx{p.dx, dxr, F, rows, p0, p.dx_bf16});
    }
    __syncthreads();  // the next tile overwrites every buffer
  }
}

// out[i] = sum over the G slabs, in CTA order, of element i
__global__ void sum_slabs(const float* __restrict__ slabs, int G, size_t len,
                          float* __restrict__ out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < G; ++c) s += slabs[(size_t)c * len + i];
    out[i] = s;
  }
}

size_t smem_bytes(int F, int F3) {
  const int Fp = tile::pad16(F), F2p = tile::pad16(2 * F), F3p = tile::pad16(F3);
  const int ldcs = F2p > Fp ? F2p : Fp;
  return (size_t)kRows *
             (2 * (Fp + kPad) + (F2p + kPad) + 2 * (F3p + kPad) + (4 * Fp + kPad)) *
             sizeof(bf16) +
         (size_t)(kRows * F + 2 * ldcs) * sizeof(float) + (size_t)kRows * Fp;
}

}  // namespace

extern "C" {

// The gradient buffer's layout, in floats: out[0..5] the offsets of dW1 [F,
// 2F], db1, dW2g [2F, 4F], db2g, dW3 [F, F3], db3 (each row-major), out[6]
// the length of one slab and of the buffer.
void fused_upsampler_bwd_layout(int F, int F3, long long* out) {
  const Layout L = layout(F, F3);
  const size_t v[7] = {L.w1, L.b1, L.w2, L.b2, L.w3, L.b3, L.total};
  for (int i = 0; i < 7; ++i) out[i] = (long long)v[i];
}

// Launch on `stream`: the stencil's adjoint from dy ([B, 2H, 2W, F3], bf16 if
// dy_bf16 else f32) into dz3 ([B*H*W, 4 F3] f32); zero the G slabs; G
// persistent CTAs over the 32-pixel tiles; the slabs summed into `grads`.
// dx is [B, H, W, F], bf16 if dx_bf16 else f32.  Returns the first
// cudaError_t (0 = success).  The caller (kernels/fused_upsampler.py) has
// checked the shapes, padded the weights and allocated dz3, the slabs
// ([G, slab length]) and grads.
int fused_upsampler_bwd(const void* x, const void* dy, const void* w1f, const float* b1,
                        const void* w2f, const float* b2, const void* w1b, const void* w2b,
                        const void* w3hi, const void* w3lo, float* dz3, void* dx, float* slabs,
                        float* grads, int B, int H, int W, int F, int F3, int G, int dy_bf16,
                        int dx_bf16, void* stream) {
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.dz3 = dz3;
  p.w1f = static_cast<const bf16*>(w1f);
  p.b1 = b1;
  p.w2f = static_cast<const bf16*>(w2f);
  p.b2 = b2;
  p.w1b = static_cast<const bf16*>(w1b);
  p.w2b = static_cast<const bf16*>(w2b);
  p.w3hi = static_cast<const bf16*>(w3hi);
  p.w3lo = static_cast<const bf16*>(w3lo);
  p.dx = dx;
  p.slabs = slabs;
  p.L = layout(F, F3);
  p.P = B * H * W;
  p.F = F;
  p.F3 = F3;
  p.Fp = tile::pad16(F);
  p.F2p = tile::pad16(2 * F);
  p.F3p = tile::pad16(F3);
  p.n_tiles = (p.P + kRows - 1) / kRows;
  p.dx_bf16 = dx_bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  int e = dy_bf16 ? stencil::launch_bwd<__nv_bfloat16, float>(dy, dz3, B, H, W, F3, st)
                  : stencil::launch_bwd<float, float>(dy, dz3, B, H, W, F3, st);
  if (e) return e;
  cudaError_t err = cudaMemsetAsync(slabs, 0, (size_t)G * p.L.total * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(F, F3);
  err = cudaFuncSetAttribute(block_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_bwd_kernel<<<G, kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t blocks = (p.L.total + 255) / 256;
  sum_slabs<<<(int)(blocks < 2048 ? blocks : 2048), 256, 0, st>>>(slabs, G, p.L.total, grads);
  return (int)cudaGetLastError();
}

}  // extern "C"
