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
// Design: two launches.
//  1. chain_fwd_kernel: persistent CTAs walk the tiles (64, 128 or 256
//     pixels, the caller's choice by width) through the chain body of
//     csrc/upsampler_chain.cuh (weights in a shared-memory ring fed by a
//     producer warp's tensor copies, wgmma products): x -> h1 ->
//     per phase z_k -> z3_k, with x, h1 and one phase of z in shared memory
//     as bf16.  z3 goes to an f32 scratch [B, H, W, 4 F3] in device memory.
//  2. the stencil (csrc/phase_stencil.cuh) from the scratch to the output.
// The TPU kernel keeps z3 on chip by recomputing a halo of rows; here the
// scratch's round trip is ~235 MB per B=2 renderer pass, under 0.1 ms of
// bytes (its stores cost ~0.07 ms, PERF.md), and the chain's recompute of
// the halo would cost more.  The stencil launch itself is the larger part
// (~0.28 ms a pass): its code is K5's, to be made faster with K5.

#include <algorithm>

#include "phase_stencil.cuh"
#include "upsampler_chain.cuh"

namespace {

using namespace uchain;

// The tensor maps, in the order of Params::m
enum { kW1t, kW2t, kW3t, kMaps };

struct Params {
  Maps m;           // W1^T [2F, Fp]; per phase W2g^T [4 Fp, F2p]; W3^T [F3, Fp]
  const bf16* x;    // [P, F] bf16
  const float* b1;  // [2F]
  const float* b2;  // [4F] group-major
  const float* b3;  // [F3]
  float* z3;        // [P, 4 F3]
  long long P;
  int F, F3, Fp, F2p, F3p, n_tiles;
  Geo geo;
};

// Byte offsets in the dynamic shared memory (from its first 1024-byte
// boundary): the x, h1 and z tiles, the ring, the epilogues' tables
// (epilogue_tables, and b3 zero-padded) and the ring's barriers.
struct Layout {
  size_t h1, z, ring, res, b1, b2, b3, bars, total;
};

__host__ __device__ inline Layout layout(const Geo& geo, int Fp, int F2p, int F3p) {
  Layout o;
  const size_t sub = geo.sub();
  o.h1 = Fp / kSliceK * sub;
  o.z = o.h1 + F2p / kSliceK * sub;
  o.ring = o.z + Fp / kSliceK * sub;
  o.b1 = o.ring + (size_t)geo.stages * geo.bstage;
  o.b2 = o.b1 + F2p * sizeof(float);
  o.b3 = o.b2 + 4 * Fp * sizeof(float);
  o.res = o.b3 + F3p * sizeof(float);
  o.bars = o.res + ((4 * Fp * sizeof(unsigned short) + 15) & ~(size_t)15);
  o.total = o.bars + 2 * geo.stages * sizeof(uint64_t);
  return o;
}

// The geometry for widths F, F3 and tiles of 64 nrg pixels: stages as wide
// as the widest pass, as many as fit (at least kMinStages)
inline Geo make_geo(int F, int F3, int nrg) {
  Geo g{nrg, 0, kMinStages};
  const int Fp = pad32(F), F2p = pad32(2 * F), F3p = pad32(F3);
  const int pw = std::max(g.pass_width(F2p), std::max(g.pass_width(Fp), g.pass_width(F3p)));
  g.bstage = pw * kSliceK * 2;
  const size_t base = layout(g, Fp, F2p, F3p).total + 1024;
  if (base < kSmemLimit)
    g.stages = std::min<size_t>(kMaxStages, kMinStages + (kSmemLimit - base) / (g.bstage + 16));
  return g;
}

__global__ void __launch_bounds__(kThreads, 1) chain_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int F = p.F, F3 = p.F3, Fp = p.Fp, F2p = p.F2p, F3p = p.F3p;
  const Geo geo = p.geo;
  const int rows = geo.rows();
  const Layout L = layout(geo, Fp, F2p, F3p);
  unsigned char *X = smem, *H1 = smem + L.h1, *Z = smem + L.z;
  unsigned short* res = reinterpret_cast<unsigned short*>(smem + L.res);
  float* b1s = reinterpret_cast<float*>(smem + L.b1);
  float* b2s = reinterpret_cast<float*>(smem + L.b2);
  float* b3s = reinterpret_cast<float*>(smem + L.b3);
  Ring ring = {smem_addr(smem + L.ring), smem_addr(smem + L.bars), geo.bstage, geo.bstage,
               geo.stages, 0};
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  epilogue_tables(res, b1s, b2s, p.b1, p.b2, F, Fp, F2p);
  for (int c = tid; c < F3p; c += blockDim.x) b3s[c] = c < F3 ? p.b3[c] : 0.f;
  __syncthreads();

  auto h1 = [&] { return Prod{F2p, 1, {{smem_addr(X), kW1t, 0, Fp / kSliceK}}}; };
  auto zk = [&](int k) { return Prod{Fp, 1, {{smem_addr(H1), kW2t, k * Fp, F2p / kSliceK}}}; };
  auto z3 = [&] { return Prod{F3p, 1, {{smem_addr(Z), kW3t, 0, Fp / kSliceK}}}; };

  if (tid / 32 == kWarps) {  // the producer: one thread streams the slices into the ring
    if (tid % 32 == 0)
      for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
        load_product(ring, geo, p.m, h1());
        for (int k = 0; k < 4; ++k) {
          load_product(ring, geo, p.m, zk(k));
          load_product(ring, geo, p.m, z3());
        }
      }
    return;  // its copies land before the consumers, which wait for them, finish
  }

  const Frag f(geo);
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    const long long p0 = (long long)t * rows;
    // X = bf16 x of the tile's rows below P, zero past them and past F (x's
    // rows are 2F bytes apart, no multiple of 16 for F = 258 or 129: no
    // tensor copy reads them)
    for (int i = tid; i < rows * Fp; i += kConsumers) {
      const int r = i / Fp, c = i - r * Fp;
      *reinterpret_cast<bf16*>(X + swz(geo.sub(), r, c)) =
          (p0 + r < p.P && c < F) ? p.x[(p0 + r) * F + c] : __float2bfloat16(0.f);
    }
    fence_proxy_async();  // X reaches the wgmma
    consumer_sync();
    run_product(ring, geo, h1(), [&](int, int col0, bool on, float(&acc)[kAcc]) {
      if (on) epi_h1(f, acc, col0, b1s, F2p, H1, nullptr);
    });
    fence_proxy_async();
    consumer_sync();
    for (int k = 0; k < 4; ++k) {
      // z_k = lrelu(h1 W2g_k + b2_k) + x P_k, rounded to bf16 into Z
      run_product(ring, geo, zk(k), [&](int, int col0, bool on, float(&acc)[kAcc]) {
        if (!on) return;
#pragma unroll
        for (int j = 0; j < kAcc / 4; ++j) {
          if (col0 + 8 * j >= Fp) continue;  // uniform across the warp
          const int c = col0 + 8 * j + f.c2;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t pos;
            const float2 z = z_pair(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], f.row0 + 8 * h,
                                    k * Fp + c, b2s, res, X, f.sub, pos);
            put2(Z, f.at(col0, j, h), z.x, z.y);
          }
        }
      });
      fence_proxy_async();
      consumer_sync();
      // z3_k = bf16(z_k) W3 + b3 for the tile's rows below P
      run_product(ring, geo, z3(), [&](int, int col0, bool on, float(&acc)[kAcc]) {
        if (!on) return;
        float* out = p.z3 + (size_t)p0 * 4 * F3 + (size_t)k * F3;
#pragma unroll
        for (int j = 0; j < kAcc / 4; ++j) {
          if (col0 + 8 * j >= F3) continue;  // uniform across the warp
          const int c = col0 + 8 * j + f.c2;
          const float2 b = *reinterpret_cast<const float2*>(b3s + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = f.row0 + 8 * h;
            float* o = out + (size_t)r * 4 * F3 + c;
            if (p0 + r >= p.P) continue;
            if (c < F3) o[0] = acc[4 * j + 2 * h] + b.x;
            if (c + 1 < F3) o[1] = acc[4 * j + 2 * h + 1] + b.y;
          }
        }
      });
      consumer_sync();  // the next phase rewrites Z, the next tile X and H1
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of the chain kernel for widths F, F3 and tiles of
// 64 nrg pixels (the caller takes the most rows that fit)
long long fused_upsampler_fwd_smem(int F, int F3, int nrg) {
  const Geo g = make_geo(F, F3, nrg);
  return (long long)(layout(g, pad32(F), pad32(2 * F), pad32(F3)).total + 1024);
}

// Launch on `stream`: the chain into the scratch z3 ([B*H*W, 4 F3] f32), in
// tiles of 64 nrg pixels, then the stencil into y ([B, 2H, 2W, F3], bf16 if
// y_bf16 else f32).  Returns the first cudaError_t (0 = success).  The
// caller (kernels/fused_upsampler.py) has checked the shapes and the shared
// memory and built x as bf16 [B*H*W, F] and the weights as zero-padded bf16
// [N, K] matrices, Fp = pad32(F), F2p = pad32(2F): w1t
// W1^T [2F, Fp], w2t [4 Fp, F2p] (rows k Fp + c: column k F + c of W2g, rows
// past F of a phase zero), w3t W3^T [F3, Fp].
int fused_upsampler_fwd(const void* x, const void* w1t, const float* b1, const void* w2t,
                        const float* b2, const void* w3t, const float* b3, float* z3, void* y,
                        int B, int H, int W, int F, int F3, int nrg, int y_bf16, void* stream) {
  Params p = {};
  p.x = static_cast<const bf16*>(x);
  p.b1 = b1;
  p.b2 = b2;
  p.b3 = b3;
  p.z3 = z3;
  p.P = (long long)B * H * W;
  p.F = F;
  p.F3 = F3;
  p.Fp = pad32(F);
  p.F2p = pad32(2 * F);
  p.F3p = pad32(F3);
  p.geo = make_geo(F, F3, nrg);
  p.n_tiles = (int)((p.P + p.geo.rows() - 1) / p.geo.rows());
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_64B;
  p.m.box_rows[kW1t] = p.geo.pass_width(p.F2p);
  p.m.box_rows[kW2t] = p.geo.pass_width(p.Fp);
  p.m.box_rows[kW3t] = p.geo.pass_width(p.F3p);
  if (!tile::bf16_map(&p.m.map[kW1t], w1t, 2 * F, p.Fp, p.Fp, p.m.box_rows[kW1t], kSliceK, sw) ||
      !tile::bf16_map(&p.m.map[kW2t], w2t, 4 * p.Fp, p.F2p, p.F2p, p.m.box_rows[kW2t], kSliceK,
                      sw) ||
      !tile::bf16_map(&p.m.map[kW3t], w3t, F3, p.Fp, p.Fp, p.m.box_rows[kW3t], kSliceK, sw))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = layout(p.geo, p.Fp, p.F2p, p.F3p).total + 1024;
  cudaError_t err = cudaFuncSetAttribute(chain_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  chain_fwd_kernel<<<p.n_tiles < sms ? p.n_tiles : sms, kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return y_bf16 ? stencil::launch_fwd<float, __nv_bfloat16>(z3, y, B, H, W, F3, st)
                : stencil::launch_fwd<float, float>(z3, y, B, H, W, F3, st);
}

}  // extern "C"
