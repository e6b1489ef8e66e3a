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
// bf16(dh1p)), the bias gradients f32 sums of the unrounded values.
//  * the f32 product on bf16 tensor cores: each f32 operand u is split into
//    u_hi = bf16(u) and u_lo = bf16(u - u_hi), and dz3 W3^T is the sum of
//    the three products hi.hi + hi.lo + lo.hi, one segment after the other
//    (relative error ~2^-16, against bf16's 2^-8).
//  * the lrelu masks: zp > 0 is kept as a bit per element; h1p > 0 is read
//    as bf16(lrelu(h1p)) > 0, the same test.
// The data products run in the k order of the earlier kernel, so dx keeps
// its bits; the weight and bias gradients are the same sums in another
// order.
//
// Bound.  Per pixel the backward repeats the forward's chain up to z (2F^2 +
// 8F^2 multiply-adds), then dz (4 F F3, three times for the split), dh1
// (8F^2), dx (2F^2) and the weight gradients (as many as the forward):
// ~4x the forward's operations, ~26 G multiply-adds per block at B=2, 53
// us at 989 TFLOP/s, against 10-80 MB of bytes that must move (x, dy and dx,
// the weights and their gradients).
//
// Design.  The pixels go in chunks of whole tiles (the caller's plan,
// kernels/fused_upsampler.py); per chunk:
//  * dz3_kernel: dz3 = the stencil's adjoint of dy (csrc/phase_stencil.cuh,
//    element by element), its bf16 halves into the chunk, its column sums
//    (db3) per tile;
//  * block_bwd_kernel: persistent CTAs walk the chunk's tiles through the
//    chain body of csrc/upsampler_chain.cuh (weights in a shared-memory ring
//    fed by a producer warp's tensor copies, wgmma products).  Per tile:
//    recompute h1; per phase recompute z_k and its mask, then dz_k (its A,
//    the dz3 halves, by tensor copies from the chunk) and dzp_k; then dh1
//    over the four phases (its A, dzp, read back from the chunk the same
//    way: it would not fit in shared memory beside the rest) and dx, with
//    the residual's cotangent gathered from bf16(dz) into shared memory that
//    x held (reading it in dx's epilogue instead took a third of the kernel
//    at the last block).  The operands of the weight gradients go to the
//    chunk point-major in bf16 (h1, z and bf16(dz3) as [4 P, width] phase
//    rows, dzp, dh1p; dW1's x is the caller's zero-padded copy, which the
//    tile also takes by tensor copies), the bias gradients' column sums to
//    a small buffer per tile;
//  * upsampler_dw_kernel: dW1 and dW2g (+)= X^T D over the chunk's pixels,
//    then dW3 over its 4 P phase rows: the wgmma GEMM of csrc/field_dw.cuh,
//    which the fused field backwards launch under their own names.
// After the last chunk upsampler_sum_kernel sums the per-tile bias buffers
// in tile order.  No atomics: the same bits on every run.
//
// Tiles and occupancy: 64 pixels at the first block (F = 258: 8,192 pixels
// at B=2 make 128 tiles for 132 SMs), 128 at the narrower ones (the
// caller's choice: the most rows whose wave of tiles keeps a chunk small,
// csrc/upsampler_chain.cuh); the shared memory (x, h1, a ring of three to
// eight stages, ~220 KB) allows one CTA per SM.

#include <algorithm>

#include "field_dw.cuh"
#include "phase_stencil.cuh"
#include "upsampler_chain.cuh"

namespace {

using namespace uchain;

constexpr int kMaxZPasses = 2;  // passes of a phase of z that the masks hold

// The tensor maps, in the order of Params::m: the recompute's weights, the
// data gradients' weights, the chunk's dzp as dh1's A, x, the chunk's dz3
// halves as dz's A
enum { kW1t, kW2t, kW3hi, kW3lo, kW2, kW1, kDzp, kX, kD3hi, kD3lo, kMaps };

// The chunk buffer's operands of the weight gradients (rows of the chunk's
// pixels, point-major, bf16) and the residual's bf16(dz); dW1's x is the
// caller's padded x
struct Chunk {
  bf16* h1;    // [Pc, F2p]     h1
  bf16* z;     // [Pc, 4, Fp]   bf16(z_k): [4 Pc, Fp] phase rows
  bf16* d3hi;  // [Pc, 4, F3p]  bf16(dz3_k)
  bf16* d3lo;  // [Pc, 4, F3p]  bf16(dz3_k - bf16(dz3_k))
  bf16* dzp;   // [Pc, 4 Fp]    bf16(dzp), phase-padded columns
  bf16* dzb;   // [Pc, 4 Fp]    bf16(dz)
  bf16* dh1;   // [Pc, F2p]     bf16(dh1p)
};

struct Params {
  Maps m;  // W1^T [2F, Fp], W2g^T [4 Fp, F2p], W3 hi and lo [F, F3p], W2g [2F,
           // 4 Fp], W1 [F, F2p], dzp [Pc, 4 Fp], x [tiles * rows, Fp], the dz3
           // halves [Pc, 4, F3p]
  const void* dy;    // [B, 2H, 2W, F3], bf16 if dy_bf16 else f32
  void* dx;          // [P, F], bf16 if dx_bf16 else f32
  const float* b1;   // [2F]
  const float* b2;   // [4F]
  Chunk c;
  float* small;      // [tiles, 6F + F3]: per tile db1, db2g, db3
  long long P;
  int H, W, F, F3, Fp, F2p, F3p;
  int t0, nt;        // the chunk's first tile and its tiles
  int dy_bf16, dx_bf16;
  Geo geo;
};

// Byte offsets in the dynamic shared memory (from its first 1024-byte
// boundary): the x tile, which the residual's f32 cotangent [rows, F] takes
// over once it is dead; the h1 tile (later dh1p); the ring; the z masks, the
// column sums, the epilogues' tables (epilogue_tables) and the barriers (the
// ring's, then dzp's ready, x's full and empty).
struct Layout {
  size_t h1, ring, mask, cs, b1, b2, res, bars, total;
};

__host__ __device__ inline Layout layout(const Geo& geo, int F, int Fp, int F2p) {
  Layout o;
  const size_t sub = geo.sub();
  const size_t x = Fp / kSliceK * sub, dxr = (size_t)geo.rows() * F * sizeof(float);
  o.h1 = ((x > dxr ? x : dxr) + 1023) & ~(size_t)1023;
  o.ring = o.h1 + F2p / kSliceK * sub;
  o.mask = o.ring + (size_t)geo.stages * (geo.bstage + geo.sub());
  o.cs = o.mask + (size_t)kMaxZPasses * kConsumers * sizeof(uint32_t);
  o.b1 = o.cs + (size_t)4 * geo.nrg * F2p * sizeof(float);
  o.b2 = o.b1 + F2p * sizeof(float);
  o.res = o.b2 + 4 * Fp * sizeof(float);
  o.bars = o.res + ((4 * Fp * sizeof(unsigned short) + 15) & ~(size_t)15);
  o.total = o.bars + (2 * geo.stages + 3) * sizeof(uint64_t);
  return o;
}

// The geometry for widths F and tiles of 64 nrg pixels: stages as wide as
// the widest pass, as many as fit (at least kMinStages)
inline Geo make_geo(int F, int nrg) {
  Geo g{nrg, 0, kMinStages};
  const int Fp = pad32(F), F2p = pad32(2 * F);
  g.bstage = std::max(g.pass_width(F2p), g.pass_width(Fp)) * kSliceK * 2;
  const size_t base = layout(g, F, Fp, F2p).total + 1024;
  if (base < kSmemLimit)
    g.stages = std::min<size_t>(kMaxStages,
                                kMinStages + (kSmemLimit - base) / (g.bstage + g.sub() + 16));
  return g;
}

// dz3 = the stencil's adjoint of dy (csrc/phase_stencil.cuh, element by
// element) for the chunk's tiles, block lt tile t0 + lt: thread (c, g) takes
// column c of rows g, g + ng, ..., all four phases of each, writes the bf16
// halves to the chunk and sums the f32 values; the tile's db3 is the sum of
// the row groups' sums, in order.
__global__ void __launch_bounds__(kConsumers) dz3_kernel(const __grid_constant__ Params p) {
  __shared__ float part[kConsumers];
  const int F3 = p.F3, F3p = p.F3p, rows = p.geo.rows(), H = p.H, W = p.W;
  const int ng = kConsumers / F3p, c = threadIdx.x % F3p, g = threadIdx.x / F3p;
  const int p0 = (p.t0 + blockIdx.x) * rows, P = (int)p.P;  // P < 2^31 (the caller checks)
  const int lp0 = blockIdx.x * rows;  // chunk offsets fit in 32 bits
  if (g < ng) {
    float s = 0.f;
    for (int r = g; r < rows; r += ng) {
      const int px = p0 + r, b = px / (H * W), hw = px - b * H * W, h = hw / W, w = hw - h * W;
      const bool on = px < P && c < F3;
      bf16* hi = p.c.d3hi + (lp0 + r) * 4 * F3p + c;
      bf16* lo = p.c.d3lo + (lp0 + r) * 4 * F3p + c;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v = 0.f;
        if (on && p.dy_bf16)
          v = stencil::adjoint_at(static_cast<const bf16*>(p.dy), b, h, w, k, c, H, W, F3);
        else if (on)
          v = stencil::adjoint_at(static_cast<const float*>(p.dy), b, h, w, k, c, H, W, F3);
        const bf16 vh = __float2bfloat16_rn(v);
        hi[k * F3p] = vh;
        lo[k * F3p] = __float2bfloat16_rn(v - bf2f(vh));
        s += v;
      }
    }
    part[threadIdx.x] = s;
  }
  __syncthreads();
  float* db3 = p.small + (size_t)(p.t0 + blockIdx.x) * (6 * p.F + F3) + 6 * p.F;
  for (int cc = threadIdx.x; cc < F3; cc += blockDim.x) {
    float s = 0.f;
    for (int gg = 0; gg < ng; ++gg) s += part[gg * F3p + cc];
    db3[cc] = s;
  }
}

// The residual's cotangent of x channel f in one pixel: the sum of bf16(dz)
// (dzb, [4, Fp] of the pixel) over the channels c of each phase k whose
// residual reads f, 4c + k = f (mod F), phase by phase, in increasing c.
// With d = gcd(4, F) a phase has d such channels or none: c0 + i F / d.
template <int d>
__device__ __forceinline__ float residual(const bf16* dzb, int f, int F, int Fp) {
  const int Fq = F / d;
  const int inv2 = (Fq + 1) / 2;  // the inverse of 2 mod Fq; Fq is odd whenever d < 4
  const int inv = d == 4 ? 1 : (d == 2 ? inv2 : (inv2 * inv2) % Fq);  // of 4 / d mod Fq
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // branch-free: a phase without sources adds zeros
    const int e = ((f - k) % F + F) % F;
    const bool has = e % d == 0;
    const int c0 = (e / d * inv) % Fq;
#pragma unroll
    for (int i = 0; i < d; ++i) s += has ? bf2f(dzb[k * Fp + c0 + i * Fq]) : 0.f;
  }
  return s;
}

// The column sums of a pass's values v (the warpgroup's 64 columns from
// col0, below n): each warp's 16 rows summed, into cs[row group * 4 + warp
// of the warpgroup][c]
__device__ __forceinline__ void colsum(const Geo& geo, const float (&v)[kAcc], int col0, int n,
                                       float* cs, int ldcs) {
  const int lane = threadIdx.x & 31;
  const int w = (threadIdx.x >> 7) / geo.ncg() * 4 + ((threadIdx.x >> 5) & 3);
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    float s0 = v[4 * j] + v[4 * j + 2], s1 = v[4 * j + 1] + v[4 * j + 3];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    const int c = col0 + 8 * j + 2 * (lane & 3);
    if (lane < 4 && c < n) {
      cs[w * ldcs + c] = s0;
      cs[w * ldcs + c + 1] = s1;
    }
  }
}

// out[c] = the warps' column sums of c, row group by row group, in order,
// for c < n
__device__ __forceinline__ void sum_cols(const Geo& geo, const float* cs, int ldcs, int n,
                                         float* out) {
  for (int c = threadIdx.x; c < n; c += kConsumers) {
    float s = 0.f;
    for (int w = 0; w < 4 * geo.nrg; ++w) s += cs[w * ldcs + c];
    out[c] = s;
  }
}

__global__ void __launch_bounds__(kThreads, 1) block_bwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int F = p.F, F3 = p.F3, Fp = p.Fp, F2p = p.F2p, F3p = p.F3p;
  const Geo geo = p.geo;
  const int rows = geo.rows(), sub = geo.sub();
  const Layout L = layout(geo, F, Fp, F2p);
  unsigned char *X = smem, *H1 = smem + L.h1;
  float* dxr = reinterpret_cast<float*>(smem);                   // [rows, F], over X
  uint32_t* maskw = reinterpret_cast<uint32_t*>(smem + L.mask);  // [kMaxZPasses, kConsumers]
  float* cs = reinterpret_cast<float*>(smem + L.cs);             // [4 nrg, F2p]
  unsigned short* res = reinterpret_cast<unsigned short*>(smem + L.res);
  float* b1s = reinterpret_cast<float*>(smem + L.b1);
  float* b2s = reinterpret_cast<float*>(smem + L.b2);
  Ring ring = {smem_addr(smem + L.ring), smem_addr(smem + L.bars), geo.bstage + sub, geo.bstage,
               geo.stages, 0};
  const uint32_t ready = ring.bars + 16 * geo.stages;  // the tile's dzp is written
  const uint32_t xfull = ready + 8, xempty = ready + 16;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), kWarps);
    }
    mbar_init(ready, 1);
    mbar_init(xfull, 1);
    mbar_init(xempty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  epilogue_tables(res, b1s, b2s, p.b1, p.b2, F, Fp, F2p);
  __syncthreads();

  const int ks1 = Fp / kSliceK, ks2 = F2p / kSliceK, ks3 = F3p / kSliceK;
  auto h1 = [&] { return Prod{F2p, 1, {{smem_addr(X), kW1t, 0, ks1}}}; };
  auto zk = [&](int k) { return Prod{Fp, 1, {{smem_addr(H1), kW2t, k * Fp, ks2}}}; };
  auto dz = [&](int k, int lt) {  // A: phase k of the tile's dz3 halves, from the chunk
    return Prod{Fp, 3, {{0, kW3hi, 0, ks3, kD3hi, lt * rows, k},
                        {0, kW3lo, 0, ks3, kD3hi, lt * rows, k},
                        {0, kW3hi, 0, ks3, kD3lo, lt * rows, k}}};
  };
  auto dh1 = [&](int lt) { return Prod{F2p, 1, {{0, kW2, 0, 4 * ks1, kDzp, lt * rows}}}; };
  auto dx = [&] { return Prod{Fp, 1, {{smem_addr(H1), kW1, 0, ks2}}}; };

  if (tid / 32 == kWarps) {  // the producer: one thread streams the slices into the ring
    if (tid % 32 == 0) {
      int it = 0;
      for (int lt = blockIdx.x; lt < p.nt; lt += gridDim.x, ++it) {
        if (it > 0) mbar_wait(xempty, (it - 1) & 1);  // the previous tile is done with X
        load_x(geo, &p.m.map[kX], smem_addr(X), Fp, (long long)(p.t0 + lt) * rows, xfull);
        load_product(ring, geo, p.m, h1());
        for (int k = 0; k < 4; ++k) {
          load_product(ring, geo, p.m, zk(k));
          load_product(ring, geo, p.m, dz(k, lt));
        }
        mbar_wait(ready, it & 1);  // dh1's A: the tile's dzp rows
        load_product(ring, geo, p.m, dh1(lt));
        load_product(ring, geo, p.m, dx());
      }
    }
    return;  // its copies land before the consumers, which wait for them, finish
  }

  const Frag f(geo);
  const size_t Ls = 6 * (size_t)F + F3;  // a tile's row of the small buffer
  const int d = F % 4 == 0 ? 4 : (F % 2 == 0 ? 2 : 1);  // the residual's sources per phase
  for (int lt = blockIdx.x, it = 0; lt < p.nt; lt += gridDim.x, ++it) {
    const long long p0 = (long long)(p.t0 + lt) * rows;  // first pixel of the tile
    const int lp0 = lt * rows;  // and its row in the chunk (chunk offsets fit in 32 bits)
    float* small = p.small + (size_t)(p.t0 + lt) * Ls;
    mbar_wait(xfull, it & 1);
    run_product(ring, geo, h1(), [&](int, int col0, bool on, float(&acc)[kAcc]) {
      if (on) epi_h1(f, acc, col0, b1s, F2p, H1, p.c.h1 + lp0 * F2p);
    });
    fence_proxy_async();
    consumer_sync();

    for (int k = 0; k < 4; ++k) {
      // z_k: bf16(z_k) into the chunk's phase rows, the mask bits kept
      run_product(ring, geo, zk(k), [&](int ps, int col0, bool on, float(&acc)[kAcc]) {
        if (!on) return;
        uint32_t mask = 0;
#pragma unroll
        for (int j = 0; j < kAcc / 4; ++j) {
          if (col0 + 8 * j >= Fp) continue;  // uniform across the warp
          const int c = col0 + 8 * j + f.c2;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = f.row0 + 8 * h;
            uint32_t pos;
            const float2 z = z_pair(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], r, k * Fp + c,
                                    b2s, res, X, sub, pos);
            mask |= pos << (4 * j + 2 * h);
            *reinterpret_cast<__nv_bfloat162*>(p.c.z + ((lp0 + r) * 4 + k) * Fp + c) =
                __floats2bfloat162_rn(z.x, z.y);
          }
        }
        maskw[ps * kConsumers + tid] = mask;
      });
      // dz_k = dz3_k W3^T (hi.hi + hi.lo + lo.hi): bf16(dz) for the
      // residual, dzp = lrelu'(zp) dz into the chunk, db2g's column sums
      run_product(ring, geo, dz(k, lt), [&](int ps, int col0, bool on, float(&acc)[kAcc]) {
        if (!on) return;
        // past F the weights' rows are zero, so dz and dzp are zero
        const uint32_t mask = maskw[ps * kConsumers + tid];
#pragma unroll
        for (int j = 0; j < kAcc / 4; ++j) {
          const int c = col0 + 8 * j + f.c2;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = f.row0 + 8 * h, q = 4 * j + 2 * h;
            const float d0 = acc[q], d1 = acc[q + 1];
            acc[q] = (mask >> q) & 1 ? d0 : 0.2f * d0;
            acc[q + 1] = (mask >> (q + 1)) & 1 ? d1 : 0.2f * d1;
            if (col0 + 8 * j < Fp) {  // uniform across the warp
              const int o = (lp0 + r) * 4 * Fp + k * Fp + c;
              *reinterpret_cast<__nv_bfloat162*>(p.c.dzb + o) = __floats2bfloat162_rn(d0, d1);
              *reinterpret_cast<__nv_bfloat162*>(p.c.dzp + o) =
                  __floats2bfloat162_rn(acc[q], acc[q + 1]);
            }
          }
        }
        colsum(geo, acc, col0, F, cs, F2p);
      });
      consumer_sync();  // the column sums are in
      sum_cols(geo, cs, F2p, F, small + 2 * F + k * F);
    }

    // the tile's dzp is in the chunk buffer: make it visible to the tensor
    // copies of dh1's A, then let the producer start them
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    consumer_sync();
    if (tid == 0) mbar_arrive(ready, true);
    // the residual's cotangent dxr[r, f] over X, which is dead: for x
    // channel f, the bf16(dz) of the channels whose residual reads it, phase
    // by phase, in increasing channel order
    for (int i = tid; i < rows * F; i += kConsumers) {
      const int r = i / F, c = i - r * F;
      const bf16* dzb = p.c.dzb + (lp0 + r) * 4 * Fp;
      dxr[i] = d == 4 ? residual<4>(dzb, c, F, Fp)
                      : (d == 2 ? residual<2>(dzb, c, F, Fp) : residual<1>(dzb, c, F, Fp));
    }
    // dh1 = bf16(dzp) bf16(W2g)^T; dh1p = lrelu'(h1p) dh1 into H1 (in place,
    // as bf16) and the chunk; db1's column sums
    run_product(ring, geo, dh1(lt), [&](int, int col0, bool on, float(&acc)[kAcc]) {
      if (!on) return;
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j) {
        const int c = col0 + 8 * j + f.c2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = f.row0 + 8 * h, q = 4 * j + 2 * h;
          if (col0 + 8 * j >= F2p) {  // uniform across the warp
            acc[q] = acc[q + 1] = 0.f;
            continue;
          }
          // past 2F the weights' rows and h1 are zero, so dh1p is zero
          const int o = f.at(col0, j, h);
          const float2 hv = get2(H1, o);
          acc[q] = hv.x > 0.f ? acc[q] : 0.2f * acc[q];
          acc[q + 1] = hv.y > 0.f ? acc[q + 1] : 0.2f * acc[q + 1];
          put2(H1, o, acc[q], acc[q + 1]);
          *reinterpret_cast<__nv_bfloat162*>(p.c.dh1 + (lp0 + r) * F2p + c) =
              __floats2bfloat162_rn(acc[q], acc[q + 1]);
        }
      }
      colsum(geo, acc, col0, 2 * F, cs, F2p);
    });
    fence_proxy_async();
    consumer_sync();  // dh1p and dxr are in
    sum_cols(geo, cs, F2p, 2 * F, small);
    // dx = bf16(dh1p) bf16(W1)^T + dxr
    run_product(ring, geo, dx(), [&](int, int col0, bool on, float(&acc)[kAcc]) {
      if (!on) return;
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = col0 + 8 * j + f.c2 + i;
          if (c >= F) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = f.row0 + 8 * h;
            if (p0 + r >= p.P) continue;
            const float v = acc[4 * j + 2 * h + i] + dxr[r * F + c];
            const int o = ((int)p0 + r) * F + c;  // P F < 2^31 (the caller checks)
            if (p.dx_bf16)
              static_cast<bf16*>(p.dx)[o] = __float2bfloat16_rn(v);
            else
              static_cast<float*>(p.dx)[o] = v;
          }
        }
      }
    });
    fence_proxy_async();  // the reads of dxr before the tensor copies of the next X
    consumer_sync();      // the next tile rewrites X (dxr), H1 and the column sums
    if (tid == 0) mbar_arrive(xempty, true);
  }
}

__global__ void __launch_bounds__(fdw::kThreads)
    upsampler_dw_kernel(const __grid_constant__ fdw::Jobs js) {
  extern __shared__ __align__(16) unsigned char smem[];
  fdw::dw_tile(js, smem);
}

__global__ void __launch_bounds__(256)
    upsampler_dwsum_kernel(const __grid_constant__ fdw::Jobs js) {
  fdw::dw_reduce(js);
}

__global__ void upsampler_sum_kernel(const float* small, int G, size_t len, float* out) {
  fdw::sum_small(small, G, len, out);
}

inline size_t align256(size_t o) { return (o + 255) & ~(size_t)255; }

// Offsets (in floats) of the gradients in the output buffer: the padded
// weight blocks the GEMM writes, then the bias sums (a tile's row of the
// small buffer).
struct Grads {
  size_t w1, w2, w3, b, total;
};

inline Grads grad_layout(int F, int F3) {
  const size_t Fp = pad32(F), F2p = pad32(2 * F), F3p = pad32(F3);
  Grads g;
  g.w1 = 0;
  g.w2 = g.w1 + Fp * F2p;
  g.w3 = g.w2 + F2p * 4 * Fp;
  g.b = g.w3 + Fp * F3p;
  g.total = g.b + 6 * (size_t)F + F3;
  return g;
}

// The GEMM's two job lists for a chunk of P pixels (P a multiple of 64):
// dW1 and dW2g over its pixels, dW3 over its 4 P phase rows; numbered for
// `sms` SMs with as many point ranges per output tile as keep the partial
// sums within kPartBytes (at least fdw::kMaxSplits, at most kMaxDwSplits:
// dW3's one or two output tiles over a chunk's rows need hundreds)
constexpr int kMaxDwSplits = 256;
constexpr size_t kPartBytes = 8 << 20;

// The most point ranges a job list of `len` output floats may split into
inline int split_cap(size_t len) {
  const size_t fit = kPartBytes / (len * sizeof(float));
  return (int)std::min<size_t>(kMaxDwSplits, std::max<size_t>(fdw::kMaxSplits, fit));
}

inline void weight_jobs(fdw::Jobs (&js)[2], const bf16* x, const Chunk& c, float* grads, int F,
                        int F3, int P, int first, int sms, float* part) {
  const int Fp = pad32(F), F2p = pad32(2 * F), F3p = pad32(F3);
  const Grads g = grad_layout(F, F3);
  js[0] = {};
  js[0].job[0] = {x, c.dh1, grads + g.w1, Fp, F2p};
  js[0].job[1] = {c.h1, c.dzp, grads + g.w2, F2p, 4 * Fp};
  js[0].n_jobs = 2;
  js[0].P = P;
  js[1] = {};
  js[1].job[0] = {c.z, c.d3hi, grads + g.w3, Fp, F3p};
  js[1].n_jobs = 1;
  js[1].P = 4 * P;
  for (fdw::Jobs& j : js) {
    size_t len = 0;
    for (int i = 0; i < j.n_jobs; ++i) len += (size_t)j.job[i].M * j.job[i].N;
    j.accumulate = !first;
    fdw::number_tiles(j, sms, part, split_cap(len));
  }
}

// Byte offsets of the scratch: the small per-tile buffers, the chunk buffer
// for chunks of up to chunk_tiles tiles, the GEMM's partial sums.
struct Scratch {
  size_t h1, z, d3hi, d3lo, dzp, dzb, dh1, part, total;
};

inline Scratch scratch_layout(long long n_tiles, int F, int F3, int rows, int chunk_tiles,
                              int sms) {
  const size_t Fp = pad32(F), F2p = pad32(2 * F), F3p = pad32(F3);
  const size_t Pc = (size_t)chunk_tiles * rows;
  Scratch s;
  size_t o = align256((size_t)n_tiles * (6 * F + F3) * sizeof(float));
  s.h1 = o;  o = align256(o + Pc * F2p * 2);
  s.z = o;   o = align256(o + Pc * 4 * Fp * 2);
  s.d3hi = o; o = align256(o + Pc * 4 * F3p * 2);
  s.d3lo = o; o = align256(o + Pc * 4 * F3p * 2);
  s.dzp = o; o = align256(o + Pc * 4 * Fp * 2);
  s.dzb = o; o = align256(o + Pc * 4 * Fp * 2);
  s.dh1 = o; o = align256(o + Pc * F2p * 2);
  s.part = o;
  // the partial sums of as many point ranges as a job list may split into:
  // a chunk shorter than a full one (a plan's last) can have more ranges
  // than the full one, each shorter
  fdw::Jobs js[2];
  weight_jobs(js, nullptr, Chunk{}, nullptr, F, F3, (int)Pc, 1, sms, nullptr);
  size_t part = 0;
  for (const fdw::Jobs& j : js)
    part = std::max(part, (size_t)split_cap(j.part_len) * j.part_len);
  s.total = align256(o + part * sizeof(float));
  return s;
}

// dW (+)= X^T D for the jobs, then the partials' sum
int dw_launch(const fdw::Jobs& js, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(upsampler_dw_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)fdw::kSmem);
  if (err != cudaSuccess) return (int)err;
  upsampler_dw_kernel<<<js.tiles * js.splits, fdw::kThreads, fdw::kSmem, st>>>(js);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  upsampler_dwsum_kernel<<<fdw::blocks256(js.part_len), 256, 0, st>>>(js);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of the tile kernel for widths F, F3 and tiles of 64
// nrg pixels (the caller takes the most rows that fit); 2^40 where the
// tile cannot take the widths (more passes of a phase of z than its masks
// hold, or F3 past 512)
long long fused_upsampler_bwd_smem(int F, int F3, int nrg) {
  const Geo geo = make_geo(F, nrg);
  if (geo.passes(pad32(F)) > kMaxZPasses || pad32(F3) > kConsumers) return 1LL << 40;
  return (long long)(layout(geo, F, pad32(F), pad32(2 * F)).total + 1024);
}

// The buffers' layout: out[0..3] the offsets (in floats) of dW1 [Fp, F2p],
// dW2g [F2p, 4 Fp] (phase-padded columns), dW3 [Fp, F3p] (the real block of
// each at its top left) and the bias sums db1 [2F], db2g [4F], db3 [F3] in
// `grads`; out[4] the length of `grads`; out[5] the bytes of scratch for
// B*H*W pixels in tiles of 64 nrg pixels, chunks of up to chunk_tiles tiles,
// on a card of `sms` SMs.  Fp = pad32(F), F2p = pad32(2F), F3p = pad32(F3).
void fused_upsampler_bwd_layout(int B, int H, int W, int F, int F3, int nrg, int chunk_tiles,
                                int sms, long long* out) {
  const Grads g = grad_layout(F, F3);
  const int rows = Geo{nrg}.rows();
  const long long n_tiles = ((long long)B * H * W + rows - 1) / rows;
  out[0] = (long long)g.w1;
  out[1] = (long long)g.w2;
  out[2] = (long long)g.w3;
  out[3] = (long long)g.b;
  out[4] = (long long)g.total;
  out[5] = (long long)scratch_layout(n_tiles, F, F3, rows, chunk_tiles, sms).total;
}

// Launch one chunk on `stream`: tiles [t0, t0 + nt) of 64 nrg pixels (first:
// the first chunk, whose weight gradients are stored rather than added;
// last: the last, which sums the per-tile bias buffers into `grads`).  dy is
// [B, 2H, 2W, F3] (bf16 if dy_bf16 else f32), dx [B, H, W, F] (bf16 if
// dx_bf16 else f32).  Returns the first cudaError_t (0 = success).  The
// caller (kernels/fused_upsampler.py) has checked the shapes (Fp <= 512, F3p
// <= 512, the shared memory within the card's), built x as bf16 [tiles *
// rows, Fp] (zero past B*H*W rows and F columns) and the weights as
// zero-padded bf16 [N, K] matrices (w1t W1^T [2F, Fp], w2t [4 Fp, F2p] with
// rows k Fp + c column k F + c of W2g, w3hi and w3lo [F, F3p], w2 W2g [2F,
// 4 Fp] with phase-padded columns, w1 W1 [F, F2p]) and allocated `scratch`
// (the layout's bytes) and `grads`.
int fused_upsampler_bwd(const void* x, const void* dy, const void* w1t, const float* b1,
                        const void* w2t, const float* b2, const void* w3hi, const void* w3lo,
                        const void* w2, const void* w1, void* dx, void* scratch, float* grads,
                        int B, int H, int W, int F, int F3, int nrg, int chunk_tiles, int t0,
                        int nt, int first, int last, int dy_bf16, int dx_bf16, void* stream) {
  Params p = {};
  p.dy = dy;
  p.dx = dx;
  p.b1 = b1;
  p.b2 = b2;
  p.P = (long long)B * H * W;
  p.H = H;
  p.W = W;
  p.F = F;
  p.F3 = F3;
  p.Fp = pad32(F);
  p.F2p = pad32(2 * F);
  p.F3p = pad32(F3);
  p.t0 = t0;
  p.nt = nt;
  p.dy_bf16 = dy_bf16;
  p.dx_bf16 = dx_bf16;
  p.geo = make_geo(F, nrg);
  const int rows = p.geo.rows();
  cudaError_t err;
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long n_tiles = (p.P + rows - 1) / rows;
  const Scratch S = scratch_layout(n_tiles, F, F3, rows, chunk_tiles, sms);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  p.small = reinterpret_cast<float*>(base);
  p.c = {reinterpret_cast<bf16*>(base + S.h1),   reinterpret_cast<bf16*>(base + S.z),
         reinterpret_cast<bf16*>(base + S.d3hi), reinterpret_cast<bf16*>(base + S.d3lo),
         reinterpret_cast<bf16*>(base + S.dzp),  reinterpret_cast<bf16*>(base + S.dzb),
         reinterpret_cast<bf16*>(base + S.dh1)};

  const int Fp = p.Fp, F2p = p.F2p, F3p = p.F3p;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_64B;
  Maps& m = p.m;
  m.box_rows[kW1t] = p.geo.pass_width(F2p);  // each at most bstage / 64
  m.box_rows[kW2t] = p.geo.pass_width(Fp);
  m.box_rows[kW3hi] = m.box_rows[kW3lo] = p.geo.pass_width(Fp);
  m.box_rows[kW2] = p.geo.pass_width(F2p);
  m.box_rows[kW1] = p.geo.pass_width(Fp);
  m.box_rows[kDzp] = rows;
  const size_t Pc = (size_t)chunk_tiles * rows;
  if (!tile::bf16_map(&m.map[kW1t], w1t, 2 * F, Fp, Fp, m.box_rows[kW1t], kSliceK, sw) ||
      !tile::bf16_map(&m.map[kW2t], w2t, 4 * Fp, F2p, F2p, m.box_rows[kW2t], kSliceK, sw) ||
      !tile::bf16_map(&m.map[kW3hi], w3hi, F, F3p, F3p, m.box_rows[kW3hi], kSliceK, sw) ||
      !tile::bf16_map(&m.map[kW3lo], w3lo, F, F3p, F3p, m.box_rows[kW3lo], kSliceK, sw) ||
      !tile::bf16_map(&m.map[kW2], w2, 2 * F, 4 * Fp, 4 * Fp, m.box_rows[kW2], kSliceK, sw) ||
      !tile::bf16_map(&m.map[kW1], w1, F, F2p, F2p, m.box_rows[kW1], kSliceK, sw) ||
      !tile::bf16_map(&m.map[kDzp], p.c.dzp, Pc, 4 * Fp, 4 * Fp, rows, kSliceK, sw) ||
      !tile::bf16_map(&m.map[kX], x, (size_t)n_tiles * rows, Fp, Fp, rows, kSliceK, sw) ||
      !tile::bf16_map(&m.map[kD3hi], p.c.d3hi, Pc, F3p, F3p, rows, kSliceK, sw, 4) ||
      !tile::bf16_map(&m.map[kD3lo], p.c.d3lo, Pc, F3p, F3p, rows, kSliceK, sw, 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  dz3_kernel<<<nt, kConsumers, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem = layout(p.geo, F, Fp, F2p).total + 1024;
  err = cudaFuncSetAttribute(block_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_bwd_kernel<<<nt < sms ? nt : sms, kThreads, smem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  fdw::Jobs js[2];
  weight_jobs(js, static_cast<const bf16*>(x) + (size_t)t0 * rows * Fp, p.c, grads, F, F3,
              nt * rows, first, sms, reinterpret_cast<float*>(base + S.part));
  for (const fdw::Jobs& j : js) {
    const int e = dw_launch(j, st);
    if (e) return e;
  }
  if (last) {
    const Grads g = grad_layout(F, F3);
    upsampler_sum_kernel<<<fdw::blocks256(6 * (size_t)F + F3), 256, 0, st>>>(
        p.small, (int)n_tiles, 6 * (size_t)F + F3, grads + g.b);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // extern "C"
