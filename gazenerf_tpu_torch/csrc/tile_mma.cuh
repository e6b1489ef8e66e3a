// Tensor-core building blocks shared by the port's kernels.
//
// The mma.sync m16n8k16 fragment helpers (bf16 in, f32 accumulate) serve
// the fused field backward (csrc/field_bwd.cuh) and the fused upsampler's
// two kernels (csrc/fused_upsampler_fwd.cu, csrc/fused_upsampler_bwd.cu);
// the wgmma fences and waits serve the field forward (csrc/field_fwd.cuh)
// and the weight-gradient GEMM (csrc/field_dw.cuh).  The rest belongs to
// the upsampler: a tile of kRows pixels times a weight matrix, the per-tile
// weight-gradient outer product added into a private f32 slab, the column
// sums of a product's epilogue values, and the epilogues of the block's
// forward chain, which its backward recomputes.
//
// Layouts (upsampler): activations in shared memory, [kRows, ld] bf16, ld =
// K + 8 with K a multiple of 16 (the +8 makes the fragment loads free of
// bank conflicts); weights in global memory [N, K] bf16 row-major (out, in),
// zero-padded to multiples of 16 both ways, so every fragment register is
// one 32-bit load.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 32;       // pixels per tile
constexpr int kThreads = 256;   // 8 warps: 2 row groups of 16 x 4 column groups
constexpr int kChunk = 32;      // columns of one warp pass (four n8 tiles)
constexpr int kPad = 8;         // bf16 elements of row padding

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// two 16-bit values into one fragment register, the lower k in the low half
__device__ __forceinline__ uint32_t pack2(unsigned short lo, unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.2f * v; }

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of row
// l & 7 of matrix l >> 3 (16 bytes, 16-byte aligned); register j holds matrix
// j, lane l its row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes from global to shared memory, asynchronously (L2 only); with
// `valid` false the 16 bytes are zeros and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// wait until at most `n` of this thread's committed copy groups are pending
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// wgmma's warpgroup-wide fences and waits (csrc/field_dw.cuh, csrc/field_fwd.cuh)
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}
// orders this thread's generic-proxy writes to shared memory (cp.async
// included) before the async proxy's reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One K-segment of a product: the [kRows, K] tile `a` (row stride lda) times
// the [N, K] weight `w` transposed.
struct Seg {
  const bf16* a;
  int lda;
  const bf16* w;
  int K;
};

// out[r, c] = sum over the segments of a[r, :] . w[c, :] for the tile's
// kRows rows and the N (a multiple of 16) columns.  Warp (rg, cg) = (warp &
// 1, warp >> 1) takes rows rg*16 + [0, 16) and the column chunks cg*32 +
// 128 j.  Each accumulator pair goes through epi(r, c, v0, v1) (columns c,
// c + 1), which may change the values; when `cs` is given, the changed
// values' column sums over each row group land in cs[rg * ldcs + c].
template <class Epi>
__device__ void gemm(const Seg* segs, int nseg, int N, const Epi& epi, float* cs = nullptr,
                     int ldcs = 0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 1, cg = warp >> 1;
  const int row0 = rg * 16;
  for (int n0 = cg * kChunk; n0 < N; n0 += 4 * kChunk) {
    float acc[4][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[ni][q] = 0.f;
    for (int s = 0; s < nseg; ++s) {
      const Seg op = segs[s];
#pragma unroll 2
      for (int k = 0; k < op.K; k += 16) {
        uint32_t a[4];
        const bf16* p = op.a + (row0 + g) * op.lda + k + 2 * t;
        a[0] = lds32(p);
        a[1] = lds32(p + 8 * op.lda);
        a[2] = lds32(p + 8);
        a[3] = lds32(p + 8 * op.lda + 8);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if (n0 + ni * 8 < N) {
            const bf16* q = op.w + (size_t)(n0 + ni * 8 + g) * op.K + k + 2 * t;
            mma16816(acc[ni], a, ldg32(q), ldg32(q + 8));
          }
        }
      }
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      if (n0 + ni * 8 >= N) continue;  // uniform across the warp
      const int c = n0 + ni * 8 + 2 * t;
      epi(row0 + g, c, acc[ni][0], acc[ni][1]);
      epi(row0 + g + 8, c, acc[ni][2], acc[ni][3]);
      if (cs) {
        float s0 = acc[ni][0] + acc[ni][2], s1 = acc[ni][1] + acc[ni][3];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        }
        if (g == 0) {
          cs[rg * ldcs + c] = s0;
          cs[rg * ldcs + c + 1] = s1;
        }
      }
    }
  }
}

// slab[m * ldo + n] += sum over the tile's rows r of X[r, m] * D[r, n], for
// m < M and n < N: the weight gradient X^T . D of one tile.  X and D are
// bf16 tiles in shared memory (row strides ldx, ldd of at least pad16(M) and
// pad16(N)); the slab is row-major f32 in global memory, private to the
// CTA.  Warps take 16 x 32 blocks in turn; the fragments are gathered from
// the row-major tiles by 16-bit loads.
__device__ inline void outer_acc(const bf16* X, int ldx, int M, const bf16* D, int ldd, int N,
                          float* slab, int ldo) {
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(X);
  const unsigned short* ds = reinterpret_cast<const unsigned short*>(D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nbm = (M + 15) / 16, nbn = (N + kChunk - 1) / kChunk;
  for (int blk = warp; blk < nbm * nbn; blk += kThreads / 32) {
    const int m0 = (blk / nbn) * 16, n0 = (blk % nbn) * kChunk;
    float acc[4][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[ni][q] = 0.f;
#pragma unroll
    for (int k = 0; k < kRows; k += 16) {
      const int k0 = (k + 2 * t) * ldx, k1 = k0 + ldx, k8 = k0 + 8 * ldx, k9 = k8 + ldx;
      const int m = m0 + g;
      uint32_t a[4];
      a[0] = pack2(xs[k0 + m], xs[k1 + m]);
      a[1] = pack2(xs[k0 + m + 8], xs[k1 + m + 8]);
      a[2] = pack2(xs[k8 + m], xs[k9 + m]);
      a[3] = pack2(xs[k8 + m + 8], xs[k9 + m + 8]);
      const int d0 = (k + 2 * t) * ldd, d1 = d0 + ldd, d8 = d0 + 8 * ldd, d9 = d8 + ldd;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        if (n0 + ni * 8 < N) {
          const int n = n0 + ni * 8 + g;
          mma16816(acc[ni], a, pack2(ds[d0 + n], ds[d1 + n]), pack2(ds[d8 + n], ds[d9 + n]));
        }
      }
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + ni * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + g + 8 * h;
        if (r >= M) continue;
        float* o = slab + (size_t)r * ldo + c;
        if (c < N) o[0] += acc[ni][2 * h];
        if (c + 1 < N) o[1] += acc[ni][2 * h + 1];
      }
    }
  }
}

// h1 = bf16(lrelu(v + b1)), zero in the padded columns
struct EpiH1 {
  bf16* h1;
  int ld;
  const float* b1;
  int n;
  __device__ void operator()(int r, int c, float& v0, float& v1) const {
    v0 = c < n ? lrelu(v0 + b1[c]) : 0.f;
    v1 = c + 1 < n ? lrelu(v1 + b1[c + 1]) : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(h1 + r * ld + c) = __floats2bfloat162_rn(v0, v1);
  }
};

// phase k of z: bf16(lrelu(zp) + x[(4c + k) % F]) with zp = v + b2[kF + c],
// zero in the padded columns; given `mask`, also mask[r, c] = zp > 0 (the
// backward's lrelu mask; 0 in the padded columns)
struct EpiZ {
  bf16* z;
  int ld;
  const float* b2;  // b2 + k F
  const bf16* xs;
  int ldx, F, k;
  unsigned char* mask = nullptr;
  int ldm = 0;
  __device__ float one(int r, int c, float v) const {
    if (c >= F) {
      if (mask) mask[r * ldm + c] = 0;
      return 0.f;
    }
    const float zp = v + b2[c];
    if (mask) mask[r * ldm + c] = zp > 0.f;
    return lrelu(zp) + bf2f(xs[r * ldx + (4 * c + k) % F]);
  }
  __device__ void operator()(int r, int c, float& v0, float& v1) const {
    v0 = one(r, c, v0);
    v1 = one(r, c + 1, v1);
    *reinterpret_cast<__nv_bfloat162*>(z + r * ld + c) = __floats2bfloat162_rn(v0, v1);
  }
};

}  // namespace tile
