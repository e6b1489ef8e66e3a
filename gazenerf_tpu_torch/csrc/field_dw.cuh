// The fused field backward's weight gradients, out of the tile loop: for a
// chunk of P points (whole tiles) the tile body (csrc/field_bwd.cuh) has
// written every layer's input X ([P, M] bf16, point-major: the trunk's
// activations, the padded embedding) and the bf16-rounded cotangent of its
// output D ([P, N] bf16); this GEMM computes
//
//     dW[m, n] (+)= sum over the chunk's points p of X[p, m] D[p, n]
//
// for every layer of the chunk in one launch, into the row-major [in, out]
// gradient blocks of the JAX layout, adding to what earlier chunks left
// (`accumulate`).  It replaces the TPU kernel's in-kernel accumulation
// (gazenerf_tpu/kernels/fused_field_bwd.py:_bwd_kernel; its split_dw
// epilogue computes the same contractions as XLA matmuls).  Beside it, the
// folded feature head's dWr2 / dbr2 as an f32 contraction over the chunk's
// rays (head_dw) and the CTA-order sum of the tile kernel's small per-CTA
// buffers (sum_small).  Both K2 (csrc/fused_field_bwd.cu) and K4
// (csrc/fused_field2_bwd.cu) include this header and launch these with
// their own kernel names; csrc/field_dw.cu exposes the GEMM alone.
//
// Numerics: bf16 x bf16 products summed in f32, the numerics of the tile
// loop it replaces.  Each CTA sums one output tile over one of `splits`
// consecutive point ranges of the chunk, in order, into its own f32 partial;
// dw_reduce then adds the partials in split order to what earlier chunks
// left: no atomics, the same bits on every run, and the same bits for K2
// and K4 fed the same chunks in the same order.
//
// What bounds it: at hidden 384 a chunk of 33,792 points is 44.8 G
// multiply-adds against ~0.48 GB of operands: ~93 operations per byte, below
// the card's ridge (~295), so with its operands read once it would be
// bandwidth-bound (~0.14 ms per chunk at 3.35 TB/s against ~0.09 ms of bf16
// tensor work).  Every X slice is read by the N / 128 CTAs of its row of
// output tiles and every D slice by the M / 64 of its column, mostly from L2.
// Design: one warpgroup per CTA computes a 64 x 128 output tile with wgmma
// m64n128k16 from shared memory, over the point dimension in slices of 64
// points staged by cp.async in a ring of four (97 KB, two CTAs per SM).
// Both operands are point-major, so both are MN-major ("transposed") for
// wgmma: each slice sits in [64 points][64 columns] tiles of 128-byte rows
// in the 128-byte swizzle, the canonical layout whose descriptor steps 1024
// bytes per 8 points (SBO) and 8 KB per 64 columns (LBO).  The 162 output
// tiles of a chunk at hidden 384 are too few for 132 SMs, so the points are
// split into about two waves of CTAs.

#pragma once

#include "tile_mma.cuh"

namespace fdw {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 64;       // output rows (X columns) per CTA: one wgmma m64
constexpr int kBN = 128;      // output columns (D columns) per CTA: its n128
constexpr int kBK = 64;       // points per stage
constexpr int kStages = 4;
constexpr int kThreads = 128;  // one warpgroup
constexpr int kATile = kBK * kBM * 2;  // [kBK][64] bf16, 128-byte rows
constexpr int kBHalf = kBK * 64 * 2;   // [kBK][64] bf16: B holds two, n 0-63 and 64-127
constexpr int kStageBytes = kATile + 2 * kBHalf;
constexpr size_t kSmem = (size_t)kStages * kStageBytes + 1024;  // + alignment to 1024
constexpr int kMaxJobs = 12;
constexpr int kMaxSplits = 8;   // point ranges per output tile
constexpr int kCtasPerSm = 2;   // what shared memory allows: 2 x 97 KB

// One product: out[M, N] (+)= x[P, M]^T d[P, N].  M and N are multiples of
// 32; the rows of x and d are contiguous (row strides M and N).
struct Job {
  const bf16* x;
  const bf16* d;
  float* out;
  int M, N;
  int tiles_n;     // ceil(N / kBN)
  int first_tile;  // index of its first output tile
  size_t off;      // offset of its partials in each split's part buffer
};

struct Jobs {
  Job job[kMaxJobs];
  int n_jobs;
  int tiles;        // output tiles in all
  int splits;       // point ranges per output tile: tiles * splits CTAs
  int P;            // points, a multiple of kBK
  int split_p;      // points per range, a multiple of kBK
  int accumulate;   // dw_reduce adds to out, else stores
  float* part;      // [splits, part_len] f32 partial sums
  size_t part_len;  // sum over the jobs of M * N
};

// A job list's numbering: output tiles in job order, each job row-major over
// its [ceil(M / kBM), ceil(N / kBN)] tiles; the point ranges, as many as
// make about two waves of kCtasPerSm CTAs on each of `sms` SMs (at most
// max_splits, at least kBK points each).  `part` holds splits * part_len
// floats (at most max_splits * part_len).
inline void number_tiles(Jobs& js, int sms, float* part, int max_splits = kMaxSplits) {
  int t = 0;
  size_t off = 0;
  for (int j = 0; j < js.n_jobs; ++j) {
    Job& jb = js.job[j];
    jb.tiles_n = (jb.N + kBN - 1) / kBN;
    jb.first_tile = t;
    jb.off = off;
    t += (jb.M + kBM - 1) / kBM * jb.tiles_n;
    off += (size_t)jb.M * jb.N;
  }
  js.tiles = t;
  js.part_len = off;
  js.part = part;
  int splits = (2 * kCtasPerSm * sms + t / 2) / t;
  splits = splits < 1 ? 1 : splits > max_splits ? max_splits : splits;
  if (splits > js.P / kBK) splits = js.P / kBK;
  js.split_p = (js.P / kBK + splits - 1) / splits * kBK;
  js.splits = (js.P + js.split_p - 1) / js.split_p;
}

using tile::cp_async16;
using tile::cp_async_commit;
using tile::cp_async_wait;
using tile::smem_addr;
using tile::fence_proxy_async;
using tile::wgmma_commit;
using tile::wgmma_fence;
using tile::wgmma_wait;

// A shared-memory matrix descriptor for wgmma: 128-byte swizzle; the byte
// offsets between 64-element atoms along M or N (lbo) and between groups of
// 8 rows along K (sbo).  The address must lie on a 1024-byte swizzle atom.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// d[64] (+)= A . B for one m64n128k16 bf16 product, both operands in shared
// memory, MN-major (A as [k][m], B as [k][n]: "transposed"), 128-byte
// swizzled; f32 accumulators.  Element d[4 j + 2 h + i] of thread (warp w,
// lane g * 4 + t) is row 16 w + g + 8 h, column 8 j + 2 t + i.
__device__ __forceinline__ void wgmma_m64n128k16_tt(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Row r of a [kBK][64] bf16 tile with 128-byte rows, 16-byte chunk c, as the
// 128-byte swizzle places it
__device__ __forceinline__ int sw128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// The CTA blockIdx.x of the job list: one 64 x 128 output tile over one
// range of points, into its partial.  Launch tiles * splits CTAs of kThreads
// threads with kSmem bytes of dynamic shared memory.
__device__ __forceinline__ void dw_tile(const Jobs& js, unsigned char* smem_raw) {
  const int t = blockIdx.x / js.splits, split = blockIdx.x % js.splits;
  const int pbeg = split * js.split_p;
  const int pend = pbeg + js.split_p < js.P ? pbeg + js.split_p : js.P;
  int j = 0;
  while (j + 1 < js.n_jobs && t >= js.job[j + 1].first_tile) ++j;
  const Job& jb = js.job[j];
  const int M = jb.M, N = jb.N;
  const int tm = (t - jb.first_tile) / jb.tiles_n, tn = (t - jb.first_tile) % jb.tiles_n;
  const int m0 = tm * kBM, n0 = tn * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  // stage s: the X slice [kBK][64 m], then the D slice as two [kBK][64 n]
  auto load = [&](int kt) {
    if (pbeg + kt * kBK < pend) {
      unsigned char* a = smem + (kt % kStages) * kStageBytes;
      unsigned char* b = a + kATile;
      const size_t p = (size_t)pbeg + kt * kBK;
#pragma unroll
      for (int q = 0; q < kBK * 8 / kThreads; ++q) {
        const int i = tid + q * kThreads, r = i >> 3, c = i & 7;
        const bool ok = m0 + c * 8 < M;
        cp_async16(a + sw128(r, c), ok ? jb.x + (p + r) * M + m0 + c * 8 : jb.x, ok);
      }
#pragma unroll
      for (int q = 0; q < 2 * kBK * 8 / kThreads; ++q) {
        const int i = tid + q * kThreads, h = i / (kBK * 8), r = (i >> 3) % kBK, c = i & 7;
        const int n = n0 + h * 64 + c * 8;
        const bool ok = n < N;
        cp_async16(b + h * kBHalf + sw128(r, c), ok ? jb.d + (p + r) * N + n : jb.d, ok);
      }
    }
    cp_async_commit();
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  const int nk = (pend - pbeg) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(s);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();               // everyone's
    const unsigned char* a = smem + (kt % kStages) * kStageBytes;
    const unsigned char* b = a + kATile;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)  // 16 points: 2 groups of 8 rows, 2048 bytes
      wgmma_m64n128k16_tt(acc, sw128_desc(a + ks * 2048, kBHalf, 1024),
                          sw128_desc(b + ks * 2048, kBHalf, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // slice kt - 1's products are done: its stage may be refilled
    load(kt + kStages - 1);
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  const int g = lane >> 2, tq = lane & 3;
  float* part = js.part + (size_t)split * js.part_len + jb.off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + warp * 16 + g + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      const int n = n0 + jn * 8 + 2 * tq;
      if (n < N)
        *reinterpret_cast<float2*>(part + (size_t)m * N + n) =
            make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
    }
  }
}

// out_j (+)= the sum of the job's partials in split order, every element of
// every job
__device__ __forceinline__ void dw_reduce(const Jobs& js) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < js.part_len;
       e += (size_t)gridDim.x * blockDim.x) {
    int j = 0;
    while (j + 1 < js.n_jobs && e >= js.job[j + 1].off) ++j;
    float s = 0.f;
    for (int k = 0; k < js.splits; ++k) s += js.part[(size_t)k * js.part_len + e];
    float* o = js.job[j].out + (e - js.job[j].off);
    *o = js.accumulate ? *o + s : s;
  }
}

// The folded head's gradients over a chunk's rays: out[k, c] (+)= sum over
// the rays r, in order, of aw[r, k] gf[r, c] (k < K = H/2 + 1: the last row
// of aw is sum_s w_s, so the last row of out is dbr2), in f32.
__device__ __forceinline__ void head_dw(const float* aw, const float* gf, int rays, int K, int C,
                                        int accumulate, float* out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < K * C; i += gridDim.x * blockDim.x) {
    const int k = i / C, c = i - k * C;
    float s = 0.f;
    for (int r = 0; r < rays; ++r) s = __fmaf_rn(aw[(size_t)r * K + k], gf[(size_t)r * C + c], s);
    out[i] = accumulate ? out[i] + s : s;
  }
}

// out[i] = sum over the G per-CTA buffers c, in order, of small[c * len + i]
__device__ __forceinline__ void sum_small(const float* small, int G, size_t len, float* out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < G; ++c) s += small[(size_t)c * len + i];
    out[i] = s;
  }
}

// blocks of 256 threads for a grid-stride loop over n elements
inline int blocks256(size_t n) {
  const size_t b = (n + 255) / 256;
  return (int)(b < 2048 ? b : 2048);
}

}  // namespace fdw
