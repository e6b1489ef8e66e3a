// The fused upsampler block's chain body, shared by its forward
// (csrc/fused_upsampler_fwd.cu, K7) and its backward's recompute
// (csrc/fused_upsampler_bwd.cu, K8), so the two compute the same bits: one
// CTA of 16 consumer warps and a producer warp takes tiles of 64, 128 or
// 256 pixels through products of the form
//
//     out[rows, N] = sum over the segments s of A_s[rows, K_s] B_s[N, K_s]^T
//
// (x W1, h1 W2g_k per phase, z_k W3 in the forward; dz3_k W3^T, dzp W2g^T and
// dh1p W1^T in the backward), each followed by an epilogue the kernel
// supplies.
//
// Numerics: bf16 operands, f32 accumulation; every product is a chain of
// wgmma k16 steps in increasing k, segment after segment, from zeroed
// accumulators: the k order of the earlier mma.sync m16n8k16 kernels, whose
// sums a wgmma chain gives to the bit (PERF.md, the bit probe).  Zero
// padding of K adds exact zeros.
//
// What bounds it on Hopper, and what the design does about it.  Per pixel
// the chain is 2F^2 + 8F^2 (+ 4 F F3) multiply-adds against a few hundred
// bytes the function must move: tensor-core work.  The earlier kernels lost
// most of their time elsewhere (PERF.md): each of eight warps read its B
// fragments from L2 with 4-byte loads, two warps each fetching every weight
// of a 32-pixel tile.  So:
//  * the weights reach shared memory once per tile for all 16 consumer
//    warps: one thread of a producer warp copies [pass columns, 32]
//    K-slices of the zero-padded [N, K] bf16 weight matrices with tensor
//    copies (TMA, whose 64-byte swizzle is wgmma's; rows past a matrix
//    arrive as zeros) into a ring of stages with full and empty mbarriers.
//    The weights do not depend on the data, so the producer runs ahead
//    across products and tiles (the CTAs are persistent);
//  * a stage may also carry a [rows, 32] K-slice of A from a matrix in
//    device memory (K8's dz3 halves, and its dh1's A, the four phases' dzp,
//    which the tile wrote before and which would not fit in shared memory
//    beside the rest); K8's tile of x arrives by tensor copies too;
//  * the products are wgmma m64n64k16, A and B from shared memory: the four
//    warpgroups are nrg row groups of 64 pixels times 4 / nrg column groups
//    of 64 columns; a product of N columns takes ceil(N / (64 ncg)) passes
//    of equal width in whole 64-column blocks, so the widths 258 / 129 / 64
//    waste little;
//  * activation tiles live in shared memory as [rows, 32] sub-blocks with
//    64-byte rows in the 64-byte swizzle (wgmma's K-major layout, and free of
//    bank conflicts for the epilogue's stores);
//  * the epilogues read their biases and the residual's channels from
//    tables in shared memory, with no branch per element (past a width the
//    weights' rows and the tables are zero).
// A tile is 64 nrg pixels: the caller takes the most rows that its shared
// memory holds and that still make about a tile per SM.  At the first block
// (F = 258; 8,192 pixels at B=2, 4,096 in a request) that is 64, one wgmma
// m64: a 128-pixel tile would leave half the card idle.  At the narrow
// blocks (129, 64) a 64-pixel tile spends its time in fixed costs (a
// product's few slices, its epilogue and barrier) while most warpgroups sit
// out products of 64 or 128 columns; 128 and 256 rows let a slice feed them
// all.

#pragma once

#include "tile_mma.cuh"

namespace uchain {

typedef __nv_bfloat16 bf16;

constexpr int kGroupRows = 64;            // pixels of a warpgroup: one wgmma m64
constexpr int kGroups = 4;                // consumer warpgroups
constexpr int kConsumers = 128 * kGroups;
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kGroupCols = 64;            // a warpgroup's columns of a pass
constexpr int kAcc = kGroupCols / 2;      // f32 accumulators a thread
constexpr int kSliceK = 32;               // K-columns per stage: 64-byte rows
constexpr int kBlock = kGroupRows * kSliceK * 2;  // [64, 32] bf16: a warpgroup's share
constexpr int kMaxSegs = 3;
constexpr int kMaxMaps = 10;

__host__ __device__ inline int pad32(int n) { return (n + 31) / 32 * 32; }

constexpr int kMinStages = 3, kMaxStages = 8;  // the ring's depth
constexpr size_t kSmemLimit = 232448;          // dynamic shared memory of a CTA (H100)

// The tile's geometry: 64 nrg pixels; the warpgroups as nrg row groups times
// ncg = 4 / nrg column groups.  An activation tile is K / 32 sub-blocks of
// [rows, 32]; a stage is `bstage` bytes of B ([pass width, 32], the widest
// of the kernel's passes), then, where A streams, [rows, 32] of A; the ring
// has `stages` of them.
struct Geo {
  int nrg, bstage, stages;
  __host__ __device__ int rows() const { return kGroupRows * nrg; }
  __host__ __device__ int ncg() const { return kGroups / nrg; }
  __host__ __device__ int sub() const { return nrg * kBlock; }
  // the passes of a product whose outputs are n (padded) columns wide, and
  // their width: equal passes in whole 64-column blocks
  __host__ __device__ int passes(int n) const {
    return (n + ncg() * kGroupCols - 1) / (ncg() * kGroupCols);
  }
  __host__ __device__ int pass_width(int n) const {
    const int np = passes(n);
    return (n + np * kGroupCols - 1) / (np * kGroupCols) * kGroupCols;
  }
};

using tile::bf2f;
using tile::desc;
using tile::fence_proxy_async;
using tile::mbar_arrive;
using tile::mbar_expect_tx;
using tile::mbar_init;
using tile::mbar_wait;
using tile::smem_addr;
using tile::tma_load_2d;
using tile::wgmma_commit;
using tile::wgmma_fence;
using tile::wgmma_wait;

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.2f * v; }

// Byte offset of element (r, c) of an activation tile of `sub`-byte
// sub-blocks: 64-byte rows, their 16-byte chunks permuted by (r / 2) % 4
// (the 64-byte swizzle of wgmma and of the tensor copies)
__device__ __forceinline__ int swz(int sub, int r, int c) {
  return (c >> 5) * sub + r * 64 + ((((c >> 3) & 3) ^ ((r >> 1) & 3)) << 4) + (c & 7) * 2;
}

// d (+)= A . B^T for one m64n64k16 bf16 product, A ([64, 16]) and B ([64,
// 16]) K-major in shared memory; f32 accumulators.  Element d[4 j + 2 h + i]
// of thread (warp w of the warpgroup, lane g * 4 + t) is row 16 w + g + 8 h,
// column 8 j + 2 t + i.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[kAcc], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// the consumer warps alone (named barrier 1): the producer warp runs ahead
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// One segment of a product: its B is rows [brow, brow + N) of tensor map
// `map` (K-columns [0, 32 kslices)); its A the tile at shared address `a`
// ([rows, 32 kslices], swizzled) or, with amap >= 0, rows [arow, arow +
// rows) of tensor map `amap` (of its plane `aplane` where that is a 3-D
// map), carried in the stages.
struct Seg {
  uint32_t a;
  int map, brow, kslices;
  int amap = -1, arow = 0, aplane = -1;
};

// A product: N output columns (padded to 32) from its segments, in order.
struct Prod {
  int n, nseg;
  Seg seg[kMaxSegs];
};

// The ring of stages: stage s is [pass columns, 32] of B at stage + s *
// stride, then [rows, 32] of A; full[s] (the producer arrives with the bytes,
// the copies complete them) and empty[s] (one arrival per consumer warp once
// its products have read the stage; per warp, not per warpgroup, so that no
// warp can free a stage for its next fill before every warp has waited for
// the current one).  j counts the slices this thread has taken or given.
struct Ring {
  uint32_t stage, bars;
  int stride, bbytes, stages;  // bytes per stage, of them B's
  int j;
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8 * (stages + s); }
  __device__ __forceinline__ uint32_t b(int s) const { return stage + s * stride; }
  __device__ __forceinline__ uint32_t a(int s) const { return stage + s * stride + bbytes; }
};

// The tensor maps of the weights (and K8's streamed A), in the kernel's
// parameters, and each map's box rows
struct Maps {
  CUtensorMap map[kMaxMaps];
  int box_rows[kMaxMaps];
};

// Producer: the slices of one product, in the order run_product takes them
__device__ inline void load_product(Ring& ring, const Geo& geo, const Maps& m, const Prod& pr) {
  const int np = geo.passes(pr.n), pw = geo.pass_width(pr.n);
  const int abytes = geo.rows() * kSliceK * 2;
  for (int p = 0; p < np; ++p)
#pragma unroll
    for (int s = 0; s < kMaxSegs; ++s) {  // unrolled: the segments stay in registers
      if (s == pr.nseg) break;
      const Seg& sg = pr.seg[s];
      for (int i = 0; i < sg.kslices; ++i, ++ring.j) {
        const int st = ring.j % ring.stages;
        if (ring.j >= ring.stages) mbar_wait(ring.empty(st), (ring.j / ring.stages - 1) & 1);
        const bool stream_a = sg.amap >= 0;
        mbar_expect_tx(ring.full(st), m.box_rows[sg.map] * kSliceK * 2 + (stream_a ? abytes : 0));
        tma_load_2d(ring.b(st), &m.map[sg.map], i * kSliceK, sg.brow + p * pw, ring.full(st));
        if (stream_a && sg.aplane >= 0)
          tile::tma_load_3d(ring.a(st), &m.map[sg.amap], i * kSliceK, sg.aplane, sg.arow,
                            ring.full(st));
        else if (stream_a)
          tma_load_2d(ring.a(st), &m.map[sg.amap], i * kSliceK, sg.arow, ring.full(st));
      }
    }
}

// Consumers: the product, pass by pass; after pass p epi(p, col0, on, acc)
// with this warpgroup's accumulators for its row group's 64 pixels and the
// columns col0 + [0, 64) (on: the warpgroup computed them; otherwise
// nothing was computed).  Each slice
// waits for its stage; its products run behind the next slice's wait, and a
// warp frees a stage once its share of the products that read it is done.
template <class Epi>
__device__ inline void run_product(Ring& ring, const Geo& geo, const Prod& pr, Epi&& epi) {
  const int wg = threadIdx.x >> 7, rg = wg / geo.ncg(), cg = wg % geo.ncg();
  const bool signal = (threadIdx.x & 31) == 0;  // one arrival per warp
  const int np = geo.passes(pr.n), pw = geo.pass_width(pr.n), sub = geo.sub();
  for (int p = 0; p < np; ++p) {
    const int col0 = p * pw + cg * kGroupCols;
    const bool on = cg * kGroupCols < pw && col0 < pr.n;  // uniform across the warpgroup
    float acc[kAcc];
#pragma unroll
    for (int q = 0; q < kAcc; ++q) acc[q] = 0.f;
    bool first = true;
#pragma unroll
    for (int s = 0; s < kMaxSegs; ++s) {  // unrolled: the segments stay in registers
      if (s == pr.nseg) break;
      const Seg& sg = pr.seg[s];
      for (int i = 0; i < sg.kslices; ++i, ++ring.j) {
        const int st = ring.j % ring.stages;
        mbar_wait(ring.full(st), (ring.j / ring.stages) & 1);
        if (on) {
          const uint32_t a = (sg.amap >= 0 ? ring.a(st) : sg.a + i * sub) + rg * kBlock;
          const uint32_t b = ring.b(st) + cg * kBlock;
          wgmma_fence();
          wgmma_m64n64k16(acc, desc(a, 512, 2), desc(b, 512, 2));
          wgmma_m64n64k16(acc, desc(a + 32, 512, 2), desc(b + 32, 512, 2));
          wgmma_commit();
          wgmma_wait<1>();  // the previous slice's products are done
        }
        if (!first) mbar_arrive(ring.empty((ring.j - 1) % ring.stages), signal);
        first = false;
      }
    }
    wgmma_wait<0>();
    mbar_arrive(ring.empty((ring.j - 1) % ring.stages), signal);
    epi(p, col0, on, acc);
  }
}

// The thread's place in a pass's accumulators: acc[4 j + 2 h + i] is row
// row0 + 8 h, column col0 + 8 j + c2 + i; and the tiles' sub-block bytes
struct Frag {
  int row0, c2, sub, gq;
  __device__ __forceinline__ explicit Frag(const Geo& geo) {
    const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
    row0 = wg / geo.ncg() * kGroupRows + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    c2 = 2 * (lane & 3);
    sub = geo.sub();
    gq = (row0 >> 1) & 3;  // the swizzle's row term, the same for row0 + 8
  }
  // swz(sub, row0 + 8 h, col0 + 8 j + c2) for col0 a multiple of 64, j
  // known when compiled
  __device__ __forceinline__ int at(int col0, int j, int h) const {
    return ((col0 >> 5) + (j >> 2)) * sub + (row0 + 8 * h) * 64 + (((j & 3) ^ gq) << 4) + c2 * 2;
  }
};

// two values at byte offset `off` of a swizzled bf16 tile
__device__ __forceinline__ void put2(unsigned char* tile, int off, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(tile + off) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ float2 get2(const unsigned char* tile, int off) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + off));
}

__device__ __forceinline__ float get(const unsigned char* tile, int sub, int r, int c) {
  return bf2f(*reinterpret_cast<const bf16*>(tile + swz(sub, r, c)));
}

// The tables the epilogues read: res[k Fp + c] = (4c + k) % F, the x
// channel of the residual of phase k's channel c (past F the last, zero
// column of the padded x), and the biases zero-padded, b1s [F2p] and b2s
// [4 Fp] (phase-padded)
__device__ inline void epilogue_tables(unsigned short* res, float* b1s, float* b2s,
                                       const float* b1, const float* b2, int F, int Fp,
                                       int F2p) {
  for (int i = threadIdx.x; i < 4 * Fp; i += blockDim.x) {
    const int k = i / Fp, c = i - k * Fp;
    res[i] = (unsigned short)(c < F ? (4 * c + k) % F : Fp - 1);
    b2s[i] = c < F ? b2[k * F + c] : 0.f;
  }
  for (int c = threadIdx.x; c < F2p; c += blockDim.x) b1s[c] = c < 2 * F ? b1[c] : 0.f;
}

// Producer: the tile's rows [p0, p0 + rows) of x ([*, Fp] bf16, tensor map
// `map`; rows past it arrive as zeros) into the tile X at shared address x,
// Fp / 32 tensor copies of [rows, 32], completing on `full`
__device__ inline void load_x(const Geo& geo, const CUtensorMap* map, uint32_t x, int Fp,
                              long long p0, uint32_t full) {
  mbar_expect_tx(full, Fp / kSliceK * geo.sub());
  for (int i = 0; i < Fp / kSliceK; ++i)
    tma_load_2d(x + i * geo.sub(), map, i * kSliceK, (int)p0, full);
}

// h1 = bf16(lrelu(v + b1)) into H1 (zero past 2F: there the weights' rows
// and b1s are zero); with h1c, also into its rows (F2p wide) in device memory
__device__ __forceinline__ void epi_h1(const Frag& f, const float (&acc)[kAcc], int col0,
                                       const float* b1s, int F2p, unsigned char* H1, bf16* h1c) {
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    const int c = col0 + 8 * j + f.c2;
    if (col0 + 8 * j >= F2p) continue;  // uniform across the warp
    const float2 b = *reinterpret_cast<const float2*>(b1s + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = lrelu(acc[4 * j + 2 * h] + b.x), v1 = lrelu(acc[4 * j + 2 * h + 1] + b.y);
      put2(H1, f.at(col0, j, h), v0, v1);
      if (h1c)
        *reinterpret_cast<__nv_bfloat162*>(h1c + (size_t)(f.row0 + 8 * h) * F2p + c) =
            __floats2bfloat162_rn(v0, v1);
    }
  }
}

// Phase k of z for the accumulator pair (r, c), (r, c + 1) of a pass: zp =
// v + b2s[k Fp + c], z = lrelu(zp) + x[r, res[k Fp + c]] (zero past F: there
// the weights' rows and b2s are zero and res points at a zero column of x);
// the bits 1, 2 of `pos` are zp > 0
__device__ __forceinline__ float2 z_pair(float v0, float v1, int r, int kc, const float* b2s,
                                         const unsigned short* res, const unsigned char* X,
                                         int sub, uint32_t& pos) {
  const float2 b = *reinterpret_cast<const float2*>(b2s + kc);
  const float zp0 = v0 + b.x, zp1 = v1 + b.y;
  pos = (zp0 > 0.f ? 1u : 0u) | (zp1 > 0.f ? 2u : 0u);
  return make_float2(lrelu(zp0) + get(X, sub, r, res[kc]),
                     lrelu(zp1) + get(X, sub, r, res[kc + 1]));
}

}  // namespace uchain
