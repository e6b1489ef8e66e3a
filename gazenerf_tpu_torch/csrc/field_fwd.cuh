// The fused field forward's tile body, shared by the single-branch forward
// (csrc/fused_field_fwd.cu, K1) and the dual-branch forward
// (csrc/fused_field2_fwd.cu, K3), so the two compute the same bits for the
// same branch.  One CTA of 16 consumer warps and a producer warp takes
// the smallest run of whole rays of one batch whose points fill whole tiles
// of TILE_POINTS points (cta_rays; one tile when S divides TILE_POINTS),
// tile after tile through the positional-embedding tile -> 8-layer field
// MLP (skip at fea_5) -> density and 258-channel feature heads -> alpha
// compositing, and writes the per-ray feature / background alpha / depth
// and the per-sample weights.
// With the stash on, it also writes the bf16 activations x0..x7, y0b
// (rgb_0's output) and y1 (rgb_1's) of every point, or (kForm) those of the
// layers in a mask (K1's stash of every k-th trunk layer), or x0..x6 and y0b
// as int8 codes with a scale per point, quantized in shared memory
// (quantize_layer; K1's int8 stash).  With kPoints (K1's
// embed_in_kernel) the tile takes the sample points and encodes them in
// place of reading the embedding (csrc/point_encoding.cuh).
//
// Numerics: bf16 operands with f32 accumulation; bias, conditioning rows and
// ReLU applied in f32 and the result rounded to bf16 before the next
// product; rgb_0's output rounded to bf16 before rgb_1; the feature head and
// the compositing in f32.  Every product is a chain of wgmma k16 steps in
// increasing k (the embedding's segment before the hidden state's at fea_5)
// from zeroed accumulators, rounded in the epilogue of the backward's
// recompute (csrc/field_bwd.cuh, gemm_rows<false> + epi_forward).  That
// recompute runs mma.sync m16n8k16 over the same k order, and on the H100
// the two instructions give the same f32 sums to the bit (PERF.md, the bit
// probe): the stash equals the activations the backward recomputes.
//
// What bounds it on Hopper, and what the design does about it.  Per point the
// trunk and heads are ~1.3 M bf16 multiply-adds against ~130 bytes of
// traffic the function needs: tensor-core work.  The parent design lost most
// of its time elsewhere (PERF.md): every warp read its B fragments from L2
// with 4-byte loads, so each of the four warp rows fetched all 2.6 MB of
// weights per tile (the products without those fetches took a third of the
// time), and the stash was copied out behind a barrier after every layer.
// So:
//  * the weights reach shared memory once per 128-point tile, for all 16
//    warps: a small kernel first packs them per call into one stream of
//    [192, 32] K-slices in the order the tile takes them, each already in
//    the stage layout (64-byte rows, 64-byte swizzle), and one thread of a
//    producer warp copies slice after slice with a bulk copy into a ring of
//    four stages, each with a full and an empty mbarrier.  The ring runs on
//    across passes and layers (the weights do not depend on the
//    activations), so no layer starts with an empty pipeline, and no
//    CTA-wide barrier paces it;
//  * the products are wgmma m64n96k16, A and B read from shared memory by
//    the tensor cores: four warpgroups, each 64 rows x 96 columns of a pass
//    of up to 192 columns (48 accumulators a thread), one slice's products
//    in flight behind the next slice's wait;
//  * a layer of N > 192 columns is two passes of N / 2.  The activations
//    live in three column blocks [kRows, N / 2] bf16, stored as 64-column
//    sub-blocks in the 128-byte swizzle (wgmma's K-major layout, free of
//    bank conflicts for the epilogue), that rotate: pass 0 writes the free
//    block, pass 1, after a barrier, the block its layer's input began in.
//    Two and a half activation tiles leave room for the ring;
//  * the stash leaves shared memory by tensor stores (TMA: one per 64-column
//    sub-block, whose swizzle is the tensor map's), started by one thread
//    after the layer and waited for only before their block is overwritten,
//    half a layer or a layer later: the copy-out runs behind the products;
//  * compositing runs a warp per ray, the transmittance product as a warp
//    scan; the 258-wide head is applied after the sample reduction,
//      sum_s w_s (y1_s Wr2 + br2) = (sum_s w_s y1_s) Wr2 + (sum_s w_s) br2,
//    one thread per output column over all the CTA's rays (Wr2 read along
//    its rows, coalesced);
//  * a ray longer than a tile (S a multiple of 64 that does not divide
//    TILE_POINTS: 192, 256) spans tiles of one CTA, which runs them in turn
//    on the same ring: a warp composites each ray's segment of a tile (64 or
//    128 samples) and carries three things per ray to the next tile, the
//    transmittance at the segment's end, u = sum_s w_s y1_s and sum_s w_s
//    (and the depth's sum), so the head is applied once, after the ray's
//    last tile.  A ray that fits a tile takes the one-tile code as before.

#pragma once

#include <cuda.h>

#include "point_encoding.cuh"
#include "tile_mma.cuh"

#ifndef TILE_POINTS
#error "build with -DTILE_POINTS=<points per CTA> (kernels/fused_field.py)"
#endif

namespace ffwd {

typedef __nv_bfloat16 bf16;

constexpr int kRows = TILE_POINTS;  // points per tile
constexpr int kConsumers = 512;     // 4 warpgroups: products, epilogues, the rest
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;  // and a producer warp: the weight ring
// (17 warps: 96 registers a thread, a quarter of the SM's file for the five
// warps of one scheduler)
constexpr int kGroupRows = 64;      // a warpgroup's rows of a pass
constexpr int kGroupCols = 96;      // and its columns
constexpr int kAcc = kGroupCols / 2;  // f32 accumulators a thread
constexpr int kPassCols = 2 * kGroupCols;  // columns of one pass
constexpr int kSub = 64;            // columns of a 128-byte-swizzled sub-block
constexpr int kSubBytes = kRows * kSub * 2;
constexpr int kSlots = 10;          // stash: x0..x7, y0b, y1
constexpr int kLayers = kSlots;     // fea_0..7, rgb_0, rgb_1: layer l writes slot l
constexpr int kQuantTags = 8;       // int8 stash: x0..x6, y0b; x7 and y1 stay bf16
constexpr float kInv127 = 0x1.020408p-7f;  // 1 / 127 rounded to f32 (0x3c010204)
// the stash's forms: every slot; the slots in a mask; the int8 stash
enum { kFormAll = 0, kFormMask = 1, kFormQuant = 2 };
constexpr int kBlocks = 3;          // activation column blocks
constexpr int kSliceK = 32;         // weight K-columns per stage: 64-byte rows
constexpr int kStages = 4;          // stages: two slices ahead, one in flight
constexpr int kStageBytes = kPassCols * kSliceK * 2;
constexpr int kMaxPasses = 2 * (kLayers - 1) + 1;
constexpr float kEps = 1e-10f;

static_assert(kConsumers == 4 * kRows, "density head uses 4 threads per row");
static_assert(kRows == 2 * kGroupRows, "2 warpgroup rows cover the tile");

// Rays per CTA for rays of S samples: the fewest whole rays whose points
// fill whole tiles, kRows / gcd(S, kRows) (kRows / S when S divides kRows;
// for S a multiple of 64, 1 or 2)
__host__ __device__ inline int cta_rays(int S) {
  int a = S, b = kRows;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return kRows / a;
}

// and the tiles they fill
__host__ __device__ inline int cta_tiles(int S) { return cta_rays(S) * S / kRows; }

// cta_rays in the instantiation for rays that span tiles (kSpan) or the
// one for whole rays in one tile (kRows / S, S dividing kRows)
template <bool kSpan>
__host__ __device__ inline int rays_per_cta(int S) { return kSpan ? cta_rays(S) : kRows / S; }

// One branch's operands and outputs.
struct Params {
  const bf16* embed;    // [B, R, S, De]; with kPoints the points, [B, R, S, 3] f32
  const float* zvals;   // [B, R, S]
  const float* zdists;  // [B, R, S]
  const float* cb0;     // [B, H]   sc . W0c + b0
  const float* cb5;     // [B, H]   sc . W5c + b5
  const float* cbr1;    // [B, H/2] ac . Wr1c + br1
  const bf16* wstream;  // the trunk's and rgb_0/1's weights: stream_slices(H, Kp)
                        // slices [192, 32] in the order the tile takes them,
                        // each in the stage layout (pack_stream)
  const float* bmid;    // [6, H] fea_1..4, fea_6, fea_7
  const bf16* wd;       // [H]
  const float* bd;      // [1]
  const float* br0;     // [H]
  const bf16* wr2;      // [H/2, C] (in, out)
  const float* br2;     // [C]
  float* feat_out;      // [B, R, C]
  float* bga_out;       // [B, R]
  float* depth_out;     // [B, R]
  float* w_out;         // [B, R, S]
  int R, S, De, Kp, H, C;
};

// One pass: ncols output columns from one or two K-segments of the layer
// input (K0 and K1 wide); its weights are the next (K0 + K1) / 32 slices of
// the stream.
struct Pass {
  int K0, K1, ncols;
};

// A layer input's K-columns in shared memory: [0, bw) in the swizzled tile
// at shared address blk[0], [bw, 2 bw) in blk[1].  (The hot loop holds
// 32-bit shared addresses, not 64-bit pointers: a thread has 96 registers.)
struct Act {
  uint32_t blk[2];
  int bw;
};

using tile::bf2f;
using tile::bulk_load;
using tile::desc;
using tile::fence_proxy_async;
using tile::mbar_arrive;
using tile::mbar_expect_tx;
using tile::mbar_init;
using tile::mbar_wait;
using tile::smem_addr;
using tile::wgmma_commit;
using tile::wgmma_fence;
using tile::wgmma_wait;

// passes of a trunk layer at hidden width H
__host__ __device__ inline int trunk_passes(int H) { return H > kPassCols ? 2 : 1; }

// slices of the weight stream: per trunk pass fea_0's Kp / 32, six hidden
// layers' and rgb_0's H / 32 each, fea_5's (Kp + H) / 32; rgb_1's H / 32
__host__ __device__ inline int stream_slices(int H, int Kp) {
  return trunk_passes(H) * (2 * Kp + 8 * H) / kSliceK + H / kSliceK;
}

// Byte offset of element (r, c) of a [kRows, w] tile stored as 64-column
// sub-blocks, each row of a sub-block 128 bytes in the 128-byte swizzle
// (its 16-byte chunks permuted by r % 8)
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * kSubBytes + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// Byte offset in a stage of 16-byte chunk c (4 per 64-byte row) of row n:
// the 64-byte swizzle, the chunks permuted by n / 2
__device__ __forceinline__ int stage_at(int n, int c) {
  return n * kSliceK * 2 + (((c ^ (n >> 1)) & 3) << 4);
}

// d (+)= A . B^T for one m64n96k16 bf16 product, A ([64, 16]) and B ([96,
// 16]) K-major in shared memory; f32 accumulators.  Element d[4 j + 2 h + i]
// of thread (warp w of the warpgroup, lane g * 4 + t) is row 16 w + g + 8 h,
// column 8 j + 2 t + i.
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[kAcc], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The product of v over the lanes below this one
__device__ __forceinline__ float warp_prefix_product(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = o * v;
  }
  const float ex = __shfl_up_sync(0xffffffffu, v, 1);
  return lane == 0 ? 1.f : ex;
}

// ---- the weight ring: mbarriers and bulk copies ----

// the consumer warps alone (named barrier 1): the producer warp runs ahead
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// The ring: kStages stages, each with a full barrier (the producer arrives
// with the stage's bytes, the copy completes them) and an empty barrier
// (each consumer warp arrives once its products have read the stage).  The
// arrivals are per warp, not per warpgroup: the four warps of a warpgroup
// do not wait for each other (in a pass whose columns a warpgroup does not
// reach, nothing ties them at all), and a stage freed for the next fill
// while one of them has yet to wait for its current fill would complete two
// phases of its full barrier under that warp, which then waits forever.
struct Ring {
  uint32_t stage;  // shared addresses: the stages
  uint32_t bars;   // full[kStages], then empty[kStages] (8 bytes each)
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8 * (kStages + s); }
};

// ---- the weight stream, packed per call ----

// One pass's weights in the stream: rows [n0, n0 + ncols) of its one or two
// K-segments w0 [N, K0] and w1 [N, K1] (row-major, out x in), as slices
// slice0, slice0 + 1, ... of kSliceK columns each.
struct StreamPass {
  const bf16* w0;
  const bf16* w1;
  int K0, K1, n0, ncols, slice0;
};

struct StreamPlan {
  StreamPass pass[kMaxPasses];
  int npass;
};

// The stream of one branch's weights ([out, in] bf16 blocks): the passes in
// the order the tile runs them (fea_0..7, fea_5's embedding columns before
// its hidden ones, rgb_0, rgb_1); stream_slices(H, Kp) slices in all.
inline StreamPlan stream_plan(const bf16* w0e, const bf16* wmid, const bf16* w5e,
                              const bf16* w5x, const bf16* wr0, const bf16* wr1x, int H, int Kp) {
  StreamPlan pl = {};
  int slice = 0;
  auto add = [&](const bf16* w0, int K0, const bf16* w1, int K1, int N) {
    const int lnp = N > kPassCols ? 2 : 1, pw = N / lnp;
    for (int q = 0; q < lnp; ++q) {
      pl.pass[pl.npass++] = {w0, w1, K0, K1, q * pw, pw, slice};
      slice += (K0 + K1) / kSliceK;
    }
  };
  const size_t HH = (size_t)H * H;
  add(w0e, Kp, nullptr, 0, H);
  for (int i = 0; i < 4; ++i) add(wmid + i * HH, H, nullptr, 0, H);
  add(w5e, Kp, w5x, H, H);
  for (int i = 4; i < 6; ++i) add(wmid + i * HH, H, nullptr, 0, H);
  add(wr0, H, nullptr, 0, H);
  add(wr1x, H, nullptr, 0, H / 2);
  return pl;
}

// Slice blockIdx.x of the stream into `out`: thread (n, c) copies row n's
// 16-byte chunk c of the slice to where the stage layout (stage_at) keeps
// it; rows past the pass's columns are zeros.  The stream is a copy of the
// weights, made per call so that no second copy outlives the launch.
__global__ void __launch_bounds__(4 * kPassCols)
    pack_stream(const __grid_constant__ StreamPlan pl, bf16* out) {
  const int j = blockIdx.x;
  int q = 0;
  while (q + 1 < pl.npass && pl.pass[q + 1].slice0 <= j) ++q;
  const StreamPass& ps = pl.pass[q];
  const int n = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int k = (j - ps.slice0) * kSliceK;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (n < ps.ncols) {
    const bool seg0 = k < ps.K0;
    const bf16* w = seg0 ? ps.w0 : ps.w1;
    const int K = seg0 ? ps.K0 : ps.K1, k0 = seg0 ? k : k - ps.K0;
    v = *reinterpret_cast<const uint4*>(w + (size_t)(ps.n0 + n) * K + k0 + c * 8);
  }
  *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(out) + (size_t)j * kStageBytes +
                            stage_at(n, c)) = v;
}

// The tile's state: its shared-memory buffers and the ring's cursors.
struct Tile {
  unsigned char* act;  // kBlocks activation column blocks, swizzled [kRows, bw] each
  int bw, np;          // block width (H / np), trunk passes
  Ring ring;
  const Pass* tab;     // the passes in the order the layers run them
  int pass;            // the next pass to run
  int j;               // the next slice to consume
};

// Block of pass q of layer l's output: the blocks rotate, so a pass never
// writes a block its layer still reads (pass 1 of a two-pass layer writes
// the block its input began in, after a barrier).
__device__ __forceinline__ unsigned char* out_block(const Tile& t, int l, int q) {
  return t.act + ((t.np * l + q) % kBlocks) * (t.bw / kSub) * kSubBytes;
}

// Layer l's output as the next layer's input
__device__ __forceinline__ Act output_of(const Tile& t, int l) {
  return {{smem_addr(out_block(t, l, 0)), smem_addr(out_block(t, l, 1))}, t.bw};
}

// ---- the stash: tensor stores from shared memory ----

// The tile's rows [y, y + 128) of columns [x, x + 64) of the stash slot
// `map` from one 64-column sub-block, asynchronously (the 128-byte swizzle
// of the sub-block is the map's)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int x, int y, const void* src) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n"
               ::"l"(map), "r"(x), "r"(y), "r"(smem_addr(src)) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most n of this thread's store groups still read shared memory
template <int n>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(n) : "memory");
}

// acc = the pass's product: segment 0 of the layer input a0 times the
// pass's w0 rows, then segment 1 (a1, w1).  Warpgroup wg owns rows (wg % 2)
// * 64 + [0, 64) and columns (wg / 2) * 96 + [0, 96) (those at or past
// ncols are computed from the stream's zero rows and dropped by the
// epilogue).  Each slice waits for its stage to fill; its products run
// behind the next slice's wait, and a warp frees a stage once its share of
// the products that read it is done.
__device__ __forceinline__ void run_pass(Tile& t, const Pass& ps, const Act& a0, const Act& a1,
                                         float (&acc)[kAcc]) {
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int row0 = (wg & 1) * kGroupRows, col0 = (wg >> 1) * kGroupCols;
  const bool on = col0 < ps.ncols;  // uniform across the warpgroup
  const bool signal = lane == 0;  // one arrival per warp
  auto release = [&](int j) { mbar_arrive(t.ring.empty(j % kStages), signal); };
#pragma unroll
  for (int q = 0; q < kAcc; ++q) acc[q] = 0.f;
  const int nsl = (ps.K0 + ps.K1) / kSliceK;
  for (int i = 0; i < nsl; ++i, ++t.j) {
    mbar_wait(t.ring.full(t.j % kStages), (t.j / kStages) & 1);
    if (on) {
      const int k = i * kSliceK;
      const bool first = k < ps.K0;
      const int ka = first ? k : k - ps.K0, bw = first ? a0.bw : a1.bw;
      const uint32_t a = ka < bw ? (first ? a0.blk[0] : a1.blk[0]) + swz(row0, ka)
                                 : (first ? a0.blk[1] : a1.blk[1]) + swz(row0, ka - bw);
      const uint32_t b = t.ring.stage + (t.j % kStages) * kStageBytes + col0 * kSliceK * 2;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSliceK / 16; ++kk)
        wgmma_m64n96k16(acc, desc(a + kk * 32, 1024, 1), desc(b + kk * 32, 512, 2));
      wgmma_commit();
      wgmma_wait<1>();  // slice j - 1's products are done
    }
    if (i > 0) release(t.j - 1);
  }
  wgmma_wait<0>();
  release(t.j - 1);
}

// out[r, c] = bf16(act(acc + bias[c])) for the pass's ncols columns, into
// the swizzled block `out`
__device__ __forceinline__ void epilogue(const float (&acc)[kAcc], int ncols, const float* bias,
                                         bool relu, unsigned char* out) {
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (wg & 1) * kGroupRows + 16 * warp, col0 = (wg >> 1) * kGroupCols;
#pragma unroll
  for (int j = 0; j < kGroupCols / 8; ++j) {
    const int c = col0 + 8 * j + 2 * t;
    if (col0 + 8 * j >= ncols) continue;
    const float bias0 = bias[c], bias1 = bias[c + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h;
      float v0 = acc[4 * j + 2 * h] + bias0, v1 = acc[4 * j + 2 * h + 1] + bias1;
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + swz(r, c)) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// Layer l (N output columns, one or two passes; its passes are next in the
// ring): a0 . w0^T (+ a1 . w1^T) + bias, ReLU if relu, rounded to bf16 into
// its blocks.  Ends after a barrier; with the stash, thread 0 then starts
// the tensor stores of the layer's blocks into stash slot l (`map`, rows of
// N), one store group per block.  A block is overwritten no earlier than by
// pass 1 of the next layer (the first block of a two-pass layer) or by the
// layer after it, so thread 0 waits for the stores to have read the first
// block before the next layer's pass-1 barrier and for all of them before
// its closing barrier: half a layer and a whole one later.  kSkip: `map` may
// be null, and then the layer is not stored (the stash's other forms).
template <bool kStash, bool kSkip = false>
__device__ __forceinline__ void layer(Tile& t, int l, const Act& a0, const Act& a1, int N,
                                      const float* bias, bool relu, const CUtensorMap* map,
                                      size_t p0) {
  const int lnp = N > kPassCols ? 2 : 1, pw = N / lnp;
  const bool issuer = kStash && threadIdx.x == 0;
  float acc[kAcc];
  for (int q = 0; q < lnp; ++q) {
    const Pass ps = t.tab[t.pass++];
    run_pass(t, ps, a0, a1, acc);
    if (q == 1) {  // this pass writes a block its layer reads
      if (issuer) bulk_wait_read<1>();
      consumer_sync();
    }
    epilogue(acc, pw, bias + q * pw, relu, out_block(t, l, q));
  }
  if (issuer) bulk_wait_read<0>();
  fence_proxy_async();  // the layer's output reaches the next layer's wgmma and the stores
  consumer_sync();
  if (issuer && (!kSkip || map)) {  // no map: not stashed, or stashed by quantize_layer
    for (int q = 0; q < lnp; ++q) {
      for (int a = 0; a * kSub < pw; ++a)
        tma_store(map, q * pw + a * kSub, (int)p0, out_block(t, l, q) + a * kSubBytes);
      bulk_commit();
    }
  }
}

// The int8 stash of layer l (N columns, its rows in the tile's blocks after
// layer()'s closing barrier): per row the symmetric int8 codes of its bf16
// values, q = clip(rint(v * (1 / s)), -127, 127) with s = max(amax, 1e-12)
// / 127 in f32, as XLA computes the TPU kernel's quantizer: the quotient by
// 127 a product by 127's f32 reciprocal, 1 / s a quotient, the rounding to
// nearest even (jnp.round); into
// codes ([P, N] from row p0) and s into column j of scales ([P,
// kQuantTags]).  Four threads a row, each 16-byte chunk c * 8 .. c * 8 + 7 of
// it with c % 4 its part; the row's amax by two shuffles.  Reads the blocks
// only: the next layer overwrites one of them no earlier than after its
// pass-1 barrier, which every thread reaches after this.
__device__ inline void quantize_layer(const Tile& t, int l, int N, signed char* codes,
                                      float* scales, int j, size_t p0) {
  const int tid = threadIdx.x, r = tid >> 2, part = tid & 3;
  const int pw = N / (N > kPassCols ? 2 : 1);
  const unsigned char* blk0 = out_block(t, l, 0);
  const unsigned char* blk1 = out_block(t, l, 1);
  auto chunk = [&](int c) {
    return *reinterpret_cast<const uint4*>(c < pw ? blk0 + swz(r, c) : blk1 + swz(r, c - pw));
  };
  float a = 0.f;
  for (int c = 8 * part; c < N; c += 32) {
    const uint4 v = chunk(c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      a = fmaxf(a, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
  a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
  a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 2));
  const float s = __fmul_rn(fmaxf(a, 1e-12f), kInv127), inv = __fdiv_rn(1.f, s);
  if (part == 0) scales[(p0 + r) * kQuantTags + j] = s;
  signed char* row = codes + (p0 + r) * N;
  for (int c = 8 * part; c < N; c += 32) {
    const uint4 v = chunk(c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    auto code = [&](float x) {  // the byte of x's code
      return (uint32_t)(__float2int_rn(fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.f), 127.f)) &
                        0xff);
    };
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      w[k >> 1] |= (code(f.x) | code(f.y) << 8) << (16 * (k & 1));
    }
    *reinterpret_cast<uint2*>(row + c) = make_uint2(w[0], w[1]);
  }
}

// Byte offsets in the dynamic shared memory (from its first 1024-byte
// boundary): the three activation blocks, the embedding tile [kRows, Kp]
// (swizzled) and the ring, which the per-ray u [TR, H/2] (f32) takes over
// once both are dead, then the f32 per-point and per-ray buffers and the
// pass table.  When the CTA's rays span tiles (kSpan), the ring and the
// embedding tile live on from tile to tile, so u has a place of its own
// after the barriers.
struct Layout {
  size_t e, ring, sig, tab, bars, u, total;
};

template <bool kSpan>
__host__ __device__ inline Layout layout(int S, int Kp, int H) {
  Layout o;
  o.e = (size_t)kBlocks * (H / trunk_passes(H) / kSub) * kSubBytes;
  o.ring = o.e + (size_t)(Kp / kSub) * kSubBytes;
  const size_t ring_end = o.ring + (size_t)kStages * kStageBytes;
  const size_t u_end = kSpan ? 0 : o.e + (size_t)(kRows / S) * (H / 2) * sizeof(float);
  o.sig = ((ring_end > u_end ? ring_end : u_end) + 15) & ~(size_t)15;
  o.tab = o.sig + 3 * kRows * sizeof(float);  // sig, wts, the per-ray sums
  o.bars = (o.tab + kMaxPasses * sizeof(Pass) + 7) & ~(size_t)7;
  o.total = o.bars + 2 * kStages * sizeof(uint64_t);  // full, empty
  o.u = o.e;
  if (kSpan) {
    o.u = (o.total + 15) & ~(size_t)15;
    o.total = o.u + (size_t)cta_rays(S) * (H / 2) * sizeof(float);
  }
  return o;
}

// dynamic shared memory to ask for: the layout and room to align it
inline size_t smem_bytes(int S, int Kp, int H) {
  return (cta_tiles(S) > 1 ? layout<true>(S, Kp, H) : layout<false>(S, Kp, H)).total + 1024;
}

// The tensor map of one stash slot, [P, N] bf16 rows at `base`, written in
// [128, 64] boxes from the tile's 128-byte-swizzled sub-blocks (columns
// past N, in a sub-block wider than the slot, are not written)
inline bool stash_map(CUtensorMap* map, void* base, size_t P, size_t N) {
  return tile::bf16_map(map, base, P, N, N, kRows, kSub, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Compositing of tile `tile` (first point pt) of a CTA whose rays span
// tiles (S a multiple of 64): a warp per ray segment of the tile (64 or 128
// samples, lane l the samples lo + l * spl + [0, spl)), its transmittance
// starting from trans[ray], the ray's T past its earlier tiles; each ray's
// sum_s w_s (acc_ray), depth sum, trans and u[ray] = sum_s w_s y1_s carried
// on to its next tile.  Ends after a barrier.
__device__ inline void composite_span(const Params& p, int tile, size_t pt, const float* sig,
                                      float* wts, float* acc_ray, float* depth_ray,
                                      float* trans, float* u, const unsigned char* Y) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = p.S, H2 = p.H / 2;
  // the tile's rays: the CTA's rays first .. first + nseg - 1, ray `ray`'s
  // samples the tile's points [lo, hi)
  const int first = tile * kRows / S, nseg = ((tile + 1) * kRows - 1) / S - first + 1;
  auto seg = [&](int ray, int& lo, int& hi) {
    lo = max(ray * S - tile * kRows, 0);
    hi = min((ray + 1) * S - tile * kRows, kRows);
  };
  for (int sg = warp; sg < nseg; sg += kWarps) {
    const int ray = first + sg;
    int lo, hi;
    seg(ray, lo, hi);
    const int n = hi - lo, spl = (n + 31) / 32;
    float alpha[4], T[4];
    float f = 1.f;  // the lane's product of (1 - alpha + eps)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = lane * spl + q;
      const bool ok = q < spl && s < n;
      const int r = lo + s;
      alpha[q] = ok ? 1.f - expf(-sig[r] * p.zdists[pt + r]) : 0.f;
      T[q] = f;
      if (ok) f *= 1.f - alpha[q] + kEps;
    }
    const float T0 = warp_prefix_product(f);
    const float tc = trans[ray];
    const float all = __shfl_sync(0xffffffffu, T0 * f, 31);  // the segment's product
    float acc = 0.f, depth = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = lane * spl + q;
      if (q >= spl || s >= n) continue;
      const int r = lo + s;
      const float w = alpha[q] * (T[q] * (T0 * tc));
      wts[r] = w;
      p.w_out[pt + r] = w;
      acc += w;
      depth += w * p.zvals[pt + r];
    }
    acc = warp_sum(acc);
    depth = warp_sum(depth);
    if (lane == 0) {
      acc_ray[ray] += acc;
      depth_ray[ray] += depth;
      trans[ray] = tc * all;
    }
  }
  consumer_sync();

  // u[ray, c] += sum_s w_s y1_s[c] over the ray's samples in the tile
  for (int i = tid; i < nseg * H2; i += kConsumers) {
    const int sg = i / H2, c = i - sg * H2;
    int lo, hi;
    seg(first + sg, lo, hi);
    float s = 0.f;
    for (int r = lo; r < hi; ++r) s += wts[r] * bf2f(*reinterpret_cast<const bf16*>(Y + swz(r, c)));
    u[(first + sg) * H2 + c] += s;
  }
  consumer_sync();
}

// The CTA of batch b starting at ray r0: cta_rays(S) whole rays in
// cta_tiles(S) tiles, more than one only when kSpan (a separate
// instantiation, so that the one-tile code carries none of the other's
// state).  kStash: write the tiles' rows of the ten stash slots through the
// tensor maps `stash` (x0..x7, y0b: [B R S, H] bf16; y1: [B R S, H/2]),
// which lie in the kernel's parameters; with kForm kFormMask only those in
// `mask` (bit l: layer l's slot); with kFormQuant x7 and y1, and the int8
// stash of x0..x6 and y0b, codes[l] ([B R S, H] int8) and their scales ([B
// R S, kQuantTags] f32, column j for tag j: x0..x6, y0b).  kPoints: encode
// the points p.embed holds into the embedding tile.
template <bool kStash, bool kSpan, bool kPoints = false, int kForm = kFormAll>
__device__ inline void forward_tile(const Params& p, const CUtensorMap* stash, int b, int r0,
                                    unsigned mask = 0, signed char* const* codes = nullptr,
                                    float* scales = nullptr) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int H = p.H, H2 = p.H / 2, S = p.S, C = p.C, Kp = p.Kp;
  const int TR = rays_per_cta<kSpan>(S), ntiles = kSpan ? cta_tiles(S) : 1;
  const Layout L = layout<kSpan>(S, Kp, H);
  Tile t;
  t.np = trunk_passes(H);
  t.bw = H / t.np;
  t.act = smem;
  unsigned char* E = smem + L.e;
  float* u = reinterpret_cast<float*>(smem + L.u);  // [TR, H2]; one tile: after fea_5, rgb_1
  float* sig = reinterpret_cast<float*>(smem + L.sig);  // [kRows]
  float* wts = sig + kRows;                              // [kRows]
  float* acc_ray = wts + kRows;                          // [TR] sum_s w_s
  float* depth_ray = acc_ray + TR;                       // [TR] sum_s w_s z_s (kSpan)
  float* trans = depth_ray + TR;                         // [TR] T past the last tile (kSpan)
  Pass* tab = reinterpret_cast<Pass*>(smem + L.tab);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t ray0 = (size_t)b * p.R + r0;  // first ray of this CTA
  const size_t p0 = ray0 * S;                // first point

  // the passes in the order the layers run them, and the ring's barriers
  t.ring = {smem_addr(smem + L.ring), smem_addr(smem + L.bars)};
  if (tid == 0) {
    int n = 0;
    auto add = [&](int K0, int K1, int N) {
      const int lnp = N > kPassCols ? 2 : 1;
      for (int q = 0; q < lnp; ++q) tab[n++] = {K0, K1, N / lnp};
    };
    add(Kp, 0, H);
    for (int i = 0; i < 4; ++i) add(H, 0, H);
    add(Kp, H, H);
    for (int i = 0; i < 2; ++i) add(H, 0, H);
    add(H, 0, H);   // rgb_0
    add(H, 0, H2);  // rgb_1
    for (int s = 0; s < kStages; ++s) {
      mbar_init(t.ring.full(s), 1);
      mbar_init(t.ring.empty(s), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (kSpan) {  // the sums carried from tile to tile
    for (int i = tid; i < TR * H2; i += kThreads) u[i] = 0.f;
    if (tid < TR) {
      acc_ray[tid] = 0.f;
      depth_ray[tid] = 0.f;
      trans[tid] = 1.f;
    }
  }
  __syncthreads();
  t.tab = tab;
  // the trunk and rgb_0 in np passes each, rgb_1 (H / 2 <= 192 columns) in one
  const int npass = (kLayers - 1) * t.np + 1;

  if (warp == kWarps) {  // the producer: one thread streams the slices into the ring
    if (lane == 0) {
      int nsl = 0;
      for (int q = 0; q < npass; ++q) nsl += (tab[q].K0 + tab[q].K1) / kSliceK;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(p.wstream);
      for (int j = 0; j < nsl * ntiles; ++j) {  // the stream once per tile
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(t.ring.empty(s), (j / kStages - 1) & 1);
        mbar_expect_tx(t.ring.full(s), kStageBytes);
        bulk_load(t.ring.stage + s * kStageBytes,
                  src + (size_t)(kSpan ? j % nsl : j) * kStageBytes, kStageBytes,
                  t.ring.full(s));
      }
    }
    return;  // its copies land before the consumers, which wait for them, finish
  }
  t.j = 0;

  for (int tile = 0; tile < ntiles; ++tile) {
    const size_t pt = p0 + (size_t)tile * kRows;  // the tile's first point
    t.pass = 0;
    if (kStash && tile > 0 && tid == 0)
      bulk_wait_read<0>();  // the last tile's stores have read the blocks fea_0 writes
    for (int i = tid; i < kRows * Kp; i += kConsumers) {
      const int r = i / Kp, c = i - r * Kp;
      *reinterpret_cast<bf16*>(E + swz(r, c)) =
          c < p.De ? enc::embed_at<kPoints>(p.embed, pt + r, c, p.De) : __float2bfloat16(0.f);
    }
    fence_proxy_async();  // E reaches fea_0's wgmma
    consumer_sync();

    // the trunk, rgb_0 and rgb_1; layer l's rows go to stash slot l (or,
    // quantized, to codes[l])
    auto slot = [&](int l) -> const CUtensorMap* {
      if (!kStash) return nullptr;
      if (kForm == kFormMask) return mask >> l & 1 ? stash + l : nullptr;
      if (kForm == kFormQuant) return l == 7 || l == 9 ? stash + l : nullptr;
      return stash + l;
    };
    auto quant = [&](int l, int N) {
      if constexpr (kForm == kFormQuant) {
        if (l != 7 && l != 9) quantize_layer(t, l, N, codes[l], scales, l < 7 ? l : 7, pt);
      }
    };
    const Act emb = {{smem_addr(E), smem_addr(E)}, Kp};
    const Act none = {{0, 0}, 0};
    constexpr bool kSkip = kForm != kFormAll;
    layer<kStash, kSkip>(t, 0, emb, none, H, p.cb0 + (size_t)b * H, true, slot(0), pt);
    quant(0, H);
    for (int l = 1; l < 8; ++l) {
      if (l == 5)
        layer<kStash, kSkip>(t, 5, emb, output_of(t, 4), H, p.cb5 + (size_t)b * H, true,
                             slot(5), pt);
      else
        layer<kStash, kSkip>(t, l, output_of(t, l - 1), none, H,
                             p.bmid + (size_t)(l < 5 ? l - 1 : l - 2) * H, true, slot(l), pt);
      quant(l, H);
    }
    // density head from x7: 4 threads per row, f32 dot product of bf16 values
    {
      const unsigned char* x7[2] = {out_block(t, 7, 0), out_block(t, 7, 1)};
      const int r = tid >> 2, part = tid & 3;
      float s = 0.f;
      for (int k = part; k < H; k += 4) {
        const unsigned char* xr = k < t.bw ? x7[0] + swz(r, k) : x7[1] + swz(r, k - t.bw);
        s += bf2f(*reinterpret_cast<const bf16*>(xr)) * bf2f(p.wd[k]);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (part == 0) sig[r] = fmaxf(s + p.bd[0], 0.f);
    }
    layer<kStash, kSkip>(t, 8, output_of(t, 7), none, H, p.br0, false, slot(8), pt);  // rgb_0
    quant(8, H);
    layer<kStash, kSkip>(t, 9, output_of(t, 8), none, H2, p.cbr1 + (size_t)b * H2, true,
                         slot(9), pt);
    const unsigned char* Y = out_block(t, 9, 0);  // y1, swizzled [kRows, H2]

    if constexpr (kSpan) {
      composite_span(p, tile, pt, sig, wts, acc_ray, depth_ray, trans, u, Y);
      continue;
    }
    // compositing: a warp per ray, lane l the samples l * spl + [0, spl)
    const int spl = (S + 31) / 32;
    for (int ray = warp; ray < TR; ray += kWarps) {
      float alpha[4], T[4];
      float f = 1.f;  // the lane's product of (1 - alpha + eps)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = lane * spl + q;
        const bool ok = q < spl && s < S;
        const int r = ray * S + s;
        alpha[q] = ok ? 1.f - expf(-sig[r] * p.zdists[p0 + r]) : 0.f;
        T[q] = f;
        if (ok) f *= 1.f - alpha[q] + kEps;
      }
      const float T0 = warp_prefix_product(f);
      float acc = 0.f, depth = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = lane * spl + q;
        if (q >= spl || s >= S) continue;
        const int r = ray * S + s;
        const float w = alpha[q] * (T[q] * T0);
        wts[r] = w;
        p.w_out[p0 + r] = w;
        acc += w;
        depth += w * p.zvals[p0 + r];
      }
      acc = warp_sum(acc);
      depth = warp_sum(depth);
      if (lane == 0) {
        acc_ray[ray] = acc;
        p.bga_out[ray0 + ray] = 1.f - acc;
        p.depth_out[ray0 + ray] = depth;
      }
    }
    consumer_sync();

    // u[ray, c] = sum_s w_s y1_s[c]
    for (int i = tid; i < TR * H2; i += kConsumers) {
      const int ray = i / H2, c = i - ray * H2;
      float s = 0.f;
      for (int j = 0; j < S; ++j) {
        const int r = ray * S + j;
        s += wts[r] * bf2f(*reinterpret_cast<const bf16*>(Y + swz(r, c)));
      }
      u[i] = s;
    }
    consumer_sync();
  }
  if (kSpan && tid < TR) {
    p.bga_out[ray0 + tid] = 1.f - acc_ray[tid];
    p.depth_out[ray0 + tid] = depth_ray[tid];
  }

  // feat_int[ray, c] = u[ray] . Wr2[:, c] + (sum_s w_s) br2[c]: a thread per
  // column, four rays at a time, Wr2 read eight rows ahead of the sums (H/2
  // is a multiple of 32)
  for (int c = tid; c < C; c += kConsumers) {
    for (int g0 = 0; g0 < TR; g0 += 4) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < H2; k0 += 8) {
        float w[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) w[k] = bf2f(p.wr2[(size_t)(k0 + k) * C + c]);
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (g0 + q < TR) s[q] += u[(g0 + q) * H2 + k0 + k] * w[k];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (g0 + q < TR) p.feat_out[(ray0 + g0 + q) * C + c] = s[q] + acc_ray[g0 + q] * p.br2[c];
    }
  }
  if (kStash && tid == 0)  // shared memory outlives the stores' reads
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace ffwd
