// Tensor-core and copy building blocks shared by the port's kernels.
//
// The mma.sync m16n8k16 fragment helpers (bf16 in, f32 accumulate) and
// cp.async serve the fused field backward (csrc/field_bwd.cuh) and the
// weight-gradient GEMM (csrc/field_dw.cuh); the wgmma fences and waits, the
// wgmma shared-memory descriptor, the mbarriers, the bulk and tensor (TMA)
// copies and the host's tensor-map encoder serve the field forward
// (csrc/field_fwd.cuh, csrc/fused_field2_fwd.cu), that GEMM and the fused
// upsampler's chain body (csrc/upsampler_chain.cuh).

#pragma once

#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

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

// A wgmma shared-memory matrix descriptor: K-major, 8-row groups `sbo`
// bytes apart, `swizzle` 1 (128-byte) or 2 (64-byte)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t sbo, uint64_t swizzle) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (uint64_t)1 << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | swizzle << 62;
}

// ---- mbarriers and asynchronous copies ----

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Wait for the phase of `bar` with this parity to complete.  A wait that
// never ends (a fault in the pipeline) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n > (1u << 24)) __trap();
  }
}

// if `pred`, arrive on `bar`; predicated, not branched, so the warp stays
// converged for the next wgmma
__device__ __forceinline__ void mbar_arrive(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      ::"r"(bar), "r"((int)pred) : "memory");
}

// The producer's arrival on a stage's full barrier, with the stage's bytes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// bytes from global src to shared dst, completing them on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The box of the 2-D tensor `map` at element coordinates (x, y) (x the
// contiguous axis) into shared memory at dst, completing its bytes on `bar`;
// elements outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(map), "r"(x), "r"(y), "r"(bar) : "memory");
}

// The box of the 3-D tensor `map` at element coordinates (x, y, z) (x the
// contiguous axis) into shared memory at dst, completing its bytes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                            int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(map), "r"(x), "r"(y), "r"(z), "r"(bar) : "memory");
}

// cuTensorMapEncodeTiled, found through the CUDA runtime's entry-point query
// (the libraries link the runtime alone); null where it is missing
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }
  return fn;
}

// The tensor map of a row-major [rows, planes, cols] bf16 tensor at `base`
// (cols * 2 a multiple of 16 bytes; planes 1 for a matrix whose rows are
// `ld` elements apart), read or written in boxes of [box_rows, 1, box_cols]
// with the given swizzle; false if it cannot be encoded
inline bool bf16_map(CUtensorMap* map, const void* base, size_t rows, size_t cols, size_t ld,
                     int box_rows, int box_cols, CUtensorMapSwizzle swizzle, size_t planes = 1) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
  if (!fn) return false;
  const cuuint32_t rank = planes == 1 ? 2 : 3;  // 2-D: {cols, rows}
  const cuuint64_t dims[3] = {cols, rank == 2 ? rows : planes, rows};
  const cuuint64_t strides[2] = {ld * sizeof(bf16), planes * ld * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, rank == 2 ? (cuuint32_t)box_rows : 1u,
                             (cuuint32_t)box_rows};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tile
